"""`python -m gaussctrl_tpu_torch.cli.splat_train --device cpu` against
`python -m gaussctrl_tpu.cli.splat_train` on data/example_scene: the same
artifact layout and dataparser transform, checkpoints that each package's
`load_scene_npz` reads, and the port's resume of its own checkpoint; and
the `--archive-ckpts` cycle of both CLIs' `_save_ckpt` (the fp16 archive
kept latest-only, except the archives git tracks).
"""

import json
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(2)

FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")
REPO = Path(__file__).resolve().parents[1]


def _run_cli(main, out, extra):
    # blend segments of 128 instances, 16 tiles a step: the same function
    # as the defaults, faster on the CPU for both packages
    main(["--data", str(REPO / "data" / "example_scene"), "--output-dir",
          str(out), "--trainer.num_steps", "3", "--trainer.eval_every", "0",
          "--raster.tile_capacity", "128", "--raster.tile_chunk", "16",
          *extra])
    (run,) = list((out / "example_scene" / "splat").iterdir())
    return run


def test_cli_splat_train_matches_jax_cli(tmp_path, monkeypatch, request):
    """Both CLIs for 3 steps on data/example_scene (12 views, 2,600 seed
    points, 200×200, trained at 50×50), both seeding on one kNN branch
    (`pin_knn_branch`: the native one where both build): the same
    artifacts, the same dataparser transform, checkpoints each package's
    `load_scene_npz` reads with the same gaussian count; then the port
    resumes its own checkpoint for 2 more steps."""
    from test_torch_data import pin_knn_branch
    pin_knn_branch(monkeypatch, request, "native")
    from gaussctrl_tpu.cli import splat_train as jcli
    from gaussctrl_tpu.core.ckpt import load_scene_npz as j_load
    from gaussctrl_tpu_torch.cli import splat_train as tcli
    from gaussctrl_tpu_torch.core.ckpt import load_scene_npz as t_load
    jrun = _run_cli(jcli.main, tmp_path / "jax", [])
    trun = _run_cli(tcli.main, tmp_path / "torch", ["--device", "cpu"])

    def layout(run):
        return sorted(str(p.relative_to(run)) for p in run.rglob("*"))

    assert layout(trun) == layout(jrun)
    assert "ckpts/step-000000003.npz" in layout(trun)
    assert len(list((trun / "final_renders").glob("*.png"))) == 4
    assert (json.loads((trun / "dataparser_transforms.json").read_text())
            == json.loads((jrun / "dataparser_transforms.json").read_text()))
    events = [json.loads(x) for x in
              (trun / "events.jsonl").read_text().splitlines()]
    assert events[0]["step"] == 0 and "loss" in events[0]
    tck, jck = trun / "ckpts/step-000000003.npz", jrun / "ckpts/step-000000003.npz"
    assert j_load(tck).num_gaussians == t_load(jck).num_gaussians == 2600
    for k in FIELDS:
        assert np.asarray(getattr(j_load(tck), k)).shape == \
            tuple(getattr(t_load(jck), k).shape)
    rrun = _run_cli(tcli.main, tmp_path / "resume",
                    ["--device", "cpu", "--trainer.num_steps", "5",
                     "--resume-checkpoint", str(tck)])
    assert (rrun / "ckpts/step-000000005.npz").exists()


def _scene_pair(n=32, seed=3):
    """One random scene in both packages' types."""
    import jax.numpy as jnp
    from gaussctrl_tpu.splat.scene import GaussianScene as JScene
    from gaussctrl_tpu_torch.splat.scene import GaussianScene

    r = np.random.RandomState(seed)
    arrs = dict(means=r.randn(n, 3) * 2.0, scales=r.randn(n, 3) - 4.0,
                quats=r.randn(n, 4), opacities=r.randn(n, 1),
                features_dc=r.randn(n, 3), features_rest=r.randn(n, 15, 3) * 0.1)
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    return (JScene(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            GaussianScene(**{k: torch.tensor(v) for k, v in arrs.items()}))


def _files(d):
    return sorted(p.name for p in Path(d).iterdir())


def test_archive_ckpts_cycle_matches_jax(tmp_path):
    """Two checkpoints with --archive-ckpts: both CLIs keep the latest
    step and its fp16 archive only, with the same files bit for bit, and
    the archive loads back in float32."""
    from gaussctrl_tpu.cli.splat_train import _save_ckpt as j_save
    from gaussctrl_tpu_torch.cli.splat_train import _save_ckpt
    from gaussctrl_tpu_torch.core.ckpt import load_scene_npz

    js, ts = _scene_pair()
    for step in (500, 1000):
        j_save(tmp_path / "jax", step, js, archive=True)
        _save_ckpt(tmp_path / "port", step, ts, archive=True)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == \
        ["step-000001000.fp16.npz", "step-000001000.npz"]
    for name in _files(tmp_path / "jax"):
        a, b = np.load(tmp_path / "jax" / name), np.load(tmp_path / "port" / name)
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{name}:{k}")
    got = load_scene_npz(tmp_path / "port" / "step-000001000.fp16.npz")
    assert got.means.dtype == torch.float32


def test_archive_prune_spares_git_tracked_like_jax(tmp_path):
    """An archive that git tracks survives the latest-only pruning in both
    CLIs; the untracked ones in between go."""
    import subprocess

    from gaussctrl_tpu.cli.splat_train import _save_ckpt as j_save
    from gaussctrl_tpu_torch.cli.splat_train import _save_ckpt

    js, ts = _scene_pair()
    arcs = {}
    for name, save, scene in (("jax", j_save, js), ("port", _save_ckpt, ts)):
        root = tmp_path / name
        ckpts = root / "run" / "ckpts"
        subprocess.run(["git", "init", "-q", str(root)], check=True)
        for k, v in (("user.email", "t@t"), ("user.name", "t")):
            subprocess.run(["git", "-C", str(root), "config", k, v], check=True)
        save(ckpts, 500, scene, archive=True)
        subprocess.run(["git", "-C", str(root), "add", "-f",
                        "run/ckpts/step-000000500.fp16.npz"], check=True)
        subprocess.run(["git", "-C", str(root), "commit", "-qm", "archive 500"],
                       check=True)
        save(ckpts, 1000, scene, archive=True)
        save(ckpts, 1500, scene, archive=True)
        arcs[name] = sorted(p.name for p in ckpts.glob("*.fp16.npz"))
    assert arcs["port"] == arcs["jax"] == \
        ["step-000000500.fp16.npz", "step-000001500.fp16.npz"]
