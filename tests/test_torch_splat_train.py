"""`python -m gaussctrl_tpu_torch.cli.splat_train --device cpu` against
`python -m gaussctrl_tpu.cli.splat_train` on data/example_scene: the same
artifact layout and dataparser transform, checkpoints that each package's
`load_scene_npz` reads, and the port's resume of its own checkpoint.
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


def test_cli_splat_train_matches_jax_cli(tmp_path):
    """Both CLIs for 3 steps on data/example_scene (12 views, 2,600 seed
    points, 200×200, trained at 50×50): the same artifacts, the same
    dataparser transform, checkpoints each package's `load_scene_npz`
    reads with the same gaussian count; then the port resumes its own
    checkpoint for 2 more steps."""
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
