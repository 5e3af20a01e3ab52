"""`python -m gaussctrl_tpu_torch.cli.train --device cpu --tiny-sd` end to end
on a synthetic scene, its resume path, its object masks and its
re-optimised checkpoint against `gaussctrl_tpu.cli.train`'s; the option
sets of the edit and pre-training CLIs against the JAX CLIs'; and
`cli.eval` against `gaussctrl_tpu.cli.eval`.

The scene is the one of tests/test_cli.py: four ring views of random 64×64
images and a random 128-gaussian scene at SH degree 1, saved as npz by the
JAX package. For the comparison both CLIs run their pipeline in float32
with one numpy-drawn tiny parameter tree and a black background, so that
the same edit drives the same re-optimisation. Two more runs of both CLIs
edit the object 'bear' under masks from one carried tiny segmentation
stack (each package's `build_langsam_equivalent` patched to return it),
one with the CLIP proposer, one with GroundingDINO. The stacks cannot be shared
through the flags at tiny size (a SAM file means ViT-H/L/B by its width, a
GroundingDINO file Swin-B, a CLIP directory ViT-L/14).
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.cli import train as jtrain
from gaussctrl_tpu.diffusion.config import SDConfig as JSDConfig
from gaussctrl_tpu.diffusion.sample import SDModels as JSDModels
from gaussctrl_tpu.pipeline.gaussctrl import GaussCtrlPipeline as JPipeline

from gaussctrl_tpu_torch.cli import train as ttrain
from gaussctrl_tpu_torch.core.ckpt import load_scene_npz
from gaussctrl_tpu_torch.pipeline.gaussctrl import GaussCtrlPipeline

from test_torch_diffusion import random_flax_params
from test_torch_dino import carried_dino, write_vocab
from test_torch_seg import carried_clip, carried_sam

torch.set_num_threads(2)

FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")
STEPS = 2
ARGS = ["--tiny-sd",
        "--pipeline.edit_prompt", "a bronze statue",
        "--pipeline.num_inference_steps", "1",
        "--pipeline.chunk_size", "0",
        "--pipeline.ref_view_num", "2",
        "--pipeline.render_rate", str(STEPS),
        "--pipeline.render_batch", "2",
        "--optimizers.background", "black"]


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    from PIL import Image

    from gaussctrl_tpu.core.ckpt import save_pytree
    from gaussctrl_tpu.splat.scene import random_scene

    d = tmp_path_factory.mktemp("synth_scene")
    (d / "images").mkdir()
    rng = np.random.default_rng(0)
    frames = []
    for i in range(4):
        a = 2 * np.pi * i / 4
        pos = np.array([np.sin(a) * 2, 0.2, np.cos(a) * 2])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        m = np.eye(4)
        m[:3, :3] = np.stack([right, up, -fwd], axis=1)
        m[:3, 3] = pos
        name = f"images/frame_{i + 1:05d}.jpg"
        Image.fromarray((rng.uniform(size=(64, 64, 3)) * 255).astype(np.uint8)
                        ).save(d / name)
        frames.append({"file_path": name, "transform_matrix": m.tolist()})
    meta = {"w": 64, "h": 64, "fl_x": 64.0, "fl_y": 64.0, "cx": 32.0,
            "cy": 32.0, "camera_model": "OPENCV", "frames": frames}
    (d / "transforms.json").write_text(json.dumps(meta))
    save_pytree(d / "scene.npz", random_scene(jax.random.PRNGKey(0), 128,
                                              sh_degree=1, extent=0.4))
    return d


def carried_maskers(route, tmp_dir):
    """(JAX masker, port masker) on one carried tiny stack: SAM with the
    CLIP proposer (its floor lowered so that every view gets a box: the
    random towers' cosines are all below 0 on these views) or with
    GroundingDINO (threshold 0)."""
    from gaussctrl_tpu.seg import dino as jdino
    from gaussctrl_tpu.seg import grounding as jground
    from gaussctrl_tpu_torch.seg import dino as tdino
    from gaussctrl_tpu_torch.seg import grounding as tground

    jsam, tsam, _ = carried_sam()
    if route == "clip":
        jprop, tprop, _ = carried_clip()
        jprop.min_score = tprop.min_score = -1.0
    else:
        jd, td = carried_dino()
        vocab = write_vocab(tmp_dir / "vocab.txt")
        jprop = jdino.DinoBoxProposer(jd.model, jd.params,
                                      jdino.WordPieceTokenizer(vocab), 0.0)
        tprop = tdino.DinoBoxProposer(td, tdino.WordPieceTokenizer(vocab), 0.0)
    return (jground.GroundedSAMMasker(jsam, jprop),
            tground.GroundedSAMMasker(tsam, tprop))


def run_both(scene_dir, out, route=None):
    """Both CLIs on the scene, float32, with one tiny parameter tree; with a
    `route`, also `--pipeline.langsam_obj bear` and one carried
    segmentation stack."""
    params = random_flax_params(JSDModels.create(JSDConfig.tiny()), seed=3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    mp = pytest.MonkeyPatch()
    mp.setenv("GAUSSCTRL_NO_CACHE", "1")
    mp.setattr(jtrain, "GaussCtrlPipeline", lambda *a, **kw: JPipeline(
        *a, sd_params=jparams, dtype=jnp.float32, **kw))
    mp.setattr(ttrain, "GaussCtrlPipeline", lambda *a, **kw: GaussCtrlPipeline(
        *a, sd_params=params, dtype=torch.float32, **kw))
    common = ["--data", str(scene_dir),
              "--load-checkpoint", str(scene_dir / "scene.npz"), *ARGS]
    if route:
        jmask, tmask = carried_maskers(route, out)
        mp.setattr("gaussctrl_tpu.seg.grounding.build_langsam_equivalent",
                   lambda *a, **kw: jmask)
        mp.setattr("gaussctrl_tpu_torch.seg.grounding.build_langsam_equivalent",
                   lambda *a, **kw: tmask)
        common += ["--pipeline.langsam_obj", "bear"]
    try:
        jdir = jtrain.main([*common, "--output-dir", str(out / "jax")])
        tdir = ttrain.main([*common, "--output-dir", str(out / "port"),
                            "--device", "cpu"])
    finally:
        mp.undo()
    return jdir, tdir


@pytest.fixture(scope="module")
def runs(scene_dir, tmp_path_factory):
    """Both CLIs on the scene, float32, with one tiny parameter tree."""
    return run_both(scene_dir, tmp_path_factory.mktemp("cli_out"))


def test_cli_artifact_layout(runs):
    """The port writes what the JAX CLI writes: config, dataparser
    transforms, the four resume artifact folders, edited images, one
    step-numbered checkpoint, timings and the final renders."""
    jdir, tdir = runs
    for d in (jdir, tdir):
        assert (d / "config.json").exists()
        assert (d / "dataparser_transforms.json").exists()
        for artifact in ("depth_npy", "z_0", "mask_npy"):
            assert len(list((d / artifact).glob("frame_*.npy"))) == 4
        assert len(list((d / "unedited").glob("frame_*.jpg"))) == 4
        assert len(list((d / "edited").glob("*.png"))) == 4
        assert len(list((d / "final_renders").glob("*.png"))) == 4
        assert [p.name for p in (d / "ckpts").glob("step-*.npz")] == \
            [f"step-{30000 + STEPS:09d}.npz"]
    timings = json.loads((tdir / "timings.json").read_text())
    assert timings["device"] == "cpu" and timings["num_views"] == 4
    assert json.loads((tdir / "dataparser_transforms.json").read_text()) == \
        json.loads((jdir / "dataparser_transforms.json").read_text())


def test_cli_artifacts_match_jax(runs):
    """The resume artifacts agree with the JAX CLI's: depths at the render
    tests' 1e-3, inverted latents at 2e-4, edited PNGs within one level."""
    from PIL import Image
    jdir, tdir = runs
    for name, tol in (("depth_npy", 1e-3), ("z_0", 2e-4), ("mask_npy", 0)):
        for f in sorted((jdir / name).glob("*.npy")):
            np.testing.assert_allclose(np.load(tdir / name / f.name), np.load(f),
                                       rtol=tol, atol=tol, err_msg=f"{name}/{f.name}")
    for f in sorted((jdir / "edited").glob("*.png")):
        a = np.asarray(Image.open(f), np.int16)
        b = np.asarray(Image.open(tdir / "edited" / f.name), np.int16)
        assert np.abs(a - b).max() <= 1, f.name


def test_cli_checkpoint_matches_jax(runs):
    """The re-optimised checkpoint against the JAX CLI's, after two Adam
    steps at eps 1e-15: every parameter whose gradient is not exactly zero
    moves a full lr per step, so a gradient that is float noise can flip
    sign and leave an entry 2·lr away per step; each field is held to
    2·lr·steps at most, and 98% of its entries to 1e-3·lr."""
    jdir, tdir = runs
    name = f"step-{30000 + STEPS:09d}.npz"
    ref = np.load(jdir / "ckpts" / name)
    got = load_scene_npz(tdir / "ckpts" / name)
    lrs = dict(means=1.6e-6, scales=5e-3, quats=1e-3, opacities=5e-2,
               features_dc=2.5e-3, features_rest=2.5e-3 / 20)
    for k in FIELDS:
        diff = np.abs(getattr(got, k).numpy() - ref[k])
        assert diff.max() <= 2 * lrs[k] * STEPS * 1.01, (k, diff.max())
        assert (diff > 1e-3 * lrs[k]).mean() <= 0.02, (k, (diff > 1e-3 * lrs[k]).mean())


def test_cli_resume_through_load_artifacts(runs, scene_dir, tmp_path):
    """The artifacts of a run, placed beside the scene, are discovered by
    the dataparser; the port's `load_artifacts` adopts them as the JAX
    package's does (same arrays), and the CLI then skips render+invert."""
    from gaussctrl_tpu.cameras.camera import make_cameras as j_make_cameras
    from gaussctrl_tpu.data.datamanager import DataManager as JDataManager
    from gaussctrl_tpu.data.datamanager import DataManagerConfig as JDMConfig
    from gaussctrl_tpu.data.dataparser import DataparserConfig as JDPConfig

    from gaussctrl_tpu_torch.data.datamanager import (DataManager,
                                                      DataManagerConfig)
    from gaussctrl_tpu_torch.data.dataparser import DataparserConfig

    _, tdir = runs
    d = tmp_path / "resume_scene"
    shutil.copytree(scene_dir, d)
    for name in ("depth_npy", "z_0", "mask_npy", "unedited"):
        shutil.copytree(tdir / name, d / name)
    dm = DataManager(DataManagerConfig(dataparser=DataparserConfig(data=d)))
    jdm = JDataManager(JDMConfig(dataparser=JDPConfig(data=d)))
    scene = load_scene_npz(scene_dir / "scene.npz")
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    pipe = GaussCtrlPipeline(ttrain.GaussCtrlConfig(), scene, dm.cameras,
                             sd_config=SDConfig.tiny(), device="cpu")
    assert pipe.load_artifacts(dm.train_data)
    jcams = j_make_cameras(np.asarray(dm.cameras.c2w), 64.0, 64.0, 32.0, 32.0,
                           64, 64)
    jpipe = object.__new__(JPipeline)
    jpipe.cameras = jcams
    assert JPipeline.load_artifacts(jpipe, jdm.train_data)
    for k in ("unedited", "depths", "z_T", "masks", "disparity"):
        np.testing.assert_allclose(getattr(pipe, k).numpy(),
                                   np.asarray(getattr(jpipe, k)), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(pipe.z_T.numpy()[0],
                                  np.load(tdir / "z_0" / "frame_00001.npy"))

    logs = []
    mp = pytest.MonkeyPatch()
    mp.setattr("builtins.print", lambda *a, **kw: logs.append(" ".join(map(str, a))))
    try:
        out = ttrain.main(["--data", str(d), "--load-checkpoint",
                           str(scene_dir / "scene.npz"), "--output-dir",
                           str(tmp_path / "out"), "--device", "cpu", *ARGS])
    finally:
        mp.undo()
    assert any("resume" in line for line in logs)
    assert not any("inverted" in line for line in logs)
    assert len(list((out / "ckpts").glob("step-*.npz"))) == 1


@pytest.fixture(scope="module", params=["clip", "dino"])
def masked_runs(request, scene_dir, tmp_path_factory):
    return run_both(scene_dir, tmp_path_factory.mktemp(f"cli_{request.param}"),
                    request.param)


def test_cli_text_masks_match_jax(masked_runs):
    """`--pipeline.langsam_obj bear` writes binary masks in mask_npy/ equal
    to the JAX CLI's, on the CLIP route and on the GroundingDINO route, and
    the object is found in some views and not everywhere; the edited
    images agree within one level."""
    from PIL import Image
    jdir, tdir = masked_runs
    masks = []
    for f in sorted((jdir / "mask_npy").glob("*.npy")):
        got = np.load(tdir / "mask_npy" / f.name)
        assert set(np.unique(got)) <= {0.0, 1.0}, f.name
        np.testing.assert_array_equal(got, np.load(f), err_msg=f.name)
        masks.append(got)
    assert len(masks) == 4 and 0.0 < np.mean(masks) < 1.0
    for f in sorted((jdir / "edited").glob("*.png")):
        a = np.asarray(Image.open(f), np.int16)
        b = np.asarray(Image.open(tdir / "edited" / f.name), np.int16)
        assert np.abs(a - b).max() <= 1, f.name


_RENDER_SUBCOMMANDS = ("dataset", "camera-path", "interpolate", "spiral")
_ONLY_JAX = {"train": set(), "splat_train": {"--trainer.fullres_blend"},
             "render": set(), "export": set(), "viewer": set(),
             "certify": set()}
_ONLY_PORT = {"train": {"--device"}, "splat_train": {"--device"},
              "render": {f"{c} --device" for c in _RENDER_SUBCOMMANDS},
              "export": {"--device"}, "viewer": {"--device"},
              "certify": {"--device"}}
_RASTER = {"--raster.blend_impl", "--raster.bwd_write"}


@pytest.mark.parametrize("cli", ["train", "splat_train", "render", "export",
                                 "viewer", "certify"])
def test_cli_option_sets_match_jax(cli):
    """The port's CLI takes the JAX CLI's options (each subcommand's, as
    "<subcommand> <option>"), apart from an explicit list: the JAX
    pre-training CLI's --trainer.fullres_blend (the port blends with K1/K4
    at every resolution) and the port's --device."""
    import argparse
    import importlib

    class Built(Exception):
        pass

    def parser(mod):
        """The parser `mod.main` builds (the JAX pre-training, export,
        viewer and certify CLIs build it inside main), caught at its
        parse_args."""
        m = importlib.import_module(mod)
        if hasattr(m, "build_parser"):
            return m.build_parser()

        def stop(self, *a, **kw):
            raise Built(self)

        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("GAUSSCTRL_NO_CACHE", "1")
            mp.setattr(argparse.ArgumentParser, "parse_args", stop)
            with pytest.raises(Built) as built:
                m.main([])
        return built.value.args[0]

    def options(p, prefix=""):
        out = set()
        for a in p._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sub in a.choices.items():
                    out |= options(sub, f"{prefix}{name} ")
            out |= {prefix + o for o in a.option_strings
                    if o not in ("-h", "--help")}
        return out

    jopts = options(parser(f"gaussctrl_tpu.cli.{cli}"))
    topts = options(parser(f"gaussctrl_tpu_torch.cli.{cli}"))
    assert jopts - topts == _ONLY_JAX[cli]
    assert topts - jopts == _ONLY_PORT[cli]
    if cli in ("train", "splat_train"):
        assert _RASTER <= topts
    if cli == "render":
        assert {o.split()[0] for o in topts} == set(_RENDER_SUBCOMMANDS)


def test_raster_choices_accepted_and_ignored():
    """--raster.blend_impl and --raster.bwd_write parse with the JAX
    choices and defaults, name themselves in one line, and an unknown
    choice raises."""
    from gaussctrl_tpu.splat.rasterize import RasterConfig as JRaster
    from gaussctrl_tpu_torch.cli.flags import apply_overrides
    from gaussctrl_tpu_torch.splat.rasterize import (RasterConfig,
                                                     ignored_flags_line)

    assert (RasterConfig().blend_impl, RasterConfig().bwd_write) == \
        (JRaster().blend_impl, JRaster().bwd_write)
    p = ttrain.build_parser()
    base = ["--data", "d", "--load-checkpoint", "c"]
    args = p.parse_args(base + ["--raster.blend_impl", "pallas",
                                "--raster.bwd_write", "scatter"])
    cfg = apply_overrides(RasterConfig(), args, "raster")
    assert (cfg.blend_impl, cfg.bwd_write) == ("pallas", "scatter")
    line = ignored_flags_line(args)
    assert "--raster.blend_impl pallas" in line and "--raster.bwd_write scatter" in line
    assert "\n" not in line
    assert ignored_flags_line(p.parse_args(base)) == ""
    with pytest.raises(ValueError, match="blend_impl"):
        apply_overrides(RasterConfig(), p.parse_args(
            base + ["--raster.blend_impl", "triton"]), "raster")


@pytest.fixture(scope="module")
def eval_run(tmp_path_factory):
    """A run directory as the edit CLI leaves it (edited/, unedited/,
    config.json), and one carried tiny CLIP pair for both eval CLIs."""
    from PIL import Image
    from test_torch_metrics import carried_scorers

    run = tmp_path_factory.mktemp("eval") / "run"
    rng = np.random.default_rng(1)
    for name, fmt in (("edited", "{:05d}.png"), ("unedited", "frame_{:05d}.jpg")):
        (run / name).mkdir(parents=True)
        for i in range(3):
            Image.fromarray((rng.uniform(size=(40, 48, 3)) * 255).astype(np.uint8)
                            ).save(run / name / fmt.format(i + 1))
    (run / "config.json").write_text(json.dumps({"pipeline": {
        "edit_prompt": "a polar bear", "reverse_prompt": "a bear statue"}}))
    js, ts, _ = carried_scorers()
    return run, js, ts


@pytest.mark.parametrize("mode", ["dirs", "run"])
def test_eval_cli_matches_jax(eval_run, mode, capsys):
    """`cli.eval` with explicit directories and prompts, and with --run
    (which also writes eval_metrics.json into the run): the same JSON
    object as the JAX CLI's, the metrics within 1e-5."""
    from gaussctrl_tpu.cli import eval as jeval
    from gaussctrl_tpu_torch.cli import eval as teval

    run, js, ts = eval_run
    if mode == "dirs":
        argv = ["--edited", str(run / "edited"), "--original",
                str(run / "unedited"), "--edit-prompt", "a polar bear",
                "--reverse-prompt", "a bear statue"]
    else:
        argv = ["--run", str(run)]
    mp = pytest.MonkeyPatch()
    mp.setattr("gaussctrl_tpu.metrics.CLIPScorer.from_dir", lambda *a, **k: js)
    mp.setattr("gaussctrl_tpu_torch.metrics.CLIPScorer.from_dir",
               lambda *a, **k: ts)
    try:
        ref = jeval.main(argv)
        if mode == "run":
            (run / "eval_metrics.json").unlink()
        got = teval.main(argv + ["--device", "cpu"])
    finally:
        mp.undo()
    assert set(got) == set(ref) and got["num_views"] == 3
    for k, v in ref.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= 1e-5, k
        else:
            assert got[k] == v, k
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    if mode == "run":
        assert json.loads((run / "eval_metrics.json").read_text()) == got


def test_eval_cli_requires_prompt_or_run():
    from gaussctrl_tpu_torch.cli import eval as teval
    with pytest.raises(SystemExit):
        teval.main(["--edited", "/nonexistent"])
