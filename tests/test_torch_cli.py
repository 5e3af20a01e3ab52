"""`python -m gaussctrl_tpu_torch.cli.train --device cpu --tiny-sd` end to end
on a synthetic scene, its resume path, and its re-optimised checkpoint
against `gaussctrl_tpu.cli.train`'s.

The scene is the one of tests/test_cli.py: four ring views of random 64×64
images and a random 128-gaussian scene at SH degree 1, saved as npz by the
JAX package. For the comparison both CLIs run their pipeline in float32
with one numpy-drawn tiny parameter tree and a black background, so that
the same edit drives the same re-optimisation.
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


@pytest.fixture(scope="module")
def runs(scene_dir, tmp_path_factory):
    """Both CLIs on the scene, float32, with one tiny parameter tree."""
    params = random_flax_params(JSDModels.create(JSDConfig.tiny()), seed=3)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    out = tmp_path_factory.mktemp("cli_out")
    mp = pytest.MonkeyPatch()
    mp.setenv("GAUSSCTRL_NO_CACHE", "1")
    mp.setattr(jtrain, "GaussCtrlPipeline", lambda *a, **kw: JPipeline(
        *a, sd_params=jparams, dtype=jnp.float32, **kw))
    mp.setattr(ttrain, "GaussCtrlPipeline", lambda *a, **kw: GaussCtrlPipeline(
        *a, sd_params=params, dtype=torch.float32, **kw))
    try:
        common = ["--data", str(scene_dir),
                  "--load-checkpoint", str(scene_dir / "scene.npz"), *ARGS]
        jdir = jtrain.main([*common, "--output-dir", str(out / "jax")])
        tdir = ttrain.main([*common, "--output-dir", str(out / "port"),
                            "--device", "cpu"])
    finally:
        mp.undo()
    return jdir, tdir


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


def test_cli_rejects_text_masks(scene_dir, tmp_path):
    """Text-prompted masks are not ported: the flag raises, and says so."""
    with pytest.raises(NotImplementedError, match="langsam_obj"):
        ttrain.main(["--data", str(scene_dir), "--load-checkpoint",
                     str(scene_dir / "scene.npz"), "--output-dir",
                     str(tmp_path), "--device", "cpu", "--tiny-sd",
                     "--pipeline.langsam_obj", "bear"])
