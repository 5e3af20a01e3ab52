"""The port's data and checkpoint modules against the JAX package's.

PLY files, the parsed `data/example_scene`, the view subsampling and
sampler of the DataManager, the npz checkpoints and the splatfacto importer
must come out the same in both packages; files written by one are read by
the other. The native host helpers are the same C++ source built twice
(the port's copy into its own build directory) and must agree exactly.
"""

import json
import os
import shutil
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from gaussctrl_tpu import native as jnative
from gaussctrl_tpu.core import ckpt as jckpt
from gaussctrl_tpu.data import dataparser as jparser
from gaussctrl_tpu.data import ply as jply
from gaussctrl_tpu.data.datamanager import DataManager as JDataManager
from gaussctrl_tpu.data.datamanager import DataManagerConfig as JDMConfig
from gaussctrl_tpu.splat.scene import random_scene as j_random_scene

from gaussctrl_tpu_torch import native as tnative
from gaussctrl_tpu_torch.core import ckpt as tckpt
from gaussctrl_tpu_torch.data import dataparser as tparser
from gaussctrl_tpu_torch.data import ply as tply
from gaussctrl_tpu_torch.data.datamanager import DataManager, DataManagerConfig
from gaussctrl_tpu_torch.splat.scene import GaussianScene

FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")


def _np_scene(scene):
    return {k: np.asarray(getattr(scene, k)) for k in FIELDS}


def _jax_scene(seed=0, n=50, degree=2):
    return j_random_scene(jax.random.PRNGKey(seed), n, sh_degree=degree)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ply_round_trip_across_packages(tmp_path, writer):
    """A point cloud and a gaussian scene written by one package read back
    identically by the other (and by itself)."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    js = _jax_scene()
    w, r = (tply, jply) if writer == "port" else (jply, tply)
    scene = GaussianScene.from_numpy(_np_scene(js)) if writer == "port" else js
    w.write_ply(tmp_path / "pc.ply", pts, cols)
    w.write_gaussian_ply(tmp_path / "g.ply", scene)
    for reader in (r, w):
        p2, c2 = reader.read_point_cloud(tmp_path / "pc.ply")
        np.testing.assert_array_equal(p2, pts)
        np.testing.assert_allclose(c2, cols, atol=1 / 255.0 + 1e-6)
        back = reader.read_gaussian_ply(tmp_path / "g.ply")
        for k in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                          np.asarray(getattr(js, k)), err_msg=k)
    assert (tply.read_ply(tmp_path / "pc.ply").keys()
            == jply.read_ply(tmp_path / "pc.ply").keys())


def test_parse_example_scene_identical():
    """data/example_scene: the same frames, cameras, transform, scale and
    transformed points (exact: the same numpy arithmetic)."""
    ref = jparser.parse_dataset(jparser.DataparserConfig(data="data/example_scene"))
    got = tparser.parse_dataset(tparser.DataparserConfig(data="data/example_scene"))
    assert [str(p) for p in got.image_filenames] == [str(p) for p in ref.image_filenames]
    assert (got.width, got.height) == (ref.width, ref.height) == (200, 200)
    for k in ("c2w", "fx", "fy", "cx", "cy", "distortion",
              "dataparser_transform", "points_xyz", "points_rgb"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)
    assert got.dataparser_scale == ref.dataparser_scale
    assert len(got) == 12 and len(got.points_xyz) == 2600


@pytest.mark.parametrize("method,center", [("up", "poses"), ("none", "poses"),
                                           ("up", "none")])
def test_auto_orient_and_center_identical(method, center):
    rng = np.random.default_rng(4)
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (9, 1, 1))
    poses[:, :3, :3] = np.linalg.qr(rng.normal(size=(9, 3, 3)))[0]
    poses[:, :3, 3] = rng.normal(size=(9, 3)) + 2.0
    ref = jparser.auto_orient_and_center_poses(poses, method, center)
    got = tparser.auto_orient_and_center_poses(poses, method, center)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


@pytest.fixture(scope="module")
def many_views(tmp_path_factory):
    """A 48-view scene of 16×16 images with OPENCV distortion, so that the
    DataManager subsamples (4 subsets × 10 views) and undistorts."""
    from PIL import Image
    d = tmp_path_factory.mktemp("many_views")
    (d / "images").mkdir()
    rng = np.random.default_rng(0)
    frames = []
    for i in range(48):
        m = np.eye(4)
        m[:3, 3] = [np.cos(i / 8.0), 0.1 * i / 48, np.sin(i / 8.0)]
        name = f"images/frame_{i + 1:05d}.png"
        Image.fromarray((rng.uniform(size=(16, 16, 3)) * 255).astype(np.uint8)
                        ).save(d / name)
        frames.append({"file_path": name, "transform_matrix": m.tolist()})
    meta = {"w": 16, "h": 16, "fl_x": 20.0, "fl_y": 20.0, "cx": 8.0, "cy": 8.0,
            "k1": 0.05, "k2": -0.01, "p1": 0.001, "p2": 0.0,
            "camera_model": "OPENCV", "frames": frames}
    (d / "transforms.json").write_text(json.dumps(meta))
    return d


def test_datamanager_selection_identical(many_views):
    """The same seed selects the same 40 views, with the same undistorted
    images and intrinsics, and the sampler draws the same order."""
    ref = JDataManager(JDMConfig(dataparser=jparser.DataparserConfig(data=many_views)))
    got = DataManager(DataManagerConfig(
        dataparser=tparser.DataparserConfig(data=many_views)))
    assert got.selected_indices == ref.selected_indices
    assert len(got) == 40
    for k in ("c2w", "fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(getattr(got.cameras, k).numpy(),
                                      np.asarray(getattr(ref.cameras, k)), err_msg=k)
    np.testing.assert_array_equal(got.stacked_images(), ref.stacked_images())
    assert [got.next_train(i)[0] for i in range(45)] == \
        [ref.next_train(i)[0] for i in range(45)]


def _jax_native_after_build(timeout_s: float = 120.0) -> bool:
    """The JAX loader's `available()`, asked again once a build that another
    test process may have under way in native/ has settled: that loader
    caches its first failure (`_tried`), and `make` writes the library in
    place, so a process that loads it mid-write fails for good. Waits until
    the library is newer than its source and its size holds still, resets
    the cache and tries once more."""
    if jnative.available():
        return True
    if shutil.which("make") is None or \
            shutil.which(os.environ.get("CXX", "g++")) is None:
        return False
    src = jnative._NATIVE_DIR / "gaussctrl_native.cpp"
    lib = jnative._LIB_PATH
    deadline, last = time.monotonic() + timeout_s, -1
    while time.monotonic() < deadline:
        if lib.exists() and lib.stat().st_mtime >= src.stat().st_mtime:
            size = lib.stat().st_size
            if size > 0 and size == last:
                break
            last = size
        time.sleep(0.5)
    jnative._tried, jnative._lib = False, None
    return jnative.available()


def pin_knn_branch(monkeypatch, request, branch: str) -> str:
    """Put both packages' native helpers on one branch for a test and
    return the branch they are on. The two kNN branches of `from_points`
    compute different things (ROADMAP F9), so a parity case must never
    compare one package's native branch with the other's exact one.

    "exact": both packages' `available()` pinned to False (the exact O(N²)
    kNN, the cv2 undistortion). "native": both built, the JAX build settled
    by `_jax_native_after_build`; where either cannot be built, both are
    pinned to the exact branch instead, so that the case still runs, and a
    warning says so. The branch used is recorded in the test's report as
    the user property "knn_branch"."""
    used = "exact"
    if branch == "native" and tnative.available() and _jax_native_after_build():
        used = "native"
    else:
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
        if branch == "native":
            warnings.warn("native kNN helpers unavailable: both packages ran "
                          "the exact branch in place of the native one")
    request.node.user_properties.append(("knn_branch", used))
    return used


@pytest.mark.parametrize("op", ["undistort", "resize", "knn"])
def test_native_helpers_identical(op):
    """The port's build of native/gaussctrl_native.cpp against the JAX
    package's: the same source, so exactly the same results. The JAX
    package's build is retried once after a concurrent build settles."""
    if not (tnative.available() and _jax_native_after_build()):
        pytest.skip("no C++ compiler for the native helpers")
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(24, 32, 3)).astype(np.float32)
    if op == "undistort":
        args = (img, 30.0, 29.0, 16.0, 12.0, [0.05, -0.01, 0.0, 0.0, 0.001, 0.0])
    elif op == "resize":
        args = (img, 17, 45)
    else:
        args = (rng.normal(size=(500, 3)).astype(np.float32), 3)
    fn = {"undistort": "undistort", "resize": "resize", "knn": "knn_mean_dist"}[op]
    np.testing.assert_array_equal(getattr(tnative, fn)(*args),
                                  getattr(jnative, fn)(*args))


def test_npz_checkpoint_across_packages(tmp_path):
    """A checkpoint written by the port loads with the JAX package's
    `load_scene_npz`, and the JAX package's with the port's; step naming,
    latest-only pruning and the fp16 archive behave the same."""
    js = _jax_scene(3)
    p_port = tckpt.save_checkpoint(tmp_path / "port",
                                   30010, GaussianScene.from_numpy(_np_scene(js)))
    p_jax = jckpt.save_checkpoint(tmp_path / "jax", 30010, js)
    assert p_port.name == p_jax.name == "step-000030010.npz"
    assert sorted(np.load(p_port).files) == sorted(np.load(p_jax).files)
    for loaded in (jckpt.load_scene_npz(p_port), tckpt.load_scene_npz(p_jax)):
        for k in FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(loaded, k)),
                                          np.asarray(getattr(js, k)), err_msg=k)
    tckpt.save_checkpoint(tmp_path / "port", 30020, tckpt.load_scene_npz(p_port))
    assert [p.name for p in (tmp_path / "port").glob("step-*.npz")] == \
        ["step-000030020.npz"]
    arch = tckpt.compress_scene_npz(tmp_path / "port" / "step-000030020.npz",
                                    tmp_path / "port" / "step-000030030.fp16.npz")
    jarch = jckpt.compress_scene_npz(p_jax, tmp_path / "jax" / "a.fp16.npz")
    for k in FIELDS:
        np.testing.assert_array_equal(np.load(arch)[k], np.load(jarch)[k])
    assert tckpt.latest_checkpoint(tmp_path / "port") == arch
    assert tckpt.checkpoint_step(arch) == jckpt.checkpoint_step(arch) == 30030
    assert tckpt.load_scene_npz(arch).means.dtype == torch.float32


@pytest.mark.parametrize("files,latest", [
    # an orbax directory newer than the npz and beside its fp16 archive
    (["step-000000100.npz", "step-000000200.orbax/", "step-000000200.fp16.npz"],
     "step-000000200.orbax"),
    # at equal steps the full-precision npz, then the first listed
    (["step-000000200.npz", "step-000000200.orbax/", "step-000000100.orbax/"],
     "step-000000200.npz"),
])
def test_latest_checkpoint_sees_orbax_as_jax_does(tmp_path, files, latest):
    """Both packages' latest_checkpoint pick the same path across npz files
    and orbax directories; the port's loader raises on an orbax directory,
    naming it."""
    js = _jax_scene(4)
    for name in files:
        if name.endswith("/"):
            (tmp_path / name).mkdir()
        else:
            jckpt.save_pytree(tmp_path / name, js)
    got = tckpt.latest_checkpoint(tmp_path)
    assert got == jckpt.latest_checkpoint(tmp_path) == tmp_path / latest
    orbax = next(tmp_path.glob("step-*.orbax"))
    with pytest.raises(NotImplementedError, match=orbax.name):
        tckpt.load_scene_npz(orbax)


@pytest.mark.parametrize("layout", ["gauss_params", "flat"])
def test_import_splatfacto_ckpt_matches_jax(tmp_path, layout):
    """A `torch.save`d splatfacto state dict (nerfstudio's newer
    `gauss_params.*` names, or the flat 1.0 names with [N] opacities and
    [N, 1, 3] features_dc) imports to the same scene and step."""
    g = torch.Generator().manual_seed(0)
    n = 17
    prefix = "_model.gauss_params." if layout == "gauss_params" else "_model."
    shapes = dict(means=(n, 3), scales=(n, 3), quats=(n, 4),
                  opacities=(n, 1) if layout == "gauss_params" else (n,),
                  features_dc=(n, 3) if layout == "gauss_params" else (n, 1, 3),
                  features_rest=(n, 15, 3))
    state = {prefix + k: torch.randn(s, generator=g) for k, s in shapes.items()}
    state["_model.camera_optimizer.pose_adjustment"] = torch.zeros(3, 6)
    path = tmp_path / "step-000029999.ckpt"
    torch.save({"step": 29999, "pipeline": state}, path)
    ref, ref_step = jckpt.import_splatfacto_ckpt(path)
    got, step = tckpt.import_splatfacto_ckpt(path)
    assert step == ref_step == 29999
    assert got.sh_degree == 3 and got.num_gaussians == n
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    torch.save({"step": 1, "pipeline": {"_model.means": torch.zeros(2, 3)}},
               tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match="missing"):
        tckpt.import_splatfacto_ckpt(tmp_path / "bad.ckpt")


def _nerfstudio_splatfacto_ckpt(path, n=23, step=29999):
    """A checkpoint shaped as nerfstudio's `Trainer.save_checkpoint` writes
    one for splatfacto: `step`, `pipeline` (the pipeline's state dict, an
    OrderedDict with `_model.gauss_params.*` and the other modules'
    tensors), `optimizers` (one Adam `state_dict` per parameter group:
    `state` keyed by int with `step`/`exp_avg`/`exp_avg_sq`, and
    `param_groups` with tuples, bools and None), `schedulers` (their
    state dicts: ints, floats, lists, None) and `scalers` (the GradScaler's
    state dict of Python numbers)."""
    from collections import OrderedDict
    g = torch.Generator().manual_seed(1)
    shapes = dict(means=(n, 3), scales=(n, 3), quats=(n, 4), opacities=(n, 1),
                  features_dc=(n, 3), features_rest=(n, 15, 3))
    params = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    pipeline = OrderedDict()
    for k, v in params.items():
        pipeline["_model.gauss_params." + k] = v
    pipeline["_model.camera_optimizer.pose_adjustment"] = torch.zeros(40, 6)
    pipeline["datamanager.train_camera_optimizer.pose_adjustment"] = \
        torch.zeros(40, 6)
    optimizers, schedulers = {}, {}
    for name, p in params.items():
        optimizers[name] = {
            "state": {0: {"step": torch.tensor(float(step)),
                          "exp_avg": torch.zeros_like(p),
                          "exp_avg_sq": torch.zeros_like(p)}},
            "param_groups": [{"lr": 1.6e-6, "betas": (0.9, 0.999),
                              "eps": 1e-15, "weight_decay": 0,
                              "amsgrad": False, "maximize": False,
                              "foreach": None, "capturable": False,
                              "differentiable": False, "fused": None,
                              "params": [0]}]}
        if name == "means":
            schedulers[name] = {"base_lrs": [1.6e-4], "last_epoch": step,
                                "verbose": False, "_step_count": step + 1,
                                "_get_lr_called_within_step": False,
                                "_last_lr": [1.6e-6], "lr_lambdas": [None]}
    scalers = {"scale": 65536.0, "growth_factor": 2.0, "backoff_factor": 0.5,
               "growth_interval": 2000, "_growth_tracker": 0}
    torch.save({"step": step, "pipeline": pipeline, "optimizers": optimizers,
                "schedulers": schedulers, "scalers": scalers}, path)
    return params


def test_import_nerfstudio_shaped_splatfacto_ckpt(tmp_path):
    """A nerfstudio-shaped splatfacto checkpoint loads under the port's
    `weights_only=True` with no added safe globals, to the scene the JAX
    importer (`weights_only=False`) reads from it."""
    path = tmp_path / "step-000029999.ckpt"
    params = _nerfstudio_splatfacto_ckpt(path)
    torch.load(path, map_location="cpu", weights_only=True)   # no allow-list
    ref, ref_step = jckpt.import_splatfacto_ckpt(path)
    got, step = tckpt.import_splatfacto_ckpt(path)
    assert step == ref_step == 29999
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      params[k].numpy(), err_msg=k)
