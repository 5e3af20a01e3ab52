"""The port's render, stereo, export and trace entry points against the JAX
package's: `python -m gaussctrl_tpu_torch.cli.render --device cpu` and
`python -m gaussctrl_tpu.cli.render` on the same scene checkpoints, the
panorama functions of `cameras.stereo`, `cli.export`, and `cuda_trace`.

Tolerances. Images are uint8 truncations of float renders that agree to
~1e-5, so a value near a step can land one step apart: every written PNG
is within 1/255 of the JAX one on every pixel, and a run's PNGs are equal
on at least 99.9% of their values (99% for the depth images coloured
between their own percentiles, where a plateau at a bound sits on a step;
their floats are held through `depth_npy/`). `depth_npy/` and the float panoramas are held at the
render parity tolerance of tests/test_torch_splat.py (rtol/atol 1e-3 on
depth, rtol 1e-4 / atol 1e-5 on colour). With one injected renderer the
panorama functions are numpy on both sides and agree bit for bit. The
exported PLYs are byte-identical.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaussctrl_tpu.cameras import stereo as jstereo
from gaussctrl_tpu.cli import export as jexport
from gaussctrl_tpu.cli import render as jrender
from gaussctrl_tpu.core.ckpt import save_pytree as j_save_pytree
from gaussctrl_tpu.data.ply import read_point_cloud
from gaussctrl_tpu.splat.scene import GaussianScene as JScene
from gaussctrl_tpu.splat.scene import from_points as j_from_points
from gaussctrl_tpu.splat.scene import random_scene as j_random_scene

from gaussctrl_tpu_torch.cameras import stereo as tstereo
from gaussctrl_tpu_torch.cli import export as texport
from gaussctrl_tpu_torch.cli import render as trender
from gaussctrl_tpu_torch.core.writer import cuda_trace
from gaussctrl_tpu_torch.splat.scene import GaussianScene

from test_torch_cli import scene_dir  # noqa: F401  (fixture)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "data" / "example_scene"
FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")
IDENTITY = np.array([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]])


@pytest.fixture(autouse=True)
def _no_jax_cache(monkeypatch):
    monkeypatch.setenv("GAUSSCTRL_NO_CACHE", "1")


@pytest.fixture(scope="module")
def scenes(scene_dir, tmp_path_factory):  # noqa: F811
    """{name: (data dir, scene npz)}: the 4-view 64×64 synthetic scene with
    its 128-gaussian random scene, and data/example_scene (12 views,
    200×200) with a scene seeded from every 4th of its 2,600 points at
    opacity 0.5."""
    root = tmp_path_factory.mktemp("render_scenes")
    pts, cols = read_point_cloud(EXAMPLE / "points3d.ply")
    j_save_pytree(root / "example.npz", j_from_points(
        pts[::4], cols[::4], sh_degree=1, init_opacity=0.5))
    return {"synthetic": (scene_dir, scene_dir / "scene.npz"),
            "example": (EXAMPLE, root / "example.npz")}


def _camera_path(path, h, w, n, camera_type="perspective", radius=2.0):
    """A nerfstudio camera-path JSON of `n` poses on an orbit."""
    frames = []
    for i in range(n):
        a = 0.4 * i
        pos = np.array([np.sin(a) * radius, 0.3, np.cos(a) * radius])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        m = np.eye(4)
        m[:3, :3] = np.stack([right, np.cross(right, fwd), -fwd], axis=1)
        m[:3, 3] = pos
        frames.append({"camera_to_world": m.reshape(-1).tolist(),
                       "fov": 50.0 + 5 * i})
    path.write_text(json.dumps({"render_height": h, "render_width": w,
                                "camera_type": camera_type, "fps": 12,
                                "camera_path": frames}))
    return str(path)


def _images(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                  if p.suffix in (".png", ".jpeg"))


def assert_images_match(got: Path, ref: Path):
    """Every image within 1/255 of the JAX one on every value; the run's
    images equal on ≥ 99.9% of their values taken together, and its
    percentile-coloured depth images on ≥ 99% of theirs (their bounds are
    the render's own 2nd and 98th percentiles, so a plateau of pixels at
    that depth sits on a step: at 255 in one package, 254 in the other)."""
    names = _images(ref)
    assert names and _images(got) == names
    counts = {}
    for name in names:
        a = np.asarray(Image.open(got / name)).astype(int)
        b = np.asarray(Image.open(ref / name)).astype(int)
        assert a.shape == b.shape, name
        diff = np.abs(a - b)
        assert diff.max() <= 1, name
        c = counts.setdefault(name.startswith("depth/"), [0, 0])
        c[0] += int((diff == 0).sum())
        c[1] += diff.size
    for is_depth, (equal, total) in counts.items():
        assert equal / total >= (0.99 if is_depth else 0.999), (
            is_depth, equal, total)


def _both(tmp_path, argv):
    jrender.main([*argv, "--output-path", str(tmp_path / "jax")])
    trender.main([*argv, "--output-path", str(tmp_path / "torch"),
                  "--device", "cpu"])
    return tmp_path / "torch", tmp_path / "jax"


def _video_frames(path) -> int:
    import cv2
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.mark.parametrize("scene", ["synthetic", "example"])
def test_render_dataset_matches_jax(scenes, scene, tmp_path):
    """`dataset` with rgb, depth and accumulation and --save-depth-npy: on
    the synthetic scene every view with a crop box; on data/example_scene
    --max-views 3 (views 0, 5, 11)."""
    data, ckpt = scenes[scene]
    extra = (["--crop-center", "0.1", "0", "0", "--crop-scale", "0.6", "0.8", "0.8"]
             if scene == "synthetic" else ["--max-views", "3"])
    got, ref = _both(tmp_path, [
        "dataset", "--load-checkpoint", str(ckpt), "--data", str(data),
        "--rendered-output-names", "rgb", "depth", "accumulation",
        "--save-depth-npy", *extra])
    assert_images_match(got, ref)
    n = 4 if scene == "synthetic" else 3
    assert len(list((got / "rgb").glob("*.png"))) == n
    for i in range(n):
        d = np.load(got / "depth_npy" / f"{i:05d}.npy")
        assert d.shape[-1] == 1
        np.testing.assert_allclose(d, np.load(ref / "depth_npy" / f"{i:05d}.npy"),
                                   rtol=1e-3, atol=1e-3)


def test_crop_keeps_the_jax_gaussians(scenes):
    """The crop box keeps the same gaussians, every field indexed."""
    from gaussctrl_tpu.core.ckpt import load_scene_npz as j_load
    from gaussctrl_tpu_torch.core.ckpt import load_scene_npz
    _, ckpt = scenes["synthetic"]
    c, s = [0.1, 0.0, 0.0], [0.6, 0.8, 0.8]
    ref = jrender._crop(j_load(ckpt), c, s)
    got = trender._crop(load_scene_npz(ckpt), c, s)
    assert 0 < got.num_gaussians < 128
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)


@pytest.mark.parametrize("scene", ["synthetic", "example"])
def test_render_camera_path_matches_jax(scenes, scene, tmp_path):
    """`camera-path` of 3 perspective poses at 48×64 (fov 50-60°): rgb and
    depth; on data/example_scene with --side-by-side (the nearest training
    view resized beside each frame)."""
    data, ckpt = scenes[scene]
    path = _camera_path(tmp_path / "path.json", 48, 64, 3,
                        radius=2.5 if scene == "synthetic" else 1.6)
    extra = ["--side-by-side", "--data", str(data)] if scene == "example" else []
    got, ref = _both(tmp_path, [
        "camera-path", "--load-checkpoint", str(ckpt),
        "--camera-path-filename", path, "--rendered-output-names", "rgb",
        "depth", *extra])
    assert_images_match(got, ref)
    first = np.asarray(Image.open(got / "rgb" / "00000.png"))
    assert first.shape == ((48, 128, 3) if scene == "example" else (48, 64, 3))


@pytest.mark.parametrize("camera_type", ["equirectangular",
                                         "omni-directional-stereo", "vr180"])
def test_render_pano_camera_path_matches_jax(scenes, camera_type, tmp_path):
    """`camera-path` with a panoramic camera type on the synthetic scene:
    one 64×32 frame swept in 8 strips (4 for VR180), written as PNG."""
    _, ckpt = scenes["synthetic"]
    path = _camera_path(tmp_path / "path.json", 32, 64, 1, camera_type)
    got, ref = _both(tmp_path, ["camera-path", "--load-checkpoint", str(ckpt),
                                "--camera-path-filename", path,
                                "--pano-strips", "8"])
    assert _images(got) == ["rgb_00000.png"]
    assert_images_match(got, ref)


@pytest.mark.parametrize("scene", ["synthetic", "example"])
def test_render_interpolate_matches_jax(scenes, scene, tmp_path):
    """`interpolate` through the dataset cameras: 2 steps a pair on the
    synthetic scene (6 frames), 1 on data/example_scene (11 frames)."""
    data, ckpt = scenes[scene]
    steps = "2" if scene == "synthetic" else "1"
    got, ref = _both(tmp_path, ["interpolate", "--load-checkpoint", str(ckpt),
                                "--data", str(data),
                                "--interpolation-steps", steps])
    assert_images_match(got, ref)
    assert len(_images(got)) == (6 if scene == "synthetic" else 11)


@pytest.mark.parametrize("scene", ["synthetic", "example"])
def test_render_spiral_matches_jax(scenes, scene, tmp_path):
    """`spiral` about the first camera, 3 frames, as images and, on the
    synthetic scene, as an mp4 (the same frame count in both packages'
    videos)."""
    data, ckpt = scenes[scene]
    argv = ["spiral", "--load-checkpoint", str(ckpt), "--data", str(data),
            "--frames", "3", "--radius", "0.2", "--rendered-output-names",
            "rgb", "accumulation"]
    got, ref = _both(tmp_path, argv)
    assert_images_match(got, ref)
    if scene == "synthetic":
        got, ref = _both(tmp_path / "video", [*argv, "--output-format", "video"])
        for o in ("rgb", "accumulation"):
            assert _video_frames(got / f"{o}.mp4") == \
                _video_frames(ref / f"{o}.mp4") == 3


def test_video_without_cv2_refuses(scenes, tmp_path, monkeypatch):
    """Without OpenCV, --output-format video raises before rendering and
    writes no images in its place."""
    import importlib.util
    data, ckpt = scenes["synthetic"]
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "cv2" else real(name, *a))
    with pytest.raises(RuntimeError, match="cv2"):
        trender.main(["spiral", "--load-checkpoint", str(ckpt), "--data",
                      str(data), "--frames", "2", "--output-format", "video",
                      "--output-path", str(tmp_path / "out"), "--device", "cpu"])
    assert not _images(tmp_path)


def _blob_scenes(positions, colors):
    """One blob scene (radius 0.06, opaque) in both packages' types."""
    n = len(positions)
    arrs = dict(means=np.asarray(positions, np.float32),
                scales=np.log(np.full((n, 3), 0.06, np.float32)),
                quats=np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1)),
                opacities=np.full((n, 1), 8.0, np.float32),
                features_dc=np.asarray(colors, np.float32),
                features_rest=np.zeros((n, 15, 3), np.float32))
    return (JScene(**{k: jnp.asarray(v) for k, v in arrs.items()}),
            GaussianScene.from_numpy(arrs))


RED = [[2.0, -1.0, -1.0]]
PANOS = {"pano": dict(width=128, height=64, strips=16),
         "ods": dict(width=128, height=64, ipd=0.12, strips=16),
         "vr180": dict(width=128, height=64, strips=8)}


def _pano_fn(module, kind):
    return {"pano": module.render_pano, "ods": module.render_ods,
            "vr180": module.render_vr180}[kind]


@pytest.mark.parametrize("kind", list(PANOS))
def test_stereo_with_one_renderer_is_bit_equal(kind):
    """With one injected renderer the camera geometry and the resampling
    are the same numpy on both sides: bit-equal frames."""
    rng = np.random.default_rng(7)
    lut = rng.uniform(size=(4096, 3)).astype(np.float32)

    def render_fn(scene, c2w, fx, fy, cx, cy, w, h):
        # a deterministic image that depends on every camera argument
        key = int(abs(np.asarray(c2w, np.float64).sum() + fx + fy) * 1e3) % 4000
        img = np.resize(lut[key:], (h * w, 3)).reshape(h, w, 3)
        return img * np.float32((cx + cy) / (w + h))

    base = np.array([[0.9, 0.1, 0.0, 0.2], [-0.1, 0.9, 0.1, 0.1],
                     [0.0, -0.1, 1.0, 0.3]])
    kw = PANOS[kind]
    ref = _pano_fn(jstereo, kind)(None, base, background=(0, 0, 0),
                                  render_fn=render_fn, **kw)
    got = _pano_fn(tstereo, kind)(None, base, background=(0, 0, 0),
                                  render_fn=render_fn, **kw)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", list(PANOS))
def test_stereo_with_each_renderer_matches_jax(kind):
    """Each package's own renderer (the port's on the CPU) on a random scene
    around the camera: the frames agree at render tolerance."""
    s = j_random_scene(jax.random.PRNGKey(3), 300, sh_degree=3, extent=1.5)
    arrs = {k: np.asarray(getattr(s, k)) for k in FIELDS}
    tscene = GaussianScene.from_numpy(arrs)
    kw = PANOS[kind]
    ref = _pano_fn(jstereo, kind)(s, IDENTITY, background=(0.1, 0.2, 0.3), **kw)
    got = _pano_fn(tstereo, kind)(tscene, IDENTITY,
                                  background=(0.1, 0.2, 0.3), **kw)
    assert got.shape == ref.shape == (64, 128, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_mono_pano_places_azimuth_correctly():
    """A blob at world +x (azimuth +90°) lands at 3/4 of the panorama's
    width, a blob straight ahead (-z) at the centre column."""
    _, scene = _blob_scenes([[2.0, 0.0, 0.0], [0.0, 0.0, -2.0]],
                            [[2.0, -1.0, -1.0], [-1.0, 2.0, -1.0]])
    W, H = 128, 64
    pano = tstereo.render_pano(scene, IDENTITY, W, H, (0.0, 0.0, 0.0),
                               strips=16)
    assert pano.shape == (H, W, 3)
    mid = H // 2
    assert abs(int(np.argmax(pano[mid, :, 0])) - int(0.75 * W)) <= 2
    assert abs(int(np.argmax(pano[mid, :, 1])) - W // 2) <= 2


def test_ods_parallax_shifts_eyes_apart():
    """A near object appears at opposite azimuth shifts in the two ODS eyes,
    a far one at nearly the same azimuth."""
    _, near = _blob_scenes([[0.0, 0.0, -0.45]], RED)
    W, H = 128, 64
    frame = tstereo.render_ods(near, IDENTITY, W, H, (0, 0, 0), ipd=0.12,
                               strips=16)
    assert frame.shape == (H, W, 3)
    top, bottom = frame[: H // 2], frame[H // 2:]
    row = H // 4
    # the left eye sits left of the view axis: the object appears right
    assert int(np.argmax(top[row, :, 0])) > W // 2 + 1
    assert int(np.argmax(bottom[row, :, 0])) < W // 2 - 1
    _, far = _blob_scenes([[0.0, 0.0, -30.0]], RED)
    frame = tstereo.render_ods(far, IDENTITY, W, H, (0, 0, 0), ipd=0.12,
                               strips=16)
    l_col = int(np.argmax(frame[row, :, 0]))
    r_col = int(np.argmax(frame[H // 2 + row, :, 0]))
    assert abs(l_col - r_col) <= 1, (l_col, r_col)


def test_vr180_layout_and_field():
    """VR180 is left|right 180° halves; a forward blob shows at the centre of
    each half, and one behind the camera nowhere."""
    _, scene = _blob_scenes([[0.0, 0.0, -2.0]], RED)
    W, H = 128, 64
    frame = tstereo.render_vr180(scene, IDENTITY, W, H, (0, 0, 0), strips=8)
    assert frame.shape == (H, W, 3)
    mid = H // 2
    left, right = frame[:, : W // 2], frame[:, W // 2:]
    assert abs(int(np.argmax(left[mid, :, 0])) - W // 4) <= 2
    assert abs(int(np.argmax(right[mid, :, 0])) - W // 4) <= 2
    _, behind = _blob_scenes([[0.0, 0.0, 2.0]], RED)
    frame = tstereo.render_vr180(behind, IDENTITY, W, H, (0, 0, 0), strips=8)
    assert frame.max() < 0.05


def test_pano_pitch_above_camera_lands_in_top_half():
    """A blob above and ahead of the camera lands in the top half (the
    y-down view flips the sign of the pitch term in the resampling)."""
    _, scene = _blob_scenes([[0.0, 1.5, -2.0]], RED)
    pano = tstereo.render_pano(scene, IDENTITY, 128, 64, (0.0, 0.0, 0.0),
                               strips=16)
    ys, _ = np.nonzero(pano[..., 0] > 0.3)
    assert ys.size > 0
    assert ys.mean() < 64 / 2 - 2, ys.mean()


@pytest.mark.parametrize("source", ["npz", "ply", "ckpt"])
@pytest.mark.parametrize("fmt", ["gaussian-splat", "point-cloud"])
def test_export_bytes_match_jax(source, fmt, tmp_path):
    """Both CLIs export the same checkpoint (npz, an INRIA .ply, the
    nerfstudio-shaped splatfacto .ckpt of tests/test_torch_data.py) to
    byte-identical PLYs, and the port reads its gaussian-splat export back
    bit for bit."""
    from gaussctrl_tpu_torch.data.ply import read_gaussian_ply, write_gaussian_ply
    from test_torch_data import _nerfstudio_splatfacto_ckpt
    rng = np.random.default_rng(11)
    n = 200
    arrs = dict(means=rng.normal(size=(n, 3)), scales=rng.normal(size=(n, 3)) - 3,
                quats=rng.normal(size=(n, 4)), opacities=rng.normal(size=(n, 1)) * 3,
                features_dc=rng.normal(size=(n, 3)),
                features_rest=rng.normal(size=(n, 15, 3)) * 0.1)
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    src = tmp_path / f"scene.{source}"
    if source == "npz":
        np.savez(src, **arrs)
    elif source == "ply":
        write_gaussian_ply(src, GaussianScene.from_numpy(arrs))
    else:
        _nerfstudio_splatfacto_ckpt(src)
    jexport.main(["--load-checkpoint", str(src), "--output",
                  str(tmp_path / "jax.ply"), "--format", fmt])
    texport.main(["--load-checkpoint", str(src), "--output",
                  str(tmp_path / "torch.ply"), "--format", fmt,
                  "--device", "cpu"])
    got = (tmp_path / "torch.ply").read_bytes()
    assert got == (tmp_path / "jax.ply").read_bytes()
    if fmt == "gaussian-splat":
        scene = trender._load_scene(str(src))
        back = read_gaussian_ply(tmp_path / "torch.ply")
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(back, k).numpy(),
                                          getattr(scene, k).numpy(), err_msg=k)


def test_cuda_trace_writes_a_trace_on_cpu(tmp_path):
    """On the CPU the trace context writes one Chrome trace of the block's
    operators; disabled, it traces nothing and writes nothing."""
    with cuda_trace(str(tmp_path / "on")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    assert prof is not None
    (trace,) = list((tmp_path / "on").glob("*.json"))
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert "aten::mm" in names
    with cuda_trace(str(tmp_path / "off"), enabled=False) as prof:
        torch.randn(8, 8).sum()
    assert prof is None and not (tmp_path / "off").exists()


def test_camera_helpers_match_jax():
    """`projection_matrix` (rtol 1e-6: the tangents of two float32 libms)
    and `fov` (exact) against the JAX package's."""
    from gaussctrl_tpu.cameras import camera as jcam
    from gaussctrl_tpu_torch.cameras import fov, make_cameras, projection_matrix
    for args in [(0.01, 1e10, 0.9, 0.7), (0.1, 100.0, 1.2, 0.3)]:
        np.testing.assert_allclose(projection_matrix(*args).numpy(),
                                   np.asarray(jcam.projection_matrix(*args)),
                                   rtol=1e-6)
    c2w = np.tile(np.eye(4)[:3], (3, 1, 1)).astype(np.float32)
    ref = jcam.fov(jcam.make_cameras(c2w, [100, 110, 120], 90, 32, 24, 64, 48))
    got = fov(make_cameras(c2w, [100, 110, 120], 90, 32, 24, 64, 48))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
