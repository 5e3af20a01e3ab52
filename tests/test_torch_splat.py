"""The port's splat path (gaussctrl_tpu_torch.splat) against the JAX package.

Same inputs, made with numpy from a seed, go through both. The JAX blend runs
as its own tests run it on the CPU: the XLA segmented blend and `blend_pallas`
in Pallas interpret mode. Tolerances are stated per test.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.ops.splat_blend import blend_pallas
from gaussctrl_tpu.splat import project as jproject
from gaussctrl_tpu.splat import sh as jsh
from gaussctrl_tpu.splat.render import render_rgbd as j_render_rgbd
from gaussctrl_tpu.splat.scene import random_scene as j_random_scene

from gaussctrl_tpu_torch.ops import splat_blend as tblend
from gaussctrl_tpu_torch.splat import project as tproject
from gaussctrl_tpu_torch.splat import sh as tsh
from gaussctrl_tpu_torch.splat.render import render_rgbd as t_render_rgbd
from gaussctrl_tpu_torch.splat.scene import GaussianScene

# the packages re-export the `rasterize` function under the module's name
jrast = importlib.import_module("gaussctrl_tpu.splat.rasterize")
trast = importlib.import_module("gaussctrl_tpu_torch.splat.rasterize")

torch.set_num_threads(2)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x), dtype=dtype)


def _random_inputs(rng, n, H, W, ch=4):
    """The random splat inputs of tests/test_splat_blend.py, as numpy."""
    xys = rng.uniform(-8, max(H, W) + 8, (n, 2)).astype(np.float32)
    depths = rng.uniform(0.5, 8.0, (n,)).astype(np.float32)
    radii = rng.uniform(2.0, 40.0, (n,)).astype(np.float32)
    L = rng.uniform(0.05, 0.4, (n, 2)).astype(np.float32)
    co = rng.uniform(-0.9, 0.9, (n,)).astype(np.float32)
    conics = np.stack([L[:, 0], co * np.sqrt(L[:, 0] * L[:, 1]), L[:, 1]], -1)
    colors = rng.uniform(0, 1, (n, ch)).astype(np.float32)
    opac = rng.uniform(0.1, 0.95, (n,)).astype(np.float32)
    bg = rng.uniform(0, 1, (ch,)).astype(np.float32)
    return xys, depths, radii, conics.astype(np.float32), colors, opac, bg


def _random_scene_np(rng, n, sh_degree=3):
    k = (sh_degree + 1) ** 2 - 1
    return dict(
        means=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        scales=np.log(rng.uniform(0.005, 0.05, (n, 3))).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.normal(size=(n, 1)).astype(np.float32),
        features_dc=(rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
        features_rest=(rng.normal(size=(n, k, 3)) * 0.05).astype(np.float32))


def _c2w():
    return np.concatenate([np.eye(3), [[0.], [0.], [2.5]]], 1).astype(np.float32)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh_matches_jax(degree):
    """SH colours at every degree; atol 1e-6 (same fp32 arithmetic)."""
    rng = np.random.default_rng(degree)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    coeffs = rng.normal(size=(200, 16, 3)).astype(np.float32)
    ref = jsh.eval_sh(degree, jnp.asarray(dirs), jnp.asarray(coeffs))
    got = tsh.eval_sh(degree, _t(dirs), _t(coeffs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("with_opacity", [True, False])
def test_projection_matches_jax(with_opacity):
    """EWA projection of N=200 gaussians; atol 1e-5 as the slice asks
    (rtol 1e-5 on the conics, whose entries reach 1e3 for thin splats)."""
    rng = np.random.default_rng(11)
    s = _random_scene_np(rng, 200)
    from gaussctrl_tpu.cameras.camera import view_matrix as jview
    from gaussctrl_tpu_torch.cameras.camera import view_matrix as tview
    c2w = _c2w()
    op = 1.0 / (1.0 + np.exp(-s["opacities"][:, 0])) if with_opacity else None
    kw = dict(fx=60.0, fy=60.0, cx=32.0, cy=32.0, width=64, height=64)
    ref = jproject.project_gaussians(
        jnp.asarray(s["means"]), jnp.exp(jnp.asarray(s["scales"])),
        jnp.asarray(s["quats"]), jview(jnp.asarray(c2w)),
        opacities=None if op is None else jnp.asarray(op), **kw)
    got = tproject.project_gaussians(
        _t(s["means"]), torch.exp(_t(s["scales"])), _t(s["quats"]),
        tview(_t(c2w)), opacities=None if op is None else _t(op), **kw)
    for name in ("xys", "depths", "radii", "conics", "cov2d"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("n,H,W,two_class", [
    (60, 64, 128, True),      # the blend tests' random case
    (400, 96, 160, True),     # many gaussians, large-class overflow
    (120, 64, 64, False),     # single-class binning
])
def test_binning_identical(n, H, W, two_class):
    """gauss_idx / starts / ends / slot_idx / n_isect are the same integers."""
    rng = np.random.default_rng(n)
    xys, depths, radii, *_ = _random_inputs(rng, n, H, W)
    kw = {} if two_class else dict(small_tiles_x=16, small_tiles_y=16)
    ntx, nty = (W + 15) // 16, (H + 15) // 16
    ref = jrast._bin_and_sort(jnp.asarray(xys), jnp.asarray(depths),
                              jnp.asarray(radii), ntx, nty,
                              jrast.RasterConfig(**kw))
    got = trast._bin_and_sort(_t(xys), _t(depths), _t(radii), ntx, nty,
                              trast.RasterConfig(**kw))
    for name in ("gauss_idx", "starts", "ends", "slot_idx"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert int(got.n_isect) == int(ref.n_isect)
    assert int(got.ends[-1]) > 0


@pytest.mark.parametrize("n,H,W,two_class", [
    (60, 64, 128, True),
    (400, 96, 160, True),
    (120, 64, 64, False),
])
def test_tile_ranges_cover_the_sorted_buffer(n, H, W, two_class):
    """The binning cases above: the tiles' [starts, ends) ranges tile
    [0, ends[-1]) with no gap and no overlap, inside the sorted buffer, so a
    kernel that writes every row of its tile's range writes every row the
    per-gaussian sum reads."""
    rng = np.random.default_rng(n)
    xys, depths, radii, *_ = _random_inputs(rng, n, H, W)
    kw = {} if two_class else dict(small_tiles_x=16, small_tiles_y=16)
    b = trast._bin_and_sort(_t(xys), _t(depths), _t(radii), (W + 15) // 16,
                            (H + 15) // 16, trast.RasterConfig(**kw))
    starts, ends = b.starts.long(), b.ends.long()
    assert int(starts[0]) == 0
    assert torch.equal(starts[1:], ends[:-1])
    assert bool((ends >= starts).all())
    assert 0 < int(ends[-1]) <= b.gauss_idx.shape[0]


def _blend_both(rng, xys, depths, radii, conics, colors, opac, bg, ntx, nty,
                cfg_kw):
    jcfg = jrast.RasterConfig(**cfg_kw)
    binned = jrast._bin_and_sort(jnp.asarray(xys), jnp.asarray(depths),
                                 jnp.asarray(radii), ntx, nty, jcfg)
    jargs = tuple(jnp.asarray(a) for a in (xys, conics, colors, opac, bg))
    xla = jrast._blend_tiles_cv(ntx, nty, jcfg, binned, *jargs)
    pallas = blend_pallas(ntx, nty, binned.gauss_idx.shape[0], 128, 16, 256,
                          binned, *jargs)
    tb = trast._bin_and_sort(_t(xys), _t(depths), _t(radii), ntx, nty,
                             trast.RasterConfig(**cfg_kw))
    got = tblend.blend(tb.gauss_idx, tb.starts, tb.ends, _t(xys), _t(conics),
                       _t(colors), _t(opac), _t(bg), ntx, nty,
                       cfg_kw["tile_capacity"], cfg_kw["tile_chunk"])
    return xla, pallas, got


@pytest.mark.parametrize("oracle", ["xla", "pallas"])
def test_plain_blend_matches_jax_random(oracle):
    """Random 64×128 case of tests/test_splat_blend.py: rtol/atol 1e-5."""
    rng = np.random.default_rng(7)
    xys, depths, radii, conics, colors, opac, bg = _random_inputs(rng, 60, 64, 128)
    xla, pallas, got = _blend_both(rng, xys, depths, radii, conics, colors,
                                   opac, bg, 8, 4,
                                   dict(tile_capacity=64, tile_chunk=4))
    ref = xla if oracle == "xla" else pallas
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-5)
    assert float(got[1].max()) > 0.2


@pytest.mark.parametrize("oracle", ["xla", "pallas"])
def test_plain_blend_matches_jax_empty_and_deep(oracle):
    """Empty tiles render pure background; one 300-deep tile spans several
    segments. rtol 1e-4 / atol 1e-5, the JAX test's tolerance."""
    rng = np.random.default_rng(7)
    n = 300
    xys = rng.uniform(4, 12, (n, 2)).astype(np.float32)
    depths = rng.uniform(0.5, 8.0, (n,)).astype(np.float32)
    radii = np.full((n,), 3.0, np.float32)
    conics = np.tile(np.asarray([[0.3, 0.0, 0.3]], np.float32), (n, 1))
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    opac = np.full((n,), 0.3, np.float32)
    bg = np.asarray([0.1, 0.9, 0.2, 0.0], np.float32)
    xla, pallas, got = _blend_both(rng, xys, depths, radii, conics, colors,
                                   opac, bg, 2, 2,
                                   dict(tile_capacity=64, tile_chunk=2))
    ref = xla if oracle == "xla" else pallas
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-5)
    empty = got[1].numpy().max(axis=1) == 0.0
    assert empty.any()
    for t in np.nonzero(empty)[0]:
        np.testing.assert_array_equal(got[0][t].numpy(), np.tile(bg, (256, 1)))


@pytest.mark.parametrize("stats", [False, True])
def test_render_rgbd_matches_jax(stats):
    """The test_render_rgbd_routes_pallas scene (200 gaussians, 64×64):
    rgb rtol 1e-4 / atol 1e-5, depth rtol/atol 1e-3, as that test states."""
    jscene = j_random_scene(jax.random.PRNGKey(3), 200)
    scene = GaussianScene.from_numpy(
        {k: np.asarray(getattr(jscene, k)) for k in
         ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")})
    c2w = _c2w()
    kw = dict(fx=60.0, fy=60.0, cx=32.0, cy=32.0, width=64, height=64)
    bg = np.asarray([0.2, 0.3, 0.4], np.float32)
    ref = j_render_rgbd(jscene, jnp.asarray(c2w), background=jnp.asarray(bg),
                        return_stats=stats, **kw)
    got = t_render_rgbd(scene, _t(c2w), background=_t(bg),
                        return_stats=stats, **kw)
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(ref["rgb"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["depth"].numpy(), np.asarray(ref["depth"]),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got["accumulation"].numpy(),
                               np.asarray(ref["accumulation"]),
                               rtol=1e-4, atol=1e-5)
    if stats:
        assert int(got["stats"]["n_isect"]) == int(ref["stats"]["n_isect"])
        assert got["stats"]["isect_budget"] == int(ref["stats"]["isect_budget"])


@pytest.mark.cuda
def test_blend_kernel_matches_plain_on_card():
    """K1 on the card against its plain version (random 64×128 case);
    rtol/atol 1e-5 (same fp32 arithmetic, another product order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the card run is chip_smoke.py")
    rng = np.random.default_rng(7)
    xys, depths, radii, conics, colors, opac, bg = _random_inputs(rng, 60, 64, 128)
    dev = "cuda"
    tb = trast._bin_and_sort(_t(xys).to(dev), _t(depths).to(dev),
                             _t(radii).to(dev), 8, 4, trast.RasterConfig())
    args = [_t(a).to(dev) for a in (xys, conics, colors, opac, bg)]
    got = tblend.blend(tb.gauss_idx, tb.starts, tb.ends, *args, 8, 4)
    ref = tblend.blend_plain(tb.gauss_idx, tb.starts, tb.ends, *args, 8, 4)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
