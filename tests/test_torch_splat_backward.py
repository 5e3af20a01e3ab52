"""The port's blend backward (K4's plain version, `reduce_by_slot`, the
blend's autograd Function) against the JAX package.

The inputs are those of tests/test_splat_blend.py, made with numpy from a
seed. The JAX VJP runs through `_blend_tiles_cv` (the XLA segmented blend
and its replay backward) and through `blend_pallas` in Pallas interpret
mode; the port's plain backward, summed per gaussian by `reduce_by_slot`,
is held to both at rtol 2e-4 and atol 2e-5 of each gradient's largest
magnitude, as tests/test_splat_blend.py holds the two JAX routes.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.ops.splat_blend import blend_pallas

from gaussctrl_tpu_torch.ops import splat_blend as tblend

from test_torch_splat import _random_inputs, _t

jrast = importlib.import_module("gaussctrl_tpu.splat.rasterize")
trast = importlib.import_module("gaussctrl_tpu_torch.splat.rasterize")

torch.set_num_threads(2)

NAMES = ["xys", "conics", "colors", "opacities", "background"]


def _random_case():
    rng = np.random.default_rng(7)
    xys, depths, radii, conics, colors, opac, bg = _random_inputs(rng, 60, 64, 128)
    return (xys, depths, radii, conics, colors, opac, bg, 8, 4,
            dict(tile_capacity=64, tile_chunk=4))


def _deep_case():
    """One 300-deep tile over several segments beside three empty tiles."""
    rng = np.random.default_rng(7)
    n = 300
    xys = rng.uniform(4, 12, (n, 2)).astype(np.float32)
    depths = rng.uniform(0.5, 8.0, (n,)).astype(np.float32)
    radii = np.full((n,), 3.0, np.float32)
    conics = np.tile(np.asarray([[0.3, 0.0, 0.3]], np.float32), (n, 1))
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    opac = np.full((n,), 0.3, np.float32)
    bg = np.asarray([0.1, 0.9, 0.2, 0.0], np.float32)
    return (xys, depths, radii, conics, colors, opac, bg, 2, 2,
            dict(tile_capacity=64, tile_chunk=2))


def _opaque_case():
    """The random case with opacities in [0.985, 0.9999]: near the centres
    α_raw passes 0.999, where α is clamped and its gradient gated off."""
    xys, depths, radii, conics, colors, opac, bg, ntx, nty, kw = _random_case()
    opac = np.random.default_rng(8).uniform(0.985, 0.9999, opac.shape)
    return (xys, depths, radii, conics, colors, opac.astype(np.float32), bg,
            ntx, nty, kw)


def _saturating_case():
    """The deep tile with wide, dense gaussians, alone in its chunk of
    tiles: every pixel saturates in the first 64-instance segment, so the
    blend stops there, before the tile's 300 instances are all blended."""
    xys, depths, radii, conics, colors, opac, bg, ntx, nty, _ = _deep_case()
    conics = np.tile(np.asarray([[0.005, 0.0, 0.005]], np.float32),
                     (xys.shape[0], 1))
    opac = np.full(opac.shape, 0.9, np.float32)
    return (xys, depths, radii, conics, colors, opac, bg, ntx, nty,
            dict(tile_capacity=64, tile_chunk=1))


CASES = {"random": _random_case, "empty_and_deep": _deep_case,
         "opaque": _opaque_case, "saturating": _saturating_case}


def _weights(shape):
    """The uneven tile cotangent of tests/test_splat_blend.py's loss."""
    size = int(np.prod(shape))
    return np.linspace(0.5, 1.5, size, dtype=np.float32).reshape(shape)


def _jax_grads(case, route):
    xys, depths, radii, conics, colors, opac, bg, ntx, nty, kw = case
    cfg = jrast.RasterConfig(**kw)
    binned = jrast._bin_and_sort(jnp.asarray(xys), jnp.asarray(depths),
                                 jnp.asarray(radii), ntx, nty, cfg)

    def fn(*a):
        if route == "xla":
            return jrast._blend_tiles_cv(ntx, nty, cfg, binned, *a)
        return blend_pallas(ntx, nty, binned.gauss_idx.shape[0], 128, 16, 256,
                            binned, *a)

    def loss(*a):
        t, al = fn(*a)
        return (t * jnp.asarray(_weights(t.shape))).sum() + 0.7 * (al * al).sum()

    args = tuple(jnp.asarray(a) for a in (xys, conics, colors, opac, bg))
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)]


def _port_grads(case, through):
    """Gradients of the same loss through the port: `function` is the blend's
    autograd Function (plain backward → reduce_by_slot), `autograd` is torch
    autograd straight through `blend_plain`."""
    xys, depths, radii, conics, colors, opac, bg, ntx, nty, kw = case
    cfg = trast.RasterConfig(**kw)
    b = trast._bin_and_sort(_t(xys), _t(depths), _t(radii), ntx, nty, cfg)
    args = [_t(a).requires_grad_() for a in (xys, conics, colors, opac, bg)]
    if through == "function":
        t, al = trast._Blend.apply(*args, b, ntx, nty, cfg)
    else:
        t, al = tblend.blend_plain(b.gauss_idx, b.starts, b.ends, *args, ntx,
                                   nty, cfg.tile_capacity, cfg.tile_chunk)
    loss = (t * _t(_weights(t.shape))).sum() + 0.7 * (al * al).sum()
    loss.backward()
    return [a.grad.numpy() for a in args]


def _assert_close(got, ref, rtol=2e-4):
    for name, g, r in zip(NAMES, got, ref):
        scale = max(1e-3, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, rtol=rtol, atol=2e-5 * scale,
                                   err_msg=name)
        assert float(np.abs(r).max()) > 0, name


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_matches_jax_vjp(case, route):
    """Plain backward → reduce_by_slot against the JAX VJP of
    `_blend_tiles_cv` and of `blend_pallas` (interpret): rtol 2e-4."""
    c = CASES[case]()
    _assert_close(_port_grads(c, "function"), _jax_grads(c, route))


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_torch_autograd(case):
    """The autograd Function on the CPU against torch autograd straight
    through `blend_plain`: the same function differentiated two ways,
    rtol 2e-4 (the replay forms S_i as Q − prefix, autograd does not)."""
    c = CASES[case]()
    _assert_close(_port_grads(c, "function"), _port_grads(c, "autograd"))


def test_plain_backward_with_n_done_replays_exactly_those_instances():
    """With `n_done` the replays run over each tile's first n_done
    instances whatever the transmittance, which is what K4 does after K1:
    with n_done = the whole list, rows past saturation still carry the
    T_fin term; with n_done = 0 every row is zero and g_bg = Σ go."""
    xys, depths, radii, conics, colors, opac, bg, ntx, nty, kw = _deep_case()
    cfg = trast.RasterConfig(**kw)
    b = trast._bin_and_sort(_t(xys), _t(depths), _t(radii), ntx, nty, cfg)
    args = [_t(a) for a in (xys, conics, colors, opac, bg)]
    go = torch.ones((ntx * nty, 256, 4))
    ga = torch.zeros((ntx * nty, 256))
    full = b.ends - b.starts
    rows, g_bg = tblend.blend_bwd_plain(b.gauss_idx, b.starts, full, *args,
                                        go, ga, ntx, nty, **kw)
    n_used = int(b.ends[-1])
    assert (rows[:n_used].abs().sum(1) > 0).all()
    rows0, g_bg0 = tblend.blend_bwd_plain(
        b.gauss_idx, b.starts, torch.zeros_like(full), *args, go, ga, ntx,
        nty, **kw)
    assert float(rows0.abs().max()) == 0.0
    np.testing.assert_allclose(g_bg0.numpy(), np.full(4, ntx * nty * 256.0))


def test_plain_blend_counts_the_instances_it_blended():
    """`blend(..., return_done=True)` on the CPU returns, per tile, the
    instances the plain blend multiplied in: the whole list where the tile
    never saturates, the first segment (64) where it saturates there; the
    backward over those counts reproduces the forward's T_fin in g_bg."""
    for make, want in ((_deep_case, [300, 0, 0, 0]),
                       (_saturating_case, [64, 0, 0, 0])):
        xys, depths, radii, conics, colors, opac, bg, ntx, nty, kw = make()
        cfg = trast.RasterConfig(**kw)
        b = trast._bin_and_sort(_t(xys), _t(depths), _t(radii), ntx, nty, cfg)
        args = [_t(a) for a in (xys, conics, colors, opac, bg)]
        _, alpha, done = tblend.blend(b.gauss_idx, b.starts, b.ends, *args,
                                      ntx, nty, cfg.tile_capacity,
                                      cfg.tile_chunk, return_done=True)
        assert done.dtype == torch.int32 and done.tolist() == want
        go = torch.ones((ntx * nty, 256, 4))
        _, g_bg = tblend.blend_bwd(b.gauss_idx, b.starts, done, *args, go,
                                   torch.zeros((ntx * nty, 256)), ntx, nty)
        np.testing.assert_allclose(g_bg.numpy(),
                                   np.full(4, float((1 - alpha).sum())),
                                   rtol=1e-6)


def test_reduce_by_slot_matches_jax():
    """The per-gaussian sums are the JAX package's, bit for bit in order:
    random rows over the random case's binning, both classes; atol 1e-6."""
    xys, depths, radii = _random_case()[:3]
    rng = np.random.default_rng(3)
    jcfg, tcfg = jrast.RasterConfig(), trast.RasterConfig()
    n = xys.shape[0]
    jb = jrast._bin_and_sort(jnp.asarray(xys), jnp.asarray(depths),
                             jnp.asarray(radii), 8, 4, jcfg)
    tb = trast._bin_and_sort(_t(xys), _t(depths), _t(radii), 8, 4, tcfg)
    m = tb.gauss_idx.shape[0]
    rows = rng.normal(size=(m, 10)).astype(np.float32)
    valid = np.arange(m) < int(tb.ends[-1])
    ref = jrast.reduce_by_slot(jnp.asarray(rows), jb.slot_idx,
                               jnp.asarray(valid), jb, n, 16, 256)
    got = trast.reduce_by_slot(_t(rows), tb.slot_idx, torch.tensor(valid), tb,
                               n, 16, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # and the sums are those of index_add over the sorted gaussians
    direct = torch.zeros((n, 10)).index_add_(
        0, tb.gauss_idx[torch.tensor(valid)].long(), _t(rows)[torch.tensor(valid)])
    np.testing.assert_allclose(got.numpy(), direct.numpy(), atol=1e-5)


@pytest.mark.cuda
def test_backward_kernel_matches_plain_on_card():
    """K4 on the card against its plain version with the same n_done (from
    K1): rows held per group (xy, conic, colour, opacity) relative to the
    group's largest |value| at 1e-4, g_bg at rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the card run is chip_smoke.py")
    for make in CASES.values():
        xys, depths, radii, conics, colors, opac, bg, ntx, nty, kw = make()
        dev = "cuda"
        b = trast._bin_and_sort(_t(xys).to(dev), _t(depths).to(dev),
                                _t(radii).to(dev), ntx, nty, trast.RasterConfig())
        args = [_t(a).to(dev) for a in (xys, conics, colors, opac, bg)]
        _, _, done = tblend.blend(b.gauss_idx, b.starts, b.ends, *args, ntx,
                                  nty, return_done=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        go = torch.rand((ntx * nty, 256, 4), generator=gen, device=dev)
        ga = torch.rand((ntx * nty, 256), generator=gen, device=dev)
        rows, g_bg = tblend.blend_bwd(b.gauss_idx, b.starts, done, *args,
                                      go, ga, ntx, nty)
        ref, ref_bg = tblend.blend_bwd_plain(b.gauss_idx, b.starts, done,
                                             *args, go, ga, ntx, nty)
        for lo, hi in ((0, 2), (2, 5), (5, 9), (9, 10)):
            scale = float(ref[:, lo:hi].abs().max())
            err = float((rows[:, lo:hi] - ref[:, lo:hi]).abs().max())
            assert err <= 1e-4 * max(scale, 1e-6), (lo, hi, err, scale)
        np.testing.assert_allclose(g_bg.cpu().numpy(), ref_bg.cpu().numpy(),
                                   rtol=1e-5)
