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
import pathlib
import re

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
    T_fin term; with n_done = 0 every row is zero and g_bg = Σ go. (Both
    in the two-replay form, with no forward state.)"""
    xys, depths, radii, conics, colors, opac, bg, ntx, nty, kw = _deep_case()
    cfg = trast.RasterConfig(**kw)
    b = trast._bin_and_sort(_t(xys), _t(depths), _t(radii), ntx, nty, cfg)
    args = [_t(a) for a in (xys, conics, colors, opac, bg)]
    go = torch.ones((ntx * nty, 256, 4))
    ga = torch.zeros((ntx * nty, 256))
    full = b.ends - b.starts
    rec = tblend.pack_records(*args[:4])
    rows, g_bg = tblend.blend_bwd_plain(b.gauss_idx, b.starts, b.ends, full,
                                        rec, None, None, args[4], go, ga,
                                        ntx, nty, **kw)
    n_used = int(b.ends[-1])
    assert (rows[:n_used].abs().sum(1) > 0).all()
    rows0, g_bg0 = tblend.blend_bwd_plain(
        b.gauss_idx, b.starts, b.ends, torch.zeros_like(full), rec, None,
        None, args[4], go, ga, ntx, nty, **kw)
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
        _, alpha, done, *state = tblend.blend(
            b.gauss_idx, b.starts, b.ends, *args, ntx, nty, cfg.tile_capacity,
            cfg.tile_chunk, return_done=True, return_state=True)
        assert done.dtype == torch.int32 and done.tolist() == want
        go = torch.ones((ntx * nty, 256, 4))
        _, g_bg = tblend.blend_bwd(b.gauss_idx, b.starts, b.ends, done,
                                   *state, args[4], go,
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


def _forward_state(case):
    """The case's binning, blend inputs and what the forward hands the
    backward: (binned, args, done, records, acc, t_fin)."""
    xys, depths, radii, conics, colors, opac, bg, ntx, nty, kw = case
    cfg = trast.RasterConfig(**kw)
    b = trast._bin_and_sort(_t(xys), _t(depths), _t(radii), ntx, nty, cfg)
    args = [_t(a) for a in (xys, conics, colors, opac, bg)]
    _, _, done, *state = tblend.blend(b.gauss_idx, b.starts, b.ends, *args,
                                      ntx, nty, cfg.tile_capacity,
                                      cfg.tile_chunk, return_done=True,
                                      return_state=True)
    return b, args, done, state


def _cotangents(ntx, nty, seed=5):
    rng = np.random.default_rng(seed)
    return (_t(rng.uniform(-0.5, 0.5, (ntx * nty, 256, 4))),
            _t(rng.uniform(-0.5, 0.5, (ntx * nty, 256))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_from_forward_state_matches_two_replays(case):
    """One replay that takes Q = g·acc and T_fin from the forward (K4's
    form) gives the rows and g_bg of the two-replay form, in which a first
    replay accumulates them, at the file's rtol 2e-4 and atol 2e-5 of each
    group's largest |value| (S_i = Q − prefix_i cancels, Q is summed in
    another order, and the forward ran on the conics before packing)."""
    c = CASES[case]()
    ntx, nty, kw = c[7], c[8], c[9]
    b, args, done, (rec, acc, t_fin) = _forward_state(c)
    go, ga = _cotangents(ntx, nty)
    one = tblend.blend_bwd_plain(b.gauss_idx, b.starts, b.ends, done, rec,
                                 acc, t_fin, args[4], go, ga, ntx, nty, **kw)
    two = tblend.blend_bwd_plain(b.gauss_idx, b.starts, b.ends, done, rec,
                                 None, None, args[4], go, ga, ntx, nty, **kw)
    for lo, hi in ((0, 2), (2, 5), (5, 9), (9, 10)):
        ref = two[0][:, lo:hi].numpy()
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(one[0][:, lo:hi].numpy(), ref, rtol=2e-4,
                                   atol=2e-5 * np.abs(ref).max())
    np.testing.assert_allclose(one[1].numpy(), two[1].numpy(), rtol=2e-4)


@pytest.mark.parametrize("ch", [3, 4])
def test_records_pack_and_unpack(ch):
    """The 48-byte records hold x, y, the folded conic, the opacity and the
    colours, zero-padded; unpacking gives the separate arrays back: exactly,
    and the conics to one rounding of the fold (rtol 1e-6)."""
    rng = np.random.default_rng(ch)
    xys, _, _, conics, colors, opac, _ = _random_inputs(rng, 50, 64, 64, ch)
    rec = tblend.pack_records(_t(xys), _t(conics), _t(colors), _t(opac))
    assert rec.shape == (50, 12) and rec.dtype == torch.float32
    assert float(rec[:, 6 + ch:].abs().max()) == 0.0
    fold = np.asarray(tblend.CONIC_FOLD, np.float32)
    np.testing.assert_array_equal(rec[:, 2:5].numpy(), conics * fold)
    got = tblend.unpack_records(rec, ch)
    for name, g, want in zip(("xys", "colors", "opacities"),
                             (got[0], got[2], got[3]), (xys, colors, opac)):
        np.testing.assert_array_equal(g.numpy(), want, err_msg=name)
    np.testing.assert_allclose(got[1].numpy(), conics, rtol=1e-6)


@pytest.mark.parametrize("name", ["TILE", "BATCH", "REC_FLOATS"])
def test_layout_constants_match_the_kernels(name):
    """The wrapper's tile size, batch (whole batches are what K1's n_done
    counts) and record width are the ones csrc/splat_blend_common.cuh
    compiles into K1 and K4."""
    src = (pathlib.Path(tblend.__file__).parents[1] / "csrc"
           / "splat_blend_common.cuh").read_text()
    header = {}
    for k, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        header[k] = eval(expr.replace("/", "//"), {}, dict(header))
    want = dict(TILE=header["TS"], BATCH=header["BATCH"],
                REC_FLOATS=4 * header["REC4"])[name]
    assert getattr(tblend, name) == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_reduce_by_slot_ignores_rows_past_the_last_tile(case):
    """K4 leaves the rows at or past ends[-1] unset (the buffer is not
    cleared): with them NaN the per-gaussian sums stay finite and equal."""
    c = CASES[case]()
    ntx, nty, kw = c[7], c[8], c[9]
    b, args, done, state = _forward_state(c)
    go, ga = _cotangents(ntx, nty)
    rows, _ = tblend.blend_bwd_plain(b.gauss_idx, b.starts, b.ends, done,
                                     *state, args[4], go, ga, ntx, nty, **kw)
    used = int(b.ends[-1])
    assert used < rows.shape[0]
    cfg = trast.RasterConfig(**kw)
    valid = torch.arange(rows.shape[0]) < b.ends[-1]

    def reduce(r):
        return trast.reduce_by_slot(
            r, b.slot_idx, valid, b, args[0].shape[0],
            cfg.small_tiles_x * cfg.small_tiles_y,
            cfg.max_tiles_x * cfg.max_tiles_y)

    nan_rows = rows.clone()
    nan_rows[used:] = float("nan")
    ref, got = reduce(rows), reduce(nan_rows)
    assert bool(torch.isfinite(got).all()) and float(ref.abs().max()) > 0
    assert torch.equal(got, ref)


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
        _, _, done, *state = tblend.blend(b.gauss_idx, b.starts, b.ends,
                                          *args, ntx, nty, return_done=True,
                                          return_state=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        go = torch.rand((ntx * nty, 256, 4), generator=gen, device=dev)
        ga = torch.rand((ntx * nty, 256), generator=gen, device=dev)
        bwd = (b.gauss_idx, b.starts, b.ends, done, *state, args[4], go, ga,
               ntx, nty)
        used = int(b.ends[-1])
        rows, g_bg = tblend.blend_bwd(*bwd)
        rows = rows[:used]
        ref, ref_bg = tblend.blend_bwd_plain(*bwd)
        ref = ref[:used]
        for lo, hi in ((0, 2), (2, 5), (5, 9), (9, 10)):
            scale = float(ref[:, lo:hi].abs().max())
            err = float((rows[:, lo:hi] - ref[:, lo:hi]).abs().max())
            assert err <= 1e-4 * max(scale, 1e-6), (lo, hi, err, scale)
        np.testing.assert_allclose(g_bg.cpu().numpy(), ref_bg.cpu().numpy(),
                                   rtol=1e-5)
