"""Card-only tests of the splat-blend kernels K1 (`blend`) and K4
(`blend_bwd`) and the attention kernels K2 (`flash_attention_t`), K3
(`cross_view_attention`), K5 (`attention_full`) and K6 (`attention_stream`)
against their plain versions; and of the segmentation stack (SAM, the CLIP
heatmap, GroundingDINO, the deformable sampling) on the card against the
CPU.

This file imports no JAX, so it runs on a machine with the card and
PyTorch alone: `python -m pytest -m cuda tests/test_torch_card.py`. Without
a card every test skips; chip_smoke.py makes the same comparisons at the
main path's shapes.
"""

import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

from gaussctrl_tpu_torch.ops import _lib
from gaussctrl_tpu_torch.ops import flash_attention as fa
from gaussctrl_tpu_torch.ops import launch_counts
from gaussctrl_tpu_torch.ops import splat_blend as sb


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_q).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the card run is chip_smoke.py")
    return "cuda"


def _assert_close_to_plain(got, ref):
    """bf16 outputs against the plain version, relative to the output's
    values (as for K2/K3 in test_torch_attention.py): the largest error
    within 2e-2 of the largest |value|, and a relative RMS error within
    1e-2."""
    diff = got.float() - ref.float()
    ref = ref.float()
    assert diff.abs().max().item() <= 2e-2 * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["full", "stream"])
@pytest.mark.parametrize("b,tq,tk,c,heads", [
    (16, 4096, 77, 320, 8),    # text cross-attention, 4096 level
    (2, 512, 64, 1280, 8),     # composed references, 64 level
    (2, 100, 100, 320, 8),     # tails
])
def test_std_kernels_match_plain_on_card(b, tq, tk, c, heads, kernel):
    """K5/K6 on the card against their plain versions, bf16, held relative
    to the output's values as K2/K3 are."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((b, tq, c), (b, tk, c), 37))
    if kernel == "full":
        _assert_close_to_plain(fa.attention_full(q, k, v, heads),
                               fa.attention_plain(q, k, v, heads))
    else:
        _assert_close_to_plain(fa.attention_stream(q, k, v, heads),
                               fa.attention_stream_plain(q, k, v, heads))


@pytest.mark.cuda
def test_std_kernels_read_strided_references_on_card():
    """K5/K6 read one reference of a [G, F, T, C] tensor in place, as the
    grouped reference attention hands it over."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 4 * 64, 320), (2, 4, 64, 320), 41))
    for kernel, plain in ((fa.attention_full, fa.attention_plain),
                          (fa.attention_stream, fa.attention_stream_plain)):
        _assert_close_to_plain(kernel(q, k[:, 1], v[:, 1], 8),
                               plain(q, k[:, 1].contiguous(),
                                     v[:, 1].contiguous(), 8))


@pytest.mark.cuda
def test_stream_kernel_vae_width_on_card():
    """K6 at the SD VAE's mid-block width (one head of 512), bf16."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 1024, 512), (2, 1024, 512), 39))
    before = launch_counts["attention_stream"]
    _assert_close_to_plain(fa.attention_stream(q, k, v, 1),
                           fa.attention_stream_plain(q, k, v, 1))
    assert launch_counts["attention_stream"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("t", [64, 100, 200, 1024])
@pytest.mark.parametrize("d", [16, 32, 40, 80, 160])
def test_flash_kernel_widths_match_plain_on_card(d, t):
    """K2 (the TMA/wgmma core) at every head width it is built for, 8 heads,
    with query and key tails (T = 100, 200) and a half-empty 128-row block
    (T = 64), against attention_plain, bf16."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, t, 8 * d), (2, t, 8 * d), 43 + d + t))
    before = launch_counts["flash_attention_t"]
    _assert_close_to_plain(fa.flash_attention_t(q, k, v, 8),
                           fa.attention_plain(q, k, v, 8))
    assert launch_counts["flash_attention_t"] == before + 1


@pytest.mark.cuda
def test_flash_kernel_4096_tokens_on_card():
    """K2 at the inversion's largest level: B = 2, T = 4096, 8 heads of 40."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 4096, 320), (2, 4096, 320), 47))
    _assert_close_to_plain(fa.flash_attention_t(q, k, v, 8),
                           fa.attention_plain(q, k, v, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [100, 4096])
def test_stream_kernel_wide_matches_plain_on_card(t):
    """K6's wide variant (one head of 512, the VAE mid-block) with a tail
    (T = 100) and at the VAE's 4096 tokens."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, t, 512), (2, t, 512), 53 + t))
    _assert_close_to_plain(fa.attention_stream(q, k, v, 1),
                           fa.attention_stream_plain(q, k, v, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [100, 256])
def test_stream_kernel_strided_references_tq_ne_tk_on_card(t):
    """K6 on the core at width 40 with Tq = 4·T queries against one
    reference's T keys, read in place from a [G, F, T, C] tensor."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 4 * t, 320), (2, 4, t, 320), 59 + t))
    before = launch_counts["attention_stream"]
    _assert_close_to_plain(fa.attention_stream(q, k[:, 2], v[:, 2], 8),
                           fa.attention_stream_plain(q, k[:, 2].contiguous(),
                                                     v[:, 2].contiguous(), 8))
    assert launch_counts["attention_stream"] == before + 1


# (G, F, r, c): CFG-doubled with the edit's four references and the UNet's
# c, the same with the ControlNet's c = 0, and one group with one reference
# under either c
_XVIEW_CASES = [(2, 5, 4, 0.6), (2, 5, 4, 0.0), (1, 3, 1, 0.6), (1, 3, 1, 0.0)]


def _check_cross_view(d, t, g, f, r, coeff, seed):
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((g * f, t, 8 * d), (g * f, t, 8 * d), seed))
    before = launch_counts["cross_view_attention"]
    _assert_close_to_plain(fa.cross_view_attention(q, k, v, 8, r, coeff, g),
                           fa.cross_view_attention_plain(q, k, v, 8, r, coeff, g))
    assert launch_counts["cross_view_attention"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("g,f,r,coeff", _XVIEW_CASES)
@pytest.mark.parametrize("t", [64, 100, 256, 1024])
@pytest.mark.parametrize("d", [16, 32, 40, 80, 160])
def test_cross_view_kernel_widths_match_plain_on_card(d, t, g, f, r, coeff):
    """K3 at every head width it is built for, 8 heads, with a query and key
    tail (T = 100), against cross_view_attention_plain, bf16."""
    _check_cross_view(d, t, g, f, r, coeff, 61 + d + t)


@pytest.mark.cuda
@pytest.mark.parametrize("g,f,r,coeff", _XVIEW_CASES)
def test_cross_view_kernel_4096_tokens_on_card(g, f, r, coeff):
    """K3 at the edit's largest level: T = 4096, 8 heads of 40."""
    _check_cross_view(40, 4096, g, f, r, coeff, 67)


@pytest.mark.cuda
@pytest.mark.parametrize("tk", [1, 16, 64, 77, 100, fa.FULL_MAX_KEYS])
@pytest.mark.parametrize("d", [16, 40, 80, 160])
def test_full_kernel_key_counts_match_plain_on_card(d, tk):
    """K5 at key counts up to its one key tile (the padded and masked key
    tail), 8 heads, 300 queries (a query tail), k and v strided references
    of a [G, F, Tk, C] tensor, against attention_plain, bf16."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 300, 8 * d), (2, 3, tk, 8 * d), 71 + d + tk))
    before = launch_counts["attention_full"]
    _assert_close_to_plain(fa.attention_full(q, k[:, 1], v[:, 1], 8),
                           fa.attention_plain(q, k[:, 1].contiguous(),
                                              v[:, 1].contiguous(), 8))
    assert launch_counts["attention_full"] == before + 1


@pytest.mark.cuda
def test_full_kernel_refuses_keys_past_one_tile_on_card():
    """K5 raises for more keys than one key tile, launching nothing; auto
    dispatch sends such a call to K6."""
    dev = _card()
    tk = fa.FULL_MAX_KEYS + 1
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 64, 320), (2, tk, 320), 73))
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="key tile"):
        fa.attention_full(q, k, v, 8)
    assert launch_counts == before
    _assert_close_to_plain(fa.flash_attention(q, k, v, 8),
                           fa.attention_stream_plain(q, k, v, 8))
    assert launch_counts["attention_stream"] == before["attention_stream"] + 1


# ---------------------------------------------------------------------------
# K1 and K4: the splat blend and its backward
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic_view(ch, dev):
    """A 2×2-tile view (32×32 pixels) with one tile of each kind: 0 empty,
    1 a single instance, 2 a list of 1,000 near-opaque instances (opacity
    0.99-0.9999, so α_raw passes the 0.999 gate) that saturates in its first
    batch, so n_done ends mid-list, 3 6,000 faint instances (deeper than
    5,000; it never saturates). The gaussians are stored shuffled, so the
    lists gather. Returns `blend`'s arguments and the expected n_done."""
    rng = np.random.default_rng(ch)
    counts, origins = [0, 1, 1000, 6000], [(0, 0), (16, 0), (0, 16), (16, 16)]
    # (placement range in the tile, opacities): the deep tile's are just
    # above 1/255 at their centres, so that its corners never saturate
    kinds = [None, ((2, 14), (0.8, 0.8)), ((2, 14), (0.99, 0.9999)),
             ((4, 12), (0.004, 0.008))]
    xys, conics, opac = [], [], []
    for n, (ox, oy), kind in zip(counts, origins, kinds):
        if not n:
            continue
        (lo, hi), o = kind
        xys.append(rng.uniform(lo, hi, (n, 2)) + (ox, oy))
        var = rng.uniform(4.0, 40.0, (n, 2))
        rho = rng.uniform(-0.6, 0.6, n)
        det = var[:, 0] * var[:, 1] * (1 - rho**2)
        cov_xy = rho * np.sqrt(var[:, 0] * var[:, 1])
        conics.append(np.stack([var[:, 1] / det, -cov_xy / det,
                                var[:, 0] / det], -1))
        opac.append(rng.uniform(*o, n))
    total = sum(counts)
    perm = rng.permutation(total)             # list position -> gaussian
    inv = np.argsort(perm)
    as_t = lambda x: torch.tensor(np.asarray(x, np.float32), device=dev)
    xys, conics, opac = (np.concatenate(x)[inv] for x in (xys, conics, opac))
    colors = rng.uniform(0, 1, (total, ch))
    ends = np.cumsum(counts)
    gidx = np.zeros(total + 64, np.int32)     # a budget past the last tile
    gidx[:total] = perm
    i32 = lambda x: torch.tensor(np.asarray(x, np.int32), device=dev)
    args = (i32(gidx), i32(ends - counts), i32(ends), as_t(xys), as_t(conics),
            as_t(colors), as_t(opac), as_t(rng.uniform(0, 1, ch)), 2, 2)
    return args, [0, 1, sb.BATCH, 6000]


def _check_blend_kernels(args):
    """K1 and K4 on the card against their plain versions on the same
    inputs: K1's tiles and alpha within 1e-3 absolute (chip_smoke's K1
    tolerance: the same fp32 function, with ex2.approx and the product in
    another order), its records bit for bit; K4's rows over [0, ends[-1])
    per group (xy, conic, colour, opacity) and g_bg within 1e-3 of the
    group's largest |value| (chip_smoke's K4_SCALED_TOL), bit-identical over
    two calls, zero past each tile's n_done. Returns n_done."""
    gidx, starts, ends = args[:3]
    ntx, nty = args[-2:]
    ch = args[5].shape[1]
    before = dict(launch_counts)
    tiles, alpha, done, rec, acc, t_fin = sb.blend(
        *args, return_done=True, return_state=True)
    ref_tiles, ref_alpha = sb.blend_plain(*args)
    assert float((tiles - ref_tiles).abs().max()) <= 1e-3
    assert float((alpha - ref_alpha).abs().max()) <= 1e-3
    assert torch.equal(rec, sb.pack_records(*args[3:7]))
    assert torch.equal(tiles, torch.addcmul(acc, t_fin[:, :, None],
                                            args[7][None, None, :]))
    gen = torch.Generator(device=tiles.device).manual_seed(4)
    go = torch.rand(tiles.shape, generator=gen, device=tiles.device) - 0.5
    ga = torch.rand(alpha.shape, generator=gen, device=tiles.device) - 0.5
    bwd = (gidx, starts, ends, done, rec, acc, t_fin, args[7], go, ga, ntx, nty)
    used = int(ends[-1])
    rows, g_bg = sb.blend_bwd(*bwd)
    rows2, g_bg2 = sb.blend_bwd(*bwd)
    ref_rows, ref_bg = sb.blend_bwd_plain(*bwd)
    assert launch_counts["splat_blend_fwd"] == before["splat_blend_fwd"] + 1
    assert launch_counts["splat_blend_bwd"] == before["splat_blend_bwd"] + 2
    rows, rows2, ref_rows = rows[:used], rows2[:used], ref_rows[:used]
    assert torch.equal(rows, rows2) and torch.equal(g_bg, g_bg2)
    for lo, hi in ((0, 2), (2, 5), (5, 5 + ch), (5 + ch, 6 + ch)):
        scale = float(ref_rows[:, lo:hi].abs().max())
        err = float((rows[:, lo:hi] - ref_rows[:, lo:hi]).abs().max())
        assert err <= 1e-3 * scale, (lo, hi, err, scale)
    assert float((g_bg - ref_bg).abs().max()) <= 1e-3 * float(ref_bg.abs().max())
    for t in range(ntx * nty):
        lo, hi = int(starts[t]) + int(done[t]), int(ends[t])
        assert float(rows[lo:hi].abs().sum()) == 0.0
    return done.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("ch,shift", [(4, 0.0), (3, 0.0), (4, 6.0), (3, 6.0)])
def test_blend_kernels_match_plain_on_smoke_view_on_card(ch, shift):
    """K1 and K4 on view 0 of chip_smoke.py's 200,000-gaussian scene at
    512×512, at ch 3 and 4, and near-opaque (opacity logits shifted by 6,
    where α_raw passes the 0.999 gate)."""
    dev = _card()
    cs = _chip_smoke()
    scene = cs.smoke_scene(200_000, dev)
    args, _ = cs.splat_inputs(scene, cs.orbit_cameras(1, 512, dev), ch, shift)
    done = _check_blend_kernels(args)
    assert max(done) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ch", [3, 4])
def test_blend_kernels_match_plain_on_tile_kinds_on_card(ch):
    """K1 and K4 on an empty tile, a one-instance tile, a tile that
    saturates mid-list and a tile deeper than 5,000 instances; K1 blends
    exactly the whole batches it needs."""
    args, want_done = _synthetic_view(ch, _card())
    assert _check_blend_kernels(args) == want_done


@pytest.mark.cuda
def test_blend_bwd_writes_every_row_of_the_tiles_on_card():
    """K4 writes every row of [0, ends[-1]), zeros past n_done included,
    and no row past it: the buffer needs no clearing."""
    args, _ = _synthetic_view(4, _card())
    gidx, starts, ends = args[:3]
    tiles, alpha, done, rec, acc, t_fin = sb.blend(
        *args, return_done=True, return_state=True)
    go, ga = torch.ones_like(tiles), torch.ones_like(alpha)
    rows = torch.full((gidx.shape[0], 10), float("nan"), device=tiles.device)
    err = _lib.library().gc_splat_blend_bwd(
        gidx.data_ptr(), starts.data_ptr(), ends.data_ptr(), done.data_ptr(),
        rec.data_ptr(), acc.data_ptr(), t_fin.data_ptr(), go.data_ptr(),
        ga.data_ptr(), args[7].data_ptr(), rows.data_ptr(), 4, 2, 4,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _lib.check(err, "splat_blend_bwd")
    torch.cuda.synchronize()
    used = int(ends[-1])
    assert bool(torch.isfinite(rows[:used]).all())
    assert bool(torch.isnan(rows[used:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("size", [128, 512])
def test_k4_xy_rows_and_densify_decisions_on_a_pretraining_scene_on_card(size):
    """A pre-training-like scene (40,000 kNN-sized grey seeds from
    `from_points` among the smoke scene's means, at opacity 0.1) against a
    target view: the gradient with respect to `xys_shift` through K4
    against the same through K4's plain version (on K1's same forward),
    within chip_smoke's K4_SCALED_TOL of its largest magnitude, and the
    densify candidates of one accumulated step agreeing outside
    ±DECISION_BAND of grad_thresh."""
    import importlib
    dev = _card()
    cs = _chip_smoke()
    from gaussctrl_tpu_torch.splat import densify as dn
    from gaussctrl_tpu_torch.splat.render import render_rgbd
    from gaussctrl_tpu_torch.splat.scene import from_points
    from gaussctrl_tpu_torch.splat.trainer import splat_loss
    rast = importlib.import_module("gaussctrl_tpu_torch.splat.rasterize")
    gt_scene = cs.smoke_scene(200_000, dev)
    cams = cs.orbit_cameras(2, size, dev)
    with torch.no_grad():
        target = render_rgbd(gt_scene, cams.c2w[1], cams.fx[1], cams.fy[1],
                             cams.cx[1], cams.cy[1], size, size,
                             torch.zeros(3, device=dev))["rgb"]
    pts = gt_scene.means[:40_000].cpu().numpy()
    scene = from_points(pts, np.full_like(pts, 0.5), 3, device=dev)
    grads, state = [], None
    for bwd in (sb.blend_bwd, sb.blend_bwd_plain):
        shift = torch.zeros((scene.num_gaussians, 2), device=dev,
                            requires_grad=True)
        saved = rast.blend_bwd
        rast.blend_bwd = bwd
        try:
            out = render_rgbd(scene, cams.c2w[0], cams.fx[0], cams.fy[0],
                              cams.cx[0], cams.cy[0], size, size,
                              torch.full((3,), 0.3, device=dev),
                              xys_shift=shift)
            splat_loss(out["rgb"], target)[0].backward()
        finally:
            rast.blend_bwd = saved
        grads.append(shift.grad)
        state = out["radii"]
    g_k, g_p = grads
    assert (g_k - g_p).abs().max() <= cs.K4_SCALED_TOL * g_p.abs().max()
    alive = torch.ones(scene.num_gaussians, dtype=torch.bool, device=dev)
    fresh = dn.init_state(scene, scene.num_gaussians)[1]
    stats = [dn.accumulate(fresh, g, state > 0, size, size, state).avg_grad()
             for g in (g_k, g_p)]
    rec = cs.densify_agreement(*stats, alive, dn.DensifyConfig().grad_thresh,
                               cs.DECISION_BAND)
    assert rec["candidates"] > 0 and rec["disagree_outside"] == 0, rec


@pytest.mark.cuda
def test_blend_kernels_match_plain_on_an_equirect_strip_on_card():
    """K1 and K4 on the strip of a 1024×512 equirectangular frame (32
    strips: a 45×1532 pinhole, 3×96 tiles) of the smoke scene, the shape
    every strip of `render_pano` gives K1 there."""
    from gaussctrl_tpu_torch.cameras import stereo
    from gaussctrl_tpu_torch.cameras.camera import make_cameras
    dev = _card()
    cs = _chip_smoke()
    fx, fy, w, h = stereo.strip_size(1024, 512)
    assert (w, h) == (45, 1532)
    c2w = stereo._strip_camera(np.eye(4)[:3] + [[0, 0, 0, 0], [0, 0, 0, 0],
                                                [0, 0, 0, 3.5]],
                               0.1, 0.0, 0.063)
    cams = make_cameras(c2w[None], fx, fy, w / 2, h / 2, w, h, dev)
    args, _ = cs.splat_inputs(cs.smoke_scene(200_000, dev), cams)
    assert args[-2:] == (3, 96)
    assert max(_check_blend_kernels(args)) > 0


@pytest.mark.cuda
def test_k1_matches_plain_on_every_view_of_the_example_scene_on_card():
    """K1 against its plain version on each of data/example_scene's 12
    views (200×200, partial tiles) of a scene seeded from its points, as
    `cli.render dataset` renders them: within chip_smoke's K1_TOL."""
    from gaussctrl_tpu_torch.data.datamanager import (DataManager,
                                                      DataManagerConfig)
    from gaussctrl_tpu_torch.data.ply import read_point_cloud
    from gaussctrl_tpu_torch.splat.scene import from_points
    dev = _card()
    cs = _chip_smoke()
    data = os.path.join(os.path.dirname(__file__), "..", "data",
                        "example_scene")
    cfg = DataManagerConfig(load_all=True)
    cfg.dataparser.data = data
    cams = DataManager(cfg).cameras.to(dev)
    pts, cols = read_point_cloud(os.path.join(data, "points3d.ply"))
    scene = from_points(pts, cols, 3, init_opacity=0.5, device=dev)
    assert len(cams) == 12
    for i in range(len(cams)):
        args, _ = cs.splat_inputs(scene, cams[i:i + 1])
        tiles, alpha = sb.blend(*args)
        ref_tiles, ref_alpha = sb.blend_plain(*args)
        assert float((tiles - ref_tiles).abs().max()) <= cs.K1_TOL, i
        assert float((alpha - ref_alpha).abs().max()) <= cs.K1_TOL, i


@pytest.mark.cuda
def test_library_first_load_from_two_threads_on_card(tmp_path, monkeypatch):
    """Two threads that ask for the kernel library at once, with nothing
    built: one nvcc build, one library, both threads get it."""
    import threading
    _card()
    monkeypatch.setattr(_lib, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_lib, "_lib", None)
    go = threading.Barrier(2)
    got = [None, None]

    def load(i):
        go.wait(timeout=60)
        got[i] = _lib.library()

    threads = [threading.Thread(target=load, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    assert got[0] is not None and got[0] is got[1]
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(_lib.library_path())]


# ---------------------------------------------------------------------------
# the segmentation stack (plain PyTorch, float32 with TF32 off): the card
# against the CPU at tiny configs, one set of random weights on both
# ---------------------------------------------------------------------------

SEG_REL_TOL = 1e-4


def _seg_close(got, ref):
    """float32 on both sides: within 1e-4 of the largest |value|."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= \
        SEG_REL_TOL * max(1.0, ref.abs().max().item())


def _both(module):
    import copy
    return module, copy.deepcopy(module).to("cuda")


@pytest.mark.cuda
def test_sam_card_matches_cpu():
    """SAM encode, mask logits and IoU of three box prompts."""
    _card()
    from gaussctrl_tpu_torch.seg.sam import SAM, SAMConfig
    cpu, card = _both(SAM.create(SAMConfig.tiny(), seed=1))
    img = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    boxes = torch.tensor([[4., 4., 40., 40.], [0., 0., 60., 60.],
                          [30., 20., 62., 50.]])
    emb = cpu.encode(img)
    _seg_close(card.encode(img.cuda()), emb)
    m, iou = cpu.predict_boxes(emb, boxes)
    cm, ciou = card.predict_boxes(emb.cuda(), boxes.cuda())
    _seg_close(cm, m)
    _seg_close(ciou, iou)


@pytest.mark.cuda
def test_clip_heatmap_card_matches_cpu():
    """The CLIP proposer's patch/text heatmap and its boxes."""
    _card()
    from gaussctrl_tpu_torch.diffusion.clip import CLIPVisionConfig, HashTokenizer
    from gaussctrl_tpu_torch.diffusion.config import CLIPTextConfig
    from gaussctrl_tpu_torch.seg.grounding import ClipBoxProposer, random_clip
    tcfg = CLIPTextConfig.tiny()
    cpu, card = _both(random_clip(CLIPVisionConfig.tiny(), tcfg, 2))
    tok = HashTokenizer(tcfg.vocab_size, tcfg.max_position_embeddings)
    pc, pg = ClipBoxProposer(cpu, tok, min_score=-1.0), \
        ClipBoxProposer(card, tok, min_score=-1.0)
    imgs = torch.rand(4, 48, 40, 3, generator=torch.Generator().manual_seed(1))
    _seg_close(pg.heatmap(imgs.cuda(), "a bear"), pc.heatmap(imgs, "a bear"))


@pytest.mark.cuda
def test_dino_card_matches_cpu():
    """GroundingDINO's logits over the real tokens and its boxes."""
    _card()
    from gaussctrl_tpu_torch.seg.dino import DinoConfig, GroundingDINO, phrase_masks
    cfg = DinoConfig.tiny()
    cpu, card = _both(GroundingDINO.create(cfg, seed=3))
    ids = np.zeros((2, cfg.max_text_len), np.int64)
    ids[:, :5] = [1, 10, 11, 2, 1]
    attn, pos = phrase_masks(ids, (1, 2))
    attn = attn | np.eye(cfg.max_text_len, dtype=bool)
    mask = np.zeros_like(ids, bool)
    mask[:, :5] = True
    im = torch.randn(2, cfg.img_size, cfg.img_size, 3,
                     generator=torch.Generator().manual_seed(2))
    args = [torch.as_tensor(x) for x in (ids, pos, attn, mask)]
    logits, boxes = cpu(im, *args)
    cl, cb = card(im.cuda(), *[a.cuda() for a in args])
    _seg_close(cl[:, :, :5], logits[:, :, :5])
    _seg_close(cb, boxes)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [(0.1, 0.9), (-0.4, 1.4)])
def test_deform_sample_card_matches_cpu(spread):
    """Deformable sampling over two levels, points inside and outside."""
    _card()
    from gaussctrl_tpu_torch.seg.dino import deform_sample
    g = torch.Generator().manual_seed(4)
    val = torch.randn(2, 24 + 6, 2, 5, generator=g)
    locs = torch.rand(2, 7, 2, 2, 3, 2, generator=g) * (spread[1] - spread[0]) \
        + spread[0]
    w = torch.rand(2, 7, 2, 2, 3, generator=g)
    shapes = [(4, 6), (2, 3)]
    _seg_close(deform_sample(val.cuda(), shapes, locs.cuda(), w.cuda()),
               deform_sample(val, shapes, locs, w))


def _card_mesh_rank():
    """A world of one over NCCL: the gather is a copy, and the
    gaussian-sharded step (K1, K4) equals the unsharded one bit for bit."""
    from gaussctrl_tpu_torch.core.mesh import gather_rows, make_mesh
    from gaussctrl_tpu_torch.splat.scene import random_scene
    from gaussctrl_tpu_torch.splat.trainer import (make_optimizer, shard_scene,
                                                   train_step, trainable)
    mesh = make_mesh()
    x = torch.arange(6.0, device="cuda").reshape(3, 2)
    scene = random_scene(torch.Generator(device="cuda").manual_seed(2), 4096,
                         sh_degree=1, device="cuda")
    c2w = torch.eye(4, device="cuda")[:3]
    c2w[2, 3] = 2.0
    kw = dict(c2w=c2w, fx=80.0, fy=80.0, cx=32.0, cy=32.0,
              gt_image=torch.zeros((64, 64, 3), device="cuda"),
              background=torch.full((3,), 0.5, device="cuda"), width=64,
              height=64, sh_degree=1)
    local, full = trainable(shard_scene(scene, mesh)), trainable(scene)
    m_s = train_step(local, make_optimizer(local), 0, mesh=mesh, **kw)
    m_r = train_step(full, make_optimizer(full), 0, **kw)
    return dict(gathered=bool(torch.equal(gather_rows(x, mesh), x)),
                loss_equal=bool(torch.equal(m_s["loss"], m_r["loss"])),
                scene_equal=all(torch.equal(getattr(local, k),
                                            getattr(full, k))
                                for k in ("means", "scales", "quats",
                                          "opacities", "features_dc",
                                          "features_rest")))


@pytest.mark.cuda
def test_world_one_nccl_mesh_on_card():
    """`make_mesh()` on the card in a spawned rank (NCCL, a world of one):
    the gather and the gaussian-sharded re-optimisation step."""
    _card()
    from gaussctrl_tpu_torch.core.mesh import spawn_ranks
    out, = spawn_ranks(_card_mesh_rank, 1, device="cuda")
    assert out == dict(gathered=True, loss_equal=True, scene_equal=True)


@pytest.mark.cuda
def test_dryrun_multichip_on_card():
    """`dryrun_multichip(1)` without a device: one NCCL rank on the card
    runs every stage (the kernels at the tiny and nano widths) and passes
    its own checks."""
    _card()
    from gaussctrl_tpu_torch.entry import RUN_VIEWS, dryrun_multichip
    rep, = dryrun_multichip(1)
    assert rep["edit"] == "sharded == replicated"
    assert rep["nano_eps"] == "finite"
    assert rep["run"]["edited_chunk0"].shape[0] == RUN_VIEWS
