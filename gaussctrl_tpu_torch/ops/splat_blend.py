"""Splat-blend forward (kernel K1) and backward (kernel K4), each beside its
plain PyTorch version.

Counterpart of `gaussctrl_tpu/ops/splat_blend.py`. Both kernels are CUDA C++
in which one block per 16×16 tile reads its own [starts, ends) range of the
depth-sorted `gauss_idx`, and both read each gaussian as one packed 48-byte
record (`pack_records`; K1 packs them in a pre-pass):

  K1 `blend`      (`csrc/splat_blend_fwd.cu`) returns (tiles [T, 256, ch]
                  with the background composited, alpha [T, 256]), as
                  `blend_pallas` does, how many instances each tile blended
                  before it saturated, and what the backward reads: the
                  records, the un-composited channel sums `acc` and the
                  final transmittance `t_fin`;
  K4 `blend_bwd`  (`csrc/splat_blend_bwd.cu`) the VJP of K1 over exactly
                  those instances, by one replay that takes Q = g·acc and
                  T_fin from the forward: one row per sorted instance,
                  [xy(2), conic(3), colour(ch), opacity(1)], in `gauss_idx`
                  order, plus the background's cotangent.

The plain versions are the segmented blend of the JAX package's
`splat/rasterize.py:_blend_tiles` and its replay backward
`_blend_bwd_instance_grads`. `splat/rasterize.py` sums the rows per gaussian
(`reduce_by_slot`) inside the blend's `torch.autograd.Function`.
"""

from __future__ import annotations

import math

import torch

from gaussctrl_tpu_torch.ops import _lib, launch_counts

ALPHA_THRESH = 1.0 / 255.0
T_EPS = 1e-4
TILE = 16
# instances the kernels stage at a time; K1 votes on its exit once a batch,
# so its n_done counts whole batches (csrc/splat_blend_common.cuh)
BATCH = 128
# a packed record: x, y, A, B | C, o, c0, c1 | c2, c3, 0, 0 (48 bytes), with
# the conic folded: (A, B, C) = −log2(e)·(a/2, b, c/2), so that the kernels
# take e^−σ as one exp2 (csrc/splat_blend_common.cuh)
REC_FLOATS = 12
CONIC_FOLD = (-0.5 * math.log2(math.e), -math.log2(math.e),
              -0.5 * math.log2(math.e))


def pack_records(xys, conics, colors, opacities):
    """[N, 12] float32 records of the blend's per-gaussian inputs, as the
    kernels read them (the plain version of K1's pre-pass, bit for bit)."""
    n, ch = colors.shape
    fold = torch.tensor(CONIC_FOLD, dtype=torch.float32, device=xys.device)
    pad = xys.new_zeros((n, REC_FLOATS - 6 - ch))
    return torch.cat([xys.float(), conics.float() * fold,
                      opacities.float()[:, None], colors.float(), pad], 1)


def unpack_records(records, ch: int):
    """(xys [N,2], conics [N,3], colors [N,ch], opacities [N]) of packed
    records; the conics are unfolded, to within a rounding of the packed."""
    fold = torch.tensor(CONIC_FOLD, dtype=torch.float32, device=records.device)
    return (records[:, 0:2], records[:, 2:5] / fold, records[:, 6:6 + ch],
            records[:, 5])


def blend_plain(gauss_idx, starts, ends, xys, conics, colors, opacities,
                background, n_tiles_x: int, n_tiles_y: int,
                tile_capacity: int = 768, tile_chunk: int = 128,
                tile_size: int = TILE, return_done: bool = False,
                return_state: bool = False):
    """Front-to-back compositing of every tile, `tile_capacity` instances
    per segment, tiles taken `tile_chunk` at a time in order of descending
    occupancy; a chunk stops once all its pixels have T ≤ T_EPS. With
    `return_done` also the instances each tile blended [T] int32
    (min(segments run × capacity, end − start)), as K1 returns them; with
    `return_state` also (records, acc [T, 256, ch], t_fin [T, 256]), what
    the backward reads."""
    ts, cap = tile_size, tile_capacity
    n_tiles = n_tiles_x * n_tiles_y
    ch = colors.shape[-1]
    dev = xys.device
    gidx = gauss_idx.long()
    starts, ends = starts.long(), ends.long()
    pix = torch.arange(ts, dtype=torch.float32, device=dev) + 0.5
    pix_x = pix.repeat(ts)                     # [P]
    pix_y = pix.repeat_interleave(ts)          # [P]
    k = torch.arange(cap, device=dev)

    out = torch.zeros((n_tiles, ts * ts, ch), dtype=torch.float32, device=dev)
    t_fin = torch.ones((n_tiles, ts * ts), dtype=torch.float32, device=dev)
    done = torch.zeros((n_tiles,), dtype=torch.int32, device=dev)
    order = torch.argsort(starts - ends, stable=True)   # descending length
    for base in range(0, n_tiles, tile_chunk):
        tids = order[base:base + tile_chunk]
        start, end = starts[tids], ends[tids]
        px = ((tids % n_tiles_x) * ts).float()[:, None] + pix_x[None, :]
        py = ((tids // n_tiles_x) * ts).float()[:, None] + pix_y[None, :]
        n_seg = int(((end - start).max() + cap - 1) // cap)
        acc = torch.zeros((tids.shape[0], ts * ts, ch), dtype=torch.float32,
                          device=dev)
        t_run = torch.ones((tids.shape[0], ts * ts), dtype=torch.float32,
                           device=dev)
        n_run = 0
        for s in range(n_seg):
            if float(t_run.detach().max()) <= T_EPS:
                break
            n_run += 1
            pos = start[:, None] + s * cap + k[None, :]             # [G, C]
            alpha, aux = _segment(gidx, xys, conics, colors, opacities, pos,
                                  pos < end[:, None], px, py)
            g_color = aux["g_color"]
            trans = torch.cumprod(1.0 - alpha, dim=1)               # inclusive
            before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
            t_before = t_run[:, None, :] * before
            w = alpha * t_before * (t_before > T_EPS)
            acc = acc + torch.einsum("gcp,gck->gpk", w, g_color)
            t_run = t_run * trans[:, -1, :]
        out[tids] = acc
        t_fin[tids] = t_run
        done[tids] = (end - start).clamp_max(n_run * cap).int()
    res = (out + t_fin[:, :, None] * background[None, None, :], 1.0 - t_fin)
    if return_done:
        res = (*res, done)
    if return_state:
        res = (*res, pack_records(xys, conics, colors, opacities), out, t_fin)
    return res


def _segment(gidx, xys, conics, colors, opacities, pos, live, px, py):
    """One capacity segment of a tile chunk: (alpha [G,C,P], aux), the
    gated alphas and what the backward reads of them (`_segment_alpha`)."""
    gi = gidx[pos.clamp_max(gidx.shape[0] - 1)]
    g_xy, g_conic = xys[gi], conics[gi]
    dx = g_xy[:, :, 0:1] - px[:, None, :]                           # [G, C, P]
    dy = g_xy[:, :, 1:2] - py[:, None, :]
    a, b, c = g_conic[:, :, 0:1], g_conic[:, :, 1:2], g_conic[:, :, 2:3]
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    e_sig = torch.exp(-sigma)
    araw = opacities[gi][:, :, None] * e_sig
    alpha_c = torch.clamp_max(araw, 0.999)
    cond = (sigma >= 0) & (alpha_c >= ALPHA_THRESH) & live[:, :, None]
    alpha = torch.where(cond, alpha_c, torch.zeros_like(alpha_c))
    return alpha, dict(g_color=colors[gi], dx=dx, dy=dy, a=a, b=b, c=c,
                       e_sig=e_sig, araw=araw, cond=cond)


def blend_bwd_plain(gauss_idx, starts, ends, n_done, records, acc, t_fin,
                    background, g_tiles, g_alpha, n_tiles_x: int,
                    n_tiles_y: int, tile_capacity: int = 768,
                    tile_chunk: int = 128):
    """The VJP of the blend as per-instance rows, by a replay of each tile's
    first `n_done` [T] instances, where the forward
    (`blend(..., return_done=True, return_state=True)`) stopped, with K4's
    arguments: the packed `records`, and the forward's channel sums `acc`
    and final transmittance `t_fin`.

    For out_p = Σ_i w_i c_i + T_fin·bg, w_i = α_i T_i m_i, m_i = [T_i > 1e-4]:
      ∂L/∂α_i = (g·c_i) T_i m_i − [S_i + (g·bg − g_A)·T_fin] / (1 − α_i),
      S_i = Σ_{j>i} (g·c_j) w_j,
    gated to α_raw < 0.999 where α is kept. With Q = Σ_j (g·c_j) w_j = g·acc
    the replay's running prefix gives S_i = Q − prefix_i. With `acc` and
    `t_fin` None, a first replay accumulates Q and T_fin (the two-replay
    form). `ends` is K4's argument and unused here: the replay stops at
    starts + n_done, and every row starts as zero. Returns
    (rows [M, 5+ch+1] in `gauss_idx` order, zero where no instance was
    blended; g_bg [ch])."""
    ts, cap = TILE, tile_capacity
    n_tiles = n_tiles_x * n_tiles_y
    ch = g_tiles.shape[-1]
    d = 5 + ch + 1
    dev = records.device
    xys, conics, colors, opacities = unpack_records(records, ch)
    m_buf = gauss_idx.shape[0]
    gidx = gauss_idx.long()
    starts = starts.long()
    stop = starts + n_done.long()
    pix = torch.arange(ts, dtype=torch.float32, device=dev) + 0.5
    pix_x, pix_y = pix.repeat(ts), pix.repeat_interleave(ts)
    k = torch.arange(cap, device=dev)
    g_tiles = g_tiles.float()
    g_alpha = g_alpha.float()
    bg = background.to(dev, torch.float32)

    rows = torch.zeros((m_buf + cap, d), dtype=torch.float32, device=dev)
    g_bg = torch.zeros((ch,), dtype=torch.float32, device=dev)
    order = torch.argsort(starts - stop, stable=True)   # descending length
    for base in range(0, n_tiles, tile_chunk):
        tids = order[base:base + tile_chunk]
        start, end = starts[tids], stop[tids]
        px = ((tids % n_tiles_x) * ts).float()[:, None] + pix_x[None, :]
        py = ((tids // n_tiles_x) * ts).float()[:, None] + pix_y[None, :]
        go, g_a = g_tiles[tids], g_alpha[tids]                      # [G,P,ch]
        gbg = go @ bg                                               # [G, P]
        n_seg = int(((end - start).max() + cap - 1) // cap)

        def replay(s, t_run):
            pos = start[:, None] + s * cap + k[None, :]             # [G, C]
            alpha, aux = _segment(gidx, xys, conics, colors, opacities,
                                  pos, pos < end[:, None], px, py)
            trans = torch.cumprod(1.0 - alpha, dim=1)
            before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
            t_before = t_run[:, None, :] * before
            m = (t_before > T_EPS).float()
            gc = torch.einsum("gpk,gck->gcp", go, aux["g_color"])
            return pos, alpha, aux, t_before, m, alpha * t_before * m, gc, trans

        if acc is None:
            # the per-pixel total Q and the final transmittance by a replay
            t_run = torch.ones((tids.shape[0], ts * ts), device=dev)
            q_all = torch.zeros_like(t_run)
            for s in range(n_seg):
                *_, w, gc, trans = replay(s, t_run)
                q_all = q_all + (gc * w).sum(1)
                t_run = t_run * trans[:, -1, :]
            t_final = t_run
        else:
            q_all = torch.einsum("gpk,gpk->gp", go, acc[tids].float())
            t_final = t_fin[tids].float()
        gterm = (gbg - g_a) * t_final                               # [G, P]

        # the replay with the running prefix emits each row
        t_run = torch.ones_like(t_final)
        q_pre = torch.zeros_like(t_final)
        for s in range(n_seg):
            pos, alpha, aux, t_before, m, w, gc, trans = replay(s, t_run)
            q = gc * w
            s_after = q_all[:, None, :] - q_pre[:, None, :] - torch.cumsum(q, 1)
            ga = gc * t_before * m - (s_after + gterm[:, None, :]) / (1.0 - alpha)
            ga = torch.where(aux["cond"] & (aux["araw"] < 0.999), ga,
                             torch.zeros_like(ga))
            a, b, c_, dx, dy = aux["a"], aux["b"], aux["c"], aux["dx"], aux["dy"]
            g_sigma = -ga * alpha
            inst = torch.cat([
                (g_sigma * (a * dx + b * dy)).sum(-1, keepdim=True),
                (g_sigma * (c_ * dy + b * dx)).sum(-1, keepdim=True),
                (g_sigma * 0.5 * dx * dx).sum(-1, keepdim=True),
                (g_sigma * dx * dy).sum(-1, keepdim=True),
                (g_sigma * 0.5 * dy * dy).sum(-1, keepdim=True),
                torch.einsum("gcp,gpk->gck", w, go),
                (ga * aux["e_sig"]).sum(-1, keepdim=True)], dim=-1)  # [G,C,d]
            ok = pos < end[:, None]
            rows[pos[ok]] = inst[ok]
            q_pre = q_pre + q.sum(1)
            t_run = t_run * trans[:, -1, :]
        g_bg = g_bg + torch.einsum("gp,gpk->k", t_final, go)
    return rows[:m_buf], g_bg


def _check(kernel: str, **tensors) -> None:
    for name, (t, dt) in tensors.items():
        if t.device.type != "cuda" or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous {dt} "
                             f"CUDA tensor, got {t.dtype} on {t.device}")


def blend(gauss_idx, starts, ends, xys, conics, colors, opacities, background,
          n_tiles_x: int, n_tiles_y: int, tile_capacity: int = 768,
          tile_chunk: int = 128, return_done: bool = False,
          return_state: bool = False):
    """K1. Returns (tiles [T,256,ch], alpha [T,256]), with `return_done`
    the instances each tile blended [T] int32, and with `return_state`
    (records [N,12], acc [T,256,ch], t_fin [T,256]) for `blend_bwd`.

    CPU tensors take `blend_plain`; CUDA tensors launch the kernel."""
    if xys.device.type == "cpu":
        return blend_plain(gauss_idx, starts, ends, xys, conics, colors,
                           opacities, background, n_tiles_x, n_tiles_y,
                           tile_capacity, tile_chunk, return_done=return_done,
                           return_state=return_state)
    n_tiles = n_tiles_x * n_tiles_y
    n, ch = colors.shape
    i32, f32 = torch.int32, torch.float32
    _check("splat_blend", gauss_idx=(gauss_idx, i32), starts=(starts, i32),
           ends=(ends, i32), xys=(xys, f32), conics=(conics, f32),
           colors=(colors, f32), opacities=(opacities, f32))
    if (xys.shape != (n, 2) or conics.shape != (n, 3) or opacities.shape != (n,)
            or starts.shape != (n_tiles,) or ends.shape != (n_tiles,)
            or ch not in (3, 4) or background.shape != (ch,)):
        raise ValueError("splat_blend: expected xys [N,2], conics [N,3], "
                         "colors [N,3|4], opacities [N], starts/ends [tiles], "
                         "background [ch]")
    dev = xys.device
    bg = background.to(dev, f32).contiguous()
    records = torch.empty((n, REC_FLOATS), dtype=f32, device=dev)
    acc = torch.empty((n_tiles, TILE * TILE, ch), dtype=f32, device=dev)
    tiles = torch.empty_like(acc)
    t_fin = torch.empty((n_tiles, TILE * TILE), dtype=f32, device=dev)
    alpha = torch.empty_like(t_fin)
    done = torch.empty((n_tiles,), dtype=i32, device=dev)
    err = _lib.library().gc_splat_blend_fwd(
        gauss_idx.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        xys.data_ptr(), conics.data_ptr(), colors.data_ptr(),
        opacities.data_ptr(), bg.data_ptr(), records.data_ptr(),
        acc.data_ptr(), tiles.data_ptr(), alpha.data_ptr(), t_fin.data_ptr(),
        done.data_ptr(), n, n_tiles, n_tiles_x, ch,
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(err, "splat_blend_fwd")
    launch_counts["splat_blend_fwd"] += 1
    res = (tiles, alpha)
    if return_done:
        res = (*res, done)
    if return_state:
        res = (*res, records, acc, t_fin)
    return res


def blend_bwd(gauss_idx, starts, ends, n_done, records, acc, t_fin,
              background, g_tiles, g_alpha, n_tiles_x: int, n_tiles_y: int):
    """K4. The VJP of `blend` as (rows [M, 5+ch+1], g_bg [ch]) over each
    tile's first `n_done` [T] instances, from what `blend(...,
    return_done=True, return_state=True)` returned; see `blend_bwd_plain`.
    Every row of [0, ends[-1]) is written (zeros past n_done); rows at or
    past ends[-1] belong to no tile and are left as they are.

    CPU tensors take `blend_bwd_plain`; CUDA tensors launch the kernel."""
    if records.device.type == "cpu":
        return blend_bwd_plain(gauss_idx, starts, ends, n_done, records, acc,
                               t_fin, background, g_tiles, g_alpha, n_tiles_x,
                               n_tiles_y)
    n_tiles = n_tiles_x * n_tiles_y
    ch = g_tiles.shape[-1]
    i32, f32 = torch.int32, torch.float32
    _check("splat_blend_bwd", gauss_idx=(gauss_idx, i32), starts=(starts, i32),
           ends=(ends, i32), n_done=(n_done, i32), records=(records, f32),
           acc=(acc, f32), t_fin=(t_fin, f32), g_tiles=(g_tiles, f32),
           g_alpha=(g_alpha, f32), background=(background, f32))
    p = TILE * TILE
    if (records.shape[1:] != (REC_FLOATS,) or starts.shape != (n_tiles,)
            or ends.shape != (n_tiles,) or n_done.shape != (n_tiles,)
            or ch not in (3, 4) or acc.shape != (n_tiles, p, ch)
            or g_tiles.shape != (n_tiles, p, ch)
            or t_fin.shape != (n_tiles, p) or g_alpha.shape != (n_tiles, p)
            or background.shape != (ch,)):
        raise ValueError("splat_blend_bwd: expected records [N,12], "
                         "starts/ends/n_done [tiles], acc/g_tiles "
                         "[tiles,256,3|4], t_fin/g_alpha [tiles,256], "
                         "background [ch]")
    dev = records.device
    rows = torch.empty((gauss_idx.shape[0], 5 + ch + 1), dtype=f32, device=dev)
    err = _lib.library().gc_splat_blend_bwd(
        gauss_idx.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        n_done.data_ptr(), records.data_ptr(), acc.data_ptr(), t_fin.data_ptr(),
        g_tiles.data_ptr(), g_alpha.data_ptr(), background.data_ptr(),
        rows.data_ptr(), n_tiles, n_tiles_x, ch,
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(err, "splat_blend_bwd")
    launch_counts["splat_blend_bwd"] += 1
    return rows, torch.einsum("tp,tpk->k", t_fin, g_tiles)


def kernel_attrs(kernel: str, ch: int) -> dict:
    """Registers, static shared memory, local memory (bytes) and resident
    blocks per SM of K1's (`kernel="fwd"`) or K4's (`"bwd"`) instantiation
    for `ch` channels, from the CUDA runtime."""
    import ctypes
    out = (ctypes.c_int * 4)()
    fn = getattr(_lib.library(), f"gc_splat_blend_{kernel}_attrs")
    _lib.check(fn(ch, out), f"splat_blend_{kernel}_attrs")
    return dict(zip(("registers", "static_smem_bytes", "local_bytes",
                     "blocks_per_sm"), list(out)))
