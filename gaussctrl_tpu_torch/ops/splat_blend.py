"""Splat-blend forward, kernel K1, and its plain PyTorch version.

Counterpart of `gaussctrl_tpu/ops/splat_blend.py` (forward only; the
backward, K4, belongs to re-optimisation). The kernel is CUDA C++ in
`csrc/splat_blend_fwd.cu`: one block per 16×16 tile reads its own
[starts, ends) range of the depth-sorted `gauss_idx`. The plain version is
the segmented blend of the JAX package's `splat/rasterize.py:_blend_tiles`.
Both return (tiles [T, 256, ch] with the background composited,
alpha [T, 256]), as `blend_pallas` does.
"""

from __future__ import annotations

import torch

from gaussctrl_tpu_torch.ops import _lib, launch_counts

ALPHA_THRESH = 1.0 / 255.0
T_EPS = 1e-4
TILE = 16


def blend_plain(gauss_idx, starts, ends, xys, conics, colors, opacities,
                background, n_tiles_x: int, n_tiles_y: int,
                tile_capacity: int = 768, tile_chunk: int = 128,
                tile_size: int = TILE):
    """Front-to-back compositing of every tile, `tile_capacity` instances
    per segment, tiles taken `tile_chunk` at a time in order of descending
    occupancy; a chunk stops once all its pixels have T ≤ T_EPS."""
    ts, cap = tile_size, tile_capacity
    n_tiles = n_tiles_x * n_tiles_y
    ch = colors.shape[-1]
    dev = xys.device
    m_buf = gauss_idx.shape[0]
    gidx = gauss_idx.long()
    starts, ends = starts.long(), ends.long()
    pix = torch.arange(ts, dtype=torch.float32, device=dev) + 0.5
    pix_x = pix.repeat(ts)                     # [P]
    pix_y = pix.repeat_interleave(ts)          # [P]
    k = torch.arange(cap, device=dev)

    out = torch.zeros((n_tiles, ts * ts, ch), dtype=torch.float32, device=dev)
    t_fin = torch.ones((n_tiles, ts * ts), dtype=torch.float32, device=dev)
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
        for s in range(n_seg):
            if float(t_run.max()) <= T_EPS:
                break
            pos = start[:, None] + s * cap + k[None, :]            # [G, C]
            live = pos < end[:, None]
            gi = gidx[pos.clamp_max(m_buf - 1)]
            g_xy, g_conic = xys[gi], conics[gi]
            g_color, g_op = colors[gi], opacities[gi]
            dx = g_xy[:, :, 0:1] - px[:, None, :]                   # [G, C, P]
            dy = g_xy[:, :, 1:2] - py[:, None, :]
            a, b, c = g_conic[:, :, 0:1], g_conic[:, :, 1:2], g_conic[:, :, 2:3]
            sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
            alpha_c = torch.clamp_max(g_op[:, :, None] * torch.exp(-sigma), 0.999)
            cond = (sigma >= 0) & (alpha_c >= ALPHA_THRESH) & live[:, :, None]
            alpha = torch.where(cond, alpha_c, torch.zeros_like(alpha_c))
            trans = torch.cumprod(1.0 - alpha, dim=1)               # inclusive
            before = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], 1)
            t_before = t_run[:, None, :] * before
            w = alpha * t_before * (t_before > T_EPS)
            acc = acc + torch.einsum("gcp,gck->gpk", w, g_color)
            t_run = t_run * trans[:, -1, :]
        out[tids] = acc
        t_fin[tids] = t_run
    return out + t_fin[:, :, None] * background[None, None, :], 1.0 - t_fin


def blend(gauss_idx, starts, ends, xys, conics, colors, opacities, background,
          n_tiles_x: int, n_tiles_y: int, tile_capacity: int = 768,
          tile_chunk: int = 128, return_done: bool = False):
    """K1. Returns (tiles [T,256,ch], alpha [T,256]) and, with
    `return_done` on the card, the instances each tile blended [T].

    CPU tensors take `blend_plain`; CUDA tensors launch the kernel."""
    if xys.device.type == "cpu":
        out = blend_plain(gauss_idx, starts, ends, xys, conics, colors,
                          opacities, background, n_tiles_x, n_tiles_y,
                          tile_capacity, tile_chunk)
        return (*out, None) if return_done else out
    n_tiles = n_tiles_x * n_tiles_y
    ch = colors.shape[-1]
    ins = dict(gauss_idx=(gauss_idx, torch.int32), starts=(starts, torch.int32),
               ends=(ends, torch.int32), xys=(xys, torch.float32),
               conics=(conics, torch.float32), colors=(colors, torch.float32),
               opacities=(opacities, torch.float32))
    for name, (t, dt) in ins.items():
        if t.device.type != "cuda" or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"splat_blend: {name} must be a contiguous {dt} "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    n = xys.shape[0]
    if (xys.shape != (n, 2) or conics.shape != (n, 3) or colors.shape != (n, ch)
            or opacities.shape != (n,) or starts.shape != (n_tiles,)
            or ends.shape != (n_tiles,) or ch not in (3, 4)):
        raise ValueError("splat_blend: expected xys [N,2], conics [N,3], "
                         "colors [N,3|4], opacities [N], starts/ends [tiles]")
    dev = xys.device
    out = torch.empty((n_tiles, TILE * TILE, ch), dtype=torch.float32, device=dev)
    t_fin = torch.empty((n_tiles, TILE * TILE), dtype=torch.float32, device=dev)
    done = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    err = _lib.library().gc_splat_blend_fwd(
        gauss_idx.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        xys.data_ptr(), conics.data_ptr(), colors.data_ptr(),
        opacities.data_ptr(), out.data_ptr(), t_fin.data_ptr(),
        done.data_ptr(), n_tiles, n_tiles_x, ch,
        torch.cuda.current_stream(dev).cuda_stream)
    _lib.check(err, "splat_blend_fwd")
    launch_counts["splat_blend_fwd"] += 1
    tiles = out + t_fin[:, :, None] * background.to(dev, torch.float32)[None, None, :]
    res = (tiles, 1.0 - t_fin)
    return (*res, done) if return_done else res
