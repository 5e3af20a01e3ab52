"""Tile-binned gaussian rasterization, differentiable through the blend.

Counterpart of `gaussctrl_tpu/splat/rasterize.py`, with the same static
budgets so that the binning comes out identical:

  1. BIN    two classes of tile window — a 4×4 window for small gaussians,
            a 16×16 window for at most N // large_divisor large ones
            (overflow falls back to the clamped small window);
  2. SORT   one stable sort of packed keys (tile_id << shift | depth bits);
            the JAX package packs them in uint32, the port in int64 with the
            same order, and the stable sort breaks ties as JAX's does;
  3. RANGE  per-tile [start, end) by a left binary search;
  4. BLEND  a `torch.autograd.Function` (`_Blend`): forward kernel K1
            (`ops/splat_blend.blend`) on the card, its plain segmented
            version on the CPU; backward kernel K4
            (`ops/splat_blend.blend_bwd`) on the card, the plain replay on
            the CPU, both from the forward's packed records, channel sums
            and final transmittance; then `reduce_by_slot` sums the
            per-instance rows per gaussian. Gradients reach xys, conics, colors,
            opacities and the background; the binning carries none.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gaussctrl_tpu_torch.ops.splat_blend import ALPHA_THRESH, blend, blend_bwd

_SENTINEL = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    tile_size: int = 16
    max_tiles_x: int = 16       # large-class tile window
    max_tiles_y: int = 16
    small_tiles_x: int = 4      # small-class tile window
    small_tiles_y: int = 4
    large_divisor: int = 8      # large-class capacity clamp(N // d, 64, N)
    tile_capacity: int = 768    # instances per segment of the plain blend
    isect_divisor: int = 2      # sorted buffer = candidate slots / divisor
    tile_chunk: int = 128       # tiles per step of the plain blend


class Binned(NamedTuple):
    gauss_idx: torch.Tensor   # [CAP] int32, sorted by (tile, depth)
    starts: torch.Tensor      # [T] int32
    ends: torch.Tensor        # [T] int32
    n_isect: torch.Tensor     # [] intersections emitted
    slot_idx: torch.Tensor    # [CAP] candidate-grid slot per sorted entry
    lmap: torch.Tensor        # [cap_l] large-class rank → gaussian
    lvalid: torch.Tensor      # [cap_l] rank occupied


def _tile_window(xys, radii, alive, kx, ky, n_tiles_x, n_tiles_y, ts):
    """Centred, clamped [kx, ky] tile window per gaussian: (start_x,
    start_y, span_x, span_y, raw_span_x, raw_span_y)."""
    i32 = torch.int32
    tmin_x = torch.clamp(torch.floor((xys[:, 0] - radii) / ts), 0, n_tiles_x - 1).to(i32)
    tmin_y = torch.clamp(torch.floor((xys[:, 1] - radii) / ts), 0, n_tiles_y - 1).to(i32)
    tmax_x = torch.clamp(torch.ceil((xys[:, 0] + radii + 1) / ts), 1, n_tiles_x).to(i32)
    tmax_y = torch.clamp(torch.ceil((xys[:, 1] + radii + 1) / ts), 1, n_tiles_y).to(i32)
    raw_span_x = tmax_x - tmin_x
    raw_span_y = tmax_y - tmin_y
    zero = torch.zeros_like(raw_span_x)
    span_x = torch.where(alive, torch.clamp_max(raw_span_x, kx), zero)
    span_y = torch.where(alive, torch.clamp_max(raw_span_y, ky), zero)
    ctile_x = torch.clamp((xys[:, 0] / ts).to(i32), 0, n_tiles_x - 1)
    ctile_y = torch.clamp((xys[:, 1] / ts).to(i32), 0, n_tiles_y - 1)
    start_x = torch.minimum(torch.maximum(ctile_x - span_x // 2, tmin_x), tmax_x - span_x)
    start_y = torch.minimum(torch.maximum(ctile_y - span_y // 2, tmin_y), tmax_y - span_y)
    return start_x, start_y, span_x, span_y, raw_span_x, raw_span_y


def _class_keys(start_x, start_y, span_x, span_y, dq, kx, ky, n_tiles_x, shift):
    """[M] windows → flat [M·kx·ky] int64 sort keys (invalid ⇒ sentinel)."""
    slot = torch.arange(kx * ky, device=dq.device)
    dy = (slot // kx)[None, :]
    dx = (slot % kx)[None, :]
    valid = (dy < span_y[:, None]) & (dx < span_x[:, None])
    tile_id = (start_y.long()[:, None] + dy) * n_tiles_x + start_x.long()[:, None] + dx
    key = (tile_id << shift) | dq[:, None]
    return torch.where(valid, key, torch.full_like(key, _SENTINEL)).reshape(-1)


def _bin_and_sort(xys, depths, radii, n_tiles_x, n_tiles_y,
                  cfg: RasterConfig) -> Binned:
    """The depth-sorted per-tile work lists (no gradients)."""
    xys, depths, radii = xys.detach(), depths.detach(), radii.detach()
    dev = xys.device
    n = xys.shape[0]
    ts = cfg.tile_size
    kx, ky = cfg.max_tiles_x, cfg.max_tiles_y
    ksx, ksy = min(cfg.small_tiles_x, kx), min(cfg.small_tiles_y, ky)
    n_tiles = n_tiles_x * n_tiles_y
    tile_bits = max(1, int(n_tiles).bit_length())
    shift = 32 - tile_bits
    # non-negative float32 bits order like the floats; keep the leading bits
    dbits = torch.clamp_min(depths.float(), 0.0).contiguous().view(torch.int32)
    dq = dbits.long() >> tile_bits

    alive = radii > 0
    sxL, syL, spxL, spyL, rspx, rspy = _tile_window(
        xys, radii, alive, kx, ky, n_tiles_x, n_tiles_y, ts)
    idx = torch.arange(n, device=dev)

    if (ksx, ksy) == (kx, ky):
        keys = _class_keys(sxL, syL, spxL, spyL, dq, kx, ky, n_tiles_x, shift)
        n_isect = (spxL * spyL).sum()
        lmap = torch.zeros((1,), dtype=torch.long, device=dev)
        lvalid = torch.zeros((1,), dtype=torch.bool, device=dev)

        def slot_to_gauss(slot):
            return slot // (kx * ky)
    else:
        cap_l = min(n, max(n // cfg.large_divisor, 64))
        is_large = alive & ((rspx > ksx) | (rspy > ksy))
        rank = torch.cumsum(is_large.long(), 0) - is_large.long()
        eff_large = is_large & (rank < cap_l)
        lmap = torch.zeros((cap_l,), dtype=torch.long, device=dev)
        lvalid = torch.zeros((cap_l,), dtype=torch.bool, device=dev)
        lmap[rank[eff_large]] = idx[eff_large]
        lvalid[rank[eff_large]] = True
        sxS, syS, spxS, spyS, _, _ = _tile_window(
            xys, radii, alive & ~eff_large, ksx, ksy, n_tiles_x, n_tiles_y, ts)
        keys_s = _class_keys(sxS, syS, spxS, spyS, dq, ksx, ksy, n_tiles_x, shift)
        keys_l = _class_keys(
            sxL[lmap], syL[lmap],
            torch.where(lvalid, spxL[lmap], torch.zeros_like(spxL[lmap])),
            spyL[lmap], dq[lmap], kx, ky, n_tiles_x, shift)
        keys = torch.cat([keys_s, keys_l])
        n_isect = torch.where(eff_large, spxL * spyL, spxS * spyS).sum()

        def slot_to_gauss(slot):
            small_count = n * ksx * ksy
            r = torch.clamp((slot - small_count) // (kx * ky), 0, cap_l - 1)
            return torch.where(slot < small_count, slot // (ksx * ksy), lmap[r])

    s_keys, s_idx = torch.sort(keys, stable=True)
    budget = max(1024, keys.shape[0] // max(cfg.isect_divisor, 1))
    if budget < keys.shape[0]:
        s_keys, s_idx = s_keys[:budget], s_idx[:budget]
    tq = torch.arange(n_tiles + 1, dtype=torch.long, device=dev) << shift
    bounds = torch.searchsorted(s_keys, tq).to(torch.int32)
    return Binned(gauss_idx=slot_to_gauss(s_idx).to(torch.int32),
                  starts=bounds[:-1].contiguous(), ends=bounds[1:].contiguous(),
                  n_isect=n_isect, slot_idx=s_idx.to(torch.int32),
                  lmap=lmap, lvalid=lvalid)


def reduce_by_slot(rows, slot_of_row, valid, binned: Binned, n: int,
                   k2s: int, k2L: int):
    """Per-gaussian sums [n, d] of per-instance rows [M, d] without
    re-sorting: every sorted row is a candidate-grid slot, gaussian g's
    small-class slots are g·k2s … g·k2s + k2s − 1 and the large-class ranks
    go through `binned.lmap`, so the inverse of the bin sort is one scatter
    of arange and the windows collapse by a gather and a reshape-sum (the
    same order of sums as the JAX package)."""
    m, d = rows.shape
    dev = rows.device
    cap_l = binned.lmap.shape[0]
    total_slots = n * k2s + cap_l * k2L
    ar = torch.arange(m, device=dev)
    # invalid rows go to a dropped slot past the end
    tgt = torch.where(valid, slot_of_row.long(), torch.full_like(ar, total_slots))
    row_of_slot = torch.full((total_slots + 1,), m, dtype=torch.long, device=dev)
    row_of_slot[tgt] = ar
    rows_p = torch.cat([rows, rows.new_zeros((1, d))])
    per_slot = rows_p[row_of_slot[:total_slots]]                      # [S, d]
    out = per_slot[: n * k2s].reshape(n, k2s, d).sum(1)
    if cap_l > 1:
        lsum = per_slot[n * k2s:].reshape(cap_l, k2L, d).sum(1)
        lsum = torch.where(binned.lvalid[:, None], lsum, torch.zeros_like(lsum))
        out = out.index_add(0, binned.lmap, lsum)
    return out


class _Blend(torch.autograd.Function):
    """The blend with its VJP: K1/K4 on the card, the plain versions on the
    CPU (`ops/splat_blend`), rows summed per gaussian by `reduce_by_slot`."""

    @staticmethod
    def forward(ctx, xys, conics, colors, opacities, background, binned,
                n_tiles_x, n_tiles_y, cfg):
        tiles, alpha, done, records, acc, t_fin = blend(
            binned.gauss_idx, binned.starts, binned.ends, xys, conics, colors,
            opacities, background, n_tiles_x, n_tiles_y, cfg.tile_capacity,
            cfg.tile_chunk, return_done=True, return_state=True)
        ctx.save_for_backward(records, acc, t_fin, background)
        ctx.binned, ctx.done, ctx.cfg = binned, done, cfg
        ctx.grid = (n_tiles_x, n_tiles_y)
        return tiles, alpha

    @staticmethod
    def backward(ctx, g_tiles, g_alpha):
        records, acc, t_fin, background = ctx.saved_tensors
        b, cfg = ctx.binned, ctx.cfg
        n, ch = records.shape[0], acc.shape[-1]
        rows, g_bg = blend_bwd(
            b.gauss_idx, b.starts, b.ends, ctx.done, records, acc, t_fin,
            background.float().contiguous(), g_tiles.float().contiguous(),
            g_alpha.float().contiguous(), *ctx.grid)
        ksx = min(cfg.small_tiles_x, cfg.max_tiles_x)
        ksy = min(cfg.small_tiles_y, cfg.max_tiles_y)
        # rows at or past ends[-1] belong to no tile (K4 leaves them unset)
        valid = torch.arange(rows.shape[0], device=rows.device) < b.ends[-1]
        g = reduce_by_slot(rows, b.slot_idx, valid, b, n, ksx * ksy,
                           cfg.max_tiles_x * cfg.max_tiles_y)
        return (g[:, 0:2], g[:, 2:5], g[:, 5:5 + ch], g[:, 5 + ch],
                g_bg.to(background.dtype), None, None, None, None)


def _tiles_to_image(tiles, n_tiles_x, n_tiles_y, height, width, ts):
    """[T, ts·ts(, ch)] tile-major → [H, W(, ch)] row-major image."""
    rest = tiles.shape[2:]
    x = tiles.reshape(n_tiles_y, n_tiles_x, ts, ts, *rest)
    x = x.transpose(1, 2).reshape(n_tiles_y * ts, n_tiles_x * ts, *rest)
    return x[:height, :width]


def rasterize(xys, depths, radii, conics, colors, opacities, background,
              height: int, width: int, cfg: RasterConfig = RasterConfig(),
              return_stats: bool = False):
    """Composite gaussians into an image: (image [H,W,ch], alpha [H,W]) and,
    with `return_stats`, {"n_isect", "isect_budget", "max_tile_count"}
    (n_isect > isect_budget ⇒ the sorted buffer overflowed)."""
    ts = cfg.tile_size
    if ts != 16:
        raise ValueError("the blend runs 16x16 tiles (RasterConfig.tile_size=16)")
    n_tiles_x = (width + ts - 1) // ts
    n_tiles_y = (height + ts - 1) // ts
    radii = torch.where(opacities.detach() >= ALPHA_THRESH, radii,
                        torch.zeros_like(radii))
    binned = _bin_and_sort(xys, depths, radii, n_tiles_x, n_tiles_y, cfg)
    tiles, tile_alpha = _Blend.apply(
        xys.contiguous(), conics.contiguous(), colors.contiguous(),
        opacities.contiguous(), background, binned, n_tiles_x, n_tiles_y, cfg)
    img = _tiles_to_image(tiles, n_tiles_x, n_tiles_y, height, width, ts)
    alpha = _tiles_to_image(tile_alpha, n_tiles_x, n_tiles_y, height, width, ts)
    if return_stats:
        return img, alpha, {
            "n_isect": binned.n_isect,
            "isect_budget": binned.gauss_idx.shape[0],
            "max_tile_count": (binned.ends - binned.starts).max(),
        }
    return img, alpha
