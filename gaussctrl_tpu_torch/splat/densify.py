"""Adaptive density control (split, duplicate, cull) in a fixed-capacity
buffer.

Counterpart of `gaussctrl_tpu/splat/densify.py`, with its layout and its
decisions:

  * the scene holds `capacity` slots and an `alive` mask; dead slots have
    opacity and log-scales of −15, so the rasterizer gives them zero radii
    and the blend kernels K1/K4 never see them; births land in free slots;
  * `accumulate` sums, per step, the norm of the exact pixel-space
    positional gradient (the gradient with respect to `render_rgbd`'s
    `xys_shift`, i.e. K4's xy rows summed per gaussian) scaled by half the
    larger image side, and the largest screen radius, per visible gaussian;
  * `refine` splits high-gradient large gaussians into two children drawn
    from the parent (scales ÷ 1.6, parent killed), duplicates high-gradient
    small ones, and culls transparent or oversized ones; the split children
    claim `free_slots[2·rank]` and `free_slots[2·rank + 1]`, the duplicates
    follow, and a split whose two children would not both find a slot is
    not made, so decisions and slots match the JAX package's one for one;
  * `reset_opacities` clamps alive opacities (splatfacto's reset_alpha).

The scene's leaves are updated in place under `torch.no_grad()`, so the
tensors an optimizer holds stay the same objects; `grow_capacity` replaces
them with longer ones, and the optimizer's owner then moves its state
across (`trainer.adopt_params`).

Randomness: `refine` draws the children's offsets from a `torch.Generator`,
or takes them as `noise` (three [capacity, 3] arrays, the JAX package's
draws in the parity tests).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from gaussctrl_tpu_torch.splat.scene import GaussianScene

_DEAD = -15.0


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """The JAX package's defaults (splatfacto's semantics): the statistic's
    threshold, an optional quantile cap (0 = off), the size split between
    split and duplicate, the cull thresholds, the screen-size criteria as
    fractions of max(W, H), the split ratio and the schedule."""
    grad_thresh: float = 0.0002
    densify_quantile: float = 0.0
    densify_size_thresh: float = 0.01
    cull_opacity: float = 0.1
    cull_scale3d: float = 0.5
    split_screen_size: float = 0.05
    cull_screen_size: float = 0.15
    stop_screen_size_at: int = 4000
    split_ratio: float = 1.6
    warmup: int = 500
    stop_at: int = 15000
    refine_every: int = 100
    reset_alpha_every: int = 3000


@dataclasses.dataclass
class DensifyState:
    alive: torch.Tensor        # [cap] bool
    grad_accum: torch.Tensor   # [cap] summed screen-gradient norms
    grad_count: torch.Tensor   # [cap] steps with the gaussian visible
    radii_max: torch.Tensor    # [cap] largest screen radius / max(W, H)

    def avg_grad(self) -> torch.Tensor:
        return self.grad_accum / torch.clamp_min(self.grad_count, 1.0)


def _fresh_state(alive: torch.Tensor) -> DensifyState:
    z = torch.zeros(alive.shape, dtype=torch.float32, device=alive.device)
    return DensifyState(alive=alive, grad_accum=z, grad_count=z.clone(),
                        radii_max=z.clone())


def _padded_leaves(scene: GaussianScene, pad: int) -> dict:
    """The scene's fields with `pad` dead slots appended (detached)."""
    def grow(x, fill):
        x = x.detach()
        return torch.cat([x, torch.full((pad,) + x.shape[1:], fill,
                                        dtype=x.dtype, device=x.device)])

    quats = scene.quats.detach()
    ident = torch.zeros((pad, 4), dtype=quats.dtype, device=quats.device)
    ident[:, 0] = 1.0
    return dict(means=grow(scene.means, 0.0), scales=grow(scene.scales, _DEAD),
                quats=torch.cat([quats, ident]),
                opacities=grow(scene.opacities, _DEAD),
                features_dc=grow(scene.features_dc, 0.0),
                features_rest=grow(scene.features_rest, 0.0))


def pad_scene(scene: GaussianScene, pad: int) -> GaussianScene:
    """A new scene with `pad` dead slots appended (far-transparent, never
    rasterized)."""
    if not pad:
        return scene
    return GaussianScene(**_padded_leaves(scene, pad))


def init_state(scene: GaussianScene, capacity: int):
    """(the scene padded to `capacity` slots, its DensifyState); the padded
    slots are dead."""
    n = scene.num_gaussians
    assert capacity >= n, (capacity, n)
    scene = pad_scene(scene, capacity - n)
    alive = torch.arange(capacity, device=scene.means.device) < n
    return scene, _fresh_state(alive)


def grow_capacity(scene: GaussianScene, state: DensifyState, new_cap: int):
    """Grow the buffer to `new_cap` slots: every scene leaf is replaced by a
    longer one (dead slots appended, `requires_grad` as before) and the
    state padded. Returns (scene, state); the scene object is updated in
    place. An optimizer over the old leaves follows through
    `trainer.adopt_params`."""
    old = scene.num_gaussians
    pad = new_cap - old
    assert pad > 0, (old, new_cap)
    for name, leaf in _padded_leaves(scene, pad).items():
        setattr(scene, name, leaf.requires_grad_(
            getattr(scene, name).requires_grad))

    def grow(x):
        return torch.cat([x, x.new_zeros((pad,))])

    state = DensifyState(alive=grow(state.alive),
                         grad_accum=grow(state.grad_accum),
                         grad_count=grow(state.grad_count),
                         radii_max=grow(state.radii_max))
    return scene, state


@torch.no_grad()
def accumulate(state: DensifyState, xys_grads: torch.Tensor,
               visible: torch.Tensor, width: int, height: int,
               radii: Optional[torch.Tensor] = None) -> DensifyState:
    """Add one step's screen-space statistic: |∂L/∂xy| × max(W, H)/2 for
    each visible gaussian, its visibility count, and (with `radii`, screen
    pixels) the largest radius over max(W, H)."""
    side = max(width, height)
    g = torch.linalg.norm(xys_grads.float(), dim=-1) * (0.5 * side)
    radii_max = state.radii_max
    if radii is not None:
        radii_max = torch.maximum(radii_max, radii / side)
    return DensifyState(
        alive=state.alive,
        grad_accum=state.grad_accum + torch.where(visible, g, 0.0),
        grad_count=state.grad_count + visible.float(),
        radii_max=radii_max)


def _rotations(q: torch.Tensor) -> torch.Tensor:
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-8)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


@torch.no_grad()
def refine(scene: GaussianScene, state: DensifyState,
           generator: Optional[torch.Generator] = None,
           cfg: DensifyConfig = DensifyConfig(), screen_split: bool = False,
           scale_cull: bool = True, screen_cull: bool = False,
           cull_only: bool = False,
           noise: Optional[Sequence[torch.Tensor]] = None):
    """One split/duplicate/cull pass, in place on the scene's leaves.
    Returns (scene, a fresh DensifyState with the new alive mask, stats:
    n_alive, n_split, n_dup (candidates), n_cull, n_born (placed) and
    n_unplaced, as Python ints).

    The gating flags follow splatfacto's schedule (the caller derives them
    from the step): `screen_split` while step < stop_screen_size_at,
    `scale_cull`/`screen_cull` only after the first opacity reset,
    `cull_only` after the densify window. The children's offsets are
    `noise` (three [cap, 3] standard-normal arrays: first children, second
    children, duplicates) or drawn from `generator`."""
    cap = scene.num_gaussians
    dev = scene.means.device
    alive = state.alive
    avg_grad = state.avg_grad()
    opac = torch.sigmoid(scene.opacities[:, 0])
    max_scale = torch.exp(scene.scales).amax(-1)

    high_grad = (avg_grad > cfg.grad_thresh) & alive
    if cfg.densify_quantile > 0:
        qt = torch.nanquantile(torch.where(alive, avg_grad, float("nan")),
                               cfg.densify_quantile)
        high_grad = high_grad & (avg_grad >= qt)
    big = max_scale > cfg.densify_size_thresh
    if screen_split:
        big = big | (state.radii_max > cfg.split_screen_size)
    split_mask = high_grad & big
    dup_mask = high_grad & ~big
    if cull_only:
        split_mask = torch.zeros_like(split_mask)
        dup_mask = torch.zeros_like(dup_mask)
    cull_mask = opac < cfg.cull_opacity
    if scale_cull:
        toobig = max_scale > cfg.cull_scale3d
        if screen_cull:
            toobig = toobig | (state.radii_max > cfg.cull_screen_size)
        cull_mask = cull_mask | toobig
    cull_mask = cull_mask & alive
    # a split is made only if both children find a free slot: free slots
    # are packed ascending, so the first ⌊free/2⌋ split ranks succeed
    free_slots = torch.nonzero(~alive & ~cull_mask).reshape(-1)
    n_free = free_slots.numel()
    split_rank = torch.cumsum(split_mask.long(), 0) - 1
    split_mask = split_mask & (2 * split_rank + 1 < n_free)
    split_parents = torch.nonzero(split_mask).reshape(-1)
    n_split = split_parents.numel()
    # duplicates take the free slots after the split children's
    dup_parents = torch.nonzero(dup_mask).reshape(-1)
    n_dup, n_dup_placed = dup_parents.numel(), min(dup_parents.numel(),
                                                   n_free - 2 * n_split)

    if noise is None:
        noise = [torch.randn((cap, 3), generator=generator, device=dev)
                 for _ in range(3)]
    noise = [torch.as_tensor(np.array(e, np.float32), device=dev)
             if isinstance(e, np.ndarray) else e.to(dev, torch.float32)
             for e in noise]
    log_ratio = torch.log(torch.tensor(cfg.split_ratio, dtype=torch.float32))
    log_ratio = log_ratio.to(dev)
    fields = ("means", "scales", "quats", "opacities", "features_dc",
              "features_rest")

    def place(slots, parents, eps=None):
        """Copy `parents` into `slots`; with `eps`, as split children: moved
        by R(q)·(eps × scale) and shrunk. Parents are alive, so never in a
        free slot: each write leaves every parent as it was."""
        vals = {f: getattr(scene, f)[parents] for f in fields}
        if eps is not None:
            offset = torch.einsum("nij,nj->ni", _rotations(vals["quats"]),
                                  eps * torch.exp(vals["scales"]))
            vals["means"] = vals["means"] + offset
            vals["scales"] = vals["scales"] - log_ratio
        for f in fields:
            getattr(scene, f)[slots] = vals[f]

    # the i-th split parent's children at free_slots[2i] and [2i + 1]
    place(free_slots[0:2 * n_split:2], split_parents, noise[0][:n_split])
    place(free_slots[1:2 * n_split:2], split_parents, noise[1][:n_split])
    place(free_slots[2 * n_split:2 * n_split + n_dup_placed],
          dup_parents[:n_dup_placed])
    born = torch.zeros((cap,), dtype=torch.bool, device=dev)
    born[free_slots[:2 * n_split + n_dup_placed]] = True
    # split parents shrink in place and then die; duplicate parents live on
    scene.scales[split_mask] -= log_ratio
    new_alive = (alive & ~cull_mask & ~split_mask) | born
    dead = ~new_alive
    scene.opacities[dead] = _DEAD
    scene.scales[dead] = _DEAD
    n_born = int(born.sum())
    stats = {"n_alive": int(new_alive.sum()), "n_split": n_split,
             "n_dup": n_dup, "n_cull": int(cull_mask.sum()),
             "n_born": n_born,
             # candidates that found no free slot: the buffer is full
             "n_unplaced": max(2 * n_split + n_dup - n_born, 0)}
    return scene, _fresh_state(new_alive), stats


@torch.no_grad()
def reset_opacities(scene: GaussianScene, alive: torch.Tensor,
                    value: float = 0.2) -> GaussianScene:
    """Clamp alive opacities to at most `value` (splatfacto's reset_alpha at
    2 × cull_alpha_thresh), in place; dead slots keep theirs."""
    logit = torch.log(torch.tensor(value / (1 - value), dtype=torch.float32))
    op = scene.opacities
    op.copy_(torch.where(alive[:, None], torch.minimum(op, logit.to(op.device)),
                         op))
    return scene
