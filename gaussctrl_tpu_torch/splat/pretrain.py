"""From-scratch 3DGS pre-training with densification (the `ns-train
splatfacto` role).

Counterpart of `gaussctrl_tpu/splat/pretrain.py`: seed gaussians from the
sparse point cloud (`scene.from_points`), optimise L1 + SSIM with the
re-optimiser's per-group Adam (`trainer.make_optimizer`, the means' lr
decaying from step 0), and run the fixed-capacity densification of
`densify.py`, with splatfacto's schedules:

  * progressive SH: active degree = step // sh_degree_interval, capped;
  * a mean-pooled resolution pyramid, trained at 1/2^(num_downscales −
    step // resolution_schedule) of full size;
  * refines every `refine_every` steps inside (warmup, stop_at), paused for
    len(cameras) + refine_every steps after each opacity reset, then
    cull-only passes from stop_at on; the newborn slots' Adam moments are
    zeroed, and the buffer doubles (up to capacity_mult × the seed count)
    once more than 80% of it is alive;
  * an opacity reset every `reset_alpha_every` steps inside the window,
    which zeroes the opacity group's Adam state;
  * every 200 steps the metrics with the `isect_frac` overflow warning and
    a divergence sentinel that writes a post-mortem checkpoint and raises;
  * resume from a saved scene (`init_scene`, `start_step`), the view order
    from `np.random.default_rng(seed + start_step)`, as in the JAX package.

Each step renders through kernel K1 and differentiates through kernel K4 on
the card (their plain versions on the CPU) at every resolution; the JAX
package's `fullres_blend` routing has no counterpart. The densify statistic
is the gradient with respect to a zero `xys_shift`, which K4's xy rows give
exactly. The per-step backgrounds come from a `torch.Generator` seeded with
`seed` (or from the caller, `backgrounds` [num_steps, 3]), and the refines'
offsets from the same generator (or `refine_noise(capacity)`, three
[capacity, 3] arrays), so that a run can be fed the JAX package's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from gaussctrl_tpu_torch.cameras.camera import Cameras
from gaussctrl_tpu_torch.device import resolve_device
from gaussctrl_tpu_torch.splat.densify import (DensifyConfig, DensifyState,
                                               accumulate, grow_capacity,
                                               init_state, refine,
                                               reset_opacities)
from gaussctrl_tpu_torch.splat.losses import splat_loss
from gaussctrl_tpu_torch.splat.rasterize import RasterConfig
from gaussctrl_tpu_torch.splat.render import render_rgbd
from gaussctrl_tpu_torch.splat.scene import GaussianScene, from_points
from gaussctrl_tpu_torch.splat.trainer import (GROUPS, TrainConfig,
                                               _exp_decay, _renorm_quats,
                                               adopt_params, make_optimizer,
                                               reset_group_moments,
                                               trainable, zero_adam_rows)


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    num_steps: int = 30000
    capacity_mult: float = 8.0      # gaussian buffer = mult × seed points
    eval_every: int = 1000          # full-res PSNR on 4 fixed views (0 = off)
    ckpt_every: int = 0             # mid-run checkpoints via ckpt_fn (0 = off)
    sh_degree_interval: int = 1000
    # splatfacto's resolution schedule: 1/2^num_downscales of full size,
    # the downscale halved every resolution_schedule steps (0 = full size)
    num_downscales: int = 2
    resolution_schedule: int = 3000
    densify: DensifyConfig = DensifyConfig()
    train: TrainConfig = TrainConfig(lr_step_offset=0)


def pretrain_step(scene: GaussianScene, optimizer: torch.optim.Adam,
                  dstate: DensifyState, lr_step: int, c2w, fx, fy, cx, cy,
                  gt_image: torch.Tensor, background: torch.Tensor,
                  width: int, height: int, sh_degree: int,
                  raster_cfg: RasterConfig = RasterConfig(),
                  train_cfg: TrainConfig = TrainConfig(lr_step_offset=0)):
    """One training step in place, with the densify statistics: render
    with a zero `xys_shift` that requires grad, L1 + SSIM, backward (K4 on
    the card), accumulate |∂L/∂xys_shift| over the gaussians the
    projection sees (radii > 0, its opacity-aware radius), Adam (the means'
    lr at `lr_step` of its schedule), quats renormalised.
    Returns (dstate, metrics as detached tensors, the xy gradient [N, 2])."""
    sched = _exp_decay(train_cfg.lr_means, train_cfg.lr_means_final,
                       train_cfg.lr_means_max_steps, train_cfg.lr_step_offset)
    optimizer.param_groups[GROUPS.index("means")]["lr"] = sched(lr_step)
    shift = torch.zeros((scene.num_gaussians, 2), device=scene.means.device,
                        requires_grad=True)
    out = render_rgbd(scene, c2w, fx, fy, cx, cy, width, height, background,
                      sh_degree, raster_cfg, return_stats=True,
                      xys_shift=shift)
    loss, metrics = splat_loss(out["rgb"], gt_image, train_cfg.ssim_lambda)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    radii = out["radii"].detach()
    dstate = accumulate(dstate, shift.grad, radii > 0, width, height,
                        radii=radii)
    optimizer.step()
    _renorm_quats(scene)
    stats = out["stats"]
    # > 1 means the binning buffer dropped intersections this step
    metrics = dict(metrics, isect_frac=stats["n_isect"].float()
                   / float(stats["isect_budget"]))
    return dstate, {k: v.detach() for k, v in metrics.items()}, shift.grad


@torch.no_grad()
def _eval_psnr(scene: GaussianScene, cameras: Cameras, images: torch.Tensor,
               sh_degree: int, raster_cfg: RasterConfig) -> dict:
    """Full-resolution PSNR on 4 fixed views on black, their mean
    accumulation, and the largest intersection-buffer occupancy (> 1 means
    binning overflow: lower RasterConfig.isect_divisor)."""
    v_idx = [int(i * len(cameras) / 4) for i in range(4)]
    h, w = int(cameras.height), int(cameras.width)
    bg = torch.zeros(3, device=images.device)
    vals, alphas, isect_frac = [], [], 0.0
    for v in v_idx:
        out = render_rgbd(scene, cameras.c2w[v], cameras.fx[v], cameras.fy[v],
                          cameras.cx[v], cameras.cy[v], w, h, bg, sh_degree,
                          raster_cfg, return_stats=True)
        mse = torch.mean((out["rgb"] - images[v]) ** 2)
        vals.append(-10.0 * torch.log10(torch.clamp_min(mse, 1e-10)))
        isect_frac = max(isect_frac, float(out["stats"]["n_isect"])
                         / float(out["stats"]["isect_budget"]))
        alphas.append(float(out["accumulation"].mean()))
    return {"eval_psnr": float(torch.stack(vals).mean()),
            "eval_alpha": round(float(np.mean(alphas)), 3),
            "isect_frac": round(isect_frac, 3)}


def _pyramid(images: np.ndarray, cfg: PretrainConfig, device) -> dict:
    """{downscale factor: [V, H/f, W/f, 3] tensor}, mean-pooled."""
    out = {1: torch.tensor(np.asarray(images, np.float32), device=device)}
    if cfg.num_downscales and cfg.resolution_schedule:
        v, h, w, c = images.shape
        for lvl in range(1, cfg.num_downscales + 1):
            f = 2 ** lvl
            im = np.asarray(images, np.float32)[:, : h // f * f, : w // f * f]
            out[f] = torch.tensor(
                im.reshape(v, h // f, f, w // f, f, c).mean((2, 4)),
                device=device)
    return out


def _alive_scene(scene: GaussianScene, alive: torch.Tensor) -> GaussianScene:
    idx = torch.nonzero(alive).reshape(-1)
    return GaussianScene(**{f.name: getattr(scene, f.name).detach()[idx]
                            for f in dataclasses.fields(scene)})


def pretrain(cameras: Cameras, images: np.ndarray, points_xyz: np.ndarray,
             points_rgb: np.ndarray, cfg: PretrainConfig = PretrainConfig(),
             sh_degree: int = 3, raster_cfg: RasterConfig = RasterConfig(),
             seed: int = 0, log_fn=None, ckpt_fn=None,
             init_scene: Optional[GaussianScene] = None, start_step: int = 0,
             device=None, backgrounds: Optional[torch.Tensor] = None,
             refine_noise: Optional[Callable[[int], tuple]] = None):
    """The whole pre-training loop on `images` [V, H, W, 3] (numpy, in
    [0, 1]). Returns (the scene of alive gaussians, detached; the last
    step's metrics as floats). `log_fn(step, {name: value})` receives the
    metrics, the refine statistics, capacity growth and evals;
    `ckpt_fn(step, scene)` fires every `cfg.ckpt_every` steps and on
    divergence.

    Resume: pass `init_scene` (a saved scene of alive gaussians) and
    `start_step`; the schedules pick up at `start_step`, the means' lr
    decay is offset by it, and the densify statistics start cold.
    Runs on the card unless `device="cpu"`."""
    dev = resolve_device(device)
    cameras = cameras.to(dev)
    if init_scene is not None:
        scene = GaussianScene(**{f.name: getattr(init_scene, f.name).to(dev)
                                 for f in dataclasses.fields(init_scene)})
    else:
        scene = from_points(points_xyz, points_rgb, sh_degree, device=dev)
    n_seed = scene.num_gaussians
    cap_max = max(int(cfg.capacity_mult * n_seed), n_seed)
    # start near the seed count and double as the buffer fills
    capacity = min(cap_max, -(-int(1.5 * n_seed) // 4096) * 4096)
    scene, dstate = init_state(scene, capacity)
    scene = trainable(scene)
    if start_step:
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, lr_step_offset=cfg.train.lr_step_offset + start_step))
    optimizer = make_optimizer(scene, cfg.train)

    gen = torch.Generator(device=dev).manual_seed(seed)
    if backgrounds is None:
        backgrounds = torch.rand((cfg.num_steps, 3), generator=gen, device=dev)
    backgrounds = torch.as_tensor(backgrounds, dtype=torch.float32).to(dev)
    rng = np.random.default_rng(seed + start_step)
    order: list = []
    metrics: dict = {}
    pyramid = _pyramid(images, cfg, dev)
    d = cfg.densify
    for step in range(start_step, cfg.num_steps):
        if not order:
            order = list(rng.permutation(len(cameras)))
        v = int(order.pop())
        active_sh = min(step // cfg.sh_degree_interval, sh_degree)
        if cfg.num_downscales and cfg.resolution_schedule:
            f = 2 ** max(cfg.num_downscales - step // cfg.resolution_schedule, 0)
        else:
            f = 1
        dstate, metrics, _ = pretrain_step(
            scene, optimizer, dstate, step - start_step, cameras.c2w[v],
            cameras.fx[v] / f, cameras.fy[v] / f, cameras.cx[v] / f,
            cameras.cy[v] / f, pyramid[f][v], backgrounds[step],
            cameras.width // f, cameras.height // f, active_sh, raster_cfg,
            cfg.train)

        in_window = d.warmup < step < d.stop_at
        post_window = step >= d.stop_at
        scale_cull_on = step > d.reset_alpha_every  # after the first reset
        # refinement pauses for len(cameras) + refine_every steps after each
        # opacity reset; the post-window cull-only passes are not gated
        steps_since_reset = (step % d.reset_alpha_every
                             if d.reset_alpha_every else step)
        settled = steps_since_reset > len(cameras) + d.refine_every
        if ((in_window and settled) or post_window) \
                and step % d.refine_every == 0:
            alive_before = dstate.alive.clone()
            if log_fn:
                av = dstate.avg_grad()[alive_before].cpu().numpy()
                if av.size:
                    log_fn(step, {
                        "grad_p50": float(np.quantile(av, 0.5)),
                        "grad_p90": float(np.quantile(av, 0.9)),
                        "grad_p98": float(np.quantile(av, 0.98)),
                        "grad_frac_above": float((av > d.grad_thresh).mean()),
                    })
            noise = (refine_noise(scene.num_gaussians)
                     if refine_noise is not None else None)
            scene, dstate, stats = refine(
                scene, dstate, gen, d,
                screen_split=step < d.stop_screen_size_at,
                scale_cull=scale_cull_on,
                screen_cull=scale_cull_on and step < d.stop_screen_size_at,
                cull_only=post_window, noise=noise)
            zero_adam_rows(optimizer, dstate.alive & ~alive_before)
            if log_fn:
                log_fn(step, stats)
            cap = scene.num_gaussians
            if cap < cap_max and stats["n_alive"] > 0.8 * cap:
                new_cap = min(cap_max, 2 * cap)
                scene, dstate = grow_capacity(scene, dstate, new_cap)
                adopt_params(optimizer, scene)
                if log_fn:
                    log_fn(step, {"capacity": new_cap})
        if in_window and d.reset_alpha_every \
                and step % d.reset_alpha_every == 0 and step > 0:
            reset_opacities(scene, dstate.alive, value=2 * d.cull_opacity)
            # only the opacity group's moments are stale after the clamp
            reset_group_moments(optimizer, "opacities")
        if log_fn and step % 200 == 0:
            m = {k: float(x) for k, x in metrics.items()}
            log_fn(step, m)
            if m.get("isect_frac", 0.0) > 1.0:
                log_fn(step, {"WARN_isect_overflow": m["isect_frac"]})
            # divergence sentinel: fail fast with a post-mortem checkpoint
            bad = (not np.isfinite(m.get("loss", 0.0))
                   or not -1.0 - 1e-3 <= m.get("ssim", 0.0) <= 1.0 + 1e-3)
            if bad:
                if ckpt_fn:
                    ckpt_fn(step, _alive_scene(scene, dstate.alive))
                raise FloatingPointError(
                    f"pretrain diverged at step {step} (view {v}): {m}: SSIM "
                    "outside [-1,1] or a non-finite loss means the renders "
                    "left [0,1]; a post-mortem checkpoint is written when "
                    "ckpt_fn is set")
        if log_fn and cfg.eval_every and step % cfg.eval_every == 0:
            log_fn(step, _eval_psnr(scene, cameras, pyramid[1], sh_degree,
                                    raster_cfg))
        if ckpt_fn and cfg.ckpt_every and step and step % cfg.ckpt_every == 0:
            ckpt_fn(step, _alive_scene(scene, dstate.alive))

    if log_fn and cfg.eval_every:
        log_fn(cfg.num_steps, _eval_psnr(scene, cameras, pyramid[1],
                                         sh_degree, raster_cfg))
    return (_alive_scene(scene, dstate.alive),
            {k: float(x) for k, x in metrics.items()})
