"""3DGS re-optimisation against the edited views.

Counterpart of `gaussctrl_tpu/splat/trainer.py`: the six scene groups of
splatfacto's optimizer (Adam, eps 1e-15; the means' lr decays
exponentially from 1.6e-4 to 1.6e-6 over 30k steps, offset by the 30k of
pre-training, so re-optimisation runs at the final lr), the optional
camera-opt group (SO3xR3 pose deltas, Adam lr 1e-3 stepped every 100 steps
on the mean of the accumulated gradients, as `optax.MultiSteps` does), and
`reoptimize`: `num_steps` single-view L1 + SSIM steps, views drawn without
replacement by `np.random.default_rng(seed).permutation` popped from the
end, each on a random background.

The backgrounds come from a `torch.Generator` seeded with `seed`, or from
the caller (`backgrounds` [num_steps, 3]), so that a run can be fed the JAX
package's `jax.random` draws. The blend's backward runs kernel K4 on the
card (`splat/rasterize.py`). Pre-training (`splat/pretrain.py`) also needs
`zero_adam_rows` (newborn slots), `reset_group_moments` (after an opacity
reset) and `adopt_params` (Adam's state onto the leaves that capacity
growth replaced).

The gaussian-sharded step (`train_step(..., mesh=)`, the role of the JAX
package's dry run of a `train_step` on a scene sharded over the gaussians)
gives each rank a contiguous block of N / world gaussians (`shard_scene`)
with its Adam state: projection and SH run on the block, the projected rows
are gathered, the binning, the blend (K1), the loss and the blend's
backward (K4) run alike on every rank, the gather's backward hands each
rank its block's gradient, and Adam steps the block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from gaussctrl_tpu_torch.cameras.camera import Cameras
from gaussctrl_tpu_torch.core.mesh import rows_of_rank
from gaussctrl_tpu_torch.splat.losses import splat_loss
from gaussctrl_tpu_torch.splat.rasterize import RasterConfig
from gaussctrl_tpu_torch.splat.render import render_rgbd
from gaussctrl_tpu_torch.splat.scene import GaussianScene

GROUPS = ("means", "features_dc", "features_rest", "opacities", "scales",
          "quats")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr_means: float = 1.6e-4
    lr_means_final: float = 1.6e-6
    lr_means_max_steps: int = 30000
    # re-optimisation resumes past splatfacto's 30k pre-training steps
    lr_step_offset: int = 30000
    lr_features_dc: float = 2.5e-3
    lr_features_rest: float = 2.5e-3 / 20
    lr_opacities: float = 5e-2
    lr_scales: float = 5e-3
    lr_quats: float = 1e-3
    adam_eps: float = 1e-15
    ssim_lambda: float = 0.2
    # splatfacto's background_color: "random" (training) | "black" | "white"
    background: str = "random"
    # camera_opt group: SO3xR3 per-view pose deltas, Adam lr 1e-3, stepped
    # every `camera_opt_accum` iterations
    use_camera_opt: bool = False
    lr_camera_opt: float = 1e-3
    camera_opt_accum: int = 100


def _exp_decay(lr_init: float, lr_final: float, max_steps: int,
               offset: int = 0):
    def schedule(step: int) -> float:
        t = min(max((step + offset) / max_steps, 0.0), 1.0)
        return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)

    return schedule


def trainable(scene: GaussianScene) -> GaussianScene:
    """A copy of `scene` whose fields are float32 leaves that need grads."""
    return GaussianScene(**{
        f.name: getattr(scene, f.name).detach().float().clone().requires_grad_()
        for f in dataclasses.fields(scene)})


def shard_scene(scene: GaussianScene, mesh) -> GaussianScene:
    """This rank's contiguous block of the scene's gaussians; N must be a
    multiple of the mesh size (the error names the padding needed)."""
    rows = rows_of_rank(scene.num_gaussians, mesh)
    return GaussianScene(**{f.name: getattr(scene, f.name)[rows]
                            for f in dataclasses.fields(scene)})


def make_optimizer(scene: GaussianScene,
                   cfg: TrainConfig = TrainConfig()) -> torch.optim.Adam:
    """Adam over the six scene groups, each with its own lr (the means'
    group is set per step by `train_step` from its schedule)."""
    lrs = dict(means=cfg.lr_means, features_dc=cfg.lr_features_dc,
               features_rest=cfg.lr_features_rest,
               opacities=cfg.lr_opacities, scales=cfg.lr_scales,
               quats=cfg.lr_quats)
    return torch.optim.Adam(
        [{"params": [getattr(scene, g)], "lr": lrs[g], "name": g}
         for g in GROUPS], eps=cfg.adam_eps, foreach=False)


@torch.no_grad()
def zero_adam_rows(optimizer: torch.optim.Adam, rows: torch.Tensor) -> None:
    """Zero the Adam moments (exp_avg, exp_avg_sq) of the gaussian slots
    `rows` ([N] bool) in every group, keeping the other rows and each
    group's step (densification's newborn slots)."""
    for group in optimizer.param_groups:
        st = optimizer.state.get(group["params"][0])
        if st:
            st["exp_avg"][rows] = 0.0
            st["exp_avg_sq"][rows] = 0.0


@torch.no_grad()
def reset_group_moments(optimizer: torch.optim.Adam, name: str) -> None:
    """Zero one group's Adam state, step included, as a fresh optimizer of
    that group would hold it (after an opacity reset)."""
    for group in optimizer.param_groups:
        st = optimizer.state.get(group["params"][0])
        if group["name"] == name and st:
            for v in st.values():
                v.zero_()


@torch.no_grad()
def adopt_params(optimizer: torch.optim.Adam, scene: GaussianScene) -> None:
    """Point every group at the scene's current leaves after they were
    replaced by longer ones (capacity growth): each group's moments move to
    the new leaf, padded with zero rows, and its step is kept, so Adam
    continues rather than restarting."""
    for group in optimizer.param_groups:
        old = group["params"][0]
        new = getattr(scene, group["name"])
        if new is old:
            continue
        st = optimizer.state.pop(old, None)
        if st:
            pad = new.shape[0] - old.shape[0]
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = torch.cat([st[k], st[k].new_zeros((pad,) + st[k].shape[1:])])
            optimizer.state[new] = st
        group["params"] = [new]


def exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle [3] → rotation matrix (Rodrigues, Taylor-safe at 0)."""
    theta2 = torch.sum(phi * phi)
    theta = torch.sqrt(theta2 + 1e-24)
    k = phi / theta
    zero = torch.zeros((), dtype=phi.dtype, device=phi.device)
    K = torch.stack([torch.stack([zero, -k[2], k[1]]),
                     torch.stack([k[2], zero, -k[0]]),
                     torch.stack([-k[1], k[0], zero])])
    big = theta2 > 1e-16
    s = torch.where(big, torch.sin(theta), theta)
    c1 = torch.where(big, 1.0 - torch.cos(theta), 0.5 * theta2)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + s * K + c1 * (K @ K)


def apply_camera_opt(c2w: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Compose an SO3xR3 correction delta = [t (3), phi (3)] with a [3, 4]
    camera-to-world in the camera's local frame, as nerfstudio does:
    c2w' = [R·exp(phi) | R·t + t_c2w]."""
    R = exp_so3(delta[3:])
    return torch.cat([c2w[:, :3] @ R, c2w[:, :3] @ delta[:3, None] + c2w[:, 3:4]],
                     dim=1)


class CameraOptimizer:
    """Adam on the pose deltas [V, 6], stepped every `accum` calls with the
    mean of the gradients gathered since the last step (`optax.MultiSteps`
    with its default gradient mean)."""

    def __init__(self, deltas: torch.Tensor, cfg: TrainConfig = TrainConfig()):
        self.deltas = deltas
        self.accum = cfg.camera_opt_accum
        self.adam = torch.optim.Adam([deltas], lr=cfg.lr_camera_opt,
                                     eps=cfg.adam_eps, foreach=False)
        self.acc = torch.zeros_like(deltas)
        self.mini = 0

    def step(self) -> None:
        self.acc += (self.deltas.grad - self.acc) / (self.mini + 1)
        self.mini += 1
        if self.mini == self.accum:
            self.deltas.grad = self.acc.clone()
            self.adam.step()
            self.acc.zero_()
            self.mini = 0
        self.deltas.grad = None


def _renorm_quats(scene: GaussianScene) -> None:
    """Project the quats back onto the unit sphere after each Adam step (a
    function-space no-op that keeps |q| from shrinking along Adam's chords)."""
    with torch.no_grad():
        n = torch.linalg.norm(scene.quats, dim=-1, keepdim=True)
        scene.quats.div_(torch.clamp_min(n, 1e-8))


def render_loss(scene: GaussianScene, c2w, fx, fy, cx, cy,
                gt_image: torch.Tensor, background: torch.Tensor, width: int,
                height: int, sh_degree: int = 3,
                raster_cfg: RasterConfig = RasterConfig(),
                train_cfg: TrainConfig = TrainConfig(), mesh=None):
    """(loss, metrics) of one view: render, then L1 + SSIM against it."""
    out = render_rgbd(scene, c2w, fx, fy, cx, cy, width, height, background,
                      sh_degree, raster_cfg, mesh=mesh)
    return splat_loss(out["rgb"], gt_image, train_cfg.ssim_lambda)


def train_step(scene: GaussianScene, optimizer: torch.optim.Adam, step: int,
               c2w, fx, fy, cx, cy, gt_image: torch.Tensor,
               background: torch.Tensor, width: int, height: int,
               sh_degree: int = 3, raster_cfg: RasterConfig = RasterConfig(),
               train_cfg: TrainConfig = TrainConfig(),
               cam_opt: Optional[CameraOptimizer] = None,
               view_idx: int = 0, mesh=None) -> dict:
    """One re-optimisation step on one view, in place: render, L1 + SSIM,
    backward (K4 on the card), Adam over the groups (the camera-opt group
    too when `cam_opt` is given), quats renormalised. `step` is the 0-based
    step, for the means' lr schedule. With `mesh`, `scene` and `optimizer`
    hold this rank's block of a gaussian-sharded scene (module docstring).
    Returns the metrics as tensors."""
    sched = _exp_decay(train_cfg.lr_means, train_cfg.lr_means_final,
                       train_cfg.lr_means_max_steps, train_cfg.lr_step_offset)
    optimizer.param_groups[GROUPS.index("means")]["lr"] = sched(step)
    if cam_opt is not None:
        c2w = apply_camera_opt(c2w, cam_opt.deltas[view_idx])
    loss, metrics = render_loss(scene, c2w, fx, fy, cx, cy, gt_image,
                                background, width, height, sh_degree,
                                raster_cfg, train_cfg, mesh)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    if cam_opt is not None:
        cam_opt.step()
    _renorm_quats(scene)
    return {k: v.detach() for k, v in metrics.items()}


def reoptimize(scene: GaussianScene, cameras: Cameras, images: torch.Tensor,
               num_steps: int = 500, seed: int = 0,
               sh_degree: Optional[int] = None,
               raster_cfg: RasterConfig = RasterConfig(),
               train_cfg: TrainConfig = TrainConfig(), log_every: int = 50,
               log_fn=None, ckpt_every: int = 0, ckpt_fn=None,
               backgrounds: Optional[torch.Tensor] = None):
    """Re-optimise `scene` against the edited views `images` [V, H, W, 3].

    `ckpt_fn(step, scene)` fires every `ckpt_every` steps and at the end;
    `log_fn(step, {name: float})` every `log_every` steps. Returns (the
    re-optimised scene, detached; the last step's metrics as floats plus
    `loss_history` [num_steps], and `camera_deltas` with camera-opt)."""
    dev = images.device
    if sh_degree is None:
        sh_degree = scene.sh_degree
    scene = trainable(scene)
    optimizer = make_optimizer(scene, train_cfg)
    cam_opt = None
    if train_cfg.use_camera_opt:
        cam_opt = CameraOptimizer(
            torch.zeros((len(cameras), 6), device=dev, requires_grad=True),
            train_cfg)
    if backgrounds is None and train_cfg.background == "random":
        gen = torch.Generator(device=dev).manual_seed(seed)
        backgrounds = torch.rand((num_steps, 3), generator=gen, device=dev)
    elif backgrounds is None:                       # "white" or "black"
        value = 1.0 if train_cfg.background == "white" else 0.0
        backgrounds = torch.full((num_steps, 3), value, device=dev)
    backgrounds = backgrounds.to(dev, torch.float32)
    images = images.float()
    rng = np.random.default_rng(seed)
    order: list = []
    losses = []
    metrics: dict = {}
    for i in range(num_steps):
        if not order:
            order = list(rng.permutation(len(cameras)))
        v = int(order.pop())
        metrics = train_step(
            scene, optimizer, i, cameras.c2w[v], cameras.fx[v], cameras.fy[v],
            cameras.cx[v], cameras.cy[v], images[v], backgrounds[i],
            cameras.width, cameras.height, sh_degree, raster_cfg, train_cfg,
            cam_opt, v)
        losses.append(metrics["loss"])
        if log_fn is not None and (i + 1) % log_every == 0:
            log_fn(i + 1, {k: float(m) for k, m in metrics.items()})
        if ckpt_fn is not None and ckpt_every and (i + 1) % ckpt_every == 0:
            ckpt_fn(i + 1, _detached(scene))
    if ckpt_fn is not None and not (ckpt_every and num_steps % ckpt_every == 0):
        ckpt_fn(num_steps, _detached(scene))
    out = {k: float(m) for k, m in metrics.items()}
    out["loss_history"] = (torch.stack(losses) if losses
                           else torch.zeros((0,), device=dev))
    if cam_opt is not None:
        out["camera_deltas"] = cam_opt.deltas.detach()
    return _detached(scene), out


def _detached(scene: GaussianScene) -> GaussianScene:
    return GaussianScene(**{f.name: getattr(scene, f.name).detach()
                            for f in dataclasses.fields(scene)})
