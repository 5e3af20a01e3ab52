"""DDIM forward / inverse steps as pure functions.

Counterpart of `gaussctrl_tpu/diffusion/ddim.py`: SD-1.5's scheduler
(scaled_linear betas 8.5e-4 → 1.2e-2, 1000 train steps, steps_offset 1,
"leading" spacing, eta 0, epsilon prediction, final alpha = alphas_cumprod[0]).
The steps run in the latents' dtype, as the JAX steps do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DDIMSchedule:
    alphas_cumprod: np.ndarray      # [num_train_timesteps] float32
    final_alpha_cumprod: float

    @classmethod
    def sd15(cls, num_train_timesteps: int = 1000, beta_start: float = 0.00085,
             beta_end: float = 0.012) -> "DDIMSchedule":
        betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                            num_train_timesteps, dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas)
        return cls(alphas_cumprod=ac.astype(np.float32),
                   final_alpha_cumprod=np.float32(ac[0]))

    def alpha(self, t: int) -> np.float32:
        """alphas_cumprod[t], the final alpha for t < 0 (float32)."""
        if t < 0:
            return np.float32(self.final_alpha_cumprod)
        return self.alphas_cumprod[min(int(t), self.alphas_cumprod.shape[0] - 1)]


def timestep_pairs(num_inference_steps: int, num_train_timesteps: int = 1000,
                   steps_offset: int = 1):
    """(t, t_prev) int lists in denoise order (descending t)."""
    ratio = num_train_timesteps // num_inference_steps
    t = (np.arange(num_inference_steps) * ratio).round().astype(np.int64)[::-1]
    t = t + steps_offset
    return [int(x) for x in t], [int(x) for x in t - ratio]


def _coef(a: np.float32, x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(a, dtype=torch.float32).to(x.device, x.dtype)


def pred_x0(sched: DDIMSchedule, x, eps, t: int):
    a = _coef(sched.alpha(t), x)
    return (x - torch.sqrt(1.0 - a) * eps) / torch.sqrt(a)


def ddim_step(sched: DDIMSchedule, x, eps, t: int, t_prev: int):
    """One deterministic (eta=0) denoise step: state at t → state at t_prev."""
    a_prev = _coef(sched.alpha(t_prev), x)
    x0 = pred_x0(sched, x, eps, t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps


def ddim_inverse_step(sched: DDIMSchedule, x, eps, t: int, t_prev: int):
    """One inversion step: state at t_prev → state at t, with eps evaluated
    at (x, t) as the reference pipeline feeds the target timestep."""
    a_t = _coef(sched.alpha(t), x)
    x0 = pred_x0(sched, x, eps, t_prev)
    return torch.sqrt(a_t) * x0 + torch.sqrt(1.0 - a_t) * eps
