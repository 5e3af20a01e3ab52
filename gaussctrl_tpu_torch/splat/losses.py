"""Image losses for re-optimisation: (1 − λ)·L1 + λ·(1 − SSIM), λ = 0.2.

Counterpart of `gaussctrl_tpu/splat/losses.py`. SSIM uses the 11×11
gaussian window (σ = 1.5), shrunk to the next odd size ≤ min(H, W) on
images smaller than the window (a VALID filter would otherwise be empty and
its mean NaN).

The filter must run in true float32: SSIM's variances E[x²] − μ² cancel on
flat windows, and a filter in TF32 (about three decimal digits) sends the
per-pixel ratios to ±1000 (the JAX package pins `precision=HIGHEST` for the
same reason). A convolution in PyTorch takes TF32 on the card whenever
`torch.backends.cudnn.allow_tf32` is on, which is the default, and its
backward runs where no local setting reaches it. So the filter here is
written as two separable passes of shifted, weighted sums: plain fp32
elementwise work that no flag can route to the tensor cores.
"""

from __future__ import annotations

import math

import torch

SSIM_LAMBDA = 0.2


def _gaussian_taps(size: int = 11, sigma: float = 1.5) -> list[float]:
    """Normalised 1-D gaussian taps; the 2-D window is their outer product."""
    g = [math.exp(-0.5 * ((i - (size - 1) / 2.0) / sigma) ** 2)
         for i in range(size)]
    return [v / sum(g) for v in g]


def _filter2d(x: torch.Tensor, taps: list[float]) -> torch.Tensor:
    """VALID depthwise filter of [..., H, W] with the separable window."""
    k = len(taps)
    h, w = x.shape[-2] - k + 1, x.shape[-1] - k + 1
    rows = sum(t * x[..., i:i + h, :] for i, t in enumerate(taps))
    return sum(t * rows[..., :, i:i + w] for i, t in enumerate(taps))


def _floor0(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with `jnp.maximum`'s gradient, which splits a tie in half:
    on a flat window the variance can be exactly 0 (a constant background),
    where `clamp_min` would pass the whole gradient."""
    return 0.5 * (x + x.abs())


def ssim(img0: torch.Tensor, img1: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] image pair."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    k = min(11, img0.shape[0], img0.shape[1])
    taps = _gaussian_taps(k - (1 - k % 2))
    x0 = img0.float().permute(2, 0, 1)
    x1 = img1.float().permute(2, 0, 1)
    # the five filtered maps in one stack: μ0, μ1, E[x0²], E[x1²], E[x0·x1]
    f = _filter2d(torch.stack([x0, x1, x0 * x0, x1 * x1, x0 * x1]), taps)
    mu0, mu1 = f[0], f[1]
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    # variances are non-negative analytically; the floor drops round-off
    s00 = _floor0(f[2] - mu00)
    s11 = _floor0(f[3] - mu11)
    s01 = f[4] - mu01
    num = (2 * mu01 + c1) * (2 * s01 + c2)
    den = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    return torch.mean(num / den)


def splat_loss(pred: torch.Tensor, gt: torch.Tensor,
               ssim_lambda: float = SSIM_LAMBDA):
    """(loss, metrics) for one view pair [H, W, 3]; metrics are tensors."""
    l1 = torch.mean(torch.abs(gt - pred))
    sim = ssim(pred, gt)
    loss = (1.0 - ssim_lambda) * l1 + ssim_lambda * (1.0 - sim)
    psnr = -10.0 * torch.log10(torch.mean((gt - pred) ** 2) + 1e-10)
    return loss, {"l1": l1, "ssim": sim, "psnr": psnr, "loss": loss}
