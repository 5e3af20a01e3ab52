"""AutoencoderKL (the SD-1.5 VAE) in torch.nn, NCHW.

Counterpart of `gaussctrl_tpu/diffusion/vae.py`: encoding takes the latent
mean (deterministic) scaled by 0.18215; GroupNorm eps is 1e-6 throughout;
the encoder downsamples with an asymmetric (0,1) pad and a stride-2 valid
conv. Parameter names are the diffusers keys. The mid-block attention is a
single 512-wide head computed with plain PyTorch, as the JAX package does
with einsum.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gaussctrl_tpu_torch.diffusion.config import VAEConfig
from gaussctrl_tpu_torch.diffusion.nn import ResnetBlock, Upsample, attention


class VAEAttnBlock(nn.Module):
    """Single-head self-attention over HW tokens (mid block)."""

    def __init__(self, channels: int, norm_num_groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(norm_num_groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels, bias=False)
        self.to_k = nn.Linear(channels, channels, bias=False)
        self.to_v = nn.Linear(channels, channels, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        t = attention(self.to_q(t), self.to_k(t), self.to_v(t), 1)
        t = self.to_out[0](t).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return t + x


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, norm_num_groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, norm_num_groups, 1e-6)
            for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttnBlock(channels, norm_num_groups)])

    def forward(self, x):
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _VAEDownsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class _Stage(nn.Module):
    """One encoder (down) or decoder (up) level: resnets + optional resample."""

    def __init__(self, resnets, down=None, up=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if down is not None:
            self.downsamplers = nn.ModuleList([down])
        if up is not None:
            self.upsamplers = nn.ModuleList([up])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if hasattr(self, "downsamplers"):
            x = self.downsamplers[0](x)
        if hasattr(self, "upsamplers"):
            x = self.upsamplers[0](x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        boc, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        stages, prev = [], boc[0]
        for i, ch in enumerate(boc):
            res = [ResnetBlock(prev if j == 0 else ch, ch, g, 1e-6)
                   for j in range(cfg.layers_per_block)]
            stages.append(_Stage(res, down=_VAEDownsample(ch)
                                 if i < len(boc) - 1 else None))
            prev = ch
        self.down_blocks = nn.ModuleList(stages)
        self.mid_block = VAEMidBlock(boc[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, boc[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(boc[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        x = self.conv_in(x)
        for stage in self.down_blocks:
            x = stage(x)
        x = self.mid_block(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = tuple(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], g)
        stages, prev = [], rev[0]
        for i, ch in enumerate(rev):
            res = [ResnetBlock(prev if j == 0 else ch, ch, g, 1e-6)
                   for j in range(cfg.layers_per_block + 1)]
            stages.append(_Stage(res, up=Upsample(ch)
                                 if i < len(rev) - 1 else None))
            prev = ch
        self.up_blocks = nn.ModuleList(stages)
        self.conv_norm_out = nn.GroupNorm(g, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.in_channels, 3, padding=1)

    def forward(self, z):
        x = self.mid_block(self.conv_in(z))
        for stage in self.up_blocks:
            x = stage(x)
        return self.conv_out(F.silu(self.conv_norm_out(x)))


class VAE(nn.Module):
    """encode(images in [-1,1]) → scaled latent mean; decode(latent) → image."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels,
                                    2 * cfg.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels,
                                         cfg.latent_channels, 1)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """[B,3,H,W] in [-1,1] → [B,4,H/8,W/8] (mean × scaling factor)."""
        x = images.to(self.quant_conv.weight.dtype)
        moments = self.quant_conv(self.encoder(x))
        return moments[:, :self.cfg.latent_channels] * self.cfg.scaling_factor

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """scaled latents [B,4,h,w] → images [B,3,8h,8w] in [-1,1]."""
        z = latents.to(self.post_quant_conv.weight.dtype) / self.cfg.scaling_factor
        return self.decoder(self.post_quant_conv(z))

    def forward(self, images):
        return self.decode(self.encode(images))
