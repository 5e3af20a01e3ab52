"""SD-1.5 conditional UNet (torch.nn, NCHW).

Counterpart of `gaussctrl_tpu/diffusion/unet.py`: 4 down blocks (3 with
cross-attention transformers), a cross-attention mid block, 4 up blocks with
skip concatenation, timestep-MLP conditioning, ControlNet residuals added on
every skip and on the mid block, and the self-attention processor threaded
through every transformer. Parameter names are the diffusers keys
(`down_blocks.0.resnets.1.conv1.weight`, …); the JAX tree nests the encoder
half under `encoder/`, which `bridge.py` accounts for.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gaussctrl_tpu_torch.diffusion.config import UNetConfig
from gaussctrl_tpu_torch.diffusion.nn import (
    Downsample, ResnetBlock, TimestepEmbedding, Transformer2D, Upsample,
    timestep_embedding,
)


class DownBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_channels: int, out_channels: int,
                 has_attn: bool, add_downsample: bool, temb_channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels,
                        cfg.norm_num_groups, cfg.norm_eps, temb_channels)
            for j in range(cfg.layers_per_block)])
        self.attentions = nn.ModuleList([
            Transformer2D(out_channels, cfg.num_heads, cfg.cross_attention_dim,
                          cfg.transformer_layers, cfg.norm_num_groups)
            for _ in range(cfg.layers_per_block)]) if has_attn else None
        self.downsamplers = (nn.ModuleList([Downsample(out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, context, processor=None):
        res = []
        for j, resnet in enumerate(self.resnets):
            x = resnet(x, temb)
            if self.attentions is not None:
                x = self.attentions[j](x, context, processor)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            res.append(x)
        return x, res


class MidBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, channels: int, temb_channels: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock(channels, channels, cfg.norm_num_groups, cfg.norm_eps,
                        temb_channels) for _ in range(2)])
        self.attentions = nn.ModuleList([
            Transformer2D(channels, cfg.num_heads, cfg.cross_attention_dim,
                          cfg.transformer_layers, cfg.norm_num_groups)])

    def forward(self, x, temb, context, processor=None):
        x = self.resnets[0](x, temb)
        x = self.attentions[0](x, context, processor)
        return self.resnets[1](x, temb)


class UpBlock(nn.Module):
    def __init__(self, cfg: UNetConfig, in_channels: int,
                 skip_channels: Sequence[int], out_channels: int,
                 has_attn: bool, add_upsample: bool, temb_channels: int):
        super().__init__()
        n = cfg.layers_per_block + 1
        self.resnets = nn.ModuleList([
            ResnetBlock((in_channels if j == 0 else out_channels)
                        + skip_channels[-(j + 1)], out_channels,
                        cfg.norm_num_groups, cfg.norm_eps, temb_channels)
            for j in range(n)])
        self.attentions = nn.ModuleList([
            Transformer2D(out_channels, cfg.num_heads, cfg.cross_attention_dim,
                          cfg.transformer_layers, cfg.norm_num_groups)
            for _ in range(n)]) if has_attn else None
        self.upsamplers = (nn.ModuleList([Upsample(out_channels)])
                           if add_upsample else None)

    def forward(self, x, skips, temb, context, processor=None):
        for j, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips[-(j + 1)]], dim=1), temb)
            if self.attentions is not None:
                x = self.attentions[j](x, context, processor)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


def build_encoder(module: nn.Module, cfg: UNetConfig) -> List[int]:
    """Attach conv_in, time_embedding, down_blocks and mid_block (the part
    the UNet and the ControlNet share) to `module`; returns the channel
    count of every skip sample, in order."""
    c0 = cfg.block_out_channels[0]
    module.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)
    module.time_embedding = TimestepEmbedding(c0, c0 * 4)
    skips = [c0]
    blocks = []
    prev = c0
    n = len(cfg.block_out_channels)
    for i, ch in enumerate(cfg.block_out_channels):
        blocks.append(DownBlock(cfg, prev, ch, cfg.down_block_attn[i],
                                i < n - 1, c0 * 4))
        skips += [ch] * (cfg.layers_per_block + (1 if i < n - 1 else 0))
        prev = ch
    module.down_blocks = nn.ModuleList(blocks)
    module.mid_block = MidBlock(cfg, cfg.block_out_channels[-1], c0 * 4)
    return skips


def run_encoder(module: nn.Module, cfg: UNetConfig, sample, timesteps,
                context, processor=None, extra_in=None):
    """conv_in + time embedding + down blocks + mid block:
    (mid output, skip samples, temb)."""
    dtype = module.conv_in.weight.dtype
    temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                              cfg.flip_sin_to_cos, cfg.freq_shift)
    temb = module.time_embedding(temb.to(dtype))
    x = module.conv_in(sample)
    if extra_in is not None:      # the ControlNet's conditioning embedding
        x = x + extra_in
    res = [x]
    for block in module.down_blocks:
        x, r = block(x, temb, context, processor)
        res.extend(r)
    x = module.mid_block(x, temb, context, processor)
    return x, res, temb


class UNet(nn.Module):
    """The noise-prediction UNet: eps = UNet(z_t, t, text)."""

    def __init__(self, cfg: UNetConfig = UNetConfig()):
        super().__init__()
        self.cfg = cfg
        skips = build_encoder(self, cfg)
        rev = tuple(reversed(cfg.block_out_channels))
        per_block = cfg.layers_per_block + 1
        c0 = cfg.block_out_channels[0]
        blocks = []
        prev = rev[0]
        for i, ch in enumerate(rev):
            mine, skips = skips[-per_block:], skips[:-per_block]
            blocks.append(UpBlock(cfg, prev, mine, ch, cfg.up_block_attn[i],
                                  i < len(rev) - 1, c0 * 4))
            prev = ch
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_num_groups, c0,
                                          eps=cfg.norm_eps)
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context, processor=None,
                down_block_residuals: Optional[Sequence[torch.Tensor]] = None,
                mid_block_residual: Optional[torch.Tensor] = None):
        """sample [B,4,h,w], timesteps [B], context [B,T,D] → eps [B,4,h,w]."""
        dtype = self.conv_in.weight.dtype
        x, res, temb = run_encoder(self, self.cfg, sample.to(dtype), timesteps,
                                   context.to(dtype), processor)
        if down_block_residuals is not None:
            res = [r + c for r, c in zip(res, down_block_residuals)]
        if mid_block_residual is not None:
            x = x + mid_block_residual
        per_block = self.cfg.layers_per_block + 1
        for block in self.up_blocks:
            skips, res = res[-per_block:], res[:-per_block]
            x = block(x, skips, temb, context.to(dtype), processor)
        x = F.silu(self.conv_norm_out(x))
        return self.conv_out(x)
