"""Depth ControlNet (torch.nn, NCHW).

Counterpart of `gaussctrl_tpu/diffusion/controlnet.py`: a copy of the UNet
encoder, a stride-2 conv ladder embedding the 3-channel disparity hint down
to the latent resolution, and zero-initialised 1×1 convs emitting a residual
for every UNet skip and the mid block. Parameter names are the diffusers keys
(`controlnet_cond_embedding.blocks.0`, `controlnet_down_blocks.3`, …).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gaussctrl_tpu_torch.diffusion.config import ControlNetConfig
from gaussctrl_tpu_torch.diffusion.unet import build_encoder, run_encoder


class CondEmbedding(nn.Module):
    """Hint image → conv_in-resolution feature map (stride-2 ladder)."""

    def __init__(self, cfg: ControlNetConfig):
        super().__init__()
        chans = cfg.cond_embed_channels
        self.conv_in = nn.Conv2d(3, chans[0], 3, padding=1)
        blocks = []
        for i in range(len(chans) - 1):
            blocks.append(nn.Conv2d(chans[i], chans[i], 3, padding=1))
            blocks.append(nn.Conv2d(chans[i], chans[i + 1], 3, stride=2,
                                    padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(chans[-1], cfg.unet.block_out_channels[0],
                                  3, padding=1)

    def forward(self, cond):
        x = F.silu(self.conv_in(cond))
        for block in self.blocks:
            x = F.silu(block(x))
        return self.conv_out(x)


class ControlNet(nn.Module):
    def __init__(self, cfg: ControlNetConfig = ControlNetConfig()):
        super().__init__()
        self.cfg = cfg
        skips = build_encoder(self, cfg.unet)
        self.controlnet_cond_embedding = CondEmbedding(cfg)
        self.controlnet_down_blocks = nn.ModuleList(
            [nn.Conv2d(ch, ch, 1) for ch in skips])
        mid = cfg.unet.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(mid, mid, 1)

    def forward(self, sample, timesteps, context, cond_image=None,
                conditioning_scale: float = 1.0, processor=None, hint=None):
        """sample [B,4,h,w], hint = `embed_hint` output (or `cond_image`
        [B,3,H,W] to embed here) → (down residuals, mid residual)."""
        dtype = self.conv_in.weight.dtype
        if hint is None:
            hint = self.controlnet_cond_embedding(cond_image.to(dtype))
        mid, res, _ = run_encoder(self, self.cfg.unet, sample.to(dtype),
                                  timesteps, context.to(dtype), processor,
                                  extra_in=hint.to(dtype))
        down = tuple(conv(r) * conditioning_scale
                     for conv, r in zip(self.controlnet_down_blocks, res))
        return down, self.controlnet_mid_block(mid) * conditioning_scale


def zero_init_convs(model: ControlNet) -> None:
    """Zero the ControlNet's output convs, as its initialisation does."""
    convs = [model.controlnet_cond_embedding.conv_out,
             model.controlnet_mid_block, *model.controlnet_down_blocks]
    with torch.no_grad():
        for conv in convs:
            conv.weight.zero_()
            conv.bias.zero_()
