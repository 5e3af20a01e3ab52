"""Shared diffusion building blocks (torch.nn, NCHW).

Counterpart of `gaussctrl_tpu/diffusion/nn.py`. Module and parameter names
follow the diffusers checkpoint keys (`attn1.to_q`, `ff.net.0.proj`,
`resnets.0.conv1`, …), so a diffusers-layout state dict loads with
`load_state_dict`, and `bridge.py` maps the JAX package's flax trees onto
the same names. Numerics follow the JAX modules, not diffusers' defaults:
LayerNorm eps 1e-6 in the transformer block, GroupNorm eps 1e-6 in
Transformer2D, tanh-approximate GELU in GEGLU.

The self-attention processor is a forward argument threaded through the
module tree, as in the JAX package: `processor(q, k, v, heads)` maps the
projected q/k/v [B, T, C] to the attention output. Text cross-attention and
any layer given no processor take the plain attention below.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gaussctrl_tpu_torch.ops.flash_attention import attention_plain

AttnProcessor = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int],
                         torch.Tensor]


def attention(q, k, v, heads: int) -> torch.Tensor:
    """Multi-head softmax attention, fp32 scores and softmax (the JAX
    package's einsum path). q [B,Tq,C], k/v [B,Tk,C]."""
    return attention_plain(q, k, v, heads)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding. t [B] → [B, dim] (float32)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / (half - freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, emb):
        return self.linear_2(F.silu(self.linear_1(emb)))


class Attention(nn.Module):
    """QKV attention; self-attention layers accept a processor override."""

    def __init__(self, query_dim: int, heads: int,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.heads = heads
        self.is_self = context_dim is None
        kv_dim = query_dim if context_dim is None else context_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_v = nn.Linear(kv_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x, context=None, processor: Optional[AttnProcessor] = None):
        ctx = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(ctx), self.to_v(ctx)
        if self.is_self and processor is not None:
            out = processor(q, k, v, self.heads)
        else:
            out = attention(q, k, v, self.heads)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class BasicTransformerBlock(nn.Module):
    """self-attn → text cross-attn → GEGLU MLP, pre-LN residuals."""

    def __init__(self, dim: int, heads: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, heads, context_dim=context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, context, processor=None):
        x = x + self.attn1(self.norm1(x), processor=processor)
        x = x + self.attn2(self.norm2(x), context=context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GroupNorm → 1×1 in-proj → transformer blocks over HW tokens → 1×1 out."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 num_layers: int = 1, norm_num_groups: int = 32):
        super().__init__()
        self.norm = nn.GroupNorm(norm_num_groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, context_dim)
             for _ in range(num_layers)])
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context, processor=None):
        b, c, h, w = x.shape
        residual = x
        x = self.proj_in(self.norm(x))
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, context, processor)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(x) + residual


class ResnetBlock(nn.Module):
    """GN-silu-conv ×2 with an additive time embedding and a 1×1 shortcut."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm_num_groups: int = 32, norm_eps: float = 1e-5,
                 temb_channels: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.GroupNorm(norm_num_groups, in_channels, eps=norm_eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = nn.GroupNorm(norm_num_groups, out_channels, eps=norm_eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        residual = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return residual + h


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))
