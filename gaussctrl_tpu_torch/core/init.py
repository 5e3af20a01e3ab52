"""Seeded random weights for networks that have no checkpoint on disk.

Linear and convolution weights are drawn as lecun-normal (standard deviation
1/sqrt(fan_in)), their biases are zero, norms are the identity, and every
other parameter or persistent float buffer is drawn N(0, std²) with `std`
looked up by the last part of its name in `raw_std` (`default` otherwise).
The draws come from one explicit `torch.Generator` on the module's device,
so they differ from the JAX package's `jax.random` draws: parity between
the packages goes through carried weights, not through seeds.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

_AFFINE = (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)
_NORMS = (nn.LayerNorm, nn.GroupNorm)


@torch.no_grad()
def random_init_(module: nn.Module, seed: int,
                 raw_std: Optional[Dict[str, float]] = None,
                 default: float = 0.02) -> nn.Module:
    """Fill `module`'s parameters and float buffers in place; returns it."""
    raw_std = raw_std or {}
    dev = next(module.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    owned = set()
    for mod in module.modules():
        if isinstance(mod, _AFFINE):
            w = mod.weight
            fan_in = (w.shape[0] * w[0, 0].numel()
                      if isinstance(mod, nn.ConvTranspose2d) else w[0].numel())
            w.copy_(torch.randn(w.shape, generator=g, device=dev)
                    / math.sqrt(fan_in))
            owned.add(id(w))
            if mod.bias is not None:
                mod.bias.zero_()
                owned.add(id(mod.bias))
        elif isinstance(mod, _NORMS) and mod.weight is not None:
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            owned.update((id(mod.weight), id(mod.bias)))
    tensors = list(module.named_parameters()) + [
        (n, b) for n, b in module.named_buffers() if b.is_floating_point()]
    for name, t in tensors:
        if id(t) in owned:
            continue
        # an Embedding's `weight` is named by its module (indices skipped)
        parts = [p for p in name.split(".") if not p.isdigit()]
        leaf = parts[-2] if parts[-1] == "weight" and len(parts) > 1 \
            else parts[-1]
        std = raw_std.get(leaf, default)
        t.copy_(torch.randn(t.shape, generator=g, device=dev) * std)
    return module
