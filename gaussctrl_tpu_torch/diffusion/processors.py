"""Attention processors: the inversion lane's and the cross-view edit lane's.

Counterpart of `gaussctrl_tpu/diffusion/processors.py`. Every UNet and
ControlNet self-attention goes through a kernel: the inversion lane through
K2 (`FlashSelfAttnProcessor`), the edit lane through K3
(`CrossViewAttnProcessor`) at every token level. The JAX package's routing
gates and A/B switches rest on TPU measurements and are not carried over;
on the CPU the kernel wrappers take their plain versions.

    out = c · selfattn(q, k, v) + (1 − c) · mean_r attn(q, k_ref[r], v_ref[r])

with c = 0.6 on the UNet and 0 on the ControlNet. Batch layout B = G · F:
G CFG groups ([uncond | cond] when guided), F views per group, the first
`num_refs` of which are the reference views.
"""

from __future__ import annotations

import dataclasses

from gaussctrl_tpu_torch.ops.flash_attention import (cross_view_attention,
                                                     flash_attention_t)


@dataclasses.dataclass(frozen=True)
class FlashSelfAttnProcessor:
    """Plain self-attention through kernel K2."""

    def __call__(self, q, k, v, heads):
        return flash_attention_t(q, k, v, heads)


@dataclasses.dataclass(frozen=True)
class CrossViewAttnProcessor:
    """The cross-view blend through kernel K3."""
    num_refs: int = 4
    self_attn_coeff: float = 0.6   # 0.6 UNet / 0.0 ControlNet
    cfg_groups: int = 2            # 2 when CFG-doubled, 1 otherwise

    def __call__(self, q, k, v, heads):
        b = q.shape[0]
        assert b % self.cfg_groups == 0 and self.num_refs <= b // self.cfg_groups, (
            b, self.cfg_groups, self.num_refs)
        return cross_view_attention(q, k, v, heads, self.num_refs,
                                    self.self_attn_coeff, self.cfg_groups)
