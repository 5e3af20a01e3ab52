"""Attention processors: the inversion lane's and the cross-view edit lane's.

Counterpart of `gaussctrl_tpu/diffusion/processors.py`. Every UNet and
ControlNet self-attention goes through a kernel: the inversion lane through
K2 (`FlashSelfAttnProcessor`), the edit lane (`CrossViewAttnProcessor`)
through the fused K3 at the token levels of `_XVIEW_FUSED_DEFAULT`, and
elsewhere, or with `allow_fused=False`, through the composed route: the
self branch through `flash_attention` (K2) and the references through
`_grouped_ref_attention` (K5, or K6 where the keys pass K5's one key
tile). The JAX package's environment switches are not carried over; on the
CPU the kernel wrappers take their plain versions.

    out = c · selfattn(q, k, v) + (1 − c) · mean_r attn(q, k_ref[r], v_ref[r])

with c = 0.6 on the UNet and 0 on the ControlNet. Batch layout B = G · F:
G CFG groups ([uncond | cond] when guided), F views per group, the first
`num_refs` of which are the reference views.
"""

from __future__ import annotations

import dataclasses
import functools

from gaussctrl_tpu_torch.ops.flash_attention import (cross_view_attention,
                                                     flash_attention)

# token levels whose cross-view layers take the fused kernel K3; the JAX
# package's set, kept until the card's own measurements set it
_XVIEW_FUSED_DEFAULT = "4096,1024,256"


def _grouped_ref_attention(q, kg, vg, r: int, heads: int, flash_fn=None):
    """Σ_i attn(q, k_ref_i, v_ref_i) with the view axis folded into the
    query length: one call per reference, F·T queries against its T keys.
    q [B,T,C]; kg/vg [G,F,T,C]. `flash_fn(q, k, v, heads)` defaults to
    `flash_attention` with `is_self=False`."""
    if flash_fn is None:
        flash_fn = functools.partial(flash_attention, kernel="auto",
                                     is_self=False)
    b, t, c = q.shape
    g, f = kg.shape[0], kg.shape[1]
    qg = q.reshape(g, f * t, c)
    acc = 0.0
    for i in range(r):
        acc = acc + flash_fn(qg, kg[:, i], vg[:, i], heads)
    return acc.reshape(b, t, c)


@dataclasses.dataclass(frozen=True)
class FlashSelfAttnProcessor:
    """Plain self-attention through `flash_attention` (default K2)."""
    kernel: str = "full_t"

    def __call__(self, q, k, v, heads):
        return flash_attention(q, k, v, heads, kernel=self.kernel)


@dataclasses.dataclass(frozen=True)
class CrossViewAttnProcessor:
    """The cross-view blend: fused (K3) or composed (K2 + K5/K6)."""
    num_refs: int = 4
    self_attn_coeff: float = 0.6   # 0.6 UNet / 0.0 ControlNet
    cfg_groups: int = 2            # 2 when CFG-doubled, 1 otherwise
    allow_fused: bool = True       # False: the composed route at every level

    def __call__(self, q, k, v, heads):
        b, t, c = q.shape
        g, r = self.cfg_groups, self.num_refs
        f = b // g
        assert b % g == 0 and r <= f, (b, g, r)
        if self.allow_fused and str(t) in _XVIEW_FUSED_DEFAULT.split(","):
            return cross_view_attention(q, k, v, heads, r,
                                        self.self_attn_coeff, g)
        out = 0.0
        if self.self_attn_coeff != 0.0:
            out = self.self_attn_coeff * flash_attention(q, k, v, heads)
        ref = _grouped_ref_attention(q, k.reshape(g, f, t, c),
                                     v.reshape(g, f, t, c), r, heads)
        return out + (1.0 - self.self_attn_coeff) * (ref / r)
