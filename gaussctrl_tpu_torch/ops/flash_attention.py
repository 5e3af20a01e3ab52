"""Attention kernels K2 (inversion lane) and K3 (cross-view edit lane).

Counterpart of `gaussctrl_tpu/ops/flash_attention.py`. Each kernel is CUDA
C++ in `csrc/attention.cu`, launched through a wrapper that keeps the JAX
layout `[B, T, C]` (heads side by side in C), so no relayout copy is made.
Beside each wrapper is its plain PyTorch version; the wrapper takes it only
for a tensor on the CPU. On a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import math

import torch

from gaussctrl_tpu_torch.ops import _lib, launch_counts


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """softmax(q kᵀ/√d) v per batch·head, fp32 scores and softmax; the
    weights are rounded to v's dtype before the second product, as in the
    JAX kernels. q [B,Tq,C], k/v [B,Tk,C] → [B,Tq,C] in q's dtype."""
    b, tq, c = q.shape
    tk = k.shape[1]
    d = c // heads
    qh = q.reshape(b, tq, heads, d).transpose(1, 2).float()
    kh = k.reshape(b, tk, heads, d).transpose(1, 2).float()
    vh = v.reshape(b, tk, heads, d).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = (p.to(v.dtype).float() @ vh.float()) / l.clamp_min(1e-30)
    return o.transpose(1, 2).reshape(b, tq, c).to(q.dtype)


def cross_view_attention_plain(q, k, v, heads: int, num_refs: int = 4,
                               self_coeff: float = 0.6,
                               cfg_groups: int = 2) -> torch.Tensor:
    """The composed 1+r panels (the JAX `CrossViewAttnProcessor` body):
    c·attn(q, k, v) + (1−c)·mean_i attn(q, k_ref_i, v_ref_i), where the refs
    are the first `num_refs` views of each of the `cfg_groups` groups."""
    b, t, c = q.shape
    g, r = cfg_groups, num_refs
    f = b // g
    out = 0.0
    if self_coeff != 0.0:
        out = self_coeff * attention_plain(q, k, v, heads)
    kg = k.reshape(g, f, t, c)
    vg = v.reshape(g, f, t, c)
    ref = 0.0
    for i in range(r):
        kr = kg[:, i:i + 1].expand(g, f, t, c).reshape(b, t, c)
        vr = vg[:, i:i + 1].expand(g, f, t, c).reshape(b, t, c)
        ref = ref + attention_plain(q, kr, vr, heads)
    return out + (1.0 - self_coeff) * (ref / r)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, heads: int, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must all lie on one CUDA device "
                             f"or all on the CPU, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if t.dim() != 3 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes contiguous, 16-byte "
                             f"aligned [B, T, C] tensors")
    c = ts[0].shape[2]
    if any(t.shape[2] != c for t in ts) or c % heads:
        raise ValueError(f"{name}: channel widths differ or do not split "
                         f"into {heads} heads")
    d = c // heads
    if not _lib.library().gc_supported_head_dim(d):
        raise ValueError(f"{name}: head_dim {d} is not built (multiples of 8 "
                         f"whose 16-padded width is 16/32/48/80/160)")


def flash_attention_t(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """K2: attention over one K/V panel. q [B,Tq,C], k/v [B,Tk,C] → [B,Tq,C].

    CPU tensors take `attention_plain`; CUDA tensors launch the kernel."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_plain(q, k, v, heads)
    _check_cuda("flash_attention_t", heads, q, k, v)
    b, tq, c = q.shape
    if k.shape != v.shape or k.shape[0] != b:
        raise ValueError("flash_attention_t: k and v must be [B, Tk, C] like q")
    out = torch.empty_like(q)
    err = _lib.library().gc_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, tq,
        k.shape[1], c, heads, torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(err, "flash_attention_t")
    launch_counts["flash_attention_t"] += 1
    return out


def cross_view_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int, num_refs: int = 4,
                         self_coeff: float = 0.6,
                         cfg_groups: int = 2) -> torch.Tensor:
    """K3: the whole cross-view blend in one launch. q/k/v [B,T,C] with
    B = G·F (G CFG groups of F views; each group's first `num_refs` views
    are its references). CPU tensors take `cross_view_attention_plain`."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return cross_view_attention_plain(q, k, v, heads, num_refs,
                                          self_coeff, cfg_groups)
    _check_cuda("cross_view_attention", heads, q, k, v)
    b, t, c = q.shape
    g, r = cfg_groups, num_refs
    if k.shape != q.shape or v.shape != q.shape or b % g or not 0 < r <= b // g:
        raise ValueError(f"cross_view_attention: shapes {tuple(q.shape)} do "
                         f"not split into {g} groups with {r} refs")
    out = torch.empty_like(q)
    err = _lib.library().gc_cross_view_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), g, b // g,
        t, c, heads, r, float(self_coeff),
        torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(err, "cross_view_attention")
    launch_counts["cross_view_attention"] += 1
    return out
