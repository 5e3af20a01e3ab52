"""Attention kernels: K2 (inversion lane), K3 (cross-view edit lane), K5
(standard-layout single shot) and K6 (streaming), and `flash_attention`,
which dispatches among K2, K5 and K6.

Counterpart of `gaussctrl_tpu/ops/flash_attention.py`. All four run on one
TMA/wgmma flash core (`csrc/flash_core.cuh`): K2 and K6 in
`csrc/flash_hopper.cu`, K3 in `csrc/cross_view_hopper.cu` and K5 in
`csrc/attention_full_hopper.cu`; each is launched through a wrapper that
keeps the JAX layout `[B, T, C]` (heads side by side in C), so no relayout
copy is made. Beside each wrapper is its plain PyTorch version; the wrapper
takes it only for a tensor on the CPU. On a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import math

import torch

from gaussctrl_tpu_torch.ops import _lib, launch_counts

# keys per block of the streaming plain version (the JAX `_flash_kernel`'s
# block)
_BK = 64
# head widths up to which the transposed single shot (K2) is taken for
# square self-attention; wider heads (the VAE's 512) go on to K5/K6
_K2_MAX_HEAD_DIM = 160
# keys K5 takes: its whole key list is one wgmma key tile
# (csrc/attention_full_hopper.cu); longer key lists go to K6
FULL_MAX_KEYS = 128


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of t's device. The raw query
    (the one PyTorch's compiled kernels use) skips building a Stream object,
    a few microseconds that small launches such as the text
    cross-attention's would otherwise spend on the host."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


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


def attention_stream_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int, block_k: int = _BK) -> torch.Tensor:
    """The same function as `attention_plain`, as an online softmax over
    blocks of `block_k` keys (the JAX `_flash_kernel`): fp32 running max,
    sum and accumulator; each block's weights are rounded to v's dtype
    before the second product."""
    b, tq, c = q.shape
    tk = k.shape[1]
    d = c // heads
    qh = q.reshape(b, tq, heads, d).transpose(1, 2).float()
    kh = k.reshape(b, tk, heads, d).transpose(1, 2).float()
    vh = v.reshape(b, tk, heads, d).transpose(1, 2)
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, heads, tq, 1), -1e30, device=q.device)
    l = torch.zeros((b, heads, tq, 1), device=q.device)
    acc = torch.zeros((b, heads, tq, d), device=q.device)
    for lo in range(0, tk, block_k):
        s = (qh @ kh[:, :, lo:lo + block_k].transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vh[:, :, lo:lo + block_k].float()
        m = m_new
    o = acc / l.clamp_min(1e-30)
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
        k.shape[1], c, heads, _stream(q))
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
        t, c, heads, r, float(self_coeff), _stream(q))
    _lib.check(err, "cross_view_attention")
    launch_counts["cross_view_attention"] += 1
    return out


# padded head widths (round_up(d, 16)) each of K5 and K6 is built for:
# d = 8/16/32 (tiny and nano configs), 40/80/160 (SD-1.5), and for K6 512
# (the SD VAE's mid-block)
_FULL_WIDTHS = (16, 32, 48, 80, 160)
_STREAM_WIDTHS = _FULL_WIDTHS + (512,)


def full_fits(d: int, tk: int) -> bool:
    """Whether K5 takes head width d with tk keys: a width it is built for,
    and at most `FULL_MAX_KEYS` keys (one key tile)."""
    return (d % 8 == 0 and _round_up(d, 16) in _FULL_WIDTHS
            and 0 < tk <= FULL_MAX_KEYS)


def _check_std(name: str, heads: int, widths, q, k, v) -> None:
    """What K5/K6 take: bf16 [B, T, C] on one CUDA device, rows of C
    contiguous elements, q contiguous, k and v with one batch stride (so a
    view such as `kg[:, i]` of a [G, F, T, C] tensor is read in place).
    Called before every launch of the text cross-attention, so it reads
    each property once."""
    dev = q.get_device() if q.is_cuda else None
    for t in (q, k, v):
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"{name}: tensors must all lie on one CUDA device "
                             f"or all on the CPU, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        st = t.stride()
        if (len(st) != 3 or st[2] != 1 or st[1] != t.shape[2] or st[0] % 8
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: the kernel takes [B, T, C] tensors with "
                             f"contiguous rows and 16-byte aligned batches")
    b, _, c = q.shape
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    if (k.shape != v.shape or k.stride() != v.stride() or k.shape[0] != b
            or k.shape[2] != c or c % heads):
        raise ValueError(f"{name}: k and v must be [B, Tk, C] like q with one "
                         f"layout, C splitting into {heads} heads")
    d = c // heads
    if d % 8 or _round_up(d, 16) not in widths:
        raise ValueError(f"{name}: head_dim {d} is not built (multiples of 8 "
                         f"whose 16-padded width is one of {widths})")


def _launch_std(name: str, fn, q, k, v, heads: int) -> torch.Tensor:
    b, tq, c = q.shape
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             q.stride(0), k.stride(0), b, tq, k.shape[1], c, heads,
             _stream(q))
    _lib.check(err, name)
    launch_counts[name] += 1
    return out


def attention_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   heads: int) -> torch.Tensor:
    """K5: single-shot attention with the whole key list (at most
    `FULL_MAX_KEYS`) in one key tile. q [B,Tq,C], k/v [B,Tk,C] → [B,Tq,C].
    CPU tensors take `attention_plain`."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_plain(q, k, v, heads)
    _check_std("attention_full", heads, _FULL_WIDTHS, q, k, v)
    if k.shape[1] > FULL_MAX_KEYS:
        raise ValueError(f"attention_full: {k.shape[1]} keys, over the "
                         f"{FULL_MAX_KEYS} of one key tile; use "
                         f"attention_stream")
    return _launch_std("attention_full", _lib.library().gc_attention_full,
                       q, k, v, heads)


def attention_stream(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     heads: int) -> torch.Tensor:
    """K6: attention as an online softmax over K/V tiles, any Tk.
    q [B,Tq,C], k/v [B,Tk,C] → [B,Tq,C]. CPU tensors take
    `attention_stream_plain`."""
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return attention_stream_plain(q, k, v, heads)
    _check_std("attention_stream", heads, _STREAM_WIDTHS, q, k, v)
    return _launch_std("attention_stream", _lib.library().gc_attention_stream,
                       q, k, v, heads)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int, kernel: str = "auto",
                    is_self: bool | None = None) -> torch.Tensor:
    """Attention q [B,Tq,C], k/v [B,Tk,C] → [B,Tq,C] through one kernel.

    kernel: "full_t" = K2, "full" = K5, "stream" = K6, "auto" = the JAX
    package's rule with the TPU's VMEM budget replaced by K5's capacity:
    square self-attention (Tq == Tk ≤ 4096, `is_self` not False) with a
    head width K2 takes goes to K2; otherwise K5 when it is built for the
    head width and the keys fit its one key tile (`full_fits`), else K6.
    `is_self=False` marks a call that is not self-attention though square
    (the grouped references at one view)."""
    tq, c = q.shape[1], q.shape[2]
    tk = k.shape[1]
    d = c // heads
    if kernel == "full_t" or (kernel == "auto" and tq == tk and tq <= 4096
                              and is_self is not False
                              and d <= _K2_MAX_HEAD_DIM):
        return flash_attention_t(q, k, v, heads)
    if kernel == "full" or (kernel == "auto" and full_fits(d, tk)):
        return attention_full(q, k, v, heads)
    if kernel in ("auto", "stream"):
        return attention_stream(q, k, v, heads)
    raise ValueError(f"flash_attention: unknown kernel {kernel!r}")
