"""The port's attention (K2, K3 plain versions) against the JAX package.

The JAX kernels run as their own tests run them on the CPU, in Pallas
interpret mode. Inputs are numpy draws from a seed. Kernel-on-card tests skip
without CUDA; chip_smoke.py compares the kernels on the card.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.diffusion.processors import CrossViewAttnProcessor as JCross
from gaussctrl_tpu.ops.flash_attention import (cross_view_attention as j_xview,
                                               flash_attention_t as j_flash_t)

from gaussctrl_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(2)


def _qkv(shape_q, shape_kv, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_q).astype(dtype),
            rng.normal(size=shape_kv).astype(dtype),
            rng.normal(size=shape_kv).astype(dtype))


def _t(x):
    return torch.tensor(np.asarray(x, np.float32))


def _oracle(q, k, v, heads):
    """softmax(q kᵀ/√d) v in float64 numpy."""
    b, tq, c = q.shape
    tk, d = k.shape[1], c // heads
    qh = q.reshape(b, tq, heads, d).astype(np.float64)
    kh = k.reshape(b, tk, heads, d).astype(np.float64)
    vh = v.reshape(b, tk, heads, d).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(d)
    s = np.exp(s - s.max(-1, keepdims=True))
    w = s / s.sum(-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", w, vh).reshape(b, tq, c)


@pytest.mark.parametrize("b,tq,tk,c,heads", [
    (2, 64, 64, 16, 2),        # tiny (padding path)
    (1, 300, 300, 32, 4),      # non-multiple T (tail masking)
    (2, 64, 128, 16, 2),       # Tq != Tk
    (2, 256, 256, 80, 2),      # head_dim 40, the SD-1.5 4096-level width
])
def test_flash_plain_matches_jax_flash_t(b, tq, tk, c, heads):
    """Plain K2 against JAX flash_attention_t (interpret) and a float64
    oracle: atol/rtol 2e-5, the JAX test's tolerance."""
    q, k, v = _qkv((b, tq, c), (b, tk, c), 3)
    ref = j_flash_t(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                    block_q=128, interpret=True)
    got = fa.attention_plain(_t(q), _t(k), _t(v), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, heads),
                               atol=2e-5, rtol=2e-5)
    # the wrapper takes the plain version on CPU tensors
    assert torch.equal(fa.flash_attention_t(_t(q), _t(k), _t(v), heads), got)


def test_flash_plain_bf16_matches_jax_flash_t():
    """bfloat16 inputs: both round the softmax weights to bf16 before the
    second product; atol 2e-2 covers bf16 output rounding."""
    q, k, v = _qkv((2, 128, 80), (2, 128, 80), 5)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    ref = j_flash_t(*jb, 2, block_q=128, interpret=True)
    tb = [torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)]
    got = fa.attention_plain(*tb, 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=2e-2)


XVIEW_SHAPES = [
    (2, 4, 64, 16, 2, 2),      # CFG-doubled tiny
    (1, 3, 100, 32, 4, 2),     # no CFG, non-multiple T
    (2, 5, 128, 80, 2, 4),     # head_dim 40, 4 refs — the SD shape
]


@pytest.mark.parametrize("self_coeff", [0.6, 0.0])
@pytest.mark.parametrize("g,f,t,c,heads,r", XVIEW_SHAPES)
def test_cross_view_plain_matches_jax_fused(g, f, t, c, heads, r, self_coeff):
    """Plain K3 (composed 1+r panels) against the JAX fused kernel in
    interpret mode at tests/test_flash_attention.py's shapes; atol/rtol
    3e-5, that test's tolerance."""
    b = g * f
    q, k, v = _qkv((b, t, c), (b, t, c), 7)
    ref = j_xview(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                  num_refs=r, self_coeff=self_coeff, cfg_groups=g, block_q=64,
                  interpret=True)
    got = fa.cross_view_attention_plain(_t(q), _t(k), _t(v), heads, r,
                                        self_coeff, g)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("self_coeff", [0.6, 0.0])
def test_cross_view_plain_t100_matches_composed_oracle(self_coeff):
    """t = 100 with CFG groups against the composed oracle (the JAX
    processor's einsum path and a float64 composition), not the JAX fused
    kernel, whose q tail handling depends on its block size."""
    g, f, t, c, heads, r = 2, 8, 100, 64, 2, 4
    b = g * f
    q, k, v = _qkv((b, t, c), (b, t, c), 11)
    ref = JCross(r, self_coeff, g, allow_fused=False)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    kg, vg = k.reshape(g, f, t, c), v.reshape(g, f, t, c)
    o64 = self_coeff * _oracle(q, k, v, heads) if self_coeff else 0.0
    acc = 0.0
    for i in range(r):
        kr = np.broadcast_to(kg[:, i:i + 1], (g, f, t, c)).reshape(b, t, c)
        vr = np.broadcast_to(vg[:, i:i + 1], (g, f, t, c)).reshape(b, t, c)
        acc = acc + _oracle(q, kr, vr, heads)
    o64 = o64 + (1 - self_coeff) * acc / r
    got = fa.cross_view_attention(_t(q), _t(k), _t(v), heads, r, self_coeff, g)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=3e-5)
    np.testing.assert_allclose(got.numpy(), o64, atol=3e-5, rtol=3e-5)


def _assert_close_to_plain(got, ref):
    """bf16 outputs against the plain version, relative to the level's
    values (their std falls from ~1 at T = 64 to ~0.02 at T = 4096): the
    largest error within 2e-2 of the largest |value|, and a relative RMS
    error within 1e-2."""
    diff = got.float() - ref.float()
    ref = ref.float()
    assert diff.abs().max().item() <= 2e-2 * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= 1e-2


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the card run is chip_smoke.py")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("t,c", [(4096, 320), (1024, 640), (256, 1280),
                                 (64, 1280), (100, 320)])
def test_flash_kernel_matches_plain_on_card(t, c):
    """K2 on the card against its plain version, bf16 inputs, held
    relative to the level's values."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, t, c), (2, t, c), 13))
    _assert_close_to_plain(fa.flash_attention_t(q, k, v, 8),
                           fa.attention_plain(q, k, v, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("self_coeff", [0.6, 0.0])
@pytest.mark.parametrize("t,c", [(1024, 640), (100, 320)])
def test_cross_view_kernel_matches_plain_on_card(t, c, self_coeff):
    """K3 on the card against its plain version, bf16 inputs, held
    relative to the level's values."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((16, t, c), (16, t, c), 17))
    _assert_close_to_plain(fa.cross_view_attention(q, k, v, 8, 4, self_coeff, 2),
                           fa.cross_view_attention_plain(q, k, v, 8, 4,
                                                         self_coeff, 2))
