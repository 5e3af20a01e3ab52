"""The port's standard-layout attention (K5 `attention_full`, K6
`attention_stream`, the `flash_attention` dispatch), the q-blocked plain
path of `nn.attention`, and the composed cross-view route against the JAX
package.

The JAX kernels run as their own tests run them on the CPU, in Pallas
interpret mode; the port's wrappers take their plain versions on CPU
tensors. Inputs are numpy draws from a seed. The kernels' card tests are
in tests/test_torch_card.py, which imports no JAX; chip_smoke.py compares
the kernels on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu.diffusion import nn as jnn
from gaussctrl_tpu.diffusion import processors as jproc
from gaussctrl_tpu.ops.flash_attention import flash_attention as j_flash

from gaussctrl_tpu_torch.diffusion import nn as tnn
from gaussctrl_tpu_torch.diffusion import processors as tproc
from gaussctrl_tpu_torch.ops import flash_attention as fa

from test_torch_attention import _oracle, _qkv, _t

torch.set_num_threads(2)

# tests/test_flash_attention.py's shapes, a single-head d = 32 case shaped
# like the VAE mid-block, and a text cross-attention case (Tk = 77)
STD_SHAPES = [
    (2, 64, 64, 16, 2),        # tiny, blocks > T (padding path)
    (1, 300, 300, 32, 4),      # non-multiple T (tail masking)
    (2, 64, 128, 16, 2),       # cross-attention Tq != Tk
    (1, 256, 256, 32, 1),      # one head, VAE-like
    (2, 100, 77, 32, 2),       # text cross-attention: Tk = 77
]


@pytest.mark.parametrize("kernel", ["full", "stream"])
@pytest.mark.parametrize("b,tq,tk,c,heads", STD_SHAPES)
def test_std_kernels_match_jax(b, tq, tk, c, heads, kernel):
    """flash_attention(kernel=full|stream) on the CPU against the JAX
    flash_attention in interpret mode with the same kernel, and a float64
    oracle: atol/rtol 2e-5 in float32, the JAX test's tolerance. The
    wrapper is its plain version on CPU tensors."""
    q, k, v = _qkv((b, tq, c), (b, tk, c), 21)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                  block_q=64, block_k=128, interpret=True, kernel=kernel)
    got = fa.flash_attention(_t(q), _t(k), _t(v), heads, kernel=kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, heads),
                               atol=2e-5, rtol=2e-5)
    plain = fa.attention_plain if kernel == "full" else fa.attention_stream_plain
    assert torch.equal(got, plain(_t(q), _t(k), _t(v), heads))


@pytest.mark.parametrize("kernel", ["full", "stream"])
def test_std_kernels_bf16_match_jax(kernel):
    """bfloat16 inputs: both sides round the softmax weights to bf16 before
    the second product (the stream kernels per K/V block, of 128 keys in
    JAX and 64 in the port); atol 2e-2 covers bf16 output rounding."""
    q, k, v = _qkv((2, 96, 80), (2, 200, 80), 23)
    ref = j_flash(*[jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)], 2,
                  block_q=64, block_k=128, interpret=True, kernel=kernel)
    got = fa.flash_attention(*[torch.tensor(x).to(torch.bfloat16)
                               for x in (q, k, v)], 2, kernel=kernel)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=2e-2)


@pytest.mark.parametrize("block_k", [16, 64, 1000])
def test_stream_plain_is_exact_softmax_at_any_block(block_k):
    """The online softmax gives the same result whatever its block size
    (float32, against the float64 oracle at 2e-5)."""
    q, k, v = _qkv((2, 50, 32), (2, 130, 32), 25)
    got = fa.attention_stream_plain(_t(q), _t(k), _t(v), 2, block_k=block_k)
    np.testing.assert_allclose(got.numpy(), _oracle(q, k, v, 2),
                               atol=2e-5, rtol=2e-5)


# (B, Tq, Tk, C, heads, is_self, the kernel `auto` picks): the main path's
# shapes at SD-1.5 widths and the tiny config's
ROUTES = [
    (2, 4096, 4096, 320, 8, None, "flash_attention_t"),   # inversion self
    (2, 64, 64, 1280, 8, None, "flash_attention_t"),      # composed self, 64
    (2, 64, 64, 32, 1, None, "flash_attention_t"),        # tiny VAE mid-block
    (2, 64, 64, 1280, 8, False, "attention_full"),        # refs at one view
    (2, 4096, 77, 320, 8, None, "attention_full"),        # text cross-attn
    (2, 64, 77, 1280, 8, None, "attention_full"),         # text cross-attn, 64
    (2, 8 * 64, 64, 1280, 8, False, "attention_full"),    # composed refs, 64
    (2, 8 * 256, 256, 1280, 8, False, "attention_stream"),  # refs at 256
    (2, 8 * 4096, 4096, 320, 8, False, "attention_stream"),  # refs at 4096
    (2, 4096, 4096, 512, 1, None, "attention_stream"),    # SD VAE mid-block
]


@pytest.mark.parametrize("b,tq,tk,c,heads,is_self,want", ROUTES)
def test_auto_dispatch(monkeypatch, b, tq, tk, c, heads, is_self, want):
    """`auto` takes K2 for square self-attention with a head width K2
    takes, else K5 when its panel and K/V fit 227 KB, else K6 (meta tensors:
    only the route is computed)."""
    seen = []
    for name in ("flash_attention_t", "attention_full", "attention_stream"):
        monkeypatch.setattr(fa, name,
                            lambda *a, _n=name, **kw: seen.append(_n))
    q = torch.empty((b, tq, c), device="meta")
    kv = torch.empty((b, tk, c), device="meta")
    fa.flash_attention(q, kv, kv, heads, is_self=is_self)
    assert seen == [want]


def test_full_fits_bounds_the_panel():
    """K5 takes at most one key tile of FULL_MAX_KEYS = 128 keys at every
    width it is built for: the 64-token references and the text fit, as
    ROUTES assumes; the 256-token references do not at any width (at d = 40
    they did under the old shared-memory panel rule); d = 512 is not a K5
    width at any Tk."""
    assert fa.full_fits(160, 64) and fa.full_fits(160, 77)
    assert fa.full_fits(160, fa.FULL_MAX_KEYS) and fa.full_fits(16, 1)
    assert not fa.full_fits(160, fa.FULL_MAX_KEYS + 1)
    assert not fa.full_fits(40, 256) and not fa.full_fits(160, 256)
    assert fa.FULL_MAX_KEYS == 128
    assert not fa.full_fits(512, 16)


@pytest.mark.parametrize("tq,tk,q_block", [
    (256, 256, 64),    # even split
    (300, 256, 64),    # a shorter last block
    (256, 128, 512),   # block >= Tq: the plain path
    (300, 256, None),  # the budget's block choice (budget_mb below)
])
def test_qblocked_matches_jax(tq, tk, q_block):
    """attention_einsum_qblocked against the JAX function with the same
    block (or the same budget, 0.5 MB: blocks of 128 here). Each block sees
    all of K, so it is exact against the port's unblocked plain version
    (atol/rtol 1e-6, test_qblocked_einsum_exact's); against XLA's float32
    products 2e-5, the cross-package tolerance of the kernels' tests."""
    q, k, v = _qkv((3, tq, 40), (3, tk, 40), 27)
    ref = jnn.attention_einsum_qblocked(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), 2, budget_mb=0.5,
                                        q_block=q_block)
    got = tnn.attention_einsum_qblocked(_t(q), _t(k), _t(v), 2, budget_mb=0.5,
                                        q_block=q_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), fa.attention_plain(_t(q), _t(k), _t(v), 2),
                               atol=1e-6, rtol=1e-6)


def test_attention_routes_qblocked_over_budget(monkeypatch):
    """nn.attention on the CPU takes the q-blocked path when the fp32 scores
    pass the budget, as the JAX attention does under GAUSSCTRL_SCORES_MB,
    and agrees with it (2e-5, across packages) and with the port's
    unblocked plain version (1e-6); under the budget it is the plain
    version."""
    q, _, _ = _qkv((2, 512, 32), (2, 512, 32), 29)
    monkeypatch.setenv("GAUSSCTRL_SCORES_MB", "1")
    ref = jnn.attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), 4)
    # 2·4·512·512·4 B = 8 MB of scores; a budget of 1 MB forces blocking
    called = []
    orig = tnn.attention_einsum_qblocked
    monkeypatch.setattr(tnn, "attention_einsum_qblocked",
                        lambda *a, **kw: called.append(kw) or orig(*a, **kw))
    monkeypatch.setattr(tnn, "_SCORES_BUDGET_MB", 1.0)
    got = tnn.attention(_t(q), _t(q), _t(q), 4)
    assert called == [dict(budget_mb=1.0)]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got.numpy(), fa.attention_plain(_t(q), _t(q), _t(q), 4),
                               atol=1e-6, rtol=1e-6)
    monkeypatch.setattr(tnn, "_SCORES_BUDGET_MB", 2048.0)
    assert torch.equal(tnn.attention(_t(q), _t(q), _t(q), 4),
                       fa.attention_plain(_t(q), _t(q), _t(q), 4))
    assert len(called) == 1


@pytest.mark.parametrize("kernel", ["full", "stream"])
@pytest.mark.parametrize("g,f,t,c,heads,r", [
    (2, 4, 64, 16, 2, 2),      # CFG-doubled tiny
    (1, 3, 100, 32, 4, 2),     # no CFG, non-multiple T
])
def test_grouped_ref_attention_matches_jax(g, f, t, c, heads, r, kernel):
    """_grouped_ref_attention with an explicit flash_fn on both sides (the
    JAX one in interpret mode), float32: atol/rtol 3e-5, the JAX composed-
    route tests' tolerance."""
    b = g * f
    q, k, v = _qkv((b, t, c), (b, t, c), 31)
    kg, vg = k.reshape(g, f, t, c), v.reshape(g, f, t, c)
    jfn = functools.partial(j_flash, block_q=64, block_k=128, interpret=True,
                            kernel=kernel, is_self=False)
    ref = jproc._grouped_ref_attention(jnp.asarray(q), jnp.asarray(kg),
                                       jnp.asarray(vg), r, heads, flash_fn=jfn)
    tfn = functools.partial(fa.flash_attention, kernel=kernel, is_self=False)
    got = tproc._grouped_ref_attention(_t(q), _t(kg), _t(vg), r, heads,
                                       flash_fn=tfn)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=3e-5)
    # the default flash_fn (auto) computes the same function
    np.testing.assert_allclose(
        tproc._grouped_ref_attention(_t(q), _t(kg), _t(vg), r, heads).numpy(),
        np.asarray(ref), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("self_coeff", [0.6, 0.0])
@pytest.mark.parametrize("g,f,t,c,heads,r", [
    (2, 4, 64, 16, 2, 2),      # CFG-doubled tiny
    (1, 3, 100, 32, 4, 2),     # no CFG, non-multiple T
    (2, 5, 256, 80, 2, 4),     # head_dim 40, 4 refs, a fused level
])
def test_composed_processor_matches_jax(g, f, t, c, heads, r, self_coeff):
    """CrossViewAttnProcessor(allow_fused=False) against the JAX processor
    with allow_fused=False, float32: atol/rtol 3e-5."""
    b = g * f
    q, k, v = _qkv((b, t, c), (b, t, c), 33)
    ref = jproc.CrossViewAttnProcessor(r, self_coeff, g, allow_fused=False)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    got = tproc.CrossViewAttnProcessor(r, self_coeff, g, allow_fused=False)(
        _t(q), _t(k), _t(v), heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("t,allow_fused,want", [
    (256, True, ["cross_view_attention"]),
    (64, True, ["flash_attention_t", "attention_full", "attention_full"]),
    (256, False, ["flash_attention_t", "attention_stream", "attention_stream"]),
])
def test_cross_view_routes(monkeypatch, t, allow_fused, want):
    """The fused kernel K3 takes the levels of _XVIEW_FUSED_DEFAULT; other
    levels, and every level under allow_fused=False, take the composed
    route: the self branch through K2 and one call per reference view (K5
    where the view's keys fit its one key tile, at 64 tokens; K6 at 256)."""
    seen = []

    def spy(mod, name):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name,
                            lambda *a, **kw: seen.append(name) or fn(*a, **kw))

    spy(tproc, "cross_view_attention")
    for name in ("flash_attention_t", "attention_full", "attention_stream"):
        spy(fa, name)
    q, k, v = (_t(x) for x in _qkv((8, t, 32), (8, t, 32), 35))
    tproc.CrossViewAttnProcessor(2, 0.6, 2, allow_fused=allow_fused)(q, k, v, 2)
    assert seen == want
