"""Card-only tests of the attention kernels K2 (`flash_attention_t`), K5
(`attention_full`) and K6 (`attention_stream`) against their plain versions.

This file imports no JAX, so it runs on a machine with the card and
PyTorch alone: `python -m pytest -m cuda tests/test_torch_card.py`. Without
a card every test skips; chip_smoke.py makes the same comparisons at the
main path's shapes.
"""

import numpy as np
import pytest
import torch

from gaussctrl_tpu_torch.ops import flash_attention as fa
from gaussctrl_tpu_torch.ops import launch_counts


def _qkv(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_q).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the card run is chip_smoke.py")
    return "cuda"


def _assert_close_to_plain(got, ref):
    """bf16 outputs against the plain version, relative to the output's
    values (as for K2/K3 in test_torch_attention.py): the largest error
    within 2e-2 of the largest |value|, and a relative RMS error within
    1e-2."""
    diff = got.float() - ref.float()
    ref = ref.float()
    assert diff.abs().max().item() <= 2e-2 * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["full", "stream"])
@pytest.mark.parametrize("b,tq,tk,c,heads", [
    (16, 4096, 77, 320, 8),    # text cross-attention, 4096 level
    (2, 512, 64, 1280, 8),     # composed references, 64 level
    (2, 100, 100, 320, 8),     # tails
])
def test_std_kernels_match_plain_on_card(b, tq, tk, c, heads, kernel):
    """K5/K6 on the card against their plain versions, bf16, held relative
    to the output's values as K2/K3 are."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((b, tq, c), (b, tk, c), 37))
    if kernel == "full":
        _assert_close_to_plain(fa.attention_full(q, k, v, heads),
                               fa.attention_plain(q, k, v, heads))
    else:
        _assert_close_to_plain(fa.attention_stream(q, k, v, heads),
                               fa.attention_stream_plain(q, k, v, heads))


@pytest.mark.cuda
def test_std_kernels_read_strided_references_on_card():
    """K5/K6 read one reference of a [G, F, T, C] tensor in place, as the
    grouped reference attention hands it over."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 4 * 64, 320), (2, 4, 64, 320), 41))
    for kernel, plain in ((fa.attention_full, fa.attention_plain),
                          (fa.attention_stream, fa.attention_stream_plain)):
        _assert_close_to_plain(kernel(q, k[:, 1], v[:, 1], 8),
                               plain(q, k[:, 1].contiguous(),
                                     v[:, 1].contiguous(), 8))


@pytest.mark.cuda
def test_stream_kernel_vae_width_on_card():
    """K6 at the SD VAE's mid-block width (one head of 512), bf16."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 1024, 512), (2, 1024, 512), 39))
    before = launch_counts["attention_stream"]
    _assert_close_to_plain(fa.attention_stream(q, k, v, 1),
                           fa.attention_stream_plain(q, k, v, 1))
    assert launch_counts["attention_stream"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("t", [64, 100, 200, 1024])
@pytest.mark.parametrize("d", [16, 32, 40, 80, 160])
def test_flash_kernel_widths_match_plain_on_card(d, t):
    """K2 (the TMA/wgmma core) at every head width it is built for, 8 heads,
    with query and key tails (T = 100, 200) and a half-empty 128-row block
    (T = 64), against attention_plain, bf16."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, t, 8 * d), (2, t, 8 * d), 43 + d + t))
    before = launch_counts["flash_attention_t"]
    _assert_close_to_plain(fa.flash_attention_t(q, k, v, 8),
                           fa.attention_plain(q, k, v, 8))
    assert launch_counts["flash_attention_t"] == before + 1


@pytest.mark.cuda
def test_flash_kernel_4096_tokens_on_card():
    """K2 at the inversion's largest level: B = 2, T = 4096, 8 heads of 40."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 4096, 320), (2, 4096, 320), 47))
    _assert_close_to_plain(fa.flash_attention_t(q, k, v, 8),
                           fa.attention_plain(q, k, v, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [100, 4096])
def test_stream_kernel_wide_matches_plain_on_card(t):
    """K6's wide variant (one head of 512, the VAE mid-block) with a tail
    (T = 100) and at the VAE's 4096 tokens."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, t, 512), (2, t, 512), 53 + t))
    _assert_close_to_plain(fa.attention_stream(q, k, v, 1),
                           fa.attention_stream_plain(q, k, v, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [100, 256])
def test_stream_kernel_strided_references_tq_ne_tk_on_card(t):
    """K6 on the core at width 40 with Tq = 4·T queries against one
    reference's T keys, read in place from a [G, F, T, C] tensor."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 4 * t, 320), (2, 4, t, 320), 59 + t))
    before = launch_counts["attention_stream"]
    _assert_close_to_plain(fa.attention_stream(q, k[:, 2], v[:, 2], 8),
                           fa.attention_stream_plain(q, k[:, 2].contiguous(),
                                                     v[:, 2].contiguous(), 8))
    assert launch_counts["attention_stream"] == before + 1
