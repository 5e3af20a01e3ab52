"""Card-only tests of the attention kernels K2 (`flash_attention_t`), K3
(`cross_view_attention`), K5 (`attention_full`) and K6 (`attention_stream`)
against their plain versions.

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


# (G, F, r, c): CFG-doubled with the edit's four references and the UNet's
# c, the same with the ControlNet's c = 0, and one group with one reference
# under either c
_XVIEW_CASES = [(2, 5, 4, 0.6), (2, 5, 4, 0.0), (1, 3, 1, 0.6), (1, 3, 1, 0.0)]


def _check_cross_view(d, t, g, f, r, coeff, seed):
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((g * f, t, 8 * d), (g * f, t, 8 * d), seed))
    before = launch_counts["cross_view_attention"]
    _assert_close_to_plain(fa.cross_view_attention(q, k, v, 8, r, coeff, g),
                           fa.cross_view_attention_plain(q, k, v, 8, r, coeff, g))
    assert launch_counts["cross_view_attention"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("g,f,r,coeff", _XVIEW_CASES)
@pytest.mark.parametrize("t", [64, 100, 256, 1024])
@pytest.mark.parametrize("d", [16, 32, 40, 80, 160])
def test_cross_view_kernel_widths_match_plain_on_card(d, t, g, f, r, coeff):
    """K3 at every head width it is built for, 8 heads, with a query and key
    tail (T = 100), against cross_view_attention_plain, bf16."""
    _check_cross_view(d, t, g, f, r, coeff, 61 + d + t)


@pytest.mark.cuda
@pytest.mark.parametrize("g,f,r,coeff", _XVIEW_CASES)
def test_cross_view_kernel_4096_tokens_on_card(g, f, r, coeff):
    """K3 at the edit's largest level: T = 4096, 8 heads of 40."""
    _check_cross_view(40, 4096, g, f, r, coeff, 67)


@pytest.mark.cuda
@pytest.mark.parametrize("tk", [1, 16, 64, 77, 100, fa.FULL_MAX_KEYS])
@pytest.mark.parametrize("d", [16, 40, 80, 160])
def test_full_kernel_key_counts_match_plain_on_card(d, tk):
    """K5 at key counts up to its one key tile (the padded and masked key
    tail), 8 heads, 300 queries (a query tail), k and v strided references
    of a [G, F, Tk, C] tensor, against attention_plain, bf16."""
    dev = _card()
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 300, 8 * d), (2, 3, tk, 8 * d), 71 + d + tk))
    before = launch_counts["attention_full"]
    _assert_close_to_plain(fa.attention_full(q, k[:, 1], v[:, 1], 8),
                           fa.attention_plain(q, k[:, 1].contiguous(),
                                              v[:, 1].contiguous(), 8))
    assert launch_counts["attention_full"] == before + 1


@pytest.mark.cuda
def test_full_kernel_refuses_keys_past_one_tile_on_card():
    """K5 raises for more keys than one key tile, launching nothing; auto
    dispatch sends such a call to K6."""
    dev = _card()
    tk = fa.FULL_MAX_KEYS + 1
    q, k, v = (torch.tensor(x).to(dev, torch.bfloat16)
               for x in _qkv((2, 64, 320), (2, tk, 320), 73))
    before = dict(launch_counts)
    with pytest.raises(ValueError, match="key tile"):
        fa.attention_full(q, k, v, 8)
    assert launch_counts == before
    _assert_close_to_plain(fa.flash_attention(q, k, v, 8),
                           fa.attention_stream_plain(q, k, v, 8))
    assert launch_counts["attention_stream"] == before["attention_stream"] + 1
