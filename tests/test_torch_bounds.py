"""The bound arithmetic of chip_smoke.py's kernel report, pinned on the CPU.

A kernel's bound is the largest of its tensor-core operations over the
bf16 peak, its bytes over the memory rate and its exponentials over the
SFUs' rate. Attention takes one exponential per score, so at head width 40
the exponentials, not the products, set the floor.
"""

import importlib.util
import os

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


def test_inversion_level_4096_is_bound_by_exponentials():
    """K2 at B = 8, T = 4096, 8 heads of 40: 1.07e9 exponentials at 3.9e12
    a second (≈ 0.275 ms) over 1.72e11 FLOP at 989 TFLOP/s (≈ 0.174 ms)."""
    rec = chip_smoke.attention_bound(8, 8, 4096, 4096, 40)
    assert rec["bound_by"] == "exponentials"
    assert rec["bound_ms"] == pytest.approx(8 * 8 * 4096**2 / 3.9e12 * 1e3)
    assert rec["bound_ms"] == pytest.approx(0.2753, abs=1e-4)
    assert rec["exp_ms"] == rec["bound_ms"]
    assert rec["ops_ms"] == pytest.approx(0.1737, abs=1e-4)
    assert rec["bytes_ms"] < rec["ops_ms"]


def test_vae_mid_block_is_bound_by_operations():
    """K6 at the VAE mid-block (B = 8, T = 4096, one head of 512)."""
    rec = chip_smoke.attention_bound(8, 1, 4096, 4096, 512)
    assert rec["bound_by"] == "operations"
    assert rec["bound_ms"] == pytest.approx(4 * 8 * 4096**2 * 512 / 989e12 * 1e3)
    assert rec["bound_ms"] == pytest.approx(0.278, abs=1e-3)
    assert rec["exp_ms"] == pytest.approx(8 * 4096**2 / 3.9e12 * 1e3)


@pytest.mark.parametrize("tq,tk,d,by", [
    (1024, 1024, 80, "operations"),  # 320 FLOP a score: the tensor cores
    (4096, 77, 40, "bytes"),         # the text cross-attention: q and o
])
def test_other_attention_shapes(tq, tk, d, by):
    """Wider heads are bound by the products, short key lists by bytes."""
    rec = chip_smoke.attention_bound(16, 8, tq, tk, d)
    assert rec["bound_by"] == by
    assert rec["bound_ms"] == max(rec["ops_ms"], rec["bytes_ms"], rec["exp_ms"])


def test_cross_view_panels_count_every_panel_once():
    """K3: 1 + r panels of products and exponentials; k and v are read once
    (the references are views of them)."""
    one = chip_smoke.attention_cost(16, 8, 1024, 1024, 80)
    five = chip_smoke.attention_cost(16, 8, 1024, 1024, 80, panels=5)
    assert five[0] == 5 * one[0] and five[2] == 5 * one[2]
    assert five[1] == one[1] == 2.0 * 4 * 16 * 1024 * 640


def test_splat_bound_keeps_its_two_terms():
    """Kernels without exponentials (K1, K4) keep their bound."""
    rec = chip_smoke.bound_fields(3e9, chip_smoke.PEAK_FP32, 1e6)
    assert rec["bound_by"] == "operations" and rec["exp_ms"] == 0.0
