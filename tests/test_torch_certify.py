"""The port's real-weight battery (`certify`, `cli.certify`) against the JAX
package's, on the CPU.

The SD checks run on the tiny synthetic diffusers directories of
tests/test_weights_disk.py (`SDConfig.tiny()`, float32) in both packages,
their VAE given the mid-block q/k/v biases every diffusers VAE holds (zero:
the JAX package's function; the port's loader is strict, ROADMAP F2):
the same `ok` values, PSNRs within 0.05 dB, the ControlNet figures and the
cross-view `consistency_gain` within 1e-3 relative (float32 networks whose
convolutions and attention sum in other orders, through 2 DDIM steps).
SAM and GroundingDINO run from the tiny `.pth` files of
tests/test_torch_seg.py and tests/test_torch_dino.py, each package's
loader given the tiny config: the same verdicts, the figures within 1e-4.
The battery's skips, the CLI's verdict file and exit code, and
`check_mask_iou`'s calibration with an injected masker are held exactly.
"""

import functools
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussctrl_tpu import certify as jcertify
from gaussctrl_tpu.diffusion.config import SDConfig as JSDConfig
from gaussctrl_tpu.seg.sam import SAMConfig as JSAMConfig

from gaussctrl_tpu_torch import certify as tcertify
from gaussctrl_tpu_torch.diffusion.config import SDConfig
from gaussctrl_tpu_torch.seg.dino import DinoConfig
from gaussctrl_tpu_torch.seg.sam import SAMConfig

from test_dino import CFG as JDINO_CFG
from test_dino import _fake_torch_sd
from test_sam import _fake_sam_sd
from test_tokenizer_golden import _write_mini_vocab
from test_torch_dino import write_vocab
from test_torch_seg import _save_pth, carried_sam
from test_weights import tiny_params  # noqa: F401  (fixture dep)
from test_weights_disk import fake_ckpt_dirs  # noqa: F401  (fixture)

torch.set_num_threads(2)

PSNR_TOL = 0.05
REL_TOL = 1e-3


@pytest.fixture(scope="module")
def sd_dirs(fake_ckpt_dirs, tmp_path_factory):  # noqa: F811
    """`fake_ckpt_dirs` copied, with zero VAE mid-block q/k/v biases."""
    sd_dir, cn_dir = fake_ckpt_dirs
    root = tmp_path_factory.mktemp("sd_with_biases")
    shutil.copytree(sd_dir, root / "pipe")
    shutil.copytree(cn_dir, root / "controlnet")
    path = root / "pipe" / "vae" / "diffusion_pytorch_model.bin"
    vae = torch.load(path, weights_only=True)
    for side in ("encoder", "decoder"):
        for n in ("to_q", "to_k", "to_v"):
            w = vae[f"{side}.mid_block.attentions.0.{n}.weight"]
            vae[f"{side}.mid_block.attentions.0.{n}.bias"] = torch.zeros(w.shape[0])
    torch.save(vae, path)
    return str(root / "pipe"), str(root / "controlnet")


def _sd_kw(pkg):
    if pkg == "jax":
        return dict(cfg=JSDConfig.tiny(), dtype=jnp.float32)
    return dict(cfg=SDConfig.tiny(), dtype=torch.float32, device="cpu")


def test_alpha_schedule_matches_jax():
    assert tcertify.check_alpha_schedule() == jcertify.check_alpha_schedule()
    assert tcertify.check_alpha_schedule()["ok"]


def test_tokenizer_check_matches_jax(tmp_path):
    """A vocabulary that is not CLIP's: both packages report the same
    mismatching ids."""
    tok = tmp_path / "sd" / "tokenizer"
    tok.mkdir(parents=True)
    vpath, mpath, _ = _write_mini_vocab(tmp_path)
    (tok / "vocab.json").write_text(open(vpath).read())
    (tok / "merges.txt").write_text(open(mpath).read())
    got = tcertify.check_tokenizer(str(tmp_path / "sd"))
    assert got == jcertify.check_tokenizer(str(tmp_path / "sd"))
    assert got["ok"] is False and got["mismatches"]


def _close(got, ref, name):
    assert np.isfinite(got), name
    assert abs(got - ref) <= REL_TOL * max(abs(ref), 1e-6), (name, got, ref)


def test_sd_stack_matches_jax(sd_dirs):
    """VAE round trip, ControlNet zero convs and scale response, and the
    2-step invert→denoise round trip: the same verdicts and figures."""
    sd_dir, cn_dir = sd_dirs
    ref = jcertify.check_sd_stack(sd_dir, cn_dir, num_steps=2, **_sd_kw("jax"))
    got = tcertify.check_sd_stack(sd_dir, cn_dir, num_steps=2, **_sd_kw("torch"))
    assert set(got) == set(ref) == {
        "vae_roundtrip", "controlnet_nonzero", "controlnet_scale_response",
        "invert_denoise_roundtrip"}
    for name in got:
        assert "error" not in got[name], (name, got[name])
        assert got[name]["ok"] == ref[name]["ok"], name
    assert abs(got["vae_roundtrip"]["psnr"] - ref["vae_roundtrip"]["psnr"]) <= PSNR_TOL
    for k in ("latent_psnr", "image_psnr"):
        assert abs(got["invert_denoise_roundtrip"][k]
                   - ref["invert_denoise_roundtrip"][k]) <= PSNR_TOL, k
    # the untrained ControlNet's zero convs: flagged, and no scale response
    assert got["controlnet_nonzero"] == ref["controlnet_nonzero"] == {
        "ok": False, "max_abs": 0.0}
    assert got["controlnet_scale_response"]["eps_delta_maxabs"] == \
        ref["controlnet_scale_response"]["eps_delta_maxabs"] == 0.0


def test_cross_view_edit_matches_jax(sd_dirs):
    """The two-view cross-view edit at guidance 5 (CFG groups 2, one
    reference): the same verdict, the gain and both view distances within
    1e-3 relative; the port's run is deterministic (bit-equal twice)."""
    sd_dir, cn_dir = sd_dirs
    kw = dict(num_steps=2, guidance=5.0)
    ref = jcertify.check_cross_view_edit(sd_dir, cn_dir, **kw, **_sd_kw("jax"))
    got = tcertify.check_cross_view_edit(sd_dir, cn_dir, **kw, **_sd_kw("torch"))
    assert set(got) == set(ref)
    assert got["ok"] == ref["ok"]
    assert got["edit_changed_image"] == ref["edit_changed_image"]
    for k in ("consistency_gain", "xv_view_l2", "ind_view_l2"):
        _close(got[k], ref[k], k)
    assert got == tcertify.check_cross_view_edit(sd_dir, cn_dir, **kw,
                                                 **_sd_kw("torch"))


def test_run_battery_skips_match_jax():
    """With no inputs both batteries run the schedule check alone and skip
    the same checks for the same reasons."""
    got, ref = tcertify.run_battery(device="cpu"), jcertify.run_battery()
    assert got == ref
    assert got["all_ok"] and set(got["checks"]) == {"alpha_schedule"}
    for name in ("sd_stack", "cross_view_edit", "sam", "mask_iou", "dino",
                 "tokenizer_goldens"):
        assert any(name in s for s in got["skipped"]), name


def test_run_battery_records_errors(tmp_path):
    """A check that raises is recorded as failed with its error, and the
    battery goes on."""
    v = tcertify.run_battery(sam_ckpt=str(tmp_path / "missing.pth"),
                             device="cpu")
    assert v["all_ok"] is False
    for name in ("sam", "mask_iou"):
        assert v["checks"][name]["ok"] is False
        assert "FileNotFoundError" in v["checks"][name]["error"]


def test_certify_cli_writes_the_jax_verdict(tmp_path):
    """The CLI writes the JAX CLI's verdict and exits 0 when every check
    that ran passed."""
    from gaussctrl_tpu.cli.certify import main as jmain
    from gaussctrl_tpu_torch.cli.certify import main
    assert main(["--out", str(tmp_path / "v.json"), "--device", "cpu"]) == 0
    assert jmain(["--out", str(tmp_path / "j.json")]) == 0
    got = json.loads((tmp_path / "v.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text())
    assert got["all_ok"] and got["checks"]["alpha_schedule"]["ok"]


def test_certify_cli_exit_code_on_a_failed_check(tmp_path, sd_dirs):
    """A failed check (the untrained ControlNet's) gives exit code 1 and a
    verdict with all_ok false; no check carries an error."""
    from gaussctrl_tpu_torch.cli.certify import main
    sd_dir, cn_dir = sd_dirs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(SDConfig, "sd15", classmethod(lambda cls: SDConfig.tiny()))
        mp.setattr(tcertify, "_sd_stack", functools.partial(
            _tiny_float32_stack, tcertify._sd_stack))
        rc = main(["--diffusers-dir", sd_dir, "--controlnet-dir", cn_dir,
                   "--num-inference-steps", "1", "--out",
                   str(tmp_path / "v.json"), "--device", "cpu"])
    v = json.loads((tmp_path / "v.json").read_text())
    assert rc == 1 and v["all_ok"] is False
    assert v["checks"]["controlnet_nonzero"]["ok"] is False
    assert not any("error" in c for c in v["checks"].values())
    assert "tokenizer_goldens (no tokenizer/vocab.json)" in v["skipped"]


def _tiny_float32_stack(real, sd_dir, controlnet_dir, cfg, dtype, device):
    return real(sd_dir, controlnet_dir, cfg, torch.float32, device)


class _StubMasker:
    """A box proposer and a mask with fixed answers, for either package."""

    def __init__(self, box, mask_slice, wrap):
        self._box = np.asarray(box, np.float32)
        self._slice = mask_slice
        self._wrap = wrap

    def proposer(self, imgs, prompt):
        return self._box[None]

    def __call__(self, imgs, prompt):
        m = np.zeros((1, 256, 256, 1), np.float32)
        if self._slice is not None:
            m[0][self._slice] = 1.0
        return self._wrap(m)


@pytest.mark.parametrize("case", ["inside", "disjoint", "no_box"])
def test_mask_iou_with_injected_masker_matches_jax(case):
    """An in-box mask passes, a disjoint one fails, no box reports its
    reason, in both packages alike."""
    box, sl = {"inside": ([64, 64, 192, 192], (slice(72, 184), slice(72, 184), 0)),
               "disjoint": ([64, 64, 192, 192], (slice(200, 250), slice(200, 250), 0)),
               "no_box": ([-1, -1, -1, -1], None)}[case]
    ref = jcertify.check_mask_iou(masker=_StubMasker(box, sl, jnp.asarray))
    got = tcertify.check_mask_iou(masker=_StubMasker(box, sl, torch.as_tensor),
                                  device="cpu")
    assert got == ref
    assert got["ok"] is (case == "inside")


@pytest.fixture(scope="module")
def seg_files(tmp_path_factory):
    """The tiny SAM `.pth` of tests/test_torch_seg.py and the tiny
    GroundingDINO `.pth` (official nested layout) with its vocab.txt of
    tests/test_torch_dino.py."""
    root = tmp_path_factory.mktemp("seg_ckpts")
    _, _, params = carried_sam()
    _save_pth(root / "sam_tiny.pth", _fake_sam_sd(params))
    _save_pth(root / "dino_tiny.pth", _fake_torch_sd(), nest_model=True,
              module_prefix=True)
    return (str(root / "sam_tiny.pth"), str(root / "dino_tiny.pth"),
            write_vocab(root / "vocab.txt"))


@pytest.fixture
def tiny_seg_loaders(monkeypatch):
    """Both packages' SAM and GroundingDINO loaders given the tiny configs
    (the files carry no config; the loaders default to ViT-H and Swin-B)."""
    from gaussctrl_tpu.seg import dino_weights as jdw
    from gaussctrl_tpu.seg import weights as jw
    from gaussctrl_tpu_torch.seg import dino_weights as tdw
    from gaussctrl_tpu_torch.seg import weights as tw
    monkeypatch.setattr(jw, "load_sam", functools.partial(
        jw.load_sam, cfg=JSAMConfig.tiny()))
    monkeypatch.setattr(tw, "load_sam", functools.partial(
        tw.load_sam, cfg=SAMConfig.tiny()))
    monkeypatch.setattr(jdw, "load_dino", functools.partial(
        jdw.load_dino, cfg=JDINO_CFG))
    monkeypatch.setattr(tdw, "load_dino", functools.partial(
        tdw.load_dino, cfg=DinoConfig.tiny()))


def test_sam_check_matches_jax(seg_files, tiny_seg_loaders):
    sam, _, _ = seg_files
    ref = jcertify.check_sam(sam)
    got = tcertify.check_sam(sam, device="cpu")
    assert set(got) == set(ref) and got["ok"] == ref["ok"]
    for k in ("mask_frac", "iou_pred"):
        assert abs(got[k] - ref[k]) <= 1e-4, (k, got[k], ref[k])


def test_dino_check_matches_jax(seg_files, tiny_seg_loaders):
    _, dino, vocab = seg_files
    ref = jcertify.check_dino(dino, vocab)
    got = tcertify.check_dino(dino, vocab, device="cpu")
    assert set(got) == set(ref) and got["ok"] == ref["ok"]
    assert got["num_boxes"] == ref["num_boxes"]
    if ref["top_score"] is None:
        assert got["top_score"] is None
    else:
        assert abs(got["top_score"] - ref["top_score"]) <= 1e-4
