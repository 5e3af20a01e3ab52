"""Real-weight fidelity battery.

Counterpart of `gaussctrl_tpu/certify.py`: every invariant of the four
foreign networks (SD-1.5 UNet/VAE/CLIP with the depth ControlNet, SAM
ViT-H, GroundingDINO) that can be checked offline, in one battery, so that
the first machine with the checkpoints certifies the port with one command
(`python -m gaussctrl_tpu_torch.cli.certify`). Each check returns
{"ok": bool, ...detail}; `run_battery` runs those whose inputs are given and
never raises. The checks run on the card unless `device="cpu"`; the SD
checks in bf16 at `SDConfig.sd15()` unless `cfg`/`dtype` are given (the
tests run them at `SDConfig.tiny()` in float32 on the CPU). On the card
their attention runs through the kernels: K2 for the self-attention with no
processor, K5 for the text cross-attention, K3 for the cross-view edit's
fused levels and K6 for the VAE mid-block.

`check_mask_iou` reads "no box" as `boxes[0, 0] < 0`, as the JAX package
does: a box that starts left of the image counts as none (ROADMAP F8).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from gaussctrl_tpu_torch.device import resolve_device

# CLIP BPE golden token ids (openai/clip-vit-large-patch14's tokenizer, the
# SD-1.5 text stack). Byte-exact.
TOKENIZER_GOLDENS = {
    "a photo of a cat": [49406, 320, 1125, 539, 320, 2368, 49407],
    "a photo of a dog": [49406, 320, 1125, 539, 320, 1929, 49407],
    "": [49406, 49407],
}

# published SD-1.5 scaled_linear schedule endpoints (diffusers
# DDIMScheduler(beta_start=8.5e-4, beta_end=0.012, steps=1000))
ALPHAS_CUMPROD_GOLDEN = {0: 0.99915, 999: 0.0046825}

# the ControlNet's zero-initialised output convs, by diffusers key prefix
_ZERO_CONVS = ("controlnet_down_blocks.", "controlnet_mid_block.")


def _psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-12) / peak ** 2))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def check_tokenizer(sd_dir: str) -> Dict[str, Any]:
    """Golden token ids through the port's BPE against the real vocab."""
    from gaussctrl_tpu_torch.diffusion.clip import CLIPTokenizer
    vocab = os.path.join(sd_dir, "tokenizer", "vocab.json")
    merges = os.path.join(sd_dir, "tokenizer", "merges.txt")
    tok = CLIPTokenizer(vocab, merges, max_length=77)
    bad = {}
    for text, golden in TOKENIZER_GOLDENS.items():
        ids = [int(i) for i in tok.encode(text)]
        got = ids[: len(golden)]
        if got != golden or any(i != tok.EOS for i in ids[len(golden):]):
            bad[text] = got
    return {"ok": not bad, "mismatches": bad}


def check_alpha_schedule() -> Dict[str, Any]:
    from gaussctrl_tpu_torch.diffusion.ddim import DDIMSchedule
    ac = np.asarray(DDIMSchedule.sd15().alphas_cumprod, np.float64)
    errs = {str(i): float(abs(ac[i] - v))
            for i, v in ALPHAS_CUMPROD_GOLDEN.items()}
    return {"ok": all(e < 5e-5 for e in errs.values()), "abs_err": errs}


def _load_image(path: Optional[str], size: int) -> np.ndarray:
    """[1, size, size, 3] float in [0,1]; a deterministic structured
    synthetic image when no path is given. A given image is read and
    resized with OpenCV (INTER_AREA), as the JAX package does."""
    if path:
        import cv2
        img = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
        return img[None].astype(np.float32) / 255.0
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    img = np.stack([0.5 + 0.4 * np.sin(6 * xx),
                    0.5 + 0.4 * np.cos(4 * yy),
                    0.3 + 0.3 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2)], -1)
    return img[None]


def _sd_stack(sd_dir, controlnet_dir, cfg, dtype, device):
    """(SDModels from the directories in `dtype` on `device`, tokenizer)."""
    from gaussctrl_tpu_torch.diffusion.clip import load_tokenizer
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    from gaussctrl_tpu_torch.diffusion.sample import SDModels
    from gaussctrl_tpu_torch.diffusion.weights import load_sd_models

    cfg = cfg or SDConfig.sd15()
    models = SDModels.create(cfg, dtype=dtype or torch.bfloat16,
                             device=resolve_device(device))
    load_sd_models(models, sd_dir, controlnet_dir)
    return models, load_tokenizer(sd_dir, cfg.text)


def _ids(tok, text, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tok.encode(text)), device=device)[None]


def check_sd_stack(sd_dir: str, controlnet_dir: str,
                   image_path: Optional[str] = None,
                   prompt: str = "a photo of a bear",
                   num_steps: int = 20, cfg=None,
                   dtype=None, device=None) -> Dict[str, Any]:
    """VAE round trip, ControlNet zero-conv and scale response, and the
    invert→denoise fixed-point round trip on one image. `cfg`/`dtype`
    default to `SDConfig.sd15()` in bf16."""
    from gaussctrl_tpu_torch.diffusion.ddim import DDIMSchedule
    from gaussctrl_tpu_torch.diffusion.sample import (denoise, encode_text,
                                                      eps_model, invert,
                                                      vae_decode, vae_encode)

    out: Dict[str, Any] = {}
    models, tok = _sd_stack(sd_dir, controlnet_dir, cfg, dtype, device)
    dev = models.device
    img_np = _load_image(image_path, models.cfg.sample_size * 8)
    img = torch.as_tensor(img_np, device=dev)
    z0 = vae_encode(models, img)
    rec = vae_decode(models, z0)
    vae_psnr = _psnr(np.clip(_np(rec), 0, 1), img_np)
    out["vae_roundtrip"] = {"ok": vae_psnr >= 18.0, "psnr": round(vae_psnr, 2)}

    # the zero convs of a trained ControlNet are nonzero (a converter that
    # drops or misnames them zeroes the residuals: scale-0 behaviour)
    params = models.controlnet.state_dict()
    zc = [float(v.float().abs().max()) for k, v in params.items()
          if k.startswith(_ZERO_CONVS)] or [
          float(v.float().abs().max()) for v in params.values()]
    out["controlnet_nonzero"] = {"ok": max(zc) > 0.0, "max_abs": max(zc)}

    ctx = encode_text(models, _ids(tok, prompt, dev))
    disp = img.mean(-1, keepdim=True).expand(img.shape)
    e1 = eps_model(models, z0, 201, ctx, disp, 1.0)
    e0 = eps_model(models, z0, 201, ctx, disp, 0.0)
    diff = float((e1 - e0).float().abs().max())
    out["controlnet_scale_response"] = {
        "ok": bool(torch.isfinite(e1.float()).all()) and diff > 0,
        "eps_delta_maxabs": diff}

    sched = DDIMSchedule.sd15()
    zT = invert(models, sched, z0, ctx, disp, num_steps)
    z0p = denoise(models, sched, zT, ctx, ctx, disp, guidance_scale=1.0,
                  num_steps=num_steps)
    z0_np = _np(z0)
    lat_psnr = _psnr(_np(z0p), z0_np, peak=float(np.abs(z0_np).max()))
    img_psnr = _psnr(np.clip(_np(vae_decode(models, z0p)), 0, 1), img_np)
    out["invert_denoise_roundtrip"] = {
        # 20-step DDIM inversion at guidance 1 is a near fixed point on real
        # weights; random weights land far below
        "ok": lat_psnr >= 15.0 and img_psnr >= 14.0,
        "latent_psnr": round(lat_psnr, 2), "image_psnr": round(img_psnr, 2)}
    return out


def check_cross_view_edit(sd_dir: str, controlnet_dir: str,
                          image_path: Optional[str] = None,
                          edit_prompt: str = "a photo of a polar bear",
                          reverse_prompt: str = "a photo of a bear",
                          num_steps: int = 20, guidance: float = 5.0,
                          cfg=None, dtype=None, device=None) -> Dict[str, Any]:
    """A two-view cross-view edit, deterministic (DDIM eta 0, no draws).

    Two nearly identical views (the certify image and an 8 px translation)
    are inverted with the reverse prompt and edited in one CFG batch twice:
    with the cross-view processors (view 0 the single reference; K3 at the
    fused levels on the card) and without them. The method's claim is that
    the first gives more consistent edits across the views:

        consistency_gain = L2(ind0, ind1) / L2(xv0, xv1)  >  1

    Random weights land near 1 and fail, as they should."""
    from gaussctrl_tpu_torch.diffusion.ddim import DDIMSchedule
    from gaussctrl_tpu_torch.diffusion.processors import CrossViewAttnProcessor
    from gaussctrl_tpu_torch.diffusion.sample import (denoise, encode_text,
                                                      invert, vae_decode,
                                                      vae_encode)

    models, tok = _sd_stack(sd_dir, controlnet_dir, cfg, dtype, device)
    dev = models.device
    img0 = _load_image(image_path, models.cfg.sample_size * 8)
    img1 = np.roll(img0, 8, axis=2)               # second view: 8 px shift
    imgs_np = np.concatenate([img0, img1])
    imgs = torch.as_tensor(imgs_np, device=dev)
    z0 = vae_encode(models, imgs)
    disp = imgs.mean(-1, keepdim=True).expand(imgs.shape)

    def ctx(text):
        one = encode_text(models, _ids(tok, text, dev))
        return torch.cat([one, one])

    sched = DDIMSchedule.sd15()
    zT = invert(models, sched, z0, ctx(reverse_prompt), disp, num_steps)
    cp, cn = ctx(edit_prompt), ctx("")
    groups = 2 if guidance > 1.0 else 1

    def run(up, crp):
        return denoise(models, sched, zT, cp, cn, disp, guidance_scale=guidance,
                       num_steps=num_steps, unet_processor=up,
                       controlnet_processor=crp)

    z_xv = run(CrossViewAttnProcessor(1, 0.6, groups),
               CrossViewAttnProcessor(1, 0.0, groups))
    z_ind = run(None, None)
    e_xv = np.clip(_np(vae_decode(models, z_xv)), 0, 1)
    e_ind = np.clip(_np(vae_decode(models, z_ind)), 0, 1)

    def l2(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    d_xv = l2(e_xv[0], e_xv[1])
    d_ind = l2(e_ind[0], e_ind[1])
    gain = d_ind / max(d_xv, 1e-9)
    finite = bool(np.isfinite(e_xv).all() and np.isfinite(e_ind).all())
    return {"ok": finite and gain > 1.0,
            "consistency_gain": round(gain, 4),
            "xv_view_l2": round(d_xv, 5), "ind_view_l2": round(d_ind, 5),
            "edit_changed_image": l2(e_xv[0], imgs_np[0]) > 1e-3}


def check_sam(sam_ckpt: str, image_path: Optional[str] = None,
              device=None) -> Dict[str, Any]:
    """SAM on one image with a centred box: finite logits and a mask that
    is neither empty nor full."""
    from gaussctrl_tpu_torch.seg.weights import load_sam
    sam = load_sam(sam_ckpt, device=resolve_device(device))
    s = sam.cfg.img_size
    img = torch.as_tensor(_load_image(image_path, s), device=sam.device)
    emb = sam.encode(img)
    box = torch.tensor([[s * 0.25, s * 0.25, s * 0.75, s * 0.75]],
                       dtype=torch.float32, device=sam.device)
    logits, iou = sam.predict_boxes(emb, box)
    logits = _np(logits)
    frac = float((logits > 0).mean())
    return {"ok": bool(np.isfinite(logits).all()) and 0.0 < frac < 1.0,
            "mask_frac": round(frac, 4), "iou_pred": float(iou[0])}


def check_dino(dino_ckpt: str, dino_vocab: str,
               image_path: Optional[str] = None,
               prompt: str = "bear", device=None) -> Dict[str, Any]:
    """GroundingDINO on one image: finite scores and ordered boxes within
    10% of the frame (its regressors may overshoot; SAM's prompt clips)."""
    from gaussctrl_tpu_torch.seg.dino import DinoBoxProposer
    from gaussctrl_tpu_torch.seg.dino_weights import load_dino
    model, tok = load_dino(dino_ckpt, dino_vocab, device=resolve_device(device))
    proposer = DinoBoxProposer(model, tok)
    img = _load_image(image_path, 512)[0]
    boxes, logits, phrases = proposer.predict_boxes(img, prompt, 0.05, 0.05)
    inb = all(b[0] <= b[2] and b[1] <= b[3]
              and -51.2 <= min(b) and max(b) <= 563.2
              for b in np.asarray(boxes))
    return {"ok": bool(inb and np.isfinite(np.asarray(logits)).all()),
            "num_boxes": int(len(boxes)),
            "top_score": float(logits[0]) if len(logits) else None}


def check_mask_iou(sam_ckpt: Optional[str] = None,
                   dino_ckpt: Optional[str] = None,
                   dino_vocab: Optional[str] = None,
                   image_path: Optional[str] = None,
                   prompt: str = "bear",
                   masker=None, device=None) -> Dict[str, Any]:
    """Text → box → mask on one image: the SAM mask must agree with the box
    that prompted it, IoU(mask, box rectangle) ≥ 0.25. Real weights put
    most of the mask inside its box; random weights fail. `masker`
    replaces the stack (the tests inject one)."""
    dev = resolve_device(device)
    if masker is None:
        from gaussctrl_tpu_torch.seg.grounding import build_langsam_equivalent
        masker = build_langsam_equivalent(
            sam_ckpt=sam_ckpt, dino_ckpt=dino_ckpt, dino_vocab=dino_vocab,
            device=dev)
    img_np = _load_image(image_path, 256)
    img = torch.as_tensor(img_np, device=dev)
    boxes = np.asarray(masker.proposer(img, prompt))
    if boxes[0, 0] < 0:  # bail before the expensive SAM mask prediction
        return {"ok": False, "reason": "no box proposed", "mask_iou": 0.0}
    mask = torch.as_tensor(masker(img, prompt)).cpu().numpy()[0, ..., 0] > 0.5
    h = w = img_np.shape[1]
    x0, y0, x1, y1 = np.clip(boxes[0], 0, [w, h, w, h]).astype(int)
    rect = np.zeros((h, w), bool)
    rect[y0:y1, x0:x1] = True
    inter = float((mask & rect).sum())
    union = float((mask | rect).sum())
    iou = inter / union if union else 0.0
    return {"ok": iou >= 0.25, "mask_iou": round(iou, 4),
            "box": [float(v) for v in boxes[0]],
            "mask_frac": round(float(mask.mean()), 4)}


def run_battery(sd_dir: Optional[str] = None,
                controlnet_dir: Optional[str] = None,
                sam_ckpt: Optional[str] = None,
                dino_ckpt: Optional[str] = None,
                dino_vocab: Optional[str] = None,
                image: Optional[str] = None,
                prompt: str = "a photo of a bear",
                num_steps: int = 20, device=None) -> Dict[str, Any]:
    """Run every check whose inputs were supplied. Never raises: a crashed
    check records ok=False with the error, so that one bad checkpoint does
    not hide the other verdicts."""
    checks: Dict[str, Any] = {"alpha_schedule": check_alpha_schedule()}
    skipped = []

    def _run(name, fn, *a, **kw):
        try:
            res = fn(*a, **kw)
        except Exception as e:  # noqa: BLE001 — the verdict is always written
            res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if name == "_sd":
            checks.update(res)
        else:
            checks[name] = res

    if sd_dir:
        if os.path.exists(os.path.join(sd_dir, "tokenizer", "vocab.json")):
            _run("tokenizer_goldens", check_tokenizer, sd_dir)
        else:
            skipped.append("tokenizer_goldens (no tokenizer/vocab.json)")
        if controlnet_dir:
            _run("_sd", check_sd_stack, sd_dir, controlnet_dir, image,
                 prompt, num_steps, device=device)
            _run("cross_view_edit", check_cross_view_edit, sd_dir,
                 controlnet_dir, image, num_steps=num_steps, device=device)
        else:
            skipped.append("sd_stack (no --controlnet-dir)")
            skipped.append("cross_view_edit (no --controlnet-dir)")
    else:
        skipped += ["tokenizer_goldens", "sd_stack (no --diffusers-dir)",
                    "cross_view_edit (no --diffusers-dir)"]
    if sam_ckpt:
        _run("sam", check_sam, sam_ckpt, image, device=device)
        # the whole text -> box -> mask path, with the best proposer given
        _run("mask_iou", check_mask_iou, sam_ckpt, dino_ckpt, dino_vocab,
             image, prompt.replace("a photo of ", ""), device=device)
    else:
        skipped.append("sam (no --sam-ckpt)")
        skipped.append("mask_iou (no --sam-ckpt)")
    if dino_ckpt and dino_vocab:
        _run("dino", check_dino, dino_ckpt, dino_vocab, image, prompt,
             device=device)
    else:
        skipped.append("dino (no --dino-ckpt/--dino-vocab)")

    flat_ok = [v["ok"] for k, v in checks.items()
               if isinstance(v, dict) and "ok" in v]
    return {"checks": checks, "skipped": skipped,
            "all_ok": bool(flat_ok) and all(flat_ok)}
