"""Text -> boxes -> SAM masks (the Lang-SAM role).

Counterpart of `gaussctrl_tpu/seg/grounding.py`. The box stage is either
GroundingDINO (`seg/dino.py`, the reference's detector) or
`ClipBoxProposer`, which boxes the hot region of a CLIP patch/text cosine
heatmap; any callable `(images [V,H,W,3], text) -> boxes [V,4]` (xyxy image
pixels, −1s for no match) fits. `GroundedSAMMasker` is the pipeline's mask
provider: a view with no box gets an all-zero mask, so the compositing
keeps it unedited. `LangSAM` is the reference's single-image API.

Resizes follow the JAX package's: images go into the networks through
`resize_bilinear` (`jax.image.resize`'s antialiased bilinear) and masks come
back with `nearest-exact`, which is `jax.image.resize`'s "nearest".
Component labelling and the ordering of detections are host numpy, as in
the JAX package, so ties order the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gaussctrl_tpu_torch.device import exact_fp32, resolve_device
from gaussctrl_tpu_torch.diffusion.clip import (CLIP_MEAN, CLIP_STD, CLIPModel,
                                                CLIPVisionConfig,
                                                load_tokenizer)
from gaussctrl_tpu_torch.diffusion.config import CLIPTextConfig
from gaussctrl_tpu_torch.pipeline.gaussctrl import resize_bilinear
from gaussctrl_tpu_torch.seg.sam import SAM, SAMConfig


def resize_nearest(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[B,H,W,C] -> [B,height,width,C] as `jax.image.resize(..., "nearest")`."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width),
                      mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


def _label_components(hot: np.ndarray):
    """4-connected components of a small boolean grid: a list of (ys, xs)."""
    g_h, g_w = hot.shape
    seen = np.zeros_like(hot, bool)
    comps = []
    for sy, sx in zip(*np.nonzero(hot)):
        if seen[sy, sx]:
            continue
        stack = [(sy, sx)]
        seen[sy, sx] = True
        ys, xs = [], []
        while stack:
            y, x = stack.pop()
            ys.append(y)
            xs.append(x)
            for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                if 0 <= ny < g_h and 0 <= nx < g_w and hot[ny, nx] \
                        and not seen[ny, nx]:
                    seen[ny, nx] = True
                    stack.append((ny, nx))
        comps.append((np.asarray(ys), np.asarray(xs)))
    return comps


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-8)


@dataclasses.dataclass
class ClipBoxProposer:
    """Text -> boxes from a CLIP patch-similarity heatmap: the thresholded
    heatmap's 4-connected components, one box each, scored by the
    component's peak cosine mapped to [0,1] ((s+1)/2), best first."""
    clip: CLIPModel
    tokenizer: object
    rel_threshold: float = 0.75   # keep patches ≥ thresh · max-similarity
    min_score: float = 0.0        # absolute floor (cosine) to accept any box

    @torch.no_grad()
    def heatmap(self, images: torch.Tensor, prompt: str) -> torch.Tensor:
        """[V,H,W,3] in [0,1] -> patch/text cosines [V, g, g] on the device."""
        cfg = self.clip.vision_cfg
        dev = self.clip.visual_projection.weight.device
        s = cfg.image_size
        x = resize_bilinear(images.to(dev, torch.float32), s, s)
        x = (x - x.new_tensor(CLIP_MEAN)) / x.new_tensor(CLIP_STD)
        ids = torch.as_tensor(np.asarray(self.tokenizer.encode(prompt)),
                              device=dev, dtype=torch.long)[None]
        with exact_fp32():
            patches = _normalize(self.clip.image_tokens(x)[:, 1:])
            temb = _normalize(self.clip.text_embed(ids)[0])
            sims = patches @ temb
        return sims.reshape(images.shape[0], cfg.grid, cfg.grid)

    def _sims(self, images: torch.Tensor, prompt: str) -> np.ndarray:
        return self.heatmap(images, prompt).cpu().numpy()

    def _detections(self, s: np.ndarray, h: int, w: int):
        """One heatmap [g,g] -> (boxes [K,4] xyxy px, scores [K]), best first."""
        g = s.shape[0]
        if s.max() < self.min_score:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
        hot = s >= s.min() + self.rel_threshold * (s.max() - s.min())
        boxes, scores = [], []
        for ys, xs in _label_components(hot):
            boxes.append([xs.min() / g * w, ys.min() / g * h,
                          (xs.max() + 1) / g * w, (ys.max() + 1) / g * h])
            scores.append((float(s[ys, xs].max()) + 1.0) / 2.0)
        if not boxes:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.float32)
        order = np.argsort(scores)[::-1]
        return (np.asarray(boxes, np.float32)[order],
                np.asarray(scores, np.float32)[order])

    def __call__(self, images: torch.Tensor, prompt: str) -> np.ndarray:
        """images [V,H,W,3] in [0,1] -> boxes [V,4] xyxy (−1s = no match):
        each view's best-scoring component."""
        v, h, w, _ = images.shape
        sim = self._sims(images, prompt)
        boxes = np.full((v, 4), -1.0, np.float32)
        for i in range(v):
            det, _ = self._detections(sim[i], h, w)
            if len(det):
                boxes[i] = det[0]
        return boxes

    def predict_boxes(self, image: np.ndarray, prompt: str,
                      box_threshold: float = 0.3,
                      text_threshold: float = 0.25):
        """One image [H,W,3] -> (boxes [K,4], scores [K], phrases [K]) above
        `box_threshold`; `text_threshold` is accepted for the signature (the
        proposer has one phrase)."""
        h, w, _ = image.shape
        sim = self._sims(torch.as_tensor(np.asarray(image, np.float32))[None],
                         prompt)[0]
        boxes, scores = self._detections(sim, h, w)
        keep = scores >= box_threshold
        boxes, scores = boxes[keep], scores[keep]
        return boxes, scores, [prompt] * len(boxes)


def _encode(sam: SAM, images: torch.Tensor) -> torch.Tensor:
    """[B,h,w,3] in [0,1] -> SAM embeddings at the encoder's size."""
    s = sam.cfg.img_size
    return sam.encode(resize_bilinear(images.to(sam.device, torch.float32), s, s))


def _box_masks(sam: SAM, emb: torch.Tensor, boxes: np.ndarray, in_hw,
               out_hw) -> torch.Tensor:
    """SAM masks {0,1} [B, H, W, 1] for `boxes` [B,4] in image pixels of size
    `in_hw` (clipped at 0, scaled to encoder pixels), resized to `out_hw`."""
    h, w = in_hw
    size = sam.cfg.img_size
    scale = np.array([size / w, size / h, size / w, size / h], np.float32)
    b = torch.as_tensor(np.clip(boxes, 0, None) * scale, device=sam.device)
    logits, _ = sam.predict_boxes(emb, b)
    return resize_nearest((logits > 0).float()[..., None], *out_hw)


class GroundedSAMMasker:
    """Mask provider: text -> boxes (`proposer`) -> SAM masks, `batch` views
    at a time."""

    def __init__(self, sam: SAM,
                 proposer: Callable[[torch.Tensor, str], np.ndarray],
                 batch: int = 4):
        self.sam = sam
        self.proposer = proposer
        self.batch = batch

    def __call__(self, images: torch.Tensor, text: str) -> torch.Tensor:
        v, h, w, _ = images.shape
        boxes = np.asarray(self.proposer(images, text))      # [V, 4] image px
        masks = []
        for lo in range(0, v, self.batch):
            hi = min(lo + self.batch, v)
            emb = _encode(self.sam, images[lo:hi])
            m = _box_masks(self.sam, emb, boxes[lo:hi], (h, w), (h, w))
            m = m.to(images.device, images.dtype)
            # views with no box get zero masks (nothing to edit)
            found = torch.as_tensor(boxes[lo:hi, 0] >= 0, device=m.device)
            masks.append(m * found.to(m.dtype)[:, None, None, None])
        return torch.cat(masks)


class LangSAM:
    """The reference's `LangSAM.predict(image, text_prompt, box_threshold,
    text_threshold)` -> (masks [K,H,W], boxes [K,4] xyxy, phrases [K],
    logits [K]) for every detection; `image` is a PIL image or an [H,W,3]
    array in [0,1] (or 0..255). The boxes go to SAM in one batch of K."""

    def __init__(self, sam: SAM, proposer):
        self.sam = sam
        self.proposer = proposer

    def predict(self, image, text_prompt: str, box_threshold: float = 0.3,
                text_threshold: float = 0.25):
        if hasattr(image, "convert"):                  # PIL image
            image = np.asarray(image.convert("RGB"), np.float32) / 255.0
        image = np.asarray(image, np.float32)
        if image.max() > 1.5:
            image = image / 255.0
        h, w, _ = image.shape
        if hasattr(self.proposer, "predict_boxes"):
            boxes, logits, phrases = self.proposer.predict_boxes(
                image, text_prompt, box_threshold, text_threshold)
        else:                                          # single-box proposers
            b = np.asarray(self.proposer(torch.as_tensor(image)[None],
                                         text_prompt))[0]
            found = b[0] >= 0
            boxes = b[None] if found else np.zeros((0, 4), np.float32)
            logits = np.ones((1,), np.float32) if found else np.zeros((0,))
            phrases = [text_prompt] if found else []
        if len(boxes) == 0:
            return (np.zeros((0, h, w), np.float32), boxes, phrases, logits)
        emb = _encode(self.sam, torch.as_tensor(image)[None])
        emb = emb.expand(len(boxes), -1, -1, -1)
        masks = _box_masks(self.sam, emb, np.asarray(boxes), (h, w), (h, w))
        return masks[..., 0].cpu().numpy(), boxes, phrases, logits


def random_clip(vcfg: CLIPVisionConfig, tcfg: CLIPTextConfig, seed: int = 0,
                device="cpu") -> CLIPModel:
    """A CLIPModel with random weights from `seed` (`core/init.py`)."""
    from gaussctrl_tpu_torch.core.init import random_init_
    return random_init_(CLIPModel(vcfg, tcfg).to(device), seed).eval()


def build_langsam_equivalent(
    sam_ckpt: Optional[str] = None,
    clip_dir: Optional[str] = None,
    sam: Optional[SAM] = None,
    dino_ckpt: Optional[str] = None,
    dino_vocab: Optional[str] = None,
    device=None,
    seed: int = 0,
) -> GroundedSAMMasker:
    """The text->mask stack from local checkpoints, on the card unless
    `device="cpu"`.

    With `dino_ckpt` (and its BERT `dino_vocab`) the box stage is
    GroundingDINO, the reference's detector; otherwise the CLIP proposer
    (ViT-L/14 from `clip_dir`). Without checkpoints the networks are tiny
    ones with random weights from `seed`: shapes only, for smoke runs."""
    dev = resolve_device(device)
    if sam is None:
        if sam_ckpt:
            from gaussctrl_tpu_torch.seg.weights import load_sam
            sam = load_sam(sam_ckpt, device=dev)
        else:
            sam = SAM.create(SAMConfig.tiny(), seed, dev)

    if dino_ckpt:
        from gaussctrl_tpu_torch.seg.dino import DinoBoxProposer
        from gaussctrl_tpu_torch.seg.dino_weights import load_dino
        if not dino_vocab:
            raise ValueError("GroundingDINO needs a BERT vocab.txt "
                             "(--dino-vocab)")
        model, tok = load_dino(dino_ckpt, dino_vocab, device=dev)
        return GroundedSAMMasker(sam, DinoBoxProposer(model, tok))

    tcfg = CLIPTextConfig.sd15() if clip_dir else CLIPTextConfig.tiny()
    if clip_dir:
        from gaussctrl_tpu_torch.diffusion.weights import load_clip_model
        clip = load_clip_model(clip_dir, device=dev)
    else:
        clip = random_clip(CLIPVisionConfig.tiny(), tcfg, seed + 1, dev)
    proposer = ClipBoxProposer(clip, load_tokenizer(clip_dir, tcfg))
    return GroundedSAMMasker(sam, proposer)
