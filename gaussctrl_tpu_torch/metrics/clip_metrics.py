"""CLIP similarity metrics of an edit.

Counterpart of `gaussctrl_tpu/metrics/clip_metrics.py` (instruct-nerf2nerf's
protocol, which the reference defers to):

  sim(I, T) = cos(E_img(I), E_txt(T))
  dir_sim   = cos(E_img(I_edit) − E_img(I_orig), E_txt(T_edit) − E_txt(T_orig))

Images are resized into the tower with `resize_bilinear` (the JAX
package's antialiased bilinear) and the towers run in float32, TF32 off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gaussctrl_tpu_torch.device import exact_fp32, resolve_device
from gaussctrl_tpu_torch.diffusion.clip import (CLIP_MEAN, CLIP_STD, CLIPModel,
                                                CLIPVisionConfig,
                                                load_tokenizer)
from gaussctrl_tpu_torch.diffusion.config import CLIPTextConfig
from gaussctrl_tpu_torch.pipeline.gaussctrl import resize_bilinear


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True).clamp_min(1e-8)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True).clamp_min(1e-8)
    return (a * b).sum(-1)


@dataclasses.dataclass
class CLIPScorer:
    """Joint-space image and text embeddings from one CLIPModel."""
    clip: CLIPModel
    tokenizer: object

    @classmethod
    def from_dir(cls, clip_dir: Optional[str], device=None,
                 seed: int = 0) -> "CLIPScorer":
        """ViT-L/14 and the SD-1.5 text tower from a transformers CLIPModel
        directory; without one, tiny towers with random weights from `seed`
        (scores then only agree with themselves). On the card unless
        `device="cpu"`."""
        dev = resolve_device(device)
        tcfg = CLIPTextConfig.sd15() if clip_dir else CLIPTextConfig.tiny()
        if clip_dir:
            from gaussctrl_tpu_torch.diffusion.weights import load_clip_model
            clip = load_clip_model(clip_dir, device=dev)
        else:
            from gaussctrl_tpu_torch.seg.grounding import random_clip
            clip = random_clip(CLIPVisionConfig.tiny(), tcfg, seed, dev)
        return cls(clip, load_tokenizer(clip_dir, tcfg))

    @property
    def device(self) -> torch.device:
        return self.clip.visual_projection.weight.device

    @torch.no_grad()
    def embed_images(self, images01) -> torch.Tensor:
        """[B,H,W,3] in [0,1] -> joint-space embeddings [B,D] (class token)."""
        s = self.clip.vision_cfg.image_size
        x = torch.as_tensor(np.asarray(images01, np.float32)
                            if not torch.is_tensor(images01) else images01)
        x = resize_bilinear(x.to(self.device, torch.float32), s, s)
        x = (x - x.new_tensor(CLIP_MEAN)) / x.new_tensor(CLIP_STD)
        with exact_fp32():
            return self.clip.image_tokens(x)[:, 0]

    @torch.no_grad()
    def embed_texts(self, prompts: list[str]) -> torch.Tensor:
        ids = torch.as_tensor(np.stack([self.tokenizer.encode(p)
                                        for p in prompts]),
                              device=self.device, dtype=torch.long)
        with exact_fp32():
            return self.clip.text_embed(ids)


def clip_similarity(scorer: CLIPScorer, images01, prompt: str) -> float:
    """Mean cosine(edited render, edit prompt) over views."""
    ie = scorer.embed_images(images01)
    te = scorer.embed_texts([prompt])
    return float(_cos(ie, te).mean())


def clip_directional_similarity(scorer: CLIPScorer, edited01, original01,
                                edit_prompt: str, original_prompt: str
                                ) -> float:
    """Mean cosine(image delta, caption delta), the in2n protocol."""
    if edited01.shape[0] != original01.shape[0]:
        raise ValueError(
            f"directional similarity needs paired views: got "
            f"{edited01.shape[0]} edited vs {original01.shape[0]} original "
            f"images (pass view-aligned directories)")
    d_img = scorer.embed_images(edited01) - scorer.embed_images(original01)
    te = scorer.embed_texts([edit_prompt, original_prompt])
    return float(_cos(d_img, (te[0] - te[1])[None]).mean())
