"""facebook SAM checkpoints (`sam_vit_h_4b8939.pth`, ...) into `seg.sam.SAM`.

Counterpart of `gaussctrl_tpu/seg/weights.py`. The port's SAM carries the
checkpoint's own key names, so loading is `torch.load(weights_only=True)`
and a strict `load_state_dict`; only the prompt encoder's mask-prompt
weights, which box prompts never use, are dropped by name. The config is
read from `image_encoder.pos_embed`'s width (ViT-H/L/B) unless given, as
the JAX loader does.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from gaussctrl_tpu_torch.seg.sam import SAM, SAMConfig

# keys of a facebook checkpoint that the box-prompted model has no use for
_UNUSED = re.compile(r"^prompt_encoder\.(not_a_point_embed|mask_downscaling)\.")


def sam_for_checkpoint(dim: int, cfg: Optional[SAMConfig] = None) -> SAMConfig:
    """The config a facebook checkpoint's `pos_embed` width names (ViT-H/L/B)
    unless `cfg` is given, as the JAX loader decides."""
    if cfg is not None:
        return cfg
    return {1280: SAMConfig.vit_h, 1024: SAMConfig.vit_l,
            768: SAMConfig.vit_b}[dim]()


def sam_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A facebook state dict as float32 tensors, the unused keys dropped."""
    return {k: v.float() for k, v in sd.items() if not _UNUSED.match(k)}


def load_sam(ckpt_path: str, cfg: Optional[SAMConfig] = None,
             device="cpu") -> SAM:
    """A facebook SAM `.pth` -> `SAM` in float32 on `device`."""
    sd = sam_state_dict(torch.load(ckpt_path, map_location="cpu",
                                   weights_only=True))
    cfg = sam_for_checkpoint(sd["image_encoder.pos_embed"].shape[-1], cfg)
    sam = SAM(cfg)
    sam.load_state_dict(sd, strict=True)
    return sam.to(device).eval()
