"""The official GroundingDINO checkpoint into `seg.dino.GroundingDINO`.

Counterpart of `gaussctrl_tpu/seg/dino_weights.py`. The checkpoint
(`groundingdino_swinb_cogcoor.pth`) nests its state dict under "model" and
may prefix every key with "module."; both are undone. The port's modules
carry the official key names, so the rest is a strict `load_state_dict`
after dropping, by name, what the model does not use: the copies of the
layer-shared box head beyond the first (`bbox_embed.1…`, and the decoder's
references to it), Swin's `relative_position_index` buffers, BERT's pooler
and `position_ids`. Any other unexpected or missing key raises. The config
is Swin-B unless given, as in the JAX loader.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from gaussctrl_tpu_torch.seg.dino import (DinoConfig, GroundingDINO,
                                          WordPieceTokenizer)

_UNUSED = re.compile(
    r"^(bbox_embed\.[1-9]\d*\.|transformer\.decoder\.bbox_embed\.|"
    r"transformer\.decoder\.class_embed\.|transformer\.enc_out_class_embed\.|"
    r"class_embed\.|bert\.pooler\.|bert\.embeddings\.position_ids$|"
    r".*\.relative_position_index$)")


def dino_state_dict(ckpt) -> Dict[str, torch.Tensor]:
    """The checkpoint's state dict: unnested, "module." stripped, the unused
    keys dropped, floats as float32."""
    sd = ckpt.get("model", ckpt)
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^module\.", "", k)
        if not _UNUSED.match(k):
            out[k] = v.float() if v.is_floating_point() else v
    return out


def load_dino(ckpt_path: str, vocab_path: str,
              cfg: Optional[DinoConfig] = None, device="cpu"):
    """`groundingdino_swinb_cogcoor.pth` + BERT `vocab.txt` ->
    (GroundingDINO in float32 on `device`, WordPieceTokenizer)."""
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    model = GroundingDINO(cfg or DinoConfig.swin_b())
    model.load_state_dict(dino_state_dict(ckpt), strict=True)
    return model.to(device).eval(), WordPieceTokenizer(vocab_path)
