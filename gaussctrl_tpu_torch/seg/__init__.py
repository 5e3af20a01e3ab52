"""Text-prompted object masks (the Lang-SAM role).

Counterpart of `gaussctrl_tpu/seg/`: SAM (`sam.py`) prompted with boxes
from GroundingDINO (`dino.py`) or from the CLIP patch-similarity proposer
(`grounding.py`), behind the pipeline's mask contract

    masker(images [V,H,W,3] in [0,1], text) -> masks [V,H,W,1] in {0, 1}

Every network here computes in float32 (TF32 off on the card) and is plain
PyTorch: the JAX package computes these attentions as einsums, outside any
Pallas kernel.
"""

from gaussctrl_tpu_torch.seg.masker import (  # noqa: F401
    MaskProvider, NullMasker, ThresholdMasker,
)
