"""Edit-quality metrics: CLIP text-image and directional similarity.

Counterpart of `gaussctrl_tpu/metrics/`.
"""

from gaussctrl_tpu_torch.metrics.clip_metrics import (  # noqa: F401
    CLIPScorer, clip_directional_similarity, clip_similarity,
)
