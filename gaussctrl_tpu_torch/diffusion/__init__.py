"""Latent diffusion stack: SD-1.5 UNet + depth ControlNet + VAE + CLIP text
(and the CLIP vision tower the masks and metrics use).

Counterpart of `gaussctrl_tpu/diffusion/`: torch.nn modules named after the
diffusers checkpoint keys, DDIM forward/inverse steps, the attention
processors that route self-attention to kernels K2/K3, and `bridge.py`,
which carries the JAX package's parameter trees across.
"""

from gaussctrl_tpu_torch.diffusion.config import (  # noqa: F401
    CLIPTextConfig, ControlNetConfig, SDConfig, UNetConfig, VAEConfig,
)
from gaussctrl_tpu_torch.diffusion.ddim import DDIMSchedule  # noqa: F401
from gaussctrl_tpu_torch.diffusion.processors import (  # noqa: F401
    CrossViewAttnProcessor, FlashSelfAttnProcessor,
)
