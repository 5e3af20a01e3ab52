"""gaussctrl_tpu_torch — the GaussCtrl editing system in PyTorch for NVIDIA Hopper.

The PyTorch/CUDA counterpart of `gaussctrl_tpu` (JAX/Pallas), laid out module
for module like it: `splat/` (scene, projection, tile rasterizer), `cameras/`,
`diffusion/` (SD-1.5 UNet, depth ControlNet, VAE, CLIP text and vision,
DDIM), `ops/` (the hand-written CUDA kernels and their plain PyTorch
versions), `seg/` (text-prompted object masks: SAM, GroundingDINO, the CLIP
box proposer), `metrics/` (CLIP metrics of an edit) and `pipeline/`
(render → DDIM inversion → cross-view edit).

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`; there is no silent fallback. This package imports neither
JAX nor anything of `gaussctrl_tpu`.
"""

__version__ = "0.1.0"

from gaussctrl_tpu_torch.device import resolve_device  # noqa: F401
