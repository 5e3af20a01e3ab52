"""Gaussian splatting: scene, projection, SH colour, tile rasterizer."""

from gaussctrl_tpu_torch.splat.scene import GaussianScene, random_scene  # noqa: F401
from gaussctrl_tpu_torch.splat.rasterize import RasterConfig, rasterize  # noqa: F401
from gaussctrl_tpu_torch.splat.render import render_rgbd  # noqa: F401
