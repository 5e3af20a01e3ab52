"""Scene → image rendering: one fused [r, g, b, depth] pass.

Counterpart of `gaussctrl_tpu/splat/render.py:render_rgbd`: RGB and depth are
composited in a single 4-channel rasterization, and depth is alpha-normalised
with 1000 where nothing was hit.
"""

from __future__ import annotations

import torch

from gaussctrl_tpu_torch.cameras.camera import view_matrix
from gaussctrl_tpu_torch.splat.project import project_gaussians
from gaussctrl_tpu_torch.splat.rasterize import RasterConfig, rasterize
from gaussctrl_tpu_torch.splat.scene import GaussianScene
from gaussctrl_tpu_torch.splat.sh import eval_sh


def render_rgbd(scene: GaussianScene, c2w: torch.Tensor, fx, fy, cx, cy,
                width: int, height: int, background: torch.Tensor,
                sh_degree: int | None = None,
                cfg: RasterConfig = RasterConfig(),
                return_stats: bool = False):
    """Render one view: dict(rgb [H,W,3], depth [H,W,1], accumulation
    [H,W,1]) and, with `return_stats`, the rasterizer counters."""
    if sh_degree is None:
        sh_degree = scene.sh_degree
    viewmat = view_matrix(c2w)
    opac = torch.sigmoid(scene.opacities[:, 0])
    proj = project_gaussians(scene.means, torch.exp(scene.scales), scene.quats,
                             viewmat, fx, fy, cx, cy, width, height,
                             opacities=opac.detach())
    viewdirs = scene.means - c2w[:3, 3][None, :]
    viewdirs = viewdirs / torch.linalg.norm(viewdirs, dim=-1,
                                            keepdim=True).clamp_min(1e-8)
    rgbs = eval_sh(sh_degree, viewdirs.detach(), scene.colors)
    rgbs = torch.clamp_min(rgbs + 0.5, 0.0)

    chans = torch.cat([rgbs, proj.depths[:, None]], dim=-1)
    bg4 = torch.cat([background, torch.zeros_like(background[:1])])
    out = rasterize(proj.xys, proj.depths, proj.radii, proj.conics, chans,
                    opac, bg4, height, width, cfg, return_stats=return_stats)
    img, alpha = out[0], out[1]
    rgb = torch.clamp_max(img[..., :3], 1.0)
    depth = torch.where(alpha > 0, img[..., 3] / torch.clamp_min(alpha, 1e-10),
                        torch.full_like(alpha, 1000.0))
    result = {"rgb": rgb, "depth": depth[..., None],
              "accumulation": alpha[..., None]}
    if return_stats:
        result["stats"] = out[2]
    return result
