"""Scene → image rendering: one fused [r, g, b, depth] pass.

Counterpart of `gaussctrl_tpu/splat/render.py:render_rgbd`: RGB and depth are
composited in a single 4-channel rasterization, and depth is alpha-normalised
with 1000 where nothing was hit. `render_camera` renders one camera of a
batch. With a `mesh` the scene is this rank's block of a gaussian-sharded
scene: projection and SH run on its rows, their results are gathered in
rank order (`core.mesh.AllGatherRows`), and the binning, the blend and what
follows run alike on every rank.
"""

from __future__ import annotations

import torch

from gaussctrl_tpu_torch.cameras.camera import Cameras, view_matrix
from gaussctrl_tpu_torch.core.mesh import AllGatherRows, gather_rows
from gaussctrl_tpu_torch.splat.project import project_gaussians
from gaussctrl_tpu_torch.splat.rasterize import RasterConfig, rasterize
from gaussctrl_tpu_torch.splat.scene import GaussianScene
from gaussctrl_tpu_torch.splat.sh import eval_sh


def render_rgbd(scene: GaussianScene, c2w: torch.Tensor, fx, fy, cx, cy,
                width: int, height: int, background: torch.Tensor,
                sh_degree: int | None = None,
                cfg: RasterConfig = RasterConfig(),
                return_stats: bool = False,
                xys_shift: torch.Tensor | None = None, mesh=None):
    """Render one view: dict(rgb [H,W,3], depth [H,W,1], accumulation
    [H,W,1], radii [N], the projection's opacity-aware screen radii, 0 for
    a gaussian it culls) and, with `return_stats`, the rasterizer counters.

    `xys_shift` [N, 2] (zeros) is added to the projected centres: the
    gradient with respect to it is the exact pixel-space positional
    gradient (splatfacto's densification statistic), which the blend's
    backward (kernel K4 on the card) gives in its xy rows. `mesh`: the
    gaussian-sharded form (module docstring); `radii` are then all N."""
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
    xys = proj.xys if xys_shift is None else proj.xys + xys_shift
    conics, depths, radii = proj.conics, proj.depths, proj.radii
    if mesh is not None:
        # one gather of the projected rows: global index = unsharded index,
        # so the stable depth sort orders exactly as it does unsharded
        rows = AllGatherRows.apply(
            torch.cat([xys, conics, chans, opac[:, None]], dim=-1), mesh)
        xys, conics, chans, opac = rows.split([2, 3, 4, 1], dim=-1)
        opac, depths = opac[:, 0], chans[:, 3].detach()
        radii = gather_rows(radii, mesh)
    out = rasterize(xys, depths, radii, conics, chans, opac, bg4, height,
                    width, cfg, return_stats=return_stats)
    img, alpha = out[0], out[1]
    rgb = torch.clamp_max(img[..., :3], 1.0)
    depth = torch.where(alpha > 0, img[..., 3] / torch.clamp_min(alpha, 1e-10),
                        torch.full_like(alpha, 1000.0))
    result = {"rgb": rgb, "depth": depth[..., None],
              "accumulation": alpha[..., None], "radii": radii}
    if return_stats:
        result["stats"] = out[2]
    return result


def render_camera(scene: GaussianScene, cameras: Cameras, idx: int,
                  background: torch.Tensor, sh_degree: int | None = None,
                  cfg: RasterConfig = RasterConfig()):
    """Render the `idx`-th camera of a batch (`render_rgbd`'s dict)."""
    return render_rgbd(scene, cameras.c2w[idx], cameras.fx[idx],
                       cameras.fy[idx], cameras.cx[idx], cameras.cy[idx],
                       cameras.width, cameras.height, background, sh_degree,
                       cfg)
