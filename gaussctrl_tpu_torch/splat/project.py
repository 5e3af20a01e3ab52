"""EWA gaussian projection.

Counterpart of `gaussctrl_tpu/splat/project.py`: quat→R, Σ = R S Sᵀ Rᵀ, the
perspective Jacobian with the 1.3·tan(fov/2) frustum clamp, the 2D covariance
plus the 0.3 low-pass, conic inversion, the opacity-aware screen radius and
the near-plane cull — the same per-channel arithmetic in the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Projected(NamedTuple):
    xys: torch.Tensor      # [N, 2] pixel-space centres
    depths: torch.Tensor   # [N] view-space z
    radii: torch.Tensor    # [N] float screen radii (0 ⇒ culled)
    conics: torch.Tensor   # [N, 3] upper-tri inverse 2D covariance (a, b, c)
    cov2d: torch.Tensor    # [N, 3] upper-tri 2D covariance


def project_gaussians(means, scales, quats, viewmat, fx, fy, cx, cy,
                      width: int, height: int, clip_thresh: float = 0.01,
                      blur: float = 0.3, opacities=None) -> Projected:
    """means [N,3], linear scales [N,3], quats [N,4], viewmat [4,4];
    opacities [N] post-sigmoid (optional, for the footprint radius)."""
    W_rot = viewmat[:3, :3]
    p_view = means @ W_rot.T + viewmat[:3, 3]
    tz = p_view[:, 2]
    valid = tz > clip_thresh
    tz_safe = torch.where(valid, tz, torch.ones_like(tz))

    tan_fovx = 0.5 * width / fx
    tan_fovy = 0.5 * height / fy
    lim_x, lim_y = 1.3 * tan_fovx, 1.3 * tan_fovy
    tx = torch.clamp(p_view[:, 0] / tz_safe, -lim_x, lim_x) * tz_safe
    ty = torch.clamp(p_view[:, 1] / tz_safe, -lim_y, lim_y) * tz_safe

    q = quats / torch.linalg.norm(quats, dim=-1, keepdim=True).clamp_min(1e-8)
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    sx, sy, sz = scales[:, 0], scales[:, 1], scales[:, 2]
    m00 = (1 - 2 * (qy * qy + qz * qz)) * sx
    m01 = (2 * (qx * qy - qw * qz)) * sy
    m02 = (2 * (qx * qz + qw * qy)) * sz
    m10 = (2 * (qx * qy + qw * qz)) * sx
    m11 = (1 - 2 * (qx * qx + qz * qz)) * sy
    m12 = (2 * (qy * qz - qw * qx)) * sz
    m20 = (2 * (qx * qz - qw * qy)) * sx
    m21 = (2 * (qy * qz + qw * qx)) * sy
    m22 = (1 - 2 * (qx * qx + qy * qy)) * sz
    c00 = m00 * m00 + m01 * m01 + m02 * m02
    c01 = m00 * m10 + m01 * m11 + m02 * m12
    c02 = m00 * m20 + m01 * m21 + m02 * m22
    c11 = m10 * m10 + m11 * m11 + m12 * m12
    c12 = m10 * m20 + m11 * m21 + m12 * m22
    c22 = m20 * m20 + m21 * m21 + m22 * m22

    rz = 1.0 / tz_safe
    rz2 = rz * rz
    w0x, w0y, w0z = W_rot[0, 0], W_rot[0, 1], W_rot[0, 2]
    w1x, w1y, w1z = W_rot[1, 0], W_rot[1, 1], W_rot[1, 2]
    w2x, w2y, w2z = W_rot[2, 0], W_rot[2, 1], W_rot[2, 2]
    a0 = fx * rz
    a2 = -fx * tx * rz2
    b1 = fy * rz
    b2 = -fy * ty * rz2
    t0x = a0 * w0x + a2 * w2x
    t0y = a0 * w0y + a2 * w2y
    t0z = a0 * w0z + a2 * w2z
    t1x = b1 * w1x + b2 * w2x
    t1y = b1 * w1y + b2 * w2y
    t1z = b1 * w1z + b2 * w2z
    u0x = c00 * t0x + c01 * t0y + c02 * t0z
    u0y = c01 * t0x + c11 * t0y + c12 * t0z
    u0z = c02 * t0x + c12 * t0y + c22 * t0z
    a = t0x * u0x + t0y * u0y + t0z * u0z + blur
    b = t1x * u0x + t1y * u0y + t1z * u0z
    u1x = c00 * t1x + c01 * t1y + c02 * t1z
    u1y = c01 * t1x + c11 * t1y + c12 * t1z
    u1z = c02 * t1x + c12 * t1y + c22 * t1z
    c = t1x * u1x + t1y * u1y + t1z * u1z + blur

    det = a * c - b * b
    det_safe = torch.where(det > 0, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)

    mid = 0.5 * (a + c)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lam1 = mid + disc
    sigma = torch.sqrt(torch.clamp_min(lam1, 0.0))
    if opacities is not None:
        mult = torch.sqrt(2.0 * torch.log(torch.clamp_min(opacities * 255.0,
                                                          1e-6)))
        radius = torch.ceil(torch.clamp_max(mult, 3.0) * sigma)
        radius = torch.where(opacities * 255.0 > 1.0, radius,
                             torch.zeros_like(radius))
    else:
        radius = torch.ceil(3.0 * sigma)

    xys = torch.stack([fx * p_view[:, 0] * rz + cx,
                       fy * p_view[:, 1] * rz + cy], -1)
    ok = valid & (det > 0)
    radius = torch.where(ok, radius, torch.zeros_like(radius))
    return Projected(xys=xys, depths=tz, radii=radius, conics=conic,
                     cov2d=torch.stack([a, b, c], -1))
