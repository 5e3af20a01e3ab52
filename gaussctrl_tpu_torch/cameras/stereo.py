"""Omni-directional stereo (ODS) / VR180 / equirectangular rendering.

Counterpart of `gaussctrl_tpu/cameras/stereo.py`. A tile rasterizer is
pinhole-only, so the panorama is swept in narrow azimuth strips: each strip
is a pinhole render (K1 on the card) whose camera sits at that strip's ODS
eye position (the per-column ray-origin circle, quantised to one origin per
strip), and the strip's pixels are resampled into equirectangular
coordinates exactly:

    u = fx·tan(α) ,  v = fy·tan(φ)/cos(α)

for azimuth α relative to the strip centre and pitch φ. Pitch is rendered
to ±`max_pitch`; the polar caps clamp to the edge row.

Layouts are nerfstudio's: ODS stacks the left eye on top of the right (each
W×H/2); VR180 puts left|right side by side (each W/2×H over a 180° field);
`equirectangular` is the monocular 360° panorama (ipd 0). The camera
geometry and the resampling are numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from gaussctrl_tpu_torch.splat.rasterize import RasterConfig


def _strip_camera(base_c2w: np.ndarray, theta_c: float, eye: float,
                  ipd: float) -> np.ndarray:
    """Pinhole c2w for the strip centred at azimuth `theta_c`.

    eye ∈ {-1 (left), 0 (mono), +1 (right)}; the origin sits on the ODS view
    circle: c + eye·(ipd/2)·(d̂(θ)×ŷ), forward = d̂(θ).
    """
    x, y, z = base_c2w[:3, 0], base_c2w[:3, 1], base_c2w[:3, 2]
    c = base_c2w[:3, 3]
    ct, st = np.cos(theta_c), np.sin(theta_c)
    z_new = -st * x + ct * z          # backward axis of the yawed frame
    x_new = ct * x + st * z
    fwd = -z_new
    origin = c + eye * (ipd / 2.0) * np.cross(fwd, y)
    return np.stack([x_new, y, z_new, origin], axis=1).astype(np.float32)


def _resample_strip(img: np.ndarray, alphas: np.ndarray, phis: np.ndarray,
                    fx: float, fy: float, cx: float, cy: float) -> np.ndarray:
    """Bilinear pull of pano pixels (azimuth α × pitch φ) from a strip render."""
    u = fx * np.tan(alphas)[None, :] + cx                       # [1, Wp]
    # the view matrix flips the camera to y-down, so an upward pitch (φ > 0)
    # projects above the principal point: v = cy − fy·tan(φ)/cos(α)
    v = cy - fy * (np.tan(phis)[:, None] / np.cos(alphas)[None, :])
    u = np.clip(u, 0.0, img.shape[1] - 1.001)
    v = np.clip(np.broadcast_to(v, (phis.size, alphas.size)),
                0.0, img.shape[0] - 1.001)
    u = np.broadcast_to(u, v.shape)
    u0, v0 = u.astype(np.int32), v.astype(np.int32)
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    p00 = img[v0, u0]
    p01 = img[v0, u0 + 1]
    p10 = img[v0 + 1, u0]
    p11 = img[v0 + 1, u0 + 1]
    return (p00 * (1 - du) * (1 - dv) + p01 * du * (1 - dv)
            + p10 * (1 - du) * dv + p11 * du * dv)


def strip_size(width: int, height: int, hfov: float = 2 * np.pi,
               strips: int = 32, max_pitch: float = np.radians(75.0)):
    """(fx, fy, w, h) of the strip pinhole: at least the panorama's sampling
    density at the strip centre, and 2 px of margin on every side."""
    d_theta = hfov / strips
    fx = width / hfov * 1.25
    fy = height / np.pi * 1.25
    w_r = int(np.ceil(2 * fx * np.tan(d_theta / 2))) + 4
    h_r = int(np.ceil(2 * fy * np.tan(max_pitch) / np.cos(d_theta / 2))) + 4
    return fx, fy, w_r, h_r


def render_pano(scene, base_c2w, width: int, height: int, background,
                eye: float = 0.0, ipd: float = 0.063,
                hfov: float = 2 * np.pi, strips: int = 32,
                max_pitch: float = np.radians(75.0),
                raster_cfg: RasterConfig = RasterConfig(),
                render_fn=None) -> np.ndarray:
    """One equirectangular panorama [height, width, 3] for one eye.

    `hfov` 2π for ODS/360, π for VR180. `render_fn(scene, c2w, fx, fy, cx,
    cy, w, h)` injects the renderer; by default `render_rgbd`'s rgb on the
    scene's device (one K1 launch a strip on the card)."""
    if render_fn is None:
        from gaussctrl_tpu_torch.splat.render import render_rgbd

        dev = scene.means.device
        bg = torch.as_tensor(background, dtype=torch.float32, device=dev)

        def render_fn(scene, c2w, fx, fy, cx, cy, w, h):
            with torch.no_grad():
                out = render_rgbd(scene, torch.as_tensor(c2w, device=dev),
                                  fx, fy, cx, cy, w, h, bg, cfg=raster_cfg)
            return out["rgb"].cpu().numpy()

    base_c2w = np.asarray(base_c2w, np.float64)
    d_theta = hfov / strips
    fx, fy, w_r, h_r = strip_size(width, height, hfov, strips, max_pitch)
    cx, cy = w_r / 2.0, h_r / 2.0

    # pano angle grids (pitch +π/2 top → −π/2 bottom), caps clamped
    phis = (0.5 - (np.arange(height) + 0.5) / height) * np.pi
    phis = np.clip(phis, -max_pitch, max_pitch)
    pano = np.zeros((height, width, 3), np.float32)
    for s, cols in enumerate(np.array_split(np.arange(width), strips)):
        theta_c = -hfov / 2 + (s + 0.5) * d_theta
        thetas = -hfov / 2 + (cols + 0.5) / width * hfov
        c2w = _strip_camera(base_c2w, theta_c, eye, ipd)
        img = render_fn(scene, c2w, fx, fy, cx, cy, w_r, h_r)
        pano[:, cols] = _resample_strip(np.asarray(img, np.float32),
                                        thetas - theta_c, phis, fx, fy, cx, cy)
    return pano


def render_ods(scene, base_c2w, width: int, height: int, background,
               ipd: float = 0.063, strips: int = 32,
               raster_cfg: RasterConfig = RasterConfig(),
               render_fn=None) -> np.ndarray:
    """Omni-directional stereo frame [height, width, 3]: the left eye stacked
    on top of the right."""
    eyes = []
    for eye in (-1.0, 1.0):
        eyes.append(render_pano(scene, base_c2w, width, height // 2,
                                background, eye=eye, ipd=ipd,
                                hfov=2 * np.pi, strips=strips,
                                raster_cfg=raster_cfg, render_fn=render_fn))
    return np.concatenate(eyes, axis=0)


def render_vr180(scene, base_c2w, width: int, height: int, background,
                 ipd: float = 0.063, strips: int = 16,
                 raster_cfg: RasterConfig = RasterConfig(),
                 render_fn=None) -> np.ndarray:
    """VR180 frame [height, width, 3]: left|right half-equirectangular
    panoramas side by side."""
    eyes = []
    for eye in (-1.0, 1.0):
        eyes.append(render_pano(scene, base_c2w, width // 2, height,
                                background, eye=eye, ipd=ipd, hfov=np.pi,
                                strips=strips, raster_cfg=raster_cfg,
                                render_fn=render_fn))
    return np.concatenate(eyes, axis=1)
