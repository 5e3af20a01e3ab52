"""GaussianScene — the 3DGS parameter set.

Counterpart of `gaussctrl_tpu/splat/scene.py`, with the same storage
conventions (splatfacto's): log-space scales (the renderer applies exp),
logit-space opacities (sigmoid), unnormalised (w,x,y,z) quats, SH features
dc [N,3] + rest [N,K-1,3]. Scenes cross from the JAX package as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
           "features_rest")


@dataclasses.dataclass
class GaussianScene:
    means: torch.Tensor          # [N, 3]
    scales: torch.Tensor         # [N, 3] log-space
    quats: torch.Tensor          # [N, 4] (w, x, y, z), unnormalised
    opacities: torch.Tensor      # [N, 1] logit-space
    features_dc: torch.Tensor    # [N, 3]
    features_rest: torch.Tensor  # [N, K-1, 3]

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        k = 1 + self.features_rest.shape[1]
        return int(round(np.sqrt(k))) - 1

    @property
    def colors(self) -> torch.Tensor:
        """[N, K, 3] full SH coefficient stack (dc first)."""
        return torch.cat([self.features_dc[:, None, :], self.features_rest], 1)

    @classmethod
    def from_numpy(cls, arrays, device="cpu") -> "GaussianScene":
        """From a mapping of field name → numpy array."""
        return cls(**{k: torch.tensor(np.asarray(arrays[k], np.float32),
                                      device=device) for k in _FIELDS})


def random_scene(generator: torch.Generator, n: int, sh_degree: int = 3,
                 extent: float = 1.0, device="cpu") -> GaussianScene:
    """A random scene for tests and the smoke run, drawn from `generator`
    with the same distributions as the JAX package's `random_scene`."""
    num_rest = (sh_degree + 1) ** 2 - 1
    kw = dict(generator=generator, device=device)

    def uniform(shape, lo, hi):
        return torch.rand(shape, **kw) * (hi - lo) + lo

    return GaussianScene(
        means=uniform((n, 3), -extent, extent),
        scales=torch.log(uniform((n, 3), 0.005, 0.05) * extent),
        quats=torch.randn((n, 4), **kw),
        opacities=torch.randn((n, 1), **kw),
        features_dc=torch.randn((n, 3), **kw) * 0.5,
        features_rest=torch.randn((n, num_rest, 3), **kw) * 0.05,
    )


def from_points(points, colors, sh_degree: int = 3,
                init_opacity: float = 0.1, device="cpu") -> GaussianScene:
    """A splatfacto-style seed scene from a sparse point cloud (numpy
    [N, 3] points, colours in [0, 1]): isotropic log-scales from the mean
    distance to the 3 nearest neighbours (the native grid-hash kNN when it
    builds, else exact O(N²) up to 20,000 points, else 0.02), identity
    quats, opacity `init_opacity`, dc = (colour − 0.5) / C0 so that degree-0
    SH reproduces the colour, zero higher-degree SH."""
    from gaussctrl_tpu_torch import native
    n = points.shape[0]
    c0 = 0.28209479177387814
    num_rest = (sh_degree + 1) ** 2 - 1
    pts = np.asarray(points, np.float32)
    if native.available():
        nn = np.maximum(native.knn_mean_dist(pts, 3), 1e-6)
    elif n <= 20000:
        d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        d2_sorted = np.sort(d2, axis=1)
        nn = np.sqrt(np.maximum(d2_sorted[:, 1:4].mean(axis=1), 1e-12))
    else:
        nn = np.full((n,), 0.02, np.float32)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    logit = np.float32(np.log(init_opacity / (1 - init_opacity)))

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return GaussianScene(
        means=t(pts),
        scales=torch.log(t(nn))[:, None].repeat(1, 3),
        quats=t(quats),
        opacities=torch.full((n, 1), float(logit), device=device),
        features_dc=t((np.asarray(colors, np.float32) - 0.5) / c0),
        features_rest=torch.zeros((n, num_rest, 3), device=device))
