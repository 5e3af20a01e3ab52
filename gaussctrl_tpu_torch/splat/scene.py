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
