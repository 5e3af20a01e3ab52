"""Camera batches and the world→camera matrix.

Counterpart of `gaussctrl_tpu/cameras/camera.py`: camera-to-world poses in
the nerfstudio/OpenGL convention (+x right, +y up, -z forward); the splatting
convention (+z forward, +y down) comes from the diag(1,-1,-1) column flip and
the world→camera matrix from the analytic inverse.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Cameras:
    """Batch of pinhole cameras. c2w [N,3,4]; fx, fy, cx, cy [N]; one size."""
    c2w: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int

    def __len__(self):
        return self.c2w.shape[0]

    def __getitem__(self, idx) -> "Cameras":
        """A sub-batch (an index array or a slice keeps the batch axis)."""
        return Cameras(self.c2w[idx], self.fx[idx], self.fy[idx],
                       self.cx[idx], self.cy[idx], self.width, self.height)

    def to(self, device) -> "Cameras":
        return Cameras(self.c2w.to(device), self.fx.to(device),
                       self.fy.to(device), self.cx.to(device),
                       self.cy.to(device), self.width, self.height)


_R_EDIT = np.diag(np.array([1.0, -1.0, -1.0], dtype=np.float32))


def view_matrix(c2w: torch.Tensor) -> torch.Tensor:
    """World→camera [4,4] from a [3,4] OpenGL c2w: R' = R·diag(1,-1,-1),
    w2c = [[R'ᵀ, -R'ᵀ t], [0, 1]]."""
    R = c2w[:3, :3] @ torch.as_tensor(_R_EDIT, dtype=c2w.dtype,
                                      device=c2w.device)
    t = c2w[:3, 3:4]
    R_inv = R.T
    t_inv = -R_inv @ t
    top = torch.cat([R_inv, t_inv], dim=1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=c2w.dtype,
                          device=c2w.device)
    return torch.cat([top, bottom], dim=0)


def make_cameras(c2w: np.ndarray, fx, fy, cx, cy, width: int, height: int,
                 device="cpu") -> Cameras:
    """Build a `Cameras` batch from numpy inputs, broadcasting intrinsics."""
    n = c2w.shape[0]

    def vec(v):
        a = np.broadcast_to(np.asarray(v, np.float32).reshape(-1), (n,))
        return torch.tensor(a, device=device)

    return Cameras(torch.tensor(np.asarray(c2w, np.float32), device=device),
                   vec(fx), vec(fy), vec(cx), vec(cy), int(width), int(height))
