"""`python -m gaussctrl_tpu_torch.cli.export`: the `ns-export gaussian-splat`
role.

Counterpart of `gaussctrl_tpu/cli/export.py`: a scene checkpoint (npz,
splatfacto `.ckpt` or INRIA `.ply`) exported to the INRIA 3DGS PLY layout,
which splat viewers read, or to a plain coloured point cloud of the
gaussians whose opacity passes 0.05. It computes nothing on a device, so
`--device` (the card unless `--device cpu`) only says where the scene is
loaded, as for the other entry points.

    python -m gaussctrl_tpu_torch.cli.export --load-checkpoint scene.npz \\
        --output scene.ply [--format point-cloud] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gaussctrl_tpu_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("gaussctrl-export")
    p.add_argument("--load-checkpoint", required=True,
                   help=".npz / splatfacto .ckpt / 3DGS .ply")
    p.add_argument("--output", required=True, help="output .ply path")
    p.add_argument("--format", choices=["gaussian-splat", "point-cloud"],
                   default="gaussian-splat")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' on request)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from gaussctrl_tpu_torch.cli.render import _load_scene
    scene = _load_scene(args.load_checkpoint,
                        device=resolve_device(args.device))
    if args.format == "gaussian-splat":
        from gaussctrl_tpu_torch.data.ply import write_gaussian_ply
        write_gaussian_ply(args.output, scene)
    else:
        from gaussctrl_tpu_torch.data.ply import write_ply
        from gaussctrl_tpu_torch.splat.sh import C0
        rgb = np.clip(scene.features_dc.cpu().numpy() * C0 + 0.5, 0, 1)
        op = torch.sigmoid(scene.opacities[:, 0]).cpu().numpy()
        keep = op > 0.05                         # drop dead/padded slots
        write_ply(args.output, scene.means.cpu().numpy()[keep], rgb[keep])
    print(f"exported {scene.num_gaussians} gaussians -> {args.output}")


if __name__ == "__main__":
    main()
