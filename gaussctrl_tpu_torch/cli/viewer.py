"""`python -m gaussctrl_tpu_torch.cli.viewer`: the `ns-viewer` role.

Counterpart of `gaussctrl_tpu/cli/viewer.py`: load a scene checkpoint (npz,
splatfacto `.ckpt` or INRIA `.ply`) onto the card (`--device cpu` on
request) and serve the orbit viewer of `viewer.ViewerServer` on `--port`.

    python -m gaussctrl_tpu_torch.cli.viewer --load-checkpoint scene.npz \\
        --data data/example_scene --port 7007
"""

from __future__ import annotations

import argparse

from gaussctrl_tpu_torch.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gaussctrl-viewer")
    p.add_argument("--load-checkpoint", required=True,
                   help="scene checkpoint (.npz / splatfacto .ckpt / "
                        "3DGS .ply)")
    p.add_argument("--data", default=None,
                   help="scene data dir (enables train-camera markers and "
                        "exact jump-to-train-view)")
    p.add_argument("--port", type=int, default=7007)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' on request)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    from gaussctrl_tpu_torch.cli.render import _load_scene
    scene = _load_scene(args.load_checkpoint, device=dev)
    print(f"[viewer] {scene.num_gaussians} gaussians", flush=True)

    cameras = None
    if args.data:
        from gaussctrl_tpu_torch.data.datamanager import (DataManager,
                                                          DataManagerConfig)
        dcfg = DataManagerConfig()
        dcfg.dataparser.data = args.data
        cameras = DataManager(dcfg).cameras
        print(f"[viewer] {len(cameras)} train cameras", flush=True)

    from gaussctrl_tpu_torch.viewer import ViewerServer
    ViewerServer(scene, args.width, args.height, port=args.port,
                 cameras=cameras).serve()


if __name__ == "__main__":
    main()
