"""`python -m gaussctrl_tpu_torch.cli.render`: the `ns-gaussctrl-render` role.

Counterpart of `gaussctrl_tpu/cli/render.py`, with its subcommands and
options and the port's `--device` (the card unless `--device cpu`):

  dataset      render every dataset view (rgb/depth/accumulation;
               --save-depth-npy writes the `depth_npy/*.npy` artifacts the
               dataparser discovers)
  camera-path  render a camera-path JSON (nerfstudio's format) to images or
               video: perspective, or equirectangular / omni-directional
               stereo / VR180 through `cameras.stereo`
  interpolate  an interpolated trajectory through the dataset cameras
  spiral       a spiral about the first dataset camera

Every view is one `render_rgbd` (one K1 launch on the card); a panorama
frame is one per strip. Scenes load from an npz checkpoint, an INRIA 3DGS
`.ply` or a splatfacto `.ckpt`. Images are written with PIL; video
(`--output-format video`, mp4v) needs OpenCV and refuses to run without it.

    python -m gaussctrl_tpu_torch.cli.render dataset \\
        --load-checkpoint scene.npz --data data/example_scene \\
        --rendered-output-names rgb depth --save-depth-npy
"""

from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path

import numpy as np
import torch

from gaussctrl_tpu_torch.device import resolve_device
from gaussctrl_tpu_torch.splat.scene import _FIELDS, GaussianScene


def _load_scene(ckpt: str, args=None, device="cpu") -> GaussianScene:
    """A scene from an npz checkpoint, an INRIA `.ply` or a splatfacto
    `.ckpt`, on `device`, cropped when `args.crop_center` is set."""
    if str(ckpt).endswith(".npz"):
        from gaussctrl_tpu_torch.core.ckpt import load_scene_npz
        scene = load_scene_npz(ckpt)
    elif str(ckpt).endswith(".ply"):
        from gaussctrl_tpu_torch.data.ply import read_gaussian_ply
        scene = read_gaussian_ply(ckpt)
    else:
        from gaussctrl_tpu_torch.core.ckpt import import_splatfacto_ckpt
        scene = import_splatfacto_ckpt(ckpt)[0]
    if args is not None and getattr(args, "crop_center", None):
        scene = _crop(scene, args.crop_center, args.crop_scale)
    return GaussianScene(**{k: getattr(scene, k).to(device) for k in _FIELDS})


def _crop(scene: GaussianScene, center, scale) -> GaussianScene:
    """Axis-aligned crop box over the gaussian means: every field indexed by
    the gaussians whose mean lies within `scale / 2` of `center`."""
    c = np.asarray(center, np.float32)
    s = np.asarray(scale, np.float32)
    means = scene.means.detach().cpu().numpy()
    keep = np.all(np.abs(means - c) <= s / 2, axis=-1)
    idx = torch.as_tensor(np.nonzero(keep)[0], device=scene.means.device)
    print(f"[render] crop box keeps {len(idx)}/{len(means)} gaussians")
    return GaussianScene(**{k: getattr(scene, k)[idx] for k in _FIELDS})


def _output_format(args) -> str:
    """"video" or the image format; video needs OpenCV, checked before
    anything is rendered."""
    if args.output_format != "video":
        return args.image_format
    if importlib.util.find_spec("cv2") is None:
        raise RuntimeError("--output-format video writes mp4 with OpenCV "
                           "(cv2), which is not installed; use "
                           "--output-format images")
    return "video"


def _to_uint8(x: np.ndarray) -> np.ndarray:
    return (x * 255).astype(np.uint8)


def _render_views(scene, cams, out_dir: Path, outputs, save_depth_npy=False,
                  fmt="png", fps=24, colormap_near=None, colormap_far=None,
                  background=(0.0, 0.0, 0.0), companions=None):
    """Render every camera of `cams` and write each output as images
    (`<out>/<output>/<i:05d>.<fmt>`) or one video (`<out>/<output>.mp4`);
    depth is shown between its 2nd and 98th percentile unless bounds are
    given, and `companions` (uint8 images) are put beside each frame."""
    from PIL import Image

    from gaussctrl_tpu_torch.splat.render import render_camera

    out_dir.mkdir(parents=True, exist_ok=True)
    frames = {o: [] for o in outputs}
    bg = torch.as_tensor(background, dtype=torch.float32,
                         device=scene.means.device)
    for i in range(len(cams)):
        with torch.no_grad():
            out = render_camera(scene, cams, i, bg)
        for o in outputs:
            if o == "rgb":
                arr = _to_uint8(torch.clamp(out["rgb"], 0, 1).cpu().numpy())
            elif o == "depth":
                d = out["depth"][..., 0].cpu().numpy()
                if save_depth_npy:
                    nd = out_dir / "depth_npy"
                    nd.mkdir(exist_ok=True)
                    np.save(nd / f"{i:05d}.npy", d[..., None])
                finite = d[d < 999]
                near = (colormap_near if colormap_near is not None else
                        float(np.percentile(finite, 2)) if finite.size else 0.0)
                far = (colormap_far if colormap_far is not None else
                       float(np.percentile(finite, 98)) if finite.size else 1.0)
                norm = np.clip((d - near) / max(far - near, 1e-6), 0, 1)
                arr = _to_uint8(np.stack([norm] * 3, -1))
            elif o == "accumulation":
                a = out["accumulation"][..., 0].cpu().numpy()
                arr = _to_uint8(np.stack([a] * 3, -1))
            else:
                raise ValueError(f"unknown output {o}")
            if companions is not None:
                comp = companions[i]
                if comp.shape[:2] != arr.shape[:2]:
                    comp = np.asarray(Image.fromarray(comp).resize(
                        (arr.shape[1], arr.shape[0])))
                arr = np.concatenate([arr, comp], axis=1)
            frames[o].append(arr)
        print(f"[render] view {i + 1}/{len(cams)}", flush=True)

    for o, imgs in frames.items():
        if fmt == "video":
            _write_video(out_dir / f"{o}.mp4", imgs, fps)
        else:
            d = out_dir / o
            d.mkdir(exist_ok=True)
            for i, arr in enumerate(imgs):
                Image.fromarray(arr).save(d / f"{i:05d}.{fmt}")
    print(f"[render] wrote {out_dir}")


def _write_video(path: Path, frames, fps):
    import cv2
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


def _dataset_cameras(data: str, downscale: int | None = None, device="cpu"):
    from gaussctrl_tpu_torch.data.datamanager import (DataManager,
                                                      DataManagerConfig)
    cfg = DataManagerConfig(load_all=True)
    cfg.dataparser.data = data
    if downscale:
        cfg.dataparser.downscale_factor = downscale
    return DataManager(cfg).cameras.to(device)


def _common_kwargs(args):
    return dict(colormap_near=args.depth_near, colormap_far=args.depth_far,
                background=tuple(args.background_color), fps=args.fps)


def _trajectory_cameras(c2ws, cams, device):
    """A camera per pose in `c2ws` with the first dataset camera's
    intrinsics and size."""
    from gaussctrl_tpu_torch.cameras.camera import make_cameras
    return make_cameras(np.asarray(c2ws, np.float32), float(cams.fx[0]),
                        float(cams.fy[0]), float(cams.cx[0]),
                        float(cams.cy[0]), cams.width, cams.height, device)


def cmd_dataset(args):
    dev = resolve_device(args.device)
    scene = _load_scene(args.load_checkpoint, args, dev)
    cams = _dataset_cameras(args.data, args.downscale_factor, dev)
    if args.max_views and args.max_views < len(cams):
        idx = np.linspace(0, len(cams) - 1, args.max_views).astype(int)
        cams = cams[torch.as_tensor(idx, device=dev)]
    _render_views(scene, cams, Path(args.output_path), args.rendered_output_names,
                  save_depth_npy=args.save_depth_npy, fmt=args.image_format,
                  **_common_kwargs(args))


def _write_pano_frames(out: Path, frames, fmt, fps):
    out.mkdir(parents=True, exist_ok=True)
    if fmt == "video":
        _write_video(out / "rgb.mp4", frames, fps)
        return
    from PIL import Image
    for i, f in enumerate(frames):
        Image.fromarray(f).save(out / f"rgb_{i:05d}.{fmt}")


def cmd_camera_path(args):
    from gaussctrl_tpu_torch.cameras.camera import make_cameras
    dev = resolve_device(args.device)
    spec = json.loads(Path(args.camera_path_filename).read_text())
    h, w = int(spec["render_height"]), int(spec["render_width"])
    c2ws, fxs, fys = [], [], []
    for cam in spec["camera_path"]:
        m = np.asarray(cam["camera_to_world"], np.float64).reshape(4, 4)
        c2ws.append(m[:3])
        fov = float(cam.get("fov", spec.get("fov", 75.0)))
        fy = h / (2 * np.tan(np.radians(fov) / 2))
        fys.append(fy)
        fxs.append(fy)  # nerfstudio camera paths use square pixels
    cams = make_cameras(np.asarray(c2ws, np.float32), np.asarray(fxs),
                        np.asarray(fys), w / 2, h / 2, w, h, dev)
    fmt = _output_format(args)
    scene = _load_scene(args.load_checkpoint, args, dev)
    kw = _common_kwargs(args)
    kw["fps"] = float(spec.get("fps", args.fps))
    cam_type = str(spec.get("camera_type", "perspective")).lower().replace(
        "_", "-")
    if cam_type in ("equirectangular", "omni-directional-stereo", "vr-180",
                    "omnidirectional-stereo", "vr180"):
        from gaussctrl_tpu_torch.cameras.stereo import (render_ods,
                                                        render_pano,
                                                        render_vr180)
        bg = tuple(args.background_color)
        frames = []
        for i in range(len(c2ws)):
            if cam_type == "equirectangular":
                f = render_pano(scene, c2ws[i], w, h, bg,
                                strips=args.pano_strips)
            elif cam_type in ("vr-180", "vr180"):
                f = render_vr180(scene, c2ws[i], w, h, bg, ipd=args.ipd,
                                 strips=max(args.pano_strips // 2, 4))
            else:
                f = render_ods(scene, c2ws[i], w, h, bg, ipd=args.ipd,
                               strips=args.pano_strips)
            frames.append(_to_uint8(np.clip(f, 0, 1)))
        out = Path(args.output_path)
        _write_pano_frames(out, frames, fmt, kw["fps"])
        print(f"[render] {len(frames)} {cam_type} frames -> {out}")
        return
    if args.side_by_side and args.data:
        from gaussctrl_tpu_torch.data.datamanager import (DataManager,
                                                          DataManagerConfig)
        dcfg = DataManagerConfig(load_all=True)
        dcfg.dataparser.data = args.data
        dm = DataManager(dcfg)
        train_pos = dm.cameras.c2w[:, :3, 3].numpy()
        companions = []
        for m in c2ws:
            i = int(np.argmin(np.linalg.norm(train_pos - m[:3, 3], axis=-1)))
            img = dm.train_data[i]["image"]
            companions.append(_to_uint8(np.clip(img, 0, 1)))
        kw["companions"] = companions
    _render_views(scene, cams, Path(args.output_path),
                  args.rendered_output_names, fmt=fmt, **kw)


def cmd_interpolate(args):
    dev = resolve_device(args.device)
    cams = _dataset_cameras(args.data)
    c2w = cams.c2w.numpy()
    steps = args.interpolation_steps
    out = []
    for i in range(len(c2w) - 1):
        for t in np.linspace(0, 1, steps, endpoint=False):
            a, b = c2w[i], c2w[i + 1]
            m = (1 - t) * a + t * b
            # re-orthonormalise the rotation (good enough for previews)
            u, _, vt = np.linalg.svd(m[:3, :3])
            m[:3, :3] = u @ vt
            out.append(m)
    interp = _trajectory_cameras(out, cams, dev)
    fmt = _output_format(args)
    scene = _load_scene(args.load_checkpoint, args, dev)
    _render_views(scene, interp, Path(args.output_path),
                  args.rendered_output_names, fmt=fmt, **_common_kwargs(args))


def cmd_spiral(args):
    dev = resolve_device(args.device)
    cams = _dataset_cameras(args.data)
    base = cams.c2w[0].numpy()
    out = []
    for t in np.linspace(0, 2 * np.pi, args.frames, endpoint=False):
        offset = base[:3, :3] @ np.array(
            [np.cos(t) * args.radius, np.sin(t) * args.radius, 0.0])
        m = base.copy()
        m[:3, 3] = base[:3, 3] + offset
        out.append(m)
    spiral = _trajectory_cameras(out, cams, dev)
    fmt = _output_format(args)
    scene = _load_scene(args.load_checkpoint, args, dev)
    _render_views(scene, spiral, Path(args.output_path),
                  args.rendered_output_names, fmt=fmt, **_common_kwargs(args))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gaussctrl-render")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, needs_data=True):
        sp.add_argument("--load-checkpoint", required=True,
                        help="scene checkpoint (.npz, 3DGS .ply or "
                             "splatfacto .ckpt)")
        if needs_data:
            sp.add_argument("--data", required=True)
        sp.add_argument("--output-path", default="renders")
        sp.add_argument("--rendered-output-names", nargs="+",
                        default=["rgb"], choices=["rgb", "depth", "accumulation"])
        sp.add_argument("--image-format", default="png", choices=["png", "jpeg"])
        sp.add_argument("--output-format", default="images",
                        choices=["images", "video"])
        sp.add_argument("--fps", type=float, default=24.0)
        sp.add_argument("--background-color", nargs=3, type=float,
                        default=[0.0, 0.0, 0.0])
        sp.add_argument("--depth-near", type=float, default=None,
                        help="depth colormap near bound (default: 2nd pct)")
        sp.add_argument("--depth-far", type=float, default=None,
                        help="depth colormap far bound (default: 98th pct)")
        sp.add_argument("--crop-center", nargs=3, type=float, default=None,
                        help="crop box center (scene units)")
        sp.add_argument("--crop-scale", nargs=3, type=float,
                        default=[1.0, 1.0, 1.0], help="crop box size")
        sp.add_argument("--device", default=None,
                        help="torch device (default: the card; 'cpu' on "
                             "request)")

    d = sub.add_parser("dataset", help="render every dataset view")
    common(d)
    d.add_argument("--save-depth-npy", action="store_true")
    d.add_argument("--downscale-factor", type=int, default=None,
                   help="render at 1/f resolution (preview)")
    d.add_argument("--max-views", type=int, default=0,
                   help="render only N evenly-spaced views (0 = all)")
    d.set_defaults(fn=cmd_dataset)

    c = sub.add_parser("camera-path", help="render a camera-path JSON")
    common(c, needs_data=False)
    c.add_argument("--camera-path-filename", required=True)
    c.add_argument("--data", default=None,
                   help="dataset dir for --side-by-side")
    c.add_argument("--ipd", type=float, default=0.063,
                   help="inter-pupillary distance for VR180/ODS paths")
    c.add_argument("--pano-strips", type=int, default=32,
                   help="azimuth strips per panorama (VR180/ODS/equirect)")
    c.add_argument("--side-by-side", action="store_true",
                   help="hstack the nearest training view next to each frame")
    c.set_defaults(fn=cmd_camera_path)

    i = sub.add_parser("interpolate", help="interpolate dataset cameras")
    common(i)
    i.add_argument("--interpolation-steps", type=int, default=10)
    i.set_defaults(fn=cmd_interpolate)

    s = sub.add_parser("spiral", help="spiral about the first camera")
    common(s)
    s.add_argument("--frames", type=int, default=60)
    s.add_argument("--radius", type=float, default=0.1)
    s.set_defaults(fn=cmd_spiral)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
