"""`python -m gaussctrl_tpu_torch.cli.splat_train`: from-scratch 3DGS
pre-training (the `ns-train splatfacto` role).

Counterpart of `gaussctrl_tpu/cli/splat_train.py`: parse the scene, seed
gaussians from its sparse point cloud, pre-train with densification
(`splat/pretrain.py`; kernels K1 and K4 on the card), and write, under
`<output-dir>/<experiment>/splat/<timestamp>/`, `dataparser_transforms.json`,
`events.jsonl`, step-numbered npz checkpoints in `ckpts/` (the final one
included; the edit CLI reads them with `--load-checkpoint`) and four
full-resolution renders in `final_renders/`.

The flags are the JAX CLI's: --data, --output-dir, --experiment-name,
--sh-degree, --seed, --resume-checkpoint, --archive-ckpts, --trainer.*
(PretrainConfig, with --trainer.densify.* and --trainer.train.*) and
--raster.*, plus --device, which defaults to the card (`--device cpu` runs
on the CPU). The JAX CLI's --trainer.fullres_blend has no counterpart: the
port blends with K1/K4 at every resolution; --raster.blend_impl and
--raster.bwd_write are accepted and ignored, with one logged line.

    python -m gaussctrl_tpu_torch.cli.splat_train --data data/example_scene \\
        --trainer.num_steps 3000
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from gaussctrl_tpu_torch.cli.flags import add_dataclass_flags, apply_overrides
from gaussctrl_tpu_torch.core.ckpt import (checkpoint_step, compress_scene_npz,
                                           load_scene_npz, save_checkpoint)
from gaussctrl_tpu_torch.core.writer import MetricsWriter
from gaussctrl_tpu_torch.data.datamanager import DataManager, DataManagerConfig
from gaussctrl_tpu_torch.splat.pretrain import PretrainConfig, pretrain
from gaussctrl_tpu_torch.splat.rasterize import (RasterConfig,
                                                 ignored_flags_line)
from gaussctrl_tpu_torch.splat.render import render_camera


def _git_tracked_archives(ckpt_dir: Path) -> set[str]:
    """Names of the fp16 archives in `ckpt_dir` that git tracks: pruning
    never unlinks one (a tracked archive is retired by whoever commits the
    newer one)."""
    try:
        out = subprocess.run(
            ["git", "ls-files", "--", "step-*.fp16.npz"],
            capture_output=True, text=True, cwd=str(ckpt_dir), timeout=30)
        return {Path(line).name for line in out.stdout.splitlines() if line}
    except (OSError, subprocess.SubprocessError):
        return set()


def _save_ckpt(ckpt_dir, step, scene, archive: bool):
    """A step-numbered checkpoint and, with `archive`, its fp16 archive;
    archives are latest-only except those git tracks."""
    out = save_checkpoint(ckpt_dir, step, scene)
    if archive:
        arch = compress_scene_npz(out, out.with_suffix(".fp16.npz"))
        tracked = _git_tracked_archives(Path(ckpt_dir))
        for f in Path(ckpt_dir).glob("step-*.fp16.npz"):
            if f != arch and f.name not in tracked:
                f.unlink()
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gaussctrl-splat-train",
                                description="3DGS pre-training (splatfacto "
                                            "role) on PyTorch/CUDA")
    p.add_argument("--data", required=True)
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--experiment-name", default=None)
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume-checkpoint", default=None,
                   help="mid-run scene .npz to resume from (step parsed "
                        "from the filename; schedules continue)")
    p.add_argument("--archive-ckpts", action="store_true",
                   help="also write a compressed fp16 archive next to every "
                        "checkpoint (step-*.fp16.npz, ~4x smaller; resume "
                        "accepts it)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' on request)")
    add_dataclass_flags(p, PretrainConfig, "trainer")
    add_dataclass_flags(p, RasterConfig, "raster")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = apply_overrides(PretrainConfig(), args, "trainer")
    raster_cfg = apply_overrides(RasterConfig(), args, "raster")
    note = ignored_flags_line(args)
    if note:
        print(f"[splat-train] {note}", flush=True)
    init_scene, start_step = None, 0
    if args.resume_checkpoint:
        init_scene = load_scene_npz(args.resume_checkpoint)
        start_step = checkpoint_step(args.resume_checkpoint) or 0
        print(f"[splat-train] resuming from {args.resume_checkpoint} "
              f"@ step {start_step} ({init_scene.num_gaussians} gaussians)",
              flush=True)
    dcfg = DataManagerConfig(load_all=True)
    dcfg.dataparser.data = args.data
    dm = DataManager(dcfg)
    parsed = dm.parsed
    if parsed.points_xyz is None:
        raise ValueError(f"{args.data} has no ply_file_path sparse point cloud")

    exp = args.experiment_name or Path(args.data).name
    out_dir = Path(args.output_dir) / exp / "splat" / time.strftime(
        "%Y-%m-%d_%H%M%S")
    out_dir.mkdir(parents=True, exist_ok=True)
    writer = MetricsWriter(str(out_dir), echo_every=200)
    (out_dir / "dataparser_transforms.json").write_text(json.dumps({
        "transform": np.asarray(parsed.dataparser_transform).tolist(),
        "scale": float(parsed.dataparser_scale),
    }, indent=2))

    print(f"[splat-train] {len(dm)} views, "
          f"{parsed.points_xyz.shape[0]} seed points, "
          f"{cfg.num_steps} steps", flush=True)
    t0 = time.time()
    scene, _ = pretrain(
        dm.cameras, dm.stacked_images(), parsed.points_xyz,
        parsed.points_rgb if parsed.points_rgb is not None
        else np.full_like(parsed.points_xyz, 0.5),
        cfg, sh_degree=args.sh_degree, raster_cfg=raster_cfg, seed=args.seed,
        log_fn=lambda s, m: writer.write(s, m),
        ckpt_fn=lambda s, sc: _save_ckpt(out_dir / "ckpts", s, sc,
                                         args.archive_ckpts),
        init_scene=init_scene, start_step=start_step, device=args.device)
    print(f"[splat-train] done in {time.time() - t0:.0f}s: "
          f"{scene.num_gaussians} gaussians", flush=True)
    path = _save_ckpt(out_dir / "ckpts", cfg.num_steps, scene,
                      args.archive_ckpts)
    print(f"[splat-train] saved {path}", flush=True)
    writer.close()

    # full-resolution renders of 4 evenly spaced views
    from PIL import Image

    cams = dm.cameras.to(scene.means.device)
    rd = out_dir / "final_renders"
    rd.mkdir(exist_ok=True)
    bg = torch.zeros(3, device=scene.means.device)
    with torch.no_grad():
        for i in np.linspace(0, len(cams) - 1, min(4, len(cams))).astype(int):
            out = render_camera(scene, cams, int(i), bg, cfg=raster_cfg)
            arr = (out["rgb"].clamp(0, 1).cpu().numpy() * 255).astype(np.uint8)
            Image.fromarray(arr).save(rd / f"{int(i):05d}.png")
    print(f"[splat-train] final renders -> {rd}", flush=True)
    return path


if __name__ == "__main__":
    main()
