"""`python -m gaussctrl_tpu_torch.cli.train`: the whole edit of a scene.

Counterpart of `gaussctrl_tpu/cli/train.py` (`ns-train gaussctrl`): load
the pre-trained scene (a splatfacto `.ckpt` or an npz), render and invert
the selected views, or adopt the artifacts of an earlier run (the resume
path), edit them across views, re-optimise the scene for `render_rate`
steps with step-numbered checkpoints, and write the edit artifacts
(`unedited/`, `depth_npy/`, `z_0/`, `mask_npy/`) in the layout the
dataparser discovers, the edited images, `timings.json` and renders of the
re-optimised scene.

The flags are those of the JAX package: --pipeline.*,
--pipeline.datamanager.*, --optimizers.*, --raster.*, --tiny-sd,
--sam-ckpt, --clip-ckpt, --dino-ckpt, --dino-vocab, plus --device, which
defaults to the card; pass `--device cpu` to run on the CPU.
--pipeline.diffusion_ckpt and --pipeline.controlnet_ckpt name local
diffusers directories to load the networks from (random weights without
them). --pipeline.langsam_obj names the object to edit: its masks come
from SAM (--sam-ckpt, a facebook .pth) prompted with boxes from
GroundingDINO (--dino-ckpt with its --dino-vocab) or from the CLIP proposer
(--clip-ckpt, a transformers CLIPModel directory); without checkpoints the
segmentation networks are tiny random ones. --raster.blend_impl and
--raster.bwd_write are accepted and ignored, with one logged line. Images
are written with PIL, imported when they are written.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch

from gaussctrl_tpu_torch.cli.flags import add_dataclass_flags, apply_overrides
from gaussctrl_tpu_torch.core.ckpt import (checkpoint_step,
                                           import_splatfacto_ckpt,
                                           load_scene_npz, save_checkpoint)
from gaussctrl_tpu_torch.data.datamanager import DataManager, DataManagerConfig
from gaussctrl_tpu_torch.pipeline import GaussCtrlConfig, GaussCtrlPipeline
from gaussctrl_tpu_torch.splat.rasterize import (RasterConfig,
                                                 ignored_flags_line)
from gaussctrl_tpu_torch.splat.render import render_rgbd
from gaussctrl_tpu_torch.splat.trainer import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gaussctrl-train",
        description="GaussCtrl on PyTorch/CUDA: text-driven 3DGS editing")
    p.add_argument("--data", required=True, help="scene dir with transforms.json")
    p.add_argument("--load-checkpoint", required=True,
                   help="pre-trained splatfacto .ckpt (torch) or .npz scene")
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--experiment-name", default=None)
    p.add_argument("--steps-per-save", type=int, default=250)
    p.add_argument("--max-num-iterations", type=int, default=1000)
    p.add_argument("--tiny-sd", action="store_true",
                   help="use the tiny SD config (tests/smoke; random weights)")
    p.add_argument("--sam-ckpt", default="",
                   help="facebook SAM .pth for langsam_obj masking")
    p.add_argument("--clip-ckpt", default="",
                   help="local HF CLIPModel dir for the text->box proposer")
    p.add_argument("--dino-ckpt", default="",
                   help="groundingdino_swinb_cogcoor.pth for the text->box "
                        "stage (preferred over --clip-ckpt when given)")
    p.add_argument("--dino-vocab", default="",
                   help="BERT vocab.txt for the GroundingDINO tokenizer")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' on request)")
    add_dataclass_flags(p, GaussCtrlConfig, "pipeline")
    add_dataclass_flags(p, DataManagerConfig, "pipeline.datamanager")
    add_dataclass_flags(p, TrainConfig, "optimizers")
    add_dataclass_flags(p, RasterConfig, "raster")
    return p


def _save_images(d: Path, images, name) -> None:
    from PIL import Image
    d.mkdir(exist_ok=True)
    for i in range(images.shape[0]):
        arr = (images[i].float().clamp(0, 1).cpu().numpy() * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / name(i))


def main(argv=None):
    args = build_parser().parse_args(argv)
    pcfg = apply_overrides(GaussCtrlConfig(), args, "pipeline")
    dcfg = apply_overrides(DataManagerConfig(), args, "pipeline.datamanager")
    tcfg = apply_overrides(TrainConfig(), args, "optimizers")
    rcfg = apply_overrides(RasterConfig(), args, "raster")
    dcfg.dataparser.data = args.data

    exp = args.experiment_name or Path(args.data).name
    out_dir = (Path(args.output_dir) / exp / "gaussctrl"
               / time.strftime("%Y-%m-%d_%H%M%S"))
    out_dir.mkdir(parents=True, exist_ok=True)

    def log(msg):
        print(f"[gaussctrl] {msg}", flush=True)

    note = ignored_flags_line(args)
    if note:
        log(note)

    log(f"loading data from {args.data}")
    dm = DataManager(dcfg)
    log(f"{len(dm)} edit views selected of {len(dm.parsed)} total")

    log(f"loading scene from {args.load_checkpoint}")
    if str(args.load_checkpoint).endswith(".npz"):
        scene = load_scene_npz(args.load_checkpoint)
        step = checkpoint_step(args.load_checkpoint) or 30000
    else:
        scene, step = import_splatfacto_ckpt(args.load_checkpoint)
    log(f"scene: {scene.num_gaussians} gaussians @ step {step}")

    sd_config = None
    if args.tiny_sd:
        from gaussctrl_tpu_torch.diffusion.config import SDConfig
        sd_config = SDConfig.tiny()
    masker = None
    if pcfg.langsam_obj:
        from gaussctrl_tpu_torch.seg.grounding import build_langsam_equivalent
        masker = build_langsam_equivalent(args.sam_ckpt or None,
                                          args.clip_ckpt or None,
                                          dino_ckpt=args.dino_ckpt or None,
                                          dino_vocab=args.dino_vocab or None,
                                          device=args.device)
        log(f"text->mask stack ready for object '{pcfg.langsam_obj}'")

    pipe = GaussCtrlPipeline(pcfg, scene, dm.cameras, sd_config=sd_config,
                             raster_cfg=rcfg, device=args.device,
                             masker=masker)
    dev = pipe.device
    (out_dir / "dataparser_transforms.json").write_text(json.dumps({
        "transform": np.asarray(dm.parsed.dataparser_transform).tolist(),
        "scale": float(dm.parsed.dataparser_scale),
    }, indent=2))
    (out_dir / "config.json").write_text(json.dumps({
        "pipeline": dataclasses.asdict(pcfg),
        "datamanager": {k: v for k, v in dataclasses.asdict(dcfg).items()
                        if not isinstance(v, dict)},
        "data": str(args.data), "load_checkpoint": str(args.load_checkpoint),
        "device": str(dev),
    }, indent=2, default=str))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings = {}
    t0 = time.time()
    if pipe.load_artifacts(dm.train_data):
        log("precomputed artifacts found — skipping render+invert (resume)")
    else:
        pipe.render_reverse(log_fn=log)
    sync()
    timings["render_invert_s"] = round(time.time() - t0, 2)
    log(f"render+invert done in {timings['render_invert_s']}s")

    # resume artifacts in the dataparser's discovery layout (frame_{i+1:05d})
    for name, arr in (("depth_npy", pipe.depths), ("z_0", pipe.z_T),
                      ("mask_npy", pipe.masks)):
        d = out_dir / name
        d.mkdir(exist_ok=True)
        for i in range(arr.shape[0]):
            np.save(d / f"frame_{i + 1:05d}.npy", arr[i].float().cpu().numpy())
    _save_images(out_dir / "unedited", pipe.unedited,
                 lambda i: f"frame_{i + 1:05d}.jpg")

    t1 = time.time()
    pipe.edit_images(log_fn=log)
    sync()
    timings["edit_s"] = round(time.time() - t1, 2)
    timings["edit_views_per_s"] = round(len(dm) / timings["edit_s"], 4)
    log(f"edit done in {timings['edit_s']}s "
        f"({timings['edit_views_per_s']} views/s)")
    _save_images(out_dir / "edited", pipe.edited, lambda i: f"{i:05d}.png")

    t2 = time.time()

    def ckpt_fn(s, scene):
        path = save_checkpoint(out_dir / "ckpts", step + s, scene)
        log(f"saved {path}")

    pipe.reoptimize(train_cfg=tcfg,
                    log_fn=lambda s, m: log(f"re-opt step {s}: {m}"),
                    ckpt_every=args.steps_per_save, ckpt_fn=ckpt_fn)
    sync()
    timings["reoptimize_s"] = round(time.time() - t2, 2)
    timings["total_s"] = round(time.time() - t0, 2)
    timings["num_views"] = len(dm)
    timings["num_gaussians"] = int(pipe.scene.num_gaussians)
    timings["device"] = str(dev)
    log(f"re-optimization ({pcfg.render_rate} steps) done in "
        f"{timings['reoptimize_s']}s")
    log(f"total wall-clock {timings['total_s']}s")
    (out_dir / "timings.json").write_text(json.dumps(timings, indent=2))

    # renders of the re-optimised scene: up to 8 evenly spaced views
    cams = pipe.cameras
    idx = np.linspace(0, len(cams) - 1, min(8, len(cams))).astype(int)
    renders = []
    with torch.no_grad():
        for i in idx:
            out = render_rgbd(pipe.scene, cams.c2w[i], cams.fx[i], cams.fy[i],
                              cams.cx[i], cams.cy[i], cams.width, cams.height,
                              torch.zeros(3, device=dev), cfg=rcfg)
            renders.append(out["rgb"])
    _save_images(out_dir / "final_renders", torch.stack(renders),
                 lambda k: f"{int(idx[k]):05d}.png")
    log(f"final re-optimized renders -> {out_dir / 'final_renders'}")
    return out_dir


if __name__ == "__main__":
    main()
