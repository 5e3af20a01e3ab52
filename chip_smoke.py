#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gaussctrl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                     # 8 views x 10 DDIM steps, 100 re-opt steps
    python3 chip_smoke.py --views 40 --steps 20 --reopt-steps 500
                                              # the reference protocol

Phases, each printing one JSON line with its wall time:

  1. environment  card name and power limit (nvidia-smi), torch and CUDA,
                  and whether PIL (the CLI's image writer) is installed;
  2. build        the kernel library (one nvcc call over every csrc/*.cu,
                  compiling them in parallel); then `sass`: registers,
                  spills, shared memory and the count of HGMMA (wgmma)
                  instructions of every instantiation of the attention
                  kernels (K2/K6, K3, K5), from ptxas and cuobjdump, failing
                  if one is missing, has none or was serialized by ptxas,
                  and the same facts of K1 and K4 with their resident
                  blocks per SM;
  3. kernels      K1 (splat blend), K4 (its backward), K2 (inversion
                  attention), K3 (cross-view attention), K5 (single-shot
                  standard-layout attention: text cross-attention, composed
                  references) and K6 (streaming attention: the VAE
                  mid-block, composed references) held against their plain
                  PyTorch versions on the card at the main path's shapes,
                  with the tolerance stated, and timed beside their plain
                  versions, one PyTorch library call where one computes the
                  same function, and their bound at 989 TFLOP/s bf16 /
                  67 TFLOP/s fp32 / 3.35 TB/s / 3.9e12 exponentials a
                  second (attention takes one per score);
  4. small        a tiny-config pipeline on the card against the same
                  pipeline on the CPU (plain versions), both bf16, with
                  each K2/K3/K5/K6 call on the card also held against its
                  plain version on its own inputs;
  5. train        a few re-optimisation steps of a tiny scene on the card
                  against the CPU in float32 (loss and first-step
                  gradients), each K4 call also held against its plain
                  version on its own inputs; then `reopt_split`: one warmed
                  full-width re-optimisation step timed in its parts;
  5c. golden     the port against the JAX package's golden
                  (tests/golden/torch_sd15.npz: SD-1.5 widths, a
                  200,000-gaussian scene at 512x512, made on the CPU in
                  float32 by scripts/torch_golden.py): the seeded weight
                  files rewritten from their seed with their sha256 checked,
                  then every case (text, vae_encode, invert_step, edit_step,
                  vae_decode, render, reopt_step, run) three ways: the plain
                  versions in float32 within the CPU's tolerance, the plain
                  versions in bf16, and K1-K6 as the main path runs them,
                  within twice the bf16 plain gap (the CPU's tolerance where
                  the path is float32), with exact launch counts and every
                  kernel held in situ;
  6a. weights    the seeded random SD-1.5 weights written to a temporary
                  diffusers layout (unet/, vae/, controlnet as fp16
                  safetensors from the port's writer, the VAE mid-block
                  under legacy names with nonzero q/k/v biases,
                  text_encoder/pytorch_model.bin with position_ids, a small
                  BPE tokenizer/, and beside them the text encoder as
                  model.safetensors with its I64 position_ids) and read
                  back by the port's loader, every tensor bit for bit, the
                  safetensors text encoder also loaded strictly into an
                  SD-1.5 text model, with bytes and write/read seconds;
  6. main path    GaussCtrlPipeline.run() with the pipeline built from those
                  directories (--pipeline.diffusion_ckpt/controlnet_ckpt,
                  cast once to bf16): render_reverse(), edit_images() and
                  reoptimize() at SD-1.5 width on a seeded random scene of
                  200,000 gaussians: finite outputs of the right shapes,
                  finite re-optimisation losses, the files' VAE biases and
                  tokenizer in the pipeline, and exact launch counts for
                  every kernel;
  7. composed     one edit step at SD-1.5 width on the fused route (K3 at
                  4096/1024/256 tokens) and on the composed route
                  (allow_fused=False: K2 for the self branch, K5/K6 for the
                  references), every composed call held in situ against K3
                  on its inputs, the two steps' outputs held to twice the
                  gap bf16 rounding alone sets there, and both routes timed
                  per token level;
  7a. mesh       the device mesh (core/mesh.py): entry() (one cross-view
                  CFG denoise step at SD-1.5 widths on zero weights) with
                  exact K3/K5 launches and its ms; run() with
                  mesh=make_mesh() (NCCL, a world of one) on the main path's
                  weights, chunk_size 0, 3 DDIM and 10 re-optimisation
                  steps, bit for bit against the same run() without a
                  mesh, exact K1-K6 launches, views/s of both, and a
                  sharded checkpoint round trip (torch.distributed.
                  checkpoint) bit for bit; then two spawned ranks on the one
                  card over gloo: the view-sharded edit of those inputs (all
                  at once and chunked) against one rank's, held to twice
                  the gap batch composition sets, and the gaussian-sharded
                  re-optimisation step of the smoke scene at 512x512
                  against the unsharded one (loss rtol 1e-5, means rtol
                  1e-4 / atol 1e-6), with both steps' ms;
  7b. masked_edit  text-prompted object masks at full width: random SAM
                  ViT-H, GroundingDINO Swin-B and CLIP ViT-L/14 (with the
                  SD-1.5 text tower) written in the reference layouts
                  (facebook .pth, the official nested .pth with a vocab.txt,
                  a transformers CLIPModel directory) and read back by the
                  port's loaders bit for bit; GaussCtrlPipeline.run() with
                  langsam_obj and a GroundedSAMMasker over GroundingDINO on a
                  fresh smoke scene (2 DDIM steps, 10 re-optimisation steps,
                  exact launch counts of K1-K6); the masks exactly 0/1, the
                  edit equal to the unedited render bit for bit wherever a
                  mask is 0, a view without a box all zero; the CLIP
                  proposer's route and the CLIP metrics on the same views;
                  the tiny segmentation stack on the card against the CPU,
                  and SAM and GroundingDINO at full width in float32 against
                  float64 on one view; the proposer's, SAM's and the masked
                  run's seconds, detections and coverage per view;
  8. pretrain     splat.pretrain.pretrain at full width: 401 steps from
                  100,000 grey seeds against 16 orbit views (512x512) of
                  the smoke scene, across 128/256/512 px, three refines, a
                  doubling of the buffer with Adam's state moved onto the
                  new leaves, an opacity reset and cull-only passes; K1 and
                  K4 held in situ at each resolution, the densify
                  candidates from K4's xy rows against those from the plain
                  backward's (agreeing outside a stated band around the
                  threshold), exact K1/K4 launch counts, births, a rising
                  eval PSNR, and ms per step at each resolution;
  9. splat_train  python -m gaussctrl_tpu_torch.cli.splat_train on
                  data/example_scene (300 steps, one refine, the resolution
                  ramp) in a subprocess: its checkpoint (loaded back),
                  dataparser_transforms.json, events.jsonl and renders;
  10. render      python -m gaussctrl_tpu_torch.cli.render in process:
                  `dataset` of that checkpoint (rgb, depth, accumulation,
                  depth_npy), and on the smoke scene saved as .npz
                  `camera-path` (8 perspective views at 512x512, one
                  equirectangular 1024x512, one ODS and one VR180 frame),
                  `spiral` (an mp4 where OpenCV is installed) and
                  `interpolate`; exact K1 launches (one a view,
                  one a panorama strip), K1 against the CPU's plain blend
                  at each shape: a 512x512 view, a 45x1532 panorama strip,
                  a 45x768 ODS strip and a 200x200 dataset view, ms a view
                  and a panorama frame, and one render traced by
                  `core.writer.cuda_trace`, whose trace names K1 as often
                  as the counter;
  11. viewer      viewer.ViewerServer on the smoke scene at 512x512 on
                  127.0.0.1: the page, /info, POSTs in every mode, with
                  markers and with view jumps (one K1 launch each, each the
                  JPEG of its frame), two requests at once from two
                  threads, and the latency of sequential requests;
  12. export      python -m gaussctrl_tpu_torch.cli.export of both scenes to
                  gaussian-splat and point-cloud PLYs, read back bit for
                  bit;
  13. certify     python -m gaussctrl_tpu_torch.cli.certify (run after 7b,
                  while the files of 6a and 7b exist) on the SD-1.5
                  directories, their ControlNet given trained-like output
                  convs, and the SAM ViT-H / GroundingDINO Swin-B files, at
                  10 DDIM steps: no check with an error or a non-finite
                  number, the schedule and both ControlNet checks ok, the
                  checks that random weights fail recorded, exact
                  K2/K3/K5/K6 launches and each check's seconds.

Then a `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero, and
without a card or without the package beside it the script exits non-zero
before printing any result. This script imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the rate
# of their type.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# exponentials a second on the SFUs: 16 a clock on each of 132 SMs at
# 1.83 GHz (the FlashAttention-3 paper's figure). Attention takes one exp2
# per score, which at head width 40 (160 tensor FLOP a score) is the floor.
PEAK_EXP = 3.9e12

# Attention levels of SD-1.5 at 512x512: (tokens, channels); 8 heads each.
LEVELS = [(4096, 320), (1024, 640), (256, 1280), (64, 1280)]
HEADS = 8
DEVICE = "cuda"
# the edit settings of the run: 4 reference views, chunks of 4, so K3 sees
# G = 2 CFG groups of F = 8 views whatever the number of views
REFS, CHUNK = 4, 4
# the smoke scene and views: a seeded random scene of 200,000 gaussians at
# SH degree 3, 512x512 views; seeded random SD-1.5 weights; 20 timing reps
GAUSSIANS, SIZE, WEIGHTS_SEED, REPS = 200_000, 512, 0, 20
# the tiny pipeline on the card against the CPU, both bf16: renders are
# float32 and held by max abs error; z_T and the edits pass through bf16
# networks whose every layer rounds differently on the two (cuDNN/cuBLAS/
# the attention kernels against the CPU's), and the random tiny networks
# amplify that: on an H100 they read a relative RMS of 0.031 (z_T) and
# 0.038 (edited), held to 0.05 and 0.06. The kernels' own share is held
# sharply in situ.
SMALL_REL_TOL = dict(z_T=0.05, edited=0.06)
# re-optimisation steps of the main path (the reference runs render_rate =
# 500; --reopt-steps 500 gives that)
REOPT_STEPS = 100
# fp32 operations per (instance, pixel) pair that the function needs.
# K1: sigma, alpha, the gates, the weight, ch = 4 channel sums, the
# transmittance. K4 (ch = 4), the one replay the VJP needs, as the JAX
# kernel writes it: dx, dy 2; sigma 9; exp(-sigma) 2; alpha_raw and the
# 0.999 clamp 2; the keep gate and alpha 4; m and w 4; g.c 7; q, prefix,
# S_i 3; T update 2 (replay 35); dL/dalpha with its gate 8; g_sigma 2; xy
# 8; conic 8; colour 4; opacity 1 (gradient 31); the sum of the 10 row
# values over the tile's pixels 10. Total 76. The pairs are those of the
# instances K1 blended (whole batches of 128 up to saturation).
OPS_PER_PAIR_FWD = 30
OPS_PER_PAIR_BWD = 76
# K1 against its plain version, absolute: the same fp32 function with
# ex2.approx, the transmittance product taken in another order; depth
# (channel 4) reaches ~5, so 1e-3
K1_TOL = 1e-3
# K4 rows held per group (xy, conic, colour, opacity) against the plain
# backward on the same inputs: the largest error over the group's largest
# |value| (fp32 sums over 256 pixels, and S_i = Q - prefix_i, in another
# order; 1/(1 - alpha) reaches 1000 below the 0.999 gate). On an H100 the
# worst group reads 6.2e-5 at 512x512.
K4_SCALED_TOL = 1e-3
# the tiny training run, card against CPU, both float32 (TF32 off): the
# blend may stop at other instances on the two (K1 per tile and 256-
# instance batch, the plain version per chunk of tiles), which moves T_fin
# below 1e-4; losses at rtol 1e-5 and first-step gradients at 1e-4 of each
# field's largest |value|. On an H100 they read 1.5e-7 and 4.8e-6.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_SCALED_TOL = 1e-4
# the plain attention materialises [B, 8, T, T] float32 scores; K2's timing
# batch is capped so that they fit beside the kernel's inputs
K2_MAX_TIMED_BATCH = 8
# self-attention layers per level in (UNet, ControlNet): down blocks 0-2 hold
# two each, the mid block one, up blocks 1-3 three each (UNet only); each
# sits in a transformer block with one text cross-attention
LAYERS_PER_LEVEL = {4096: (5, 2), 1024: (5, 2), 256: (5, 2), 64: (1, 1)}
# the composed route's edit step against the fused one's, end to end: its
# relative RMS gap at most this times the gap between the fused step with K3
# and with K3's plain version (rounding alone). On an H100 the two read
# 0.0616 and 0.0623 (random SD-1.5 weights amplify bf16 rounding); each
# layer is held sharply in situ.
COMPOSED_FLOOR_RATIO = 2.0
# text tokens the cross-attention attends to (CLIP's 77)
TEXT_TOKENS = 77
# the VAE mid-block's one head: width and tokens (64x64 latents)
VAE_WIDTH, VAE_TOKENS = 512, 4096


def fused_levels():
    """The token levels the edit lane sends to K3."""
    from gaussctrl_tpu_torch.diffusion import processors
    return processors._XVIEW_FUSED_DEFAULT.split(",")


def std_kernel(d: int, tk: int) -> str:
    """The kernel `flash_attention(kernel="auto")` takes for a call that is
    not square self-attention: K5 where the keys fit its one key tile,
    else K6."""
    from gaussctrl_tpu_torch.ops import flash_attention as fa
    return "attention_full" if fa.full_fits(d, tk) else "attention_stream"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn` on the card (CUDA events, after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_fields(flops: float, peak: float, nbytes: float,
                 exps: float = 0.0) -> dict:
    """The least time of a kernel: the largest of its operations over their
    peak rate, its bytes over the memory rate and its exponentials over the
    SFUs' rate, with the term that wins."""
    terms = dict(operations=flops / peak * 1e3, bytes=nbytes / PEAK_BYTES * 1e3,
                 exponentials=exps / PEAK_EXP * 1e3)
    by = max(terms, key=terms.get)
    return dict(bound_ms=terms[by], bound_by=by, ops_ms=terms["operations"],
                bytes_ms=terms["bytes"], exp_ms=terms["exponentials"])


def attention_cost(b: int, heads: int, tq: int, tk: int, d: int,
                   panels: int = 1):
    """(FLOPs, bytes, exponentials) of softmax(q kᵀ/√d) v over `panels` K/V
    panels: two products of 2·Tq·Tk·d FLOP each and one exponential per
    score, per (batch, head, panel); q, k and v read once and o written
    once, in bf16 (K3's reference panels are views of k and v)."""
    c = heads * d
    return (4.0 * b * heads * tq * tk * d * panels,
            2.0 * (2 * b * tq * c + 2 * b * tk * c),
            1.0 * b * heads * tq * tk * panels)


def attention_bound(b, heads, tq, tk, d, panels=1) -> dict:
    """`bound_fields` of one attention call on the tensor cores in bf16."""
    flops, nbytes, exps = attention_cost(b, heads, tq, tk, d, panels)
    return bound_fields(flops, PEAK_BF16, nbytes, exps)


def attention_layer_counts(models):
    """Names of the self-attention layers of the UNet and the ControlNet."""
    from gaussctrl_tpu_torch.diffusion.nn import Attention
    counts = {}
    for name, net in (("unet", models.unet), ("controlnet", models.controlnet)):
        for mod_name, mod in net.named_modules():
            if isinstance(mod, Attention) and mod.is_self:
                counts.setdefault(name, []).append(mod_name)
    return counts


# ---------------------------------------------------------------------------
# phase 2b: what the compiler made of the attention kernels
# ---------------------------------------------------------------------------

# padded head widths of the TMA/wgmma attention kernels, and K5's key tiles
CORE_WIDTHS = (16, 32, 48, 80, 160)
FULL_KEY_TILES = (80, 128)
# every instantiation: the K2/K6 core and K6's wide variant, K3, K5
ATTENTION_INSTANTIATIONS = (
    [f"core<{w}>" for w in CORE_WIDTHS] + ["wide<512>"]
    + [f"xview<{w}>" for w in CORE_WIDTHS]
    + [f"full<{w},{nk}>" for w in CORE_WIDTHS for nk in FULL_KEY_TILES])
# K1 and K4 for ch = 3 and 4 (no tensor cores: fp32 on the CUDA cores)
SPLAT_INSTANTIATIONS = [f"blend_{k}<{ch}>" for k in ("fwd", "bwd")
                        for ch in (3, 4)]


def _instantiation(symbol: str):
    """'core<48>' / 'wide<512>' (K2/K6), 'xview<48>' (K3), 'full<48,80>'
    (K5) or 'blend_fwd<4>' / 'blend_bwd<4>' (K1/K4) for a mangled kernel
    name, else None."""
    import re
    for pattern, name in ((r"flash_core_kernel.*CoreILi(\d+)E", "core<{}>"),
                          (r"cross_view_kernel.*XViewILi(\d+)E", "xview<{}>"),
                          (r"attention_full_kernel.*FullILi(\d+)ELi(\d+)E",
                           "full<{},{}>"),
                          (r"splat_blend_(fwd|bwd)_kernelILi(\d)E",
                           "blend_{}<{}>")):
        m = re.search(pattern, symbol)
        if m:
            return name.format(*m.groups())
    return "wide<512>" if "flash_wide_kernel" in symbol else None


def _smem_bytes(lib, name: str) -> int:
    """Dynamic shared memory of an instantiation, from the library."""
    kind, args = name[:-1].split("<")
    nums = [int(x) for x in args.split(",")]
    if kind == "xview":
        return lib.gc_cross_view_smem_bytes(*nums)
    if kind == "full":
        return lib.gc_attention_full_smem_bytes(*nums)
    return lib.gc_flash_smem_bytes(*nums)


def check_sass(build_log: str, out_dir: str) -> dict:
    """Registers, spills and shared memory of every instantiation of the
    attention kernels (K2/K6 core and wide variant, K3, K5) and of K1 and
    K4 (from ptxas' report of this process's build, when it built; K1/K4's
    also from the runtime, with their resident blocks per SM), any note of
    ptxas that it serialized an instantiation's wgmma, and the counts of
    HGMMA (wgmma) and SHFL instructions in each one's SASS (cuobjdump -sass
    of the library; K4's reduce-scatter is 12 SHFL a warp and instance). Fails unless every expected instantiation is there, each
    attention one with HGMMA and none serialized."""
    import re
    import shutil
    from gaussctrl_tpu_torch.ops import _lib
    from gaussctrl_tpu_torch.ops import splat_blend as sb
    so = _lib.library_path()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    insts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = _instantiation(m.group(1))
            if name:
                insts[name] = dict(hgmma=0, shfl=0)
        elif name and "HGMMA" in line:
            insts[name]["hgmma"] += 1
        elif name and "SHFL" in line:
            insts[name]["shfl"] += 1
    ptxas, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"serialized.*function '(\S+)'", line)
        if m and _instantiation(m.group(1)) in insts:
            insts[_instantiation(m.group(1))]["wgmma_serialized"] = True
            ptxas.append(line)
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = _instantiation(m.group(1))
        if not name or name not in insts:
            continue
        ptxas.append(line)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            insts[name]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            insts[name]["registers"] = int(m.group(1))
    for name, rec in insts.items():
        if name.startswith("blend_"):
            kind, ch = name[len("blend_"):-1].split("<")
            rec.update(runtime=sb.kernel_attrs(kind, int(ch)))
        else:
            rec["dynamic_smem_bytes"] = _smem_bytes(_lib.library(), name)
    rec = dict(phase="sass", library=os.path.basename(so),
               ptxas_in_this_run=bool(ptxas), instantiations=insts)
    emit(rec)
    if out_dir:
        with open(os.path.join(out_dir, "sass.txt"), "w") as f:
            f.write("\n".join(ptxas) + "\n" + json.dumps(insts, indent=1) + "\n")
    if (sorted(insts) != sorted(ATTENTION_INSTANTIATIONS + SPLAT_INSTANTIATIONS)
            or not all(r["hgmma"] > 0 and not r.get("wgmma_serialized")
                       for n, r in insts.items() if not n.startswith("blend_"))):
        raise AssertionError(f"the attention kernels are not all on "
                             f"unserialized wgmma, or an instantiation is "
                             f"missing: {insts}")
    return rec


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def orbit_cameras(n: int, size: int, device, radius: float = 3.5,
                  fov_deg: float = 50.0):
    import numpy as np
    from gaussctrl_tpu_torch.cameras.camera import make_cameras
    c2ws = []
    for i in range(n):
        a = 2 * math.pi * i / n
        pos = np.array([math.sin(a) * radius, 0.6, math.cos(a) * radius])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2ws.append(np.stack([right, up, -fwd, pos], axis=1))
    f = size / (2 * math.tan(math.radians(fov_deg) / 2))
    return make_cameras(np.asarray(c2ws, np.float32), f, f, size / 2, size / 2,
                        size, size, device=device)


def smoke_scene(n: int, device):
    import torch
    from gaussctrl_tpu_torch.splat.scene import random_scene
    g = torch.Generator(device=device).manual_seed(1234)
    return random_scene(g, n, sh_degree=3, extent=1.0, device=device)


def splat_inputs(scene, cams, ch: int = 4, logit_shift: float = 0.0):
    """The blend's inputs for view 0 of `cams` on `scene`, as render_rgbd
    builds them: (args of `blend`, the binning). `logit_shift` raises every
    opacity's logit (6 puts most opacities above 0.99)."""
    import importlib
    import torch
    from gaussctrl_tpu_torch.cameras.camera import view_matrix
    from gaussctrl_tpu_torch.splat.project import project_gaussians
    from gaussctrl_tpu_torch.splat.sh import eval_sh
    rast = importlib.import_module("gaussctrl_tpu_torch.splat.rasterize")

    c2w = cams.c2w[0]
    W, H = cams.width, cams.height
    opac = torch.sigmoid(scene.opacities[:, 0] + logit_shift)
    proj = project_gaussians(scene.means, torch.exp(scene.scales), scene.quats,
                             view_matrix(c2w), cams.fx[0], cams.fy[0],
                             cams.cx[0], cams.cy[0], W, H, opacities=opac)
    dirs = scene.means - c2w[:3, 3][None]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-8)
    rgb = torch.clamp_min(eval_sh(scene.sh_degree, dirs, scene.colors) + 0.5,
                          0.0)
    colors = torch.cat([rgb, proj.depths[:, None]], -1)[:, :ch].contiguous()
    radii = torch.where(opac >= rast.ALPHA_THRESH, proj.radii,
                        torch.zeros_like(proj.radii))
    ntx, nty = (W + 15) // 16, (H + 15) // 16
    b = rast._bin_and_sort(proj.xys, proj.depths, radii, ntx, nty,
                           rast.RasterConfig())
    bg = torch.zeros(ch, device=c2w.device)
    args = (b.gauss_idx, b.starts, b.ends, proj.xys.contiguous(),
            proj.conics.contiguous(), colors, opac.contiguous(), bg, ntx, nty)
    return args, b


def tile_load(done, attrs) -> dict:
    """How the blended instances spread over the tiles, and the blocks of
    the kernel an SM holds at once (the runtime's occupancy)."""
    d = done.float()
    return dict(max_blended_per_tile=int(d.max().item()),
                mean_blended_per_tile=float(d.mean().item()),
                empty_tiles=int((d == 0).sum().item()), **attrs)


def k1_held(args, plain_device, **blend_kw) -> tuple:
    """K1 on `args` (splat_inputs') and the largest absolute error of its
    tiles and alpha against blend_plain on the same inputs, run on
    `plain_device`: (K1's outputs, the error)."""
    import torch
    from gaussctrl_tpu_torch.ops import splat_blend as sb
    out = sb.blend(*args, **blend_kw)
    ref_tiles, ref_alpha = sb.blend_plain(*[
        a.to(plain_device) if isinstance(a, torch.Tensor) else a
        for a in args])
    err = max(float((out[0].to(plain_device) - ref_tiles).abs().max()),
              float((out[1].to(plain_device) - ref_alpha).abs().max()))
    return out, err


def check_k1(scene, cams, reps):
    """K1 on one 512x512 view of the smoke scene against blend_plain; its
    packed records against pack_records, bit for bit."""
    from gaussctrl_tpu_torch.ops import splat_blend as sb

    args, b = splat_inputs(scene, cams)
    ntx, nty = args[-2:]
    W, H = cams.width, cams.height
    (tiles, alpha, done, records, _, _), err = k1_held(
        args, DEVICE, return_done=True, return_state=True)
    rec_err = (records - sb.pack_records(*args[3:7])).abs().max().item()
    # the records are the same products as pack_records': bit for bit
    tol = K1_TOL
    pairs = float(done.sum().item()) * 256
    used = int(b.ends[-1].item())
    n = args[3].shape[0]
    ch = args[5].shape[1]
    # each input read once (the used index range, the per-gaussian inputs,
    # the ranges), each output written once (the records, acc and tiles ch,
    # T and alpha per pixel, n_done)
    nbytes = (4 * used + 8 * ntx * nty + 4 * n * (2 + 3 + ch + 1)
              + 4 * n * sb.REC_FLOATS
              + 4 * ntx * nty * (256 * (2 * ch + 2) + 1))
    ms = cuda_ms(lambda: sb.blend(*args), reps)
    plain = cuda_ms(lambda: sb.blend_plain(*args), max(1, reps // 10))
    rec = dict(phase="kernels", kernel="splat_blend_fwd", shape=[H, W, ch],
               n_isect=int(b.n_isect.item()), isect_budget=b.gauss_idx.shape[0],
               max_tile=int((b.ends - b.starts).max().item()),
               batch=sb.BATCH, pairs_blended=pairs, max_abs_err=err, tol=tol,
               records_max_abs_err=rec_err, kernel_ms=ms, plain_ms=plain,
               library_ms=None,
               **tile_load(done, sb.kernel_attrs("fwd", ch)),
               **bound_fields(pairs * OPS_PER_PAIR_FWD, PEAK_FP32, nbytes))
    emit(rec)
    if not (err <= tol and rec_err == 0.0):
        raise AssertionError(f"K1 disagrees with its plain version: {err} > "
                             f"{tol} or records off by {rec_err}")
    return rec


def k4_errors(rows, g_bg, ref_rows, ref_bg) -> dict:
    """K4 against its plain version: per row group (xy, conic, colour,
    opacity), the largest error over the group's largest |value|; the same
    for g_bg; and the largest absolute error of the rows."""
    ch = rows.shape[1] - 6
    groups = dict(xy=(0, 2), conic=(2, 5), colour=(5, 5 + ch),
                  opacity=(5 + ch, 6 + ch))

    def scaled(got, ref):
        return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()

    out = {k: scaled(rows[:, lo:hi], ref_rows[:, lo:hi])
           for k, (lo, hi) in groups.items()}
    out["g_bg"] = scaled(g_bg, ref_bg)
    out["max_abs_err"] = (rows - ref_rows).abs().max().item()
    return out


def k4_held(bwd_args):
    """K4 and its plain version on the same arguments, compared over the
    rows of [0, ends[-1]) (K4 leaves the rest of the buffer unset):
    (K4's rows and g_bg, their errors)."""
    from gaussctrl_tpu_torch.ops import splat_blend as sb
    used = int(bwd_args[2][-1].item())
    rows, g_bg = sb.blend_bwd(*bwd_args)
    ref_rows, ref_bg = sb.blend_bwd_plain(*bwd_args)
    return rows, g_bg, k4_errors(rows[:used], g_bg, ref_rows[:used], ref_bg)


def splat_holds(first: int) -> tuple:
    """(patch entries, worst errors by kernel) that hold the first `first`
    calls of K1 and of K4, where the rasterizer looks them up, against
    their plain versions on the same inputs on the card (`k1_held`,
    `k4_held`)."""
    import importlib
    rast = importlib.import_module("gaussctrl_tpu_torch.splat.rasterize")
    in_situ = {"splat_blend_fwd": {"calls": 0}, "splat_blend_bwd": {"calls": 0}}
    fwd, bwd = rast.blend, rast.blend_bwd

    def blend(*a, **kw):
        w = in_situ["splat_blend_fwd"]
        if w["calls"] >= first:
            return fwd(*a, **kw)
        out, err = k1_held(a, DEVICE, **kw)
        w["calls"] += 1
        w["max_abs_err"] = max(w.get("max_abs_err", 0.0), err)
        return out

    def blend_bwd(*a):
        w = in_situ["splat_blend_bwd"]
        if w["calls"] >= first:
            return bwd(*a)
        rows, g_bg, errs = k4_held(a)
        w["calls"] += 1
        for k, v in errs.items():
            w[k] = max(w.get(k, 0.0), v)
        return rows, g_bg

    return [(rast, "blend", blend), (rast, "blend_bwd", blend_bwd)], in_situ


def splat_ok(in_situ: dict) -> bool:
    """K1 and K4 were each held at least once (`splat_holds`), within
    K1_TOL and (per row group and g_bg) K4_SCALED_TOL."""
    k1, k4 = in_situ["splat_blend_fwd"], in_situ["splat_blend_bwd"]
    return (k1["calls"] > 0 and k1["max_abs_err"] <= K1_TOL
            and k4["calls"] > 0
            and all(v <= K4_SCALED_TOL for k, v in k4.items()
                    if k not in ("calls", "max_abs_err")))


def check_k4(scene, cams, reps):
    """K4 on one 512x512 view of the smoke scene against blend_bwd_plain
    over the same n_done, records, sums and T_fin (from K1), with a seeded
    random cotangent, and against the plain two-replay form (Q and T_fin
    replayed from the records, not taken from K1), which holds the K1 -> K4
    hand-off at full width: ch = 4 timed; ch = 3 (its other instantiation)
    and a near-opaque scene (where alpha_raw passes the 0.999 gate)
    checked; every case bit-identical over two calls."""
    import torch
    from gaussctrl_tpu_torch.ops import splat_blend as sb
    recs = []
    for ch, shift in ((4, 0.0), (3, 0.0), (4, 6.0)):
        args, b = splat_inputs(scene, cams, ch, shift)
        ntx, nty = args[-2:]
        _, _, done, records, acc, t_fin = sb.blend(*args, return_done=True,
                                                   return_state=True)
        gen = torch.Generator(device=DEVICE).manual_seed(4)
        T = ntx * nty
        go = torch.rand((T, 256, ch), generator=gen, device=DEVICE) - 0.5
        ga = torch.rand((T, 256), generator=gen, device=DEVICE) - 0.5
        bwd_args = (args[0], args[1], args[2], done, records, acc, t_fin,
                    args[7], go, ga, ntx, nty)
        rows, g_bg, errs = k4_held(bwd_args)
        used = int(b.ends[-1].item())
        two_rows, two_bg = sb.blend_bwd_plain(*bwd_args[:5], None, None,
                                              *bwd_args[7:])
        errs_two = k4_errors(rows[:used], g_bg, two_rows[:used], two_bg)
        del two_rows
        again, g_bg2 = sb.blend_bwd(*bwd_args)
        torch.cuda.synchronize()
        identical = bool(torch.equal(rows[:used], again[:used])
                         and torch.equal(g_bg, g_bg2))
        rec = dict(phase="kernels", kernel="splat_blend_bwd",
                   shape=[cams.height, cams.width, ch], logit_shift=shift,
                   scaled_err=errs,
                   scaled_err_two_replay=errs_two,
                   scaled_tol=K4_SCALED_TOL,
                   max_abs_err=errs.pop("max_abs_err"),
                   bit_identical=identical,
                   rows_nonzero=int((rows[:used].abs().sum(1) > 0).sum().item()),
                   **tile_load(done, sb.kernel_attrs("bwd", ch)))
        if not recs:
            pairs = float(done.sum().item()) * 256
            n = args[3].shape[0]
            d = 6 + ch
            # inputs read once: the blended index range, the records, the
            # ranges and n_done, acc and T_fin, the cotangents; output: the
            # rows of [0, ends[-1])
            nbytes = (4 * float(done.sum().item()) + 12 * T
                      + 4 * n * sb.REC_FLOATS + 4 * T * 256 * (ch + 1) * 2
                      + 4 * used * d)
            rec.update(pairs_replayed=pairs, kernel_ms=cuda_ms(
                lambda: sb.blend_bwd(*bwd_args), reps),
                plain_ms=cuda_ms(lambda: sb.blend_bwd_plain(*bwd_args),
                                 max(1, reps // 10)),
                library_ms=None,
                **bound_fields(pairs * OPS_PER_PAIR_BWD, PEAK_FP32, nbytes))
        emit(rec)
        recs.append(rec)
    bad = [(r["shape"][2], r["logit_shift"], ref, k, v) for r in recs
           for ref in ("scaled_err", "scaled_err_two_replay")
           for k, v in r[ref].items()
           if k != "max_abs_err" and not v <= K4_SCALED_TOL]
    bad += [(r["shape"][2], r["logit_shift"], "bit_identical") for r in recs
            if not r["bit_identical"]]
    if bad:
        raise AssertionError(f"K4 disagrees with its plain version: {bad}")
    return recs[0]


# Attention outputs are bf16 on both sides, and their size depends on the
# level (randn inputs: a std near 1 at T = 64, near 0.02 at T = 4096), so
# the gap is held relative to each level's plain output: the largest error
# against the largest |value|, and the relative RMS of the error. On an H100
# the kernels sit at most 0.0061 and 0.0039 from their plain versions on
# every level; an output off by a tenth reads about 0.1 on both.
ATTN_SCALED_TOL = 2e-2
ATTN_REL_RMS_TOL = 1e-2


def attn_errors(got, ref) -> dict:
    diff = got.float() - ref.float()
    ref_max = ref.float().abs().max().item()
    err = diff.abs().max().item()
    return dict(max_abs_err=err, ref_abs_max=ref_max, scaled_err=err / ref_max,
                rel_rms_err=(diff.norm() / ref.float().norm()).item(),
                scaled_tol=ATTN_SCALED_TOL, rel_rms_tol=ATTN_REL_RMS_TOL)


def attn_ok(rec) -> bool:
    return (rec["scaled_err"] <= ATTN_SCALED_TOL
            and rec["rel_rms_err"] <= ATTN_REL_RMS_TOL)


def _rand_bf16(shape, gen):
    import torch
    return torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)


def _sdpa_layout(x, heads):
    b, t, c = x.shape
    return x.view(b, t, heads, c // heads).transpose(1, 2).contiguous()


def check_k2(batch: int, reps: int):
    """K2 at B=2 against attention_plain on all four levels plus t=100;
    timed at B = `batch` (the inversion batch of the default run)."""
    import torch
    import torch.nn.functional as F
    from gaussctrl_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    recs = []
    for t, c in LEVELS + [(100, 320)]:
        q, k, v = (_rand_bf16((2, t, c), gen) for _ in range(3))
        rec = dict(phase="kernels", kernel="flash_attention_t", B=2, T=t, C=c,
                   heads=HEADS, **attn_errors(fa.flash_attention_t(q, k, v, HEADS),
                                              fa.attention_plain(q, k, v, HEADS)))
        if (t, c) in LEVELS:
            q, k, v = (_rand_bf16((batch, t, c), gen) for _ in range(3))
            qs, ks, vs = (_sdpa_layout(x, HEADS) for x in (q, k, v))
            rec.update(
                B_timed=batch,
                kernel_ms=cuda_ms(lambda: fa.flash_attention_t(q, k, v, HEADS), reps),
                plain_ms=cuda_ms(lambda: fa.attention_plain(q, k, v, HEADS),
                                 max(1, reps // 5)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs),
                                   reps))
            rec.update(attention_bound(batch, HEADS, t, t, c // HEADS))
        emit(rec)
        recs.append(rec)
    bad = [r["T"] for r in recs if not attn_ok(r)]
    if bad:
        raise AssertionError(f"K2 disagrees with its plain version at T={bad}")
    return recs


def check_k3(views: int, refs: int, reps: int):
    """K3 at G=2, F=views (refs + chunk), r=refs, c in {0.6, 0.0}, every
    level plus t=100, against the composed plain version; timed at the same
    shapes."""
    import torch
    import torch.nn.functional as F
    from gaussctrl_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    g, f, r = 2, views, refs
    b = g * f
    recs = []
    for t, c in LEVELS + [(100, 320)]:
        q, k, v = (_rand_bf16((b, t, c), gen) for _ in range(3))
        d = c // HEADS
        qs, ks, vs = (_sdpa_layout(x, HEADS) for x in (q, k, v))
        kg = ks.view(g, f, HEADS, t, d)
        vg = vs.view(g, f, HEADS, t, d)
        kr = [kg[:, i:i + 1].expand(g, f, HEADS, t, d).reshape(b, HEADS, t, d)
              for i in range(r)]
        vr = [vg[:, i:i + 1].expand(g, f, HEADS, t, d).reshape(b, HEADS, t, d)
              for i in range(r)]
        for coeff in (0.6, 0.0):
            errs = attn_errors(
                fa.cross_view_attention(q, k, v, HEADS, r, coeff, g),
                fa.cross_view_attention_plain(q, k, v, HEADS, r, coeff, g))
            panels = r + (1 if coeff else 0)

            def library(coeff=coeff):
                out = sum(F.scaled_dot_product_attention(qs, a, bb)
                          for a, bb in zip(kr, vr)) * ((1 - coeff) / r)
                if coeff:
                    out = out + coeff * F.scaled_dot_product_attention(qs, ks, vs)
                return out

            rec = dict(phase="kernels", kernel="cross_view_attention", G=g,
                       F=f, r=r, self_coeff=coeff, T=t, C=c, heads=HEADS,
                       **errs)
            if (t, c) in LEVELS:
                rec.update(
                    kernel_ms=cuda_ms(lambda: fa.cross_view_attention(
                        q, k, v, HEADS, r, coeff, g), reps),
                    plain_ms=cuda_ms(lambda: fa.cross_view_attention_plain(
                        q, k, v, HEADS, r, coeff, g), max(1, reps // 5)),
                    library_ms=cuda_ms(library, reps))
                rec.update(attention_bound(b, HEADS, t, t, d, panels))
            emit(rec)
            recs.append(rec)
    bad = [(r["T"], r["self_coeff"]) for r in recs if not attn_ok(r)]
    if bad:
        raise AssertionError(f"K3 disagrees with its plain version at (T, c)={bad}")
    return recs


def _time_std(rec, kernel, plain, library, args, reps):
    """Time a K5/K6 call beside its plain version and the library call, and
    add its bound (bf16 tensor-core operations, bytes or exponentials)."""
    q, k, _, heads = args
    rec.update(kernel_ms=cuda_ms(lambda: kernel(*args), reps),
               plain_ms=cuda_ms(lambda: plain(*args), max(1, reps // 10)),
               library_ms=cuda_ms(library, reps),
               **attention_bound(q.shape[0], heads, q.shape[1], k.shape[1],
                                 q.shape[2] // heads))


def _sdpa(q, k, v, heads):
    """The library call that computes the same function: SDPA on
    [B, h, T, d] copies (made outside the timed call)."""
    import torch.nn.functional as F
    qs, ks, vs = (_sdpa_layout(x, heads) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qs, ks, vs)


def _ref_views(g, f, t, c, gen):
    """q [G, F·t, C] and the first reference's k, v as views of [G, F, t, C]
    tensors, as `_grouped_ref_attention` hands them to its kernel."""
    q = _rand_bf16((g, f * t, c), gen)
    kg, vg = (_rand_bf16((g, f, t, c), gen) for _ in range(2))
    return q, kg[:, 0], vg[:, 0]


def check_k5(views: int, reps: int):
    """K5 at every text cross-attention level (Tk = 77; the edit batch
    B = 2·(refs + chunk), timed, and the inversion batch B = views) and at
    the composed references of each level where the keys fit its key tile
    (64 tokens: G = 2, 8·64 queries against one reference's 64 keys, k/v
    strided views), timed, against attention_plain."""
    import torch
    from gaussctrl_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    b_edit = 2 * (REFS + CHUNK)
    recs = []
    cases = [("text", b, t, c) for t, c in LEVELS
             for b in sorted({b_edit, views})]
    cases += [("ref", 2, t, c) for t, c in LEVELS if fa.full_fits(c // HEADS, t)]
    for use, b, t, c in cases:
        if use == "text":
            q = _rand_bf16((b, t, c), gen)
            k, v = (_rand_bf16((b, TEXT_TOKENS, c), gen) for _ in range(2))
        else:
            q, k, v = _ref_views(b, REFS + CHUNK, t, c, gen)
        args = (q, k, v, HEADS)
        rec = dict(phase="kernels", kernel="attention_full", use=use, B=b,
                   T=t, Tq=q.shape[1], Tk=k.shape[1], C=c, heads=HEADS,
                   **attn_errors(fa.attention_full(*args), fa.attention_plain(*args)))
        if use == "ref" or b == b_edit:
            _time_std(rec, fa.attention_full, fa.attention_plain,
                      _sdpa(*args), args, reps)
        emit(rec)
        recs.append(rec)
    bad = [(r["use"], r["B"], r["T"]) for r in recs if not attn_ok(r)]
    if bad:
        raise AssertionError(f"K5 disagrees with its plain version at {bad}")
    return recs


def check_k6(views: int, reps: int):
    """K6 at the VAE mid-block (B = views, T = 4096, one head of 512),
    timed; at the composed references of each level where `auto` picks it
    (the keys pass K5's tile: 4096, 1024, 256), timed; and at tails
    (T = 100, at widths 40 and 512), against attention_stream_plain."""
    import torch
    from gaussctrl_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    cases = [("vae", views, VAE_TOKENS, VAE_WIDTH, 1)]
    cases += [("ref", 2, t, c, HEADS) for t, c in LEVELS
              if not fa.full_fits(c // HEADS, t)]
    cases += [("tail", 2, 100, 320, HEADS), ("tail", 2, 100, VAE_WIDTH, 1)]
    recs = []
    for use, b, t, c, heads in cases:
        if use == "ref":
            q, k, v = _ref_views(b, REFS + CHUNK, t, c, gen)
        else:
            q, k, v = (_rand_bf16((b, t, c), gen) for _ in range(3))
        args = (q, k, v, heads)
        rec = dict(phase="kernels", kernel="attention_stream", use=use, B=b,
                   T=t, Tq=q.shape[1], Tk=k.shape[1], C=c, heads=heads,
                   **attn_errors(fa.attention_stream(*args),
                                 fa.attention_stream_plain(*args)))
        if use != "tail":
            _time_std(rec, fa.attention_stream, fa.attention_stream_plain,
                      _sdpa(*args), args, reps)
        emit(rec)
        recs.append(rec)
    bad = [(r["use"], r["B"], r["T"], r["C"]) for r in recs if not attn_ok(r)]
    if bad:
        raise AssertionError(f"K6 disagrees with its plain version at {bad}")
    return recs


# ---------------------------------------------------------------------------
# phase 4: tiny pipeline, card against CPU
# ---------------------------------------------------------------------------

def tiny_pipeline(device: str, state: dict) -> dict:
    """render_reverse + edit_images at the tiny config in bf16 (5 views at
    64x64, 2 steps, 2 refs, chunks of 2) with the weights in `state`."""
    import torch
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    from gaussctrl_tpu_torch.pipeline.gaussctrl import (GaussCtrlConfig,
                                                        GaussCtrlPipeline)
    scene = smoke_scene(300, "cpu")
    scene.means.mul_(0.5)
    cfg = GaussCtrlConfig(edit_prompt="a red scene", reverse_prompt="a scene",
                          num_inference_steps=2, ref_view_num=2, chunk_size=2)
    pipe = GaussCtrlPipeline(cfg, scene, orbit_cameras(5, 64, "cpu", 2.5),
                             sd_config=SDConfig.tiny(), dtype=torch.bfloat16,
                             device=device)
    for name, m in zip(("unet", "controlnet", "vae", "text"),
                       pipe.models.modules()):
        m.load_state_dict(state[name])
    pipe.render_reverse().edit_images()
    return {k: getattr(pipe, k).float().cpu()
            for k in ("unedited", "depths", "z_T", "edited")}


def _held_to_plain(kernel, plain, worst: dict, per_shape: int | None = None):
    """`kernel` that also holds its outputs against `plain` on the same
    inputs, keeping the worst errors and the number of calls held: every
    call, or with `per_shape` the first `per_shape` calls of each distinct
    argument signature (tensor shapes and the other arguments), which are
    then listed under "shapes" with the seconds spent holding them."""
    import torch
    seen = {}

    def call(*args):
        out = kernel(*args)
        if per_shape is not None:
            sig = tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a
                        for a in args)
            seen[sig] = seen.get(sig, 0) + 1
            if seen[sig] > per_shape:
                return out
            worst["shapes"] = [list(k) for k in seen]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        e = attn_errors(out, plain(*args))
        worst["calls"] = worst.get("calls", 0) + 1
        for key in ("scaled_err", "rel_rms_err"):
            worst[key] = max(worst.get(key, 0.0), e[key])
        if per_shape is not None:
            worst["hold_s"] = worst.get("hold_s", 0.0) + time.perf_counter() - t0
        return out
    return call


def attention_holds(per_shape: int | None = None) -> tuple:
    """(patch entries, worst errors by kernel) that hold every call of K2,
    K3, K5 and K6 against its plain version (`_held_to_plain`), where the
    callers look each wrapper up."""
    from gaussctrl_tpu_torch.diffusion import processors
    from gaussctrl_tpu_torch.ops import flash_attention as fa
    kernels = [(fa, "flash_attention_t", fa.attention_plain),
               (processors, "cross_view_attention", fa.cross_view_attention_plain),
               (fa, "attention_full", fa.attention_plain),
               (fa, "attention_stream", fa.attention_stream_plain)]
    in_situ = {name: {} for _, name, _ in kernels}
    return [(m, n, _held_to_plain(getattr(m, n), plain, in_situ[n], per_shape))
            for m, n, plain in kernels], in_situ


@contextlib.contextmanager
def _patched(entries):
    """Set (module, name, value) entries for the duration of the block."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in entries]
    for m, n, val in entries:
        setattr(m, n, val)
    try:
        yield
    finally:
        for m, n, val in saved:
            setattr(m, n, val)


def check_small():
    """The tiny pipeline on the card (kernels) against the same pipeline on
    the CPU (plain versions), both bf16 with the same weights. On the card,
    each K2/K3/K5/K6 call is also held against its plain version on its own
    inputs, which covers the tiny config's head widths (16 and 32). The
    tiny UNet attends at 64 and 16 tokens, none of which is a fused level
    and all of whose key lists fit K5's key tile; so on both sides the
    64-token level is made fused (K3) and the references of the composed
    16-token level are sent to K6 (kernel="stream"), so that every attention
    kernel runs: K2 in the inversion, the composed self branch and the VAE
    mid-block, K5 in the text cross-attention."""
    import torch
    from gaussctrl_tpu_torch.diffusion import processors
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    from gaussctrl_tpu_torch.diffusion.sample import SDModels
    from gaussctrl_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    models = SDModels.create(SDConfig.tiny(), device="cpu")
    models.init_params(seed=5)
    # make the zero-initialised ControlNet convs carry signal for this check
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for conv in [models.controlnet.controlnet_mid_block,
                     *models.controlnet.controlnet_down_blocks,
                     models.controlnet.controlnet_cond_embedding.conv_out]:
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) * 0.05)
    state = {k: m.to(torch.bfloat16).state_dict() for k, m in
             zip(("unet", "controlnet", "vae", "text"), models.modules())}
    routes = [
        (processors, "_XVIEW_FUSED_DEFAULT", "64"),
        (processors, "_grouped_ref_attention", functools.partial(
            processors._grouped_ref_attention, flash_fn=functools.partial(
                fa.flash_attention, kernel="stream", is_self=False)))]
    with _patched(routes):
        cpu = tiny_pipeline("cpu", state)
    holds, in_situ = attention_holds()
    with _patched(routes + holds):
        card = tiny_pipeline(DEVICE, state)
    errs, rel = {}, {}
    for k, ref in cpu.items():
        diff = card[k] - ref
        errs[k] = diff.abs().max().item()
        rel[k] = (diff.norm() / ref.norm()).item()
    tols = dict(unedited=1e-3, depths=1e-2)
    rel_tols = SMALL_REL_TOL
    rec = dict(phase="small", seconds=time.perf_counter() - t0,
               max_abs_err=errs, rel_rms_err=rel, tol=tols, rel_tol=rel_tols,
               finite=all(bool(torch.isfinite(v).all()) for v in card.values()),
               in_situ=in_situ)
    emit(rec)
    if (not rec["finite"] or any(errs[k] > tols[k] for k in tols)
            or any(rel[k] > rel_tols[k] for k in rel_tols)
            or not all(w.get("calls") and attn_ok(w) for w in in_situ.values())):
        raise AssertionError(f"card pipeline disagrees with the CPU's: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 5: tiny re-optimisation, card against CPU
# ---------------------------------------------------------------------------

TRAIN_FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
                "features_rest")


def train_run(device: str, steps: int):
    """`steps` train_steps of a tiny 300-gaussian scene (SH 3, four 64x64
    views, seeded smooth targets and backgrounds) on `device` in float32:
    (per-step losses, the first step's gradients on the CPU)."""
    import torch
    import torch.nn.functional as F
    from gaussctrl_tpu_torch.splat import trainer as tr
    scene = smoke_scene(300, "cpu")
    scene.means.mul_(0.5)
    gen = torch.Generator().manual_seed(7)
    targets = F.interpolate(torch.rand((4, 3, 8, 8), generator=gen),
                            size=(64, 64), mode="nearest").permute(0, 2, 3, 1)
    bgs = torch.rand((steps, 3), generator=gen)
    scene = tr.trainable(type(scene)(**{k: getattr(scene, k).to(device)
                                        for k in TRAIN_FIELDS}))
    cams = orbit_cameras(4, 64, device, 2.5)
    opt = tr.make_optimizer(scene)
    targets, bgs = targets.to(device), bgs.to(device)
    losses, grads = [], None
    for i in range(steps):
        v = i % len(cams)
        m = tr.train_step(scene, opt, i, cams.c2w[v], cams.fx[v], cams.fy[v],
                          cams.cx[v], cams.cy[v], targets[v], bgs[i], 64, 64, 3)
        losses.append(float(m["loss"]))
        if i == 0:
            grads = {k: getattr(scene, k).grad.detach().cpu().clone()
                     for k in TRAIN_FIELDS}
    return losses, grads


def check_train(steps: int = 3):
    """A few re-optimisation steps on the card (K1, K4) against the CPU
    (plain versions), both float32; every K4 call on the card is also held
    against its plain version on its own inputs."""
    import importlib
    rast = importlib.import_module("gaussctrl_tpu_torch.splat.rasterize")
    t0 = time.perf_counter()
    cpu_losses, cpu_grads = train_run("cpu", steps)
    in_situ = {"calls": 0}

    def held(*args):
        rows, g_bg, errs = k4_held(args)
        in_situ["calls"] += 1
        for k, v in errs.items():
            in_situ[k] = max(in_situ.get(k, 0.0), v)
        return rows, g_bg

    saved = rast.blend_bwd
    rast.blend_bwd = held
    try:
        card_losses, card_grads = train_run(DEVICE, steps)
    finally:
        rast.blend_bwd = saved
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    grad_scaled = {k: ((card_grads[k] - g).abs().max() / g.abs().max()).item()
                   for k, g in cpu_grads.items()}
    rec = dict(phase="train", seconds=time.perf_counter() - t0, steps=steps,
               card_losses=card_losses, cpu_losses=cpu_losses,
               loss_rel_err=loss_rel, loss_rtol=TRAIN_LOSS_RTOL,
               grad_scaled_err=grad_scaled,
               grad_scaled_tol=TRAIN_GRAD_SCALED_TOL, in_situ=in_situ,
               in_situ_tol=K4_SCALED_TOL)
    emit(rec)
    situ_ok = in_situ["calls"] == steps and all(
        v <= K4_SCALED_TOL for k, v in in_situ.items()
        if k not in ("calls", "max_abs_err"))
    if (not all(math.isfinite(x) for x in card_losses) or not situ_ok
            or loss_rel > TRAIN_LOSS_RTOL
            or any(v > TRAIN_GRAD_SCALED_TOL for v in grad_scaled.values())):
        raise AssertionError(f"card training disagrees with the CPU's: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 5b: where a full-width re-optimisation step goes
# ---------------------------------------------------------------------------

# the parts of a step, each timed from the end of the one before
SPLIT_PARTS = ("projection_sh", "binning_sort", "k1", "loss_forward",
               "loss_backward", "k4", "reduce_by_slot", "projection_backward",
               "adam")


def reopt_split(reps: int = 5):
    """One re-optimisation step (`trainer.train_step`) at full width, the
    smoke scene's 200,000 gaussians against one 512x512 view, warmed by two
    steps, then timed in parts by CUDA events recorded on the stream at the
    parts' borders: projection + SH, binning and sort, K1 with its wrapper,
    the L1 + SSIM forward (with the image assembly before it), the loss's
    backward down to the blend, K4 with its wrapper, reduce_by_slot, the
    projection's backward, Adam with the quats' renormalisation. Where the
    host falls behind, a part holds the stream's idle time too. Mean ms of
    each part over `reps` steps, and each step's wall time."""
    import importlib
    import torch
    import torch.nn.functional as F
    from gaussctrl_tpu_torch.splat import trainer as tr
    rast = importlib.import_module("gaussctrl_tpu_torch.splat.rasterize")
    t0 = time.perf_counter()
    scene = tr.trainable(smoke_scene(GAUSSIANS, DEVICE))
    cams = orbit_cameras(2, SIZE, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    target = F.interpolate(
        torch.rand((1, 3, 32, 32), generator=gen, device=DEVICE),
        size=(SIZE, SIZE), mode="bilinear").permute(0, 2, 3, 1)[0]
    bg = torch.rand((3,), generator=gen, device=DEVICE)
    opt = tr.make_optimizer(scene)
    marks = []

    def mark(name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.append((name, e))

    def ends_before(fn, name):
        def call(*a, **kw):
            mark(name)
            return fn(*a, **kw)
        return call

    def ends_after(fn, name):
        def call(*a, **kw):
            out = fn(*a, **kw)
            mark(name)
            return out
        return call

    borders = [(rast, "_bin_and_sort", ends_before, "projection_sh"),
               (rast, "_bin_and_sort", ends_after, "binning_sort"),
               (rast, "blend", ends_after, "k1"),
               (tr, "splat_loss", ends_after, "loss_forward"),
               (rast, "blend_bwd", ends_before, "loss_backward"),
               (rast, "blend_bwd", ends_after, "k4"),
               (rast, "reduce_by_slot", ends_after, "reduce_by_slot"),
               (opt, "step", ends_before, "projection_backward"),
               (tr, "_renorm_quats", ends_after, "adam")]
    entries = {}
    for obj, name, wrap, part in borders:
        fn = entries.get((obj, name), getattr(obj, name))
        entries[(obj, name)] = wrap(fn, part)
    parts = {k: 0.0 for k in SPLIT_PARTS}
    wall = []
    with _patched([(obj, name, fn) for (obj, name), fn in entries.items()]):
        for i in range(2 + reps):
            v = i % len(cams)
            marks.clear()
            torch.cuda.synchronize()
            t = time.perf_counter()
            mark("start")
            tr.train_step(scene, opt, i, cams.c2w[v], cams.fx[v], cams.fy[v],
                          cams.cx[v], cams.cy[v], target, bg, SIZE, SIZE, 3)
            torch.cuda.synchronize()
            if i < 2:
                continue
            wall.append((time.perf_counter() - t) * 1e3)
            names = [n for n, _ in marks]
            if names != ["start", *SPLIT_PARTS]:
                raise AssertionError(f"the step's parts came as {names}")
            for (_, e0), (name, e1) in zip(marks, marks[1:]):
                parts[name] += e0.elapsed_time(e1) / reps
    rec = dict(phase="reopt_split", gaussians=GAUSSIANS, size=SIZE, reps=reps,
               parts_ms=parts, step_ms=sum(parts.values()),
               step_wall_ms=sum(wall) / reps,
               kernels_ms=parts["k1"] + parts["k4"],
               seconds=time.perf_counter() - t0)
    emit(rec)
    return rec


# ---------------------------------------------------------------------------
# phase 6: the main path
# ---------------------------------------------------------------------------

def expected_launches(pipe, layers, V: int, ddim_steps: int, reopt_steps: int):
    """The exact launches of every kernel in one `pipe.run()` over `V`
    views with `ddim_steps` DDIM steps and `reopt_steps` re-optimisation
    steps, from the layer counts; and the number of edit chunks."""
    from gaussctrl_tpu_torch.ops import launch_counts
    cfg = pipe.config
    n_self = len(layers["unet"]) + len(layers["controlnet"])
    R = cfg.ref_view_num
    # the reference's draw may repeat a view (inclusive randint), so the
    # chunks are counted from the views that are not references
    others = [i for i in range(V) if i not in pipe.ref_indices]
    n_chunks = 1 if cfg.chunk_size <= 0 else -(-len(others) // cfg.chunk_size)
    # UNet + ControlNet forwards of the inversion and of the edit
    inv_fwd = ddim_steps * (1 if cfg.invert_batch <= 0
                            else -(-V // cfg.invert_batch))
    edit_fwd = ddim_steps * n_chunks
    expected = dict.fromkeys(launch_counts, 0)
    expected["splat_blend_fwd"] = V + reopt_steps  # renders, re-opt steps
    expected["splat_blend_bwd"] = reopt_steps
    # every self-attention of the inversion
    expected["flash_attention_t"] = inv_fwd * n_self
    for t, c in LEVELS:
        n_unet, n_cn = LAYERS_PER_LEVEL[t]
        # one text cross-attention per transformer block of every forward
        expected[std_kernel(c // HEADS, TEXT_TOKENS)] += \
            (inv_fwd + edit_fwd) * (n_unet + n_cn)
        if str(t) in fused_levels():             # K3 (4096/1024/256)
            expected["cross_view_attention"] += edit_fwd * (n_unet + n_cn)
        else:   # composed (64): the UNet's self branch (the ControlNet has
            # c = 0) and one call per reference in both networks
            expected["flash_attention_t"] += edit_fwd * n_unet
            expected[std_kernel(c // HEADS, t)] += edit_fwd * R * (n_unet + n_cn)
    # the VAE mid-block: one per encode batch, one for the decode
    expected[std_kernel(VAE_WIDTH, VAE_TOKENS)] += -(-V // cfg.render_batch) + 1
    return expected, n_chunks


def _timed_run(pipe) -> tuple:
    """`pipe.run()` with each stage timed to its end on the card: (metrics,
    {stage: seconds}, launch counts)."""
    import torch
    from gaussctrl_tpu_torch.ops import launch_counts, reset_launch_counts
    ends = {}
    for stage in ("render_reverse", "edit_images", "reoptimize"):
        def timed(*a, _fn=getattr(pipe, stage), _name=stage, **kw):
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            ends[_name] = time.perf_counter()
            return out
        setattr(pipe, stage, timed)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = pipe.run()
    counts = dict(launch_counts)
    for stage in ("render_reverse", "edit_images", "reoptimize"):
        delattr(pipe, stage)
    seconds = dict(render_reverse=ends["render_reverse"] - t0,
                   edit_images=ends["edit_images"] - ends["render_reverse"],
                   reoptimize=ends["reoptimize"] - ends["edit_images"])
    return metrics, seconds, counts


def main_path(args, card, ckpt_dirs, written):
    """`GaussCtrlPipeline.run()` on the SD-1.5 weights read from the
    diffusers directories `ckpt_dirs` (phase 6a) through
    `GaussCtrlConfig.diffusion_ckpt/controlnet_ckpt`; `written` holds the
    files' dicts, against which the VAE's mid-block q/k/v biases and the
    tokenizer are checked after loading."""
    import torch
    from gaussctrl_tpu_torch.diffusion.clip import CLIPTokenizer
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    from gaussctrl_tpu_torch.pipeline.gaussctrl import (GaussCtrlConfig,
                                                        GaussCtrlPipeline)
    t0 = time.perf_counter()
    scene = smoke_scene(GAUSSIANS, DEVICE)
    cams = orbit_cameras(args.views, SIZE, DEVICE)
    cfg = GaussCtrlConfig(edit_prompt="a photo of a polar bear",
                          reverse_prompt="a photo of a bear statue",
                          guidance_scale=5.0, num_inference_steps=args.steps,
                          chunk_size=CHUNK, ref_view_num=REFS,
                          render_rate=args.reopt_steps,
                          diffusion_ckpt=ckpt_dirs[0],
                          controlnet_ckpt=ckpt_dirs[1])
    pipe = GaussCtrlPipeline(cfg, scene, cams, sd_config=SDConfig.sd15(),
                             dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    vae_file = written["sd15/vae/diffusion_pytorch_model.safetensors"]
    attn = pipe.models.vae.decoder.mid_block.attentions[0]
    loaded_from_disk = dict(
        vae_qkv_biases=all(
            torch.equal(getattr(attn, f"to_{n}").bias.cpu(),
                        vae_file[f"decoder.mid_block.attentions.0.{old}.bias"]
                        .to(torch.bfloat16))
            for n, old in (("q", "query"), ("k", "key"), ("v", "value"))),
        vae_biases_nonzero=bool(attn.to_q.bias.abs().max() > 0),
        bpe_tokenizer=isinstance(pipe.tokenizer, CLIPTokenizer))

    layers = attention_layer_counts(pipe.models)
    V = args.views
    steps = args.reopt_steps
    expected, n_chunks = expected_launches(pipe, layers, V, args.steps, steps)

    torch.cuda.reset_peak_memory_stats()
    metrics, seconds, counts = _timed_run(pipe)
    rr, ei, ro = (seconds[k] for k in ("render_reverse", "edit_images",
                                       "reoptimize"))
    losses = metrics["loss_history"].float().cpu()

    s, H = pipe.sd_config.sample_size, SIZE
    shapes = dict(unedited=(V, H, H, 3), depths=(V, H, H, 1), z_T=(V, s, s, 4),
                  edited=(V, H, H, 3))
    finite = {k: bool(torch.isfinite(getattr(pipe, k)).all()) for k in shapes}
    finite["reopt_losses"] = bool(torch.isfinite(losses).all()) and len(losses) == steps
    finite["scene"] = all(bool(torch.isfinite(getattr(pipe.scene, k)).all())
                          for k in TRAIN_FIELDS)
    rec = dict(phase="main_path", card=card, views=V, steps=args.steps,
               weights="diffusers directories on disk (phase weights)",
               loaded_from_disk=loaded_from_disk,
               gaussians=GAUSSIANS, size=H, refs=pipe.ref_indices,
               edit_batches=n_chunks,
               chunk_size=cfg.chunk_size, setup_s=setup_s,
               reopt_steps=steps,
               render_reverse_s=rr, edit_images_s=ei,
               reoptimize_s=ro, reopt_s_per_step=ro / max(steps, 1),
               reopt_loss_first10=losses[:10].tolist(),
               reopt_loss_last10=losses[-10:].tolist(),
               render_reverse_views_per_s=V / rr,
               edit_images_views_per_s=V / ei,
               views_per_s=V / (rr + ei), run_s=rr + ei + ro,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
               self_attention_layers={k: len(v) for k, v in layers.items()},
               launches=counts, expected_launches=expected, finite=finite,
               z_T_abs_max=float(pipe.z_T.float().abs().max()),
               edited_mean=float(pipe.edited.float().mean()))
    emit(rec)
    for k, shp in shapes.items():
        if tuple(getattr(pipe, k).shape) != shp:
            raise AssertionError(f"{k} has shape {tuple(getattr(pipe, k).shape)}, "
                                 f"expected {shp}")
    if not all(finite.values()):
        raise AssertionError(f"non-finite outputs: {finite}")
    if not all(loaded_from_disk.values()):
        raise AssertionError(f"the pipeline's weights are not the files': "
                             f"{loaded_from_disk}")
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    return rec, pipe


# ---------------------------------------------------------------------------
# phase 7: the composed cross-view route against the fused one
# ---------------------------------------------------------------------------

def edit_step(pipe, fused: bool, steps: int, wrap=lambda proc: proc):
    """The first DDIM step of the edit (of `steps`) for the refs and the
    first chunk, CFG-doubled, with the cross-view processors' allow_fused
    set to `fused` (and each processor passed through `wrap`): (guided eps,
    the step's latent), NHWC."""
    import torch
    from gaussctrl_tpu_torch.diffusion.clip import NEGATIVE_PROMPT, POSITIVE_SUFFIX
    from gaussctrl_tpu_torch.diffusion.ddim import ddim_step, timestep_pairs
    from gaussctrl_tpu_torch.diffusion.processors import CrossViewAttnProcessor
    from gaussctrl_tpu_torch.diffusion.sample import (eps_model, nchw_to_nhwc,
                                                      nhwc_to_nchw)
    cfg, refs = pipe.config, pipe.ref_indices
    order = refs + [i for i in range(len(pipe.cameras)) if i not in refs][:cfg.chunk_size]
    b = len(order)
    z = pipe.z_T[order]
    disp = pipe._to_diffusion_res(pipe.disparity[order])
    ctx = torch.cat([pipe._ctx(NEGATIVE_PROMPT, b),
                     pipe._ctx(cfg.edit_prompt + POSITIVE_SUFFIX, b)])
    t, t_prev = (x[0] for x in timestep_pairs(steps))
    eps = eps_model(pipe.models, torch.cat([z, z]), t, ctx.to(pipe.models.dtype),
                    torch.cat([disp, disp]), cfg.conditioning_scale,
                    unet_processor=wrap(CrossViewAttnProcessor(
                        len(refs), cfg.self_attn_coeff, 2, allow_fused=fused)),
                    controlnet_processor=wrap(CrossViewAttnProcessor(
                        len(refs), 0.0, 2, allow_fused=fused)))
    eps_u, eps_c = eps.chunk(2)
    eps = eps_u + cfg.guidance_scale * (eps_c - eps_u)
    step = ddim_step(pipe.sched, nhwc_to_nchw(z), nhwc_to_nchw(eps).to(z.dtype),
                     t, t_prev)
    return eps, nchw_to_nhwc(step)


def _held_to_fused(proc, worst: dict):
    """A composed-route processor that also holds each of its outputs
    against the fused kernel K3 on the same inputs, keeping the worst errors
    and the number of calls per token level."""
    from gaussctrl_tpu_torch.ops import flash_attention as fa

    def call(q, k, v, heads):
        out = proc(q, k, v, heads)
        e = attn_errors(out, fa.cross_view_attention(
            q, k, v, heads, proc.num_refs, proc.self_attn_coeff, proc.cfg_groups))
        w = worst.setdefault(str(q.shape[1]), {})
        w["calls"] = w.get("calls", 0) + 1
        for key in ("scaled_err", "rel_rms_err"):
            w[key] = max(w.get(key, 0.0), e[key])
        return out
    return call


def check_composed(pipe, steps: int, reps: int):
    """One edit step at SD-1.5 width on the fused route and on the composed
    route (allow_fused=False), with each route's launches. Every composed
    call of the step is held in situ against K3 on its own inputs, at the
    kernels' tolerance. End to end, random SD-1.5 weights amplify any
    layer's bf16 rounding difference to several percent of the step's
    output, so the two steps' outputs are held against the floor that
    rounding alone sets there, the fused step with K3 replaced by its plain
    version: the composed route's relative RMS gap to the fused step at most
    COMPOSED_FLOOR_RATIO times the floor's. Then both routes are timed per
    token level (G = 2, F = refs + chunk) for the UNet's c = 0.6 and the
    ControlNet's c = 0."""
    import torch
    from gaussctrl_tpu_torch.diffusion import processors
    from gaussctrl_tpu_torch.diffusion.processors import CrossViewAttnProcessor
    from gaussctrl_tpu_torch.ops import (flash_attention as fa, launch_counts,
                                         reset_launch_counts)
    t0 = time.perf_counter()
    outs, launches, step_ms = {}, {}, {}
    for route, fused in (("fused", True), ("composed", False)):
        reset_launch_counts()
        outs[route] = edit_step(pipe, fused, steps)
        torch.cuda.synchronize()
        launches[route] = {k: v for k, v in launch_counts.items() if v}
        step_ms[route] = cuda_ms(lambda: edit_step(pipe, fused, steps), 2)
    with _patched([(processors, "cross_view_attention",
                    fa.cross_view_attention_plain)]):
        floor = edit_step(pipe, True, steps)
    in_situ = {}
    edit_step(pipe, False, steps, wrap=lambda proc: _held_to_fused(proc, in_situ))
    end_to_end = {
        name: dict(composed=attn_errors(outs["composed"][i], outs["fused"][i]),
                   floor=attn_errors(floor[i], outs["fused"][i]))
        for i, name in enumerate(("eps", "step"))}
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    f, r = REFS + CHUNK, REFS
    levels = []
    for t, c in LEVELS:
        q, k, v = (_rand_bf16((2 * f, t, c), gen) for _ in range(3))
        row = dict(T=t, C=c)
        for coeff in (0.6, 0.0):
            comp = CrossViewAttnProcessor(r, coeff, 2, allow_fused=False)
            row[f"fused_ms_c{coeff}"] = cuda_ms(
                lambda: fa.cross_view_attention(q, k, v, HEADS, r, coeff, 2), reps)
            row[f"composed_ms_c{coeff}"] = cuda_ms(lambda: comp(q, k, v, HEADS), reps)
        levels.append(row)
    per_step = {route: sum(row[f"{route}_ms_c0.6"] * LAYERS_PER_LEVEL[row["T"]][0]
                           + row[f"{route}_ms_c0.0"] * LAYERS_PER_LEVEL[row["T"]][1]
                           for row in levels) for route in ("fused", "composed")}
    rec = dict(phase="composed", seconds=time.perf_counter() - t0,
               in_situ=in_situ, end_to_end=end_to_end, launches=launches,
               step_ms=step_ms, levels=levels, attention_ms_per_step=per_step)
    emit(rec)
    if (launches["composed"].get("cross_view_attention")
            or not launches["fused"].get("cross_view_attention")):
        raise AssertionError(f"the routes did not take their kernels: {launches}")
    layers = {str(t): sum(n) for t, n in LAYERS_PER_LEVEL.items()}
    if ({t: w.get("calls") for t, w in in_situ.items()} != layers
            or not all(attn_ok(w) for w in in_situ.values())):
        raise AssertionError(f"the composed route disagrees with the fused "
                             f"kernel in situ: {in_situ}")
    step = end_to_end["step"]
    if not (step["composed"]["rel_rms_err"]
            <= COMPOSED_FLOOR_RATIO * step["floor"]["rel_rms_err"]):
        raise AssertionError(f"the composed route's edit step is further from "
                             f"the fused one than bf16 rounding sets: {step}")
    return rec


# ---------------------------------------------------------------------------
# phase 7a: the device mesh: entry(), a world of one over NCCL, two ranks on
# the one card over gloo
# ---------------------------------------------------------------------------

# the mesh runs' depth: DDIM steps and re-optimisation steps of each run()
MESH_STEPS, MESH_REOPT_STEPS = 3, 10
# the edit of two ranks against one rank's: random SD-1.5 weights amplify the
# rounding of batched layers, and a rank batches 6 views where one rank
# batches 8, so its relative RMS gap is held to this times the gap that
# batch composition alone sets on one rank (the chunked edit, chunk 2,
# against the all-at-once edit: the same function in batches of 6 views)
MESH_FLOOR_RATIO = 2.0
# the gaussian-sharded step against the unsharded one: the JAX dry run's
# tolerances (loss rtol; rtol, atol of every leaf, as of its means)
MESH_LOSS_RTOL, MESH_LEAF_RTOL, MESH_LEAF_ATOL = 1e-5, 1e-4, 1e-6
MESH_STEP_REPS = 5
# K1 and K4 calls held in situ in the world-of-one run
MESH_SPLAT_HELD = 2


def entry_expected() -> dict:
    """The launches of one `entry()` step: one reference view, so at the
    fused levels one K3 a self-attention layer; at the 64-token level the
    UNet's self branch (K2) and one reference call a layer; one text
    cross-attention a transformer block."""
    from gaussctrl_tpu_torch.ops import launch_counts
    expected = dict.fromkeys(launch_counts, 0)
    for t, c in LEVELS:
        n_unet, n_cn = LAYERS_PER_LEVEL[t]
        expected[std_kernel(c // HEADS, TEXT_TOKENS)] += n_unet + n_cn
        if str(t) in fused_levels():
            expected["cross_view_attention"] += n_unet + n_cn
        else:
            expected["flash_attention_t"] += n_unet
            expected[std_kernel(c // HEADS, t)] += n_unet + n_cn
    return expected


def mesh_held_ok(in_situ: dict) -> bool:
    """Each of K2/K3/K5/K6 had held calls within the attention tolerances,
    and K1/K4 passed `splat_ok`."""
    return splat_ok(in_situ["splat"]) and all(
        w.get("calls") and attn_ok(w) for w in in_situ["attention"].values())


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def _sharded_step_inputs(target):
    """The gaussian-sharded step's inputs: the smoke scene on the card, the
    first orbit view at SIZE and its target, a seeded background."""
    import torch
    cams = orbit_cameras(8, SIZE, DEVICE)
    bg = torch.rand(3, generator=torch.Generator(device=DEVICE).manual_seed(5),
                    device=DEVICE)
    kw = dict(c2w=cams.c2w[0], fx=cams.fx[0], fy=cams.fy[0], cx=cams.cx[0],
              cy=cams.cy[0], gt_image=target.to(DEVICE, torch.float32),
              background=bg, width=SIZE, height=SIZE)
    return smoke_scene(GAUSSIANS, DEVICE), kw


def mesh_rank(art_path: str, cfg_fields: dict) -> dict:
    """One of two ranks on the one card (gloo, CUDA tensors): the
    view-sharded edit of the world-of-one run's inputs, all at once and in
    chunks, then once more all at once with K2/K3/K5/K6 held against their
    plain versions on this rank's inputs (untimed); then a gaussian-sharded
    re-optimisation step of the smoke scene at SIZE, with K1 and K4 held,
    against the unsharded one on every leaf, both from the same start, and
    each timed over MESH_STEP_REPS more steps (both ranks share the
    card)."""
    import torch
    from gaussctrl_tpu_torch.core.mesh import gather_rows, make_mesh
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    from gaussctrl_tpu_torch.pipeline.gaussctrl import (GaussCtrlConfig,
                                                        GaussCtrlPipeline)
    from gaussctrl_tpu_torch.splat.trainer import (make_optimizer, shard_scene,
                                                   train_step, trainable)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(DEVICE)
    art = torch.load(art_path)
    cfg = GaussCtrlConfig(**cfg_fields)
    pipe = GaussCtrlPipeline(cfg, smoke_scene(8, DEVICE),
                             orbit_cameras(len(art["z_T"]), SIZE, DEVICE),
                             sd_config=SDConfig.sd15(), dtype=torch.bfloat16,
                             device=DEVICE, mesh=mesh)
    for k in ("unedited", "depths", "disparity", "z_T", "masks"):
        setattr(pipe, k, art[k].to(DEVICE))
    out = {}
    # the first edit of a fresh process also warms the card up: timed
    # apart, then each mode timed warm
    for name, chunk in (("first_edit", 0), ("chunk2", 2), ("chunk0", 0)):
        pipe.config.chunk_size = chunk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.edit_images()
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"edited_{name}"] = pipe.edited.cpu()
    torch.cuda.empty_cache()
    holds, attn_situ = attention_holds(CERTIFY_HELD_PER_SHAPE)
    with _patched(holds):
        pipe.edit_images()
    out["held_edit_bit_equal"] = bool(torch.equal(pipe.edited.cpu(),
                                                  out["edited_chunk0"]))
    del pipe
    torch.cuda.empty_cache()

    scene, kw = _sharded_step_inputs(art["edited"][0])
    local, full = trainable(shard_scene(scene, mesh)), trainable(scene)
    opt_l, opt_f = make_optimizer(local), make_optimizer(full)
    holds, splat_situ = splat_holds(1)
    with _patched(holds):
        m_s = train_step(local, opt_l, 0, mesh=mesh, **kw)
    m_r = train_step(full, opt_f, 0, **kw)
    leaves = {}
    for k in TRAIN_FIELDS:
        got = gather_rows(getattr(local, k).detach(), mesh)
        ref = getattr(full, k).detach()
        leaves[k] = dict(
            max_abs_diff=float((got - ref).abs().max()),
            bit_equal=bool(torch.equal(got, ref)),
            close=bool(torch.allclose(got, ref, rtol=MESH_LEAF_RTOL,
                                      atol=MESH_LEAF_ATOL)),
            moved=float((ref - getattr(scene, k)).abs().max()))
    out.update(loss=float(m_s["loss"]), unsharded_loss=float(m_r["loss"]),
               leaves=leaves,
               in_situ=dict(attention=attn_situ, splat=splat_situ))
    for name, sc, opt, m in (("sharded", local, opt_l, mesh),
                             ("unsharded", full, opt_f, None)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(MESH_STEP_REPS):
            train_step(sc, opt, 1 + i, mesh=m, **kw)
        torch.cuda.synchronize()
        out[f"{name}_step_ms"] = (time.perf_counter() - t0) / MESH_STEP_REPS * 1e3
    out["rank"] = mesh.get_local_rank()
    return out


def check_mesh(pipe, card: str, root: str):
    """Phase mesh. (a) `entry()` at SD-1.5 widths: one step, finite, exact
    K3/K5 launches (every kernel's count from `entry_expected`) and its ms.
    (b) `run()` with `mesh=make_mesh()` (NCCL, a world of one) on the main
    path's weights, chunk_size 0, against the same `run()` without a mesh:
    at a world of one the gathers are copies and each rank's batch is the
    whole one, so every artifact and the re-optimised scene must be equal
    bit for bit; exact K1-K6 launches; the views/s of both, run in turns
    (without, with, with, without); one more run() with the mesh, untimed,
    with K2/K3/K5/K6 (the first CERTIFY_HELD_PER_SHAPE calls of each
    argument signature) and K1/K4 (the first MESH_SPLAT_HELD calls) held
    against their plain versions on its own inputs; a sharded checkpoint
    round trip of the scene, bit for bit, with its bytes and seconds. (c)
    two ranks on the one card over gloo (spawned processes that load the
    weights from the files): the view-sharded edit of (b)'s inputs against
    (b)'s at MESH_FLOOR_RATIO times the batch-composition floor, with each
    rank's K2/K3/K5/K6 held in situ on its refs + share, and the
    gaussian-sharded step, with its K1/K4 held, against the unsharded one
    on every leaf."""
    import copy
    import dataclasses
    import torch
    import torch.distributed as dist
    from gaussctrl_tpu_torch.core.ckpt import (load_checkpoint_sharded,
                                               save_checkpoint_sharded)
    from gaussctrl_tpu_torch.core.mesh import make_mesh, spawn_ranks
    from gaussctrl_tpu_torch.core.writer import SectionTimers
    from gaussctrl_tpu_torch.entry import entry
    from gaussctrl_tpu_torch.ops import launch_counts, reset_launch_counts
    timers = SectionTimers()
    rec = dict(phase="mesh", card=card)
    checks = {}

    # (a) the flagship step at SD-1.5 widths on zero weights
    with timers.section("entry"):
        fn, args = entry(device=DEVICE)
        torch.cuda.synchronize()
        reset_launch_counts()
        out = fn(*args)
        torch.cuda.synchronize()
        counts = dict(launch_counts)
        ms = cuda_ms(lambda: fn(*args), 5)
        expected = entry_expected()
        rec["entry"] = dict(ms=ms, launches=counts, expected_launches=expected,
                            shape=list(out.shape))
        checks["entry_finite"] = bool(torch.isfinite(out).all())
        checks["entry_launches"] = counts == expected
        del fn, args, out
        torch.cuda.empty_cache()

    # (b) a world of one over NCCL against no mesh
    with timers.section("world_one"):
        mesh = make_mesh(DEVICE)
        cfg = dataclasses.replace(pipe.config, chunk_size=0,
                                  num_inference_steps=MESH_STEPS,
                                  render_rate=MESH_REOPT_STEPS)
        V = len(pipe.cameras)
        runs = {"single": [], "mesh": []}
        # in turns, so that neither side alone takes the warm-up or a
        # change in the host's load
        for name, m in (("single", None), ("mesh", mesh), ("mesh", mesh),
                        ("single", None)):
            p = copy.copy(pipe)
            p.config, p.mesh, p.masker = cfg, m, None
            p.scene = smoke_scene(GAUSSIANS, DEVICE)
            metrics, seconds, counts = _timed_run(p)
            runs[name].append(dict(
                pipe=p, metrics=metrics, seconds=seconds, counts=counts,
                views_per_s=V / (seconds["render_reverse"]
                                 + seconds["edit_images"])))
        single, meshed = runs["single"][0]["pipe"], runs["mesh"][0]["pipe"]
        arts = ("unedited", "depths", "disparity", "z_T", "masks", "edited")
        equal = {k: bool(torch.equal(getattr(single, k), getattr(meshed, k)))
                 for k in arts}
        equal.update({f"scene.{k}": bool(torch.equal(getattr(single.scene, k),
                                                     getattr(meshed.scene, k)))
                      for k in TRAIN_FIELDS})
        equal["loss_history"] = bool(torch.equal(
            runs["single"][0]["metrics"]["loss_history"],
            runs["mesh"][0]["metrics"]["loss_history"]))
        layers = attention_layer_counts(pipe.models)
        expected, _ = expected_launches(meshed, layers, V, MESH_STEPS,
                                        MESH_REOPT_STEPS)
        rec["world_one"] = dict(
            backend=dist.get_backend(), world=mesh.size(), views=V,
            steps=MESH_STEPS, reopt_steps=MESH_REOPT_STEPS,
            bit_equal=equal, expected_launches=expected,
            **{name: dict(seconds=[r["seconds"] for r in rs],
                          views_per_s=[r["views_per_s"] for r in rs],
                          counts=rs[0]["counts"])
               for name, rs in runs.items()})
        checks["world_one_bit_equal"] = all(equal.values())
        checks["world_one_launches"] = all(r["counts"] == expected
                                           for r in runs["mesh"])
        checks["world_one_finite"] = bool(torch.isfinite(meshed.edited).all())

        # every kernel of the meshed run held on its own inputs, untimed
        held = copy.copy(pipe)
        held.config, held.mesh, held.masker = cfg, mesh, None
        held.scene = smoke_scene(GAUSSIANS, DEVICE)
        attn, attn_situ = attention_holds(CERTIFY_HELD_PER_SHAPE)
        splat, splat_situ = splat_holds(MESH_SPLAT_HELD)
        with _patched(attn + splat):
            held.run()
        in_situ = dict(attention=attn_situ, splat=splat_situ)
        rec["world_one"]["in_situ"] = in_situ
        rec["world_one"]["held_run_bit_equal"] = bool(
            torch.equal(held.edited, meshed.edited))
        checks["world_one_kernels_vs_plain"] = mesh_held_ok(in_situ)
        del held

        # the batch-composition floor for (c): the same edit in chunks of 2
        floor_pipe = copy.copy(single)
        floor_pipe.config = dataclasses.replace(cfg, chunk_size=2)
        floor_pipe.edit_images()

        # the sharded checkpoint round trip (the whole scene is rank 0's)
        ckpt_dir = os.path.join(root, "mesh_ckpt")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint_sharded(ckpt_dir, MESH_REOPT_STEPS,
                                       meshed.scene, mesh)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_checkpoint_sharded(path, like=meshed.scene, mesh=mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        rec["checkpoint"] = dict(bytes=_dir_bytes(str(path)), save_s=save_s,
                                 load_s=load_s, gaussians=GAUSSIANS)
        checks["checkpoint_bit_exact"] = all(
            torch.equal(getattr(back, k), getattr(meshed.scene, k))
            for k in TRAIN_FIELDS)
        dist.destroy_process_group()

    # (c) two ranks on the one card over gloo, on (b)'s inputs; this
    # process keeps only the two edits and gives its cached memory back,
    # which the ranks' plain versions (a K3 at 4096 tokens ~7 GB) need
    with timers.section("two_ranks"):
        art_path = os.path.join(root, "mesh_inputs.pt")
        torch.save({k: getattr(single, k).cpu() for k in arts}, art_path)
        one_edit, floor_edit = single.edited, floor_pipe.edited
        del floor_pipe, single, meshed, runs
        torch.cuda.empty_cache()
        cfg_fields = {f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)}
        ranks = spawn_ranks(mesh_rank, 2, args=(art_path, cfg_fields),
                            device=DEVICE, backend="gloo", timeout_s=600,
                            group_timeout_s=300)
        floor = attn_errors(floor_edit, one_edit)
        two = dict(floor_chunk2=floor)
        for chunk, ref in ((0, one_edit), (2, floor_edit)):
            two[f"chunk{chunk}"] = attn_errors(
                ranks[0][f"edited_chunk{chunk}"].to(DEVICE), ref)
            checks[f"two_ranks_chunk{chunk}_equal_across_ranks"] = torch.equal(
                ranks[0][f"edited_chunk{chunk}"], ranks[1][f"edited_chunk{chunk}"])
        checks["two_ranks_edit_repeats"] = all(
            torch.equal(r["edited_first_edit"], r["edited_chunk0"])
            for r in ranks)
        # all at once: against one rank's all-at-once edit, to the floor
        checks["two_ranks_edit_within_floor"] = (
            two["chunk0"]["rel_rms_err"]
            <= max(MESH_FLOOR_RATIO * floor["rel_rms_err"], 1e-3))
        # in chunks: the same batches as one rank's chunked edit; only the
        # VAE decode batches differ (a share of 4 views against 8)
        checks["two_ranks_chunked_within_floor"] = (
            two["chunk2"]["rel_rms_err"]
            <= max(MESH_FLOOR_RATIO * floor["rel_rms_err"], 1e-3))
        step_keys = ("loss", "unsharded_loss", "leaves", "sharded_step_ms",
                     "unsharded_step_ms")
        two["train_step"] = [{k: r[k] for k in step_keys} for r in ranks]
        two["edit_s"] = [{k: r[k] for k in ("first_edit_s", "chunk0_s",
                                            "chunk2_s")} for r in ranks]
        two["in_situ"] = [r["in_situ"] for r in ranks]
        two["held_edit_bit_equal"] = [r["held_edit_bit_equal"] for r in ranks]
        checks["two_ranks_kernels_vs_plain"] = all(
            mesh_held_ok(r["in_situ"]) for r in ranks)
        checks["two_ranks_step_loss"] = all(
            abs(r["loss"] - r["unsharded_loss"])
            <= MESH_LOSS_RTOL * abs(r["unsharded_loss"]) for r in ranks)
        checks["two_ranks_step_leaves"] = all(
            leaf["close"] and leaf["moved"] > 0
            for r in ranks for leaf in r["leaves"].values())
        rec["two_ranks"] = two
        os.remove(art_path)
    del one_edit, floor_edit
    torch.cuda.empty_cache()
    rec["sections"] = timers.summary()
    rec["checks"] = checks
    emit(rec)
    if not all(checks.values()):
        raise AssertionError(f"phase mesh failed: "
                             f"{[k for k, v in checks.items() if not v]}")
    return rec


# ---------------------------------------------------------------------------
# phase 7b: text-prompted object masks on the edit (SAM ViT-H, GroundingDINO
# Swin-B, CLIP ViT-L/14) read from checkpoints in the reference layouts
# ---------------------------------------------------------------------------

MASK_OBJECT = "bear"
# the masked edit's own depth: the edit itself is timed by the main path
MASK_STEPS, MASK_REOPT_STEPS = 2, 10
# the tiny segmentation stack, card against CPU, float32 on both (TF32 off):
# within 1e-4 of each output's largest |value|
SEG_TINY_TOL = 1e-4
# full width, one view: float32 on the card against float64 on the card,
# held by relative RMS and by the largest error over the largest |value|
SEG_F64_REL_RMS_TOL, SEG_F64_SCALED_TOL = 1e-3, 1e-2
# a BERT vocabulary for the prompt (the word table keeps its 30522 rows)
DINO_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", ".", "?", "a", "photo",
              "of", "bear", "polar", "statue"]


def seg_configs():
    """(SAM, GroundingDINO, CLIP vision, CLIP text) configs of the phase:
    the reference's SAM ViT-H, GroundingDINO Swin-B and CLIP ViT-L/14 with
    the SD-1.5 text tower."""
    from gaussctrl_tpu_torch.diffusion.clip import CLIPVisionConfig
    from gaussctrl_tpu_torch.diffusion.config import CLIPTextConfig
    from gaussctrl_tpu_torch.seg.dino import DinoConfig
    from gaussctrl_tpu_torch.seg.sam import SAMConfig
    return (SAMConfig.vit_h(), DinoConfig.swin_b(), CLIPVisionConfig.vit_l14(),
            CLIPTextConfig.sd15())


def _err(got, ref) -> dict:
    """Largest error over the largest |value|, and relative RMS."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    if got.shape != ref.shape:
        raise AssertionError(f"shapes {tuple(got.shape)} != {tuple(ref.shape)}")
    d = got - ref
    return dict(scaled_err=(d.abs().max() / ref.abs().max().clamp_min(1e-30)).item(),
                rel_rms_err=(d.norm() / ref.norm().clamp_min(1e-30)).item())


def write_seg_checkpoints(root: str, cfgs) -> dict:
    """Random SAM, GroundingDINO and CLIP weights written in the layouts the
    reference's checkpoints have: a facebook SAM `.pth` (with the
    mask-prompt weights the box path leaves unused), the official
    GroundingDINO `.pth` (nested under "model", "module." prefixes, the
    shared box head's copies, Swin's relative_position_index buffers,
    BERT's pooler and position_ids) with a vocab.txt, and a transformers
    CLIPModel directory (safetensors from the port's writer, logit_scale
    and I64 position_ids). Floats are stored in fp16 (the released files
    are fp32) to halve the bytes the phase moves; the loaders widen them.
    Returns the paths and the written tensors."""
    import torch
    from gaussctrl_tpu_torch.diffusion.weights import save_safetensors
    from gaussctrl_tpu_torch.seg.dino import GroundingDINO
    from gaussctrl_tpu_torch.seg.grounding import random_clip
    from gaussctrl_tpu_torch.seg.sam import SAM
    sam_cfg, dino_cfg, vcfg, tcfg = cfgs
    gen = torch.Generator().manual_seed(12)
    out = dict(sam=os.path.join(root, "sam_vit_h.pth"),
               dino=os.path.join(root, "groundingdino_swinb_cogcoor.pth"),
               vocab=os.path.join(root, "vocab.txt"),
               clip=os.path.join(root, "clip-vit-large-patch14"))

    def half(sd):
        return {k: v.cpu().half() if v.is_floating_point() else v.cpu()
                for k, v in sd.items()}

    sam = half(SAM.create(sam_cfg, 11, DEVICE).state_dict())
    c = sam_cfg.out_chans
    extra = {"not_a_point_embed.weight": (1, c),
             "mask_downscaling.0.weight": (c // 16, 1, 2, 2),
             "mask_downscaling.0.bias": (c // 16,),
             "mask_downscaling.1.weight": (c // 16,),
             "mask_downscaling.1.bias": (c // 16,),
             "mask_downscaling.3.weight": (c // 4, c // 16, 2, 2),
             "mask_downscaling.3.bias": (c // 4,),
             "mask_downscaling.4.weight": (c // 4,),
             "mask_downscaling.4.bias": (c // 4,),
             "mask_downscaling.6.weight": (c, c // 4, 1, 1),
             "mask_downscaling.6.bias": (c,)}
    for k, shape in extra.items():
        sam["prompt_encoder." + k] = torch.randn(shape, generator=gen).half()
    torch.save(sam, out["sam"])

    dino = half(GroundingDINO.create(dino_cfg, 13, DEVICE).state_dict())
    head = {k: v for k, v in dino.items() if k.startswith("bbox_embed.0.")}
    for i in range(dino_cfg.dec_layers):
        for k, v in head.items():
            dino[k.replace("bbox_embed.0.", f"bbox_embed.{i}.")] = v
            dino["transformer.decoder." + k.replace("bbox_embed.0.",
                                                    f"bbox_embed.{i}.")] = v
    w = dino_cfg.window
    for s_, depth in enumerate(dino_cfg.swin_depths):
        for b in range(depth):
            dino[f"backbone.0.layers.{s_}.blocks.{b}.attn.relative_position_index"] = \
                torch.zeros((w * w, w * w), dtype=torch.int64)
    dino["bert.pooler.dense.weight"] = (torch.randn(
        (dino_cfg.bert_hidden,) * 2, generator=gen) * 0.02).half()
    dino["bert.pooler.dense.bias"] = torch.zeros(dino_cfg.bert_hidden).half()
    dino["bert.embeddings.position_ids"] = torch.arange(512)[None]
    torch.save({"model": {"module." + k: v for k, v in dino.items()}}, out["dino"])
    with open(out["vocab"], "w") as f:
        f.write("\n".join(DINO_VOCAB) + "\n")

    clip = half(random_clip(vcfg, tcfg, 14, DEVICE).state_dict())
    clip["logit_scale"] = torch.tensor(2.6592)
    clip["text_model.embeddings.position_ids"] = torch.arange(
        tcfg.max_position_embeddings)[None]
    clip["vision_model.embeddings.position_ids"] = torch.arange(
        1 + vcfg.grid ** 2)[None]
    os.makedirs(out["clip"])
    save_safetensors(os.path.join(out["clip"], "model.safetensors"), clip)
    out["tensors"] = dict(sam=sam, dino=dino, clip=clip)
    return out


def _read_back_exact(module, written: dict, rename=lambda k: k) -> bool:
    """Every tensor of `module` is the file's, bit for bit (after float32)."""
    import torch
    return all(torch.equal(v.cpu(), written[rename(k)].float())
               for k, v in module.state_dict().items())


def check_seg_tiny(tokenizer_for) -> dict:
    """The tiny segmentation stack on the card against the CPU, one set of
    weights on both: SAM's embeddings, mask logits and IoU, the CLIP
    heatmap, GroundingDINO's logits and boxes, and the CLIPScorer's image
    and text embeddings."""
    import copy
    import numpy as np
    import torch
    from gaussctrl_tpu_torch.diffusion.clip import CLIPVisionConfig
    from gaussctrl_tpu_torch.diffusion.config import CLIPTextConfig
    from gaussctrl_tpu_torch.metrics import CLIPScorer
    from gaussctrl_tpu_torch.seg.dino import DinoConfig, GroundingDINO, phrase_masks
    from gaussctrl_tpu_torch.seg.grounding import ClipBoxProposer, random_clip
    from gaussctrl_tpu_torch.seg.sam import SAM, SAMConfig
    gen = torch.Generator().manual_seed(21)
    errs = {}
    sam = SAM.create(SAMConfig.tiny(), 22)
    sam_card = copy.deepcopy(sam).to(DEVICE)
    img = torch.rand(3, 64, 64, 3, generator=gen)
    boxes = torch.tensor([[4., 4., 40., 40.], [0., 0., 60., 60.],
                          [30., 20., 62., 50.]])
    emb = sam.encode(img)
    errs["sam_embedding"] = _err(sam_card.encode(img.to(DEVICE)), emb)
    m, iou = sam.predict_boxes(emb, boxes)
    cm, ciou = sam_card.predict_boxes(emb.to(DEVICE), boxes.to(DEVICE))
    errs["sam_mask_logits"], errs["sam_iou"] = _err(cm, m), _err(ciou, iou)

    tcfg = CLIPTextConfig.tiny()
    clip = random_clip(CLIPVisionConfig.tiny(), tcfg, 23)
    clip_card = copy.deepcopy(clip).to(DEVICE)
    tok = tokenizer_for(tcfg)
    imgs = torch.rand(4, 48, 40, 3, generator=gen)
    errs["clip_heatmap"] = _err(
        ClipBoxProposer(clip_card, tok).heatmap(imgs.to(DEVICE), MASK_OBJECT),
        ClipBoxProposer(clip, tok).heatmap(imgs, MASK_OBJECT))
    sc, sg = CLIPScorer(clip, tok), CLIPScorer(clip_card, tok)
    errs["scorer_images"] = _err(sg.embed_images(imgs), sc.embed_images(imgs))
    prompts = ["a photo of a polar bear", "a photo of a bear statue"]
    errs["scorer_texts"] = _err(sg.embed_texts(prompts), sc.embed_texts(prompts))

    cfg = DinoConfig.tiny()
    dino = GroundingDINO.create(cfg, 24)
    dino_card = copy.deepcopy(dino).to(DEVICE)
    ids = np.zeros((2, cfg.max_text_len), np.int64)
    ids[:, :5] = [1, 10, 11, 2, 1]
    attn, pos = phrase_masks(ids, (1, 2))
    attn |= np.eye(cfg.max_text_len, dtype=bool)
    tmask = np.zeros_like(ids, bool)
    tmask[:, :5] = True
    text = [torch.as_tensor(x) for x in (ids, pos, attn, tmask)]
    im = torch.randn(2, cfg.img_size, cfg.img_size, 3, generator=gen)
    logits, bx = dino(im, *text)
    cl, cb = dino_card(im.to(DEVICE), *[t.to(DEVICE) for t in text])
    errs["dino_logits"] = _err(cl[:, :, :5], logits[:, :, :5])
    errs["dino_boxes"] = _err(cb, bx)
    return errs


def check_seg_f64(sam, dino, tok, view) -> dict:
    """At full width on one view [1,H,W,3]: SAM encode + decode and the
    GroundingDINO forward in float32 on the card against the same modules
    in float64 on the card. GroundingDINO's float64 decoder starts from the
    float32 run's selected locations (a near tie at the top-900 boundary
    would otherwise swap whole queries)."""
    import copy
    import torch
    from gaussctrl_tpu_torch.pipeline.gaussctrl import resize_bilinear
    from gaussctrl_tpu_torch.seg.dino import (IMAGENET_MEAN, IMAGENET_STD,
                                              DinoBoxProposer)
    errs = {}
    s = sam.cfg.img_size
    x = resize_bilinear(view.float(), s, s)
    box = torch.tensor([[0.2 * s, 0.2 * s, 0.8 * s, 0.8 * s]], device=DEVICE)
    sam64 = copy.deepcopy(sam).double()
    emb, emb64 = sam.encode(x), sam64.encode(x.double())
    m, iou = sam.predict_boxes(emb, box)
    m64, iou64 = sam64.predict_boxes(emb64, box.double())
    errs["sam_embedding"], errs["sam_mask_logits"] = _err(emb, emb64), _err(m, m64)
    errs["sam_iou"] = _err(iou, iou64)
    del sam64, emb64, m64
    torch.cuda.empty_cache()

    prop = DinoBoxProposer(dino, tok)
    text = prop._prep_text(MASK_OBJECT)
    n = int(text[3].sum())
    s = dino.cfg.img_size
    im = resize_bilinear(view.float(), s, s)
    im = (im - im.new_tensor(IMAGENET_MEAN)) / im.new_tensor(IMAGENET_STD)
    ids, pos, attn, tmask = (torch.as_tensor(t, device=DEVICE) for t in text)
    ids, pos = ids.long(), pos.long()
    dino64 = copy.deepcopy(dino).double()
    with torch.no_grad():
        img, txt = dino.encode(im, ids, pos, attn, tmask)
        top = dino.select(img, txt, tmask)
        logits, bx = dino.decode(img, txt, tmask, top)
        img64, txt64 = dino64.encode(im.double(), ids, pos, attn, tmask)
        logits64, bx64 = dino64.decode(img64, txt64, tmask, top)
    errs["dino_image_memory"] = _err(img, img64)
    errs["dino_logits"] = _err(logits[:, :, :n], logits64[:, :, :n])
    errs["dino_boxes"] = _err(bx, bx64)
    del dino64
    torch.cuda.empty_cache()
    return errs


def check_masked_edit(pipe, card: str, root: str):
    """The masked edit at full width: the segmentation checkpoints written
    in the reference layouts under `root` (kept for phase `certify`; the
    caller removes it) and read back through the port's loaders;
    `GaussCtrlPipeline.run()` (MASK_STEPS DDIM steps, MASK_REOPT_STEPS
    re-optimisation steps) with `langsam_obj` and a GroundedSAMMasker over
    GroundingDINO on a fresh smoke scene, with exact kernel launch counts;
    the CLIP proposer's route and the CLIP metrics on the same views; the
    tiny stack card against CPU and the full width float32 against
    float64. Returns (the record, the checkpoint files)."""
    import dataclasses
    import numpy as np
    import torch
    from gaussctrl_tpu_torch.diffusion.clip import load_tokenizer
    from gaussctrl_tpu_torch.diffusion.weights import load_clip_model
    from gaussctrl_tpu_torch.metrics import (CLIPScorer,
                                             clip_directional_similarity,
                                             clip_similarity)
    from gaussctrl_tpu_torch.ops import launch_counts, reset_launch_counts
    from gaussctrl_tpu_torch.seg.dino import DinoBoxProposer
    from gaussctrl_tpu_torch.seg.dino_weights import load_dino
    from gaussctrl_tpu_torch.seg.grounding import (ClipBoxProposer,
                                                   GroundedSAMMasker)
    from gaussctrl_tpu_torch.seg.weights import load_sam
    from gaussctrl_tpu_torch.splat.render import render_rgbd
    t_phase = time.perf_counter()
    cfgs = seg_configs()
    V = len(pipe.cameras)
    checks, notes = {}, []

    # 1. checkpoints written, and read back through the port's loaders
    t0 = time.perf_counter()
    files = write_seg_checkpoints(root, cfgs)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, fs in os.walk(root) for f in fs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sam = load_sam(files["sam"], device=DEVICE)
    dino, tok = load_dino(files["dino"], files["vocab"], device=DEVICE)
    clip = load_clip_model(files["clip"], device=DEVICE)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    written = files.pop("tensors")
    checks["configs_from_files"] = (sam.cfg, dino.cfg, clip.vision_cfg,
                                    clip.text_cfg) == tuple(cfgs)
    checks["read_back_bit_exact"] = (
        _read_back_exact(sam, written["sam"])
        and _read_back_exact(dino, written["dino"])
        and _read_back_exact(clip, written["clip"]))
    del written
    tcfg = cfgs[3]
    clip_tok = load_tokenizer(None, tcfg)

    # 2. the DINO threshold: random weights may score no query above the
    # default 0.3 on any view; then it is lowered to the views' median best
    # score, so that the masked path runs
    pipe.scene = smoke_scene(GAUSSIANS, DEVICE)
    cams = pipe.cameras
    bg = torch.zeros(3, device=DEVICE)
    with torch.no_grad():
        views = torch.stack([render_rgbd(
            pipe.scene, cams.c2w[i], cams.fx[i], cams.fy[i], cams.cx[i],
            cams.cy[i], cams.width, cams.height, bg, pipe.scene.sh_degree,
            pipe.raster_cfg)["rgb"] for i in range(V)])
    prop = DinoBoxProposer(dino, tok)
    text = prop._prep_text(MASK_OBJECT)
    best = torch.cat([prop.forward(views[lo:lo + prop.batch], text)[0]
                      .amax((1, 2)) for lo in range(0, V, prop.batch)]).cpu()
    default = prop.box_threshold
    if best.max() < default:
        prop.box_threshold = float(best.median())
        notes.append(f"box_threshold lowered from {default} to "
                     f"{prop.box_threshold!r}: the random GroundingDINO's best "
                     f"scores per view span [{best.min().item()!r}, "
                     f"{best.max().item()!r}], all under the default")

    # 3. the masked run, its masker's parts timed on the card
    parts = dict(proposer=0.0, sam_encode=0.0, sam_decode=0.0)
    found = {}

    def timed(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            parts[name] += time.perf_counter() - t
            return out
        return call

    def proposer(images, text):
        boxes = prop(images, text)
        found["boxes"] = boxes
        return boxes

    masker = GroundedSAMMasker(sam, timed("proposer", proposer))
    sam.encode = timed("sam_encode", sam.encode)
    sam.predict_boxes = timed("sam_decode", sam.predict_boxes)
    pipe.masker = masker
    pipe.config = dataclasses.replace(
        pipe.config, langsam_obj=MASK_OBJECT, num_inference_steps=MASK_STEPS,
        render_rate=MASK_REOPT_STEPS)
    layers = attention_layer_counts(pipe.models)
    expected, _ = expected_launches(pipe, layers, V, MASK_STEPS,
                                    MASK_REOPT_STEPS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = pipe.run()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del sam.encode, sam.predict_boxes

    masks = pipe.masks
    has_box = torch.as_tensor(found["boxes"][:, 0] >= 0, device=DEVICE)
    per_view_max = masks.flatten(1).amax(1)
    off = (masks == 0).expand_as(pipe.edited)
    checks["masks_binary"] = bool(((masks == 0) | (masks == 1)).all())
    checks["unmasked_pixels_unedited_bit_exact"] = bool(
        torch.equal(pipe.edited[off], pipe.unedited[off]))
    checks["no_box_views_all_zero"] = bool((per_view_max[~has_box] == 0).all())
    checks["some_view_masked"] = bool((per_view_max > 0).any())
    # the no-box branch, whatever the scores: the first batch's boxes again
    # with view 0's replaced by "no match" give the run's masks there, with
    # view 0 all zero
    n = masker.batch
    boxes = found["boxes"][:n].copy()
    boxes[0] = -1.0
    again = GroundedSAMMasker(sam, lambda images, text: boxes)(
        pipe.unedited[:n], MASK_OBJECT)
    checks["no_box_view_all_zero"] = bool(again[0].max() == 0) and \
        bool(torch.equal(again[1:], masks[1:n]))
    checks["launch_counts"] = counts == expected
    checks["finite"] = bool(torch.isfinite(pipe.edited).all()) and bool(
        torch.isfinite(metrics["loss_history"]).all())

    # 4. the CLIP proposer's route on the same views
    clip_prop = ClipBoxProposer(clip, clip_tok)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sims = clip_prop.heatmap(pipe.unedited, MASK_OBJECT)
    torch.cuda.synchronize()
    heat_s = time.perf_counter() - t0
    clip_boxes = clip_prop(pipe.unedited, MASK_OBJECT)
    if not (clip_boxes[:, 0] >= 0).any():
        clip_prop.min_score = -1.0
        notes.append(f"CLIP proposer floor lowered from 0 to -1: the random "
                     f"towers' cosines span [{sims.min().item():.6f}, "
                     f"{sims.max().item():.6f}] on these views")
        clip_boxes = clip_prop(pipe.unedited, MASK_OBJECT)
    t0 = time.perf_counter()
    clip_masks = GroundedSAMMasker(sam, clip_prop)(pipe.unedited, MASK_OBJECT)
    torch.cuda.synchronize()
    clip_masker_s = time.perf_counter() - t0
    clip_has = torch.as_tensor(clip_boxes[:, 0] >= 0, device=DEVICE)
    checks["clip_masks_binary"] = bool(((clip_masks == 0) | (clip_masks == 1)).all())
    checks["clip_no_box_views_all_zero"] = bool(
        (clip_masks.flatten(1).amax(1)[~clip_has] == 0).all())

    # 5. the CLIP metrics of the edit (what cli.eval computes)
    scorer = CLIPScorer(clip, clip_tok)
    t0 = time.perf_counter()
    ev = dict(clip_similarity=clip_similarity(scorer, pipe.edited,
                                              pipe.config.edit_prompt),
              clip_directional_similarity=clip_directional_similarity(
                  scorer, pipe.edited, pipe.unedited, pipe.config.edit_prompt,
                  pipe.config.reverse_prompt))
    torch.cuda.synchronize()
    ev["seconds"] = time.perf_counter() - t0
    checks["eval_finite"] = all(math.isfinite(v) for v in ev.values())

    # 6. the tiny stack card against CPU, and full width against float64
    t0 = time.perf_counter()
    tiny = check_seg_tiny(lambda tc: load_tokenizer(None, tc))
    tiny_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    f64 = check_seg_f64(sam, dino, tok, pipe.unedited[:1])
    f64_s = time.perf_counter() - t0
    checks["tiny_card_vs_cpu"] = all(e["scaled_err"] <= SEG_TINY_TOL
                                     for e in tiny.values())
    checks["full_width_f32_vs_f64"] = all(
        e["scaled_err"] <= SEG_F64_SCALED_TOL
        and e["rel_rms_err"] <= SEG_F64_REL_RMS_TOL for e in f64.values())

    coverage = masks.float().mean((1, 2, 3)).tolist()
    rec = dict(phase="masked_edit", card=card, object=MASK_OBJECT, views=V,
               ddim_steps=MASK_STEPS, reopt_steps=MASK_REOPT_STEPS,
               sam=dataclasses.asdict(cfgs[0]), dino=dataclasses.asdict(cfgs[1]),
               clip_vision=dataclasses.asdict(cfgs[2]),
               checkpoint_bytes=nbytes, write_s=write_s, read_s=read_s,
               dino_best_score_per_view=best.tolist(),
               dino_box_threshold=prop.box_threshold, notes=notes,
               proposer_s=parts["proposer"], sam_encode_s=parts["sam_encode"],
               sam_decode_s=parts["sam_decode"], masked_run_s=run_s,
               peak_mem_gb=peak_gb,
               detections=found["boxes"].tolist(),
               views_with_box=int(has_box.sum()), mask_coverage=coverage,
               launches=counts, expected_launches=expected,
               clip_route=dict(heatmap_s=heat_s, masker_s=clip_masker_s,
                               cosine_range=[sims.min().item(), sims.max().item()],
                               detections=clip_boxes.tolist(),
                               mask_coverage=clip_masks.float().mean(
                                   (1, 2, 3)).tolist()),
               eval=ev, tiny_card_vs_cpu=tiny, tiny_tol=SEG_TINY_TOL,
               tiny_s=tiny_s, full_width_f32_vs_f64=f64,
               f64_tol=dict(scaled=SEG_F64_SCALED_TOL,
                            rel_rms=SEG_F64_REL_RMS_TOL),
               f64_s=f64_s, checks=checks,
               seconds=time.perf_counter() - t_phase)
    emit(rec)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"masked_edit failed {bad}")
    return rec, files


# ---------------------------------------------------------------------------
# phase 5c: the port held against the JAX package's golden at SD-1.5 widths
# ---------------------------------------------------------------------------

GOLDEN_PATH = os.path.join(HERE, "tests", "golden", "torch_sd15.npz")
# (c) the kernels in bf16 against (b) the plain versions in bf16: each
# case's relative RMS to the golden at most this times (b)'s, on the
# outputs bf16 reaches (random SD-1.5 weights amplify bf16 rounding to
# 0.01-0.06 relative RMS end to end, PERF.md)
GOLDEN_RATIO = 2.0
GOLDEN_BF16_OUTPUTS = dict(text=("hidden",), vae_encode=("latents",),
                           invert_step=("z",), edit_step=("z",),
                           vae_decode=("images",), run=("z_T", "edited"))
# the splat path runs in float32 on every route: there the kernels (c) are
# held to the CPU's tolerance too
GOLDEN_FP32_CASES = ("render", "reopt_step")
GOLDEN_RUN_FP32_OUTPUTS = ("refs", "unedited", "depths")


def plain_routes() -> list:
    """Patch entries that send every kernel wrapper to its plain version,
    where the callers look the wrappers up."""
    import importlib
    from gaussctrl_tpu_torch.diffusion import processors
    from gaussctrl_tpu_torch.ops import flash_attention as fa
    from gaussctrl_tpu_torch.ops import splat_blend as sb
    rast = importlib.import_module("gaussctrl_tpu_torch.splat.rasterize")
    return [(fa, "flash_attention_t", fa.attention_plain),
            (processors, "cross_view_attention", fa.cross_view_attention_plain),
            (fa, "attention_full", fa.attention_plain),
            (fa, "attention_stream", fa.attention_stream_plain),
            (rast, "blend", sb.blend_plain),
            (rast, "blend_bwd", sb.blend_bwd_plain)]


def golden_expected(case: str, layers: dict, run_views: int = 0,
                    ddim_steps: int = 1) -> dict:
    """The exact kernel launches of one golden case on the kernel route."""
    from types import SimpleNamespace
    from gaussctrl_tpu_torch import golden as g
    from gaussctrl_tpu_torch.ops import launch_counts
    from gaussctrl_tpu_torch.pipeline.gaussctrl import (GaussCtrlConfig,
                                                        select_ref_views)
    if case == "run":
        cfg = GaussCtrlConfig(**g.run_config("", "", ddim_steps))
        pipe = SimpleNamespace(config=cfg, ref_indices=select_ref_views(
            run_views, cfg.ref_view_num, cfg.seed))
        return expected_launches(pipe, layers, run_views, ddim_steps,
                                 cfg.render_rate)[0]
    expected = dict.fromkeys(launch_counts, 0)
    if case in ("vae_encode", "vae_decode"):
        expected[std_kernel(VAE_WIDTH, VAE_TOKENS)] = 1
    elif case == "render":
        expected["splat_blend_fwd"] = g.RENDER_VIEWS
    elif case == "reopt_step":
        expected["splat_blend_fwd"] = expected["splat_blend_bwd"] = 1
    elif case in ("invert_step", "edit_step"):
        for t, c in LEVELS:
            n_unet, n_cn = LAYERS_PER_LEVEL[t]
            expected[std_kernel(c // HEADS, TEXT_TOKENS)] += n_unet + n_cn
            if case == "invert_step":       # K2 at every self-attention
                expected["flash_attention_t"] += n_unet + n_cn
            elif str(t) in fused_levels():   # K3
                expected["cross_view_attention"] += n_unet + n_cn
            else:    # composed: the UNet's self branch, one call a reference
                expected["flash_attention_t"] += n_unet
                expected[std_kernel(c // HEADS, t)] += \
                    g.EDIT_REFS * (n_unet + n_cn)
    return expected


def golden_held_ok(expected: dict, in_situ: dict) -> bool:
    """Every kernel the case launches was held in situ within its
    tolerance (`attention_holds`, `splat_holds`)."""
    for name, n in expected.items():
        if not n:
            continue
        w = in_situ[name]
        if not w.get("calls"):
            return False
        if name == "splat_blend_fwd":
            ok = w["max_abs_err"] <= K1_TOL
        elif name == "splat_blend_bwd":
            ok = all(v <= K4_SCALED_TOL for k, v in w.items()
                     if k not in ("calls", "max_abs_err"))
        else:
            ok = attn_ok(w)
        if not ok:
            return False
    return True


def _golden_route(case: str, route: str, golden: dict, **kw) -> dict:
    """One case on one route: "plain" (every wrapper sent to its plain
    version; no launch allowed) or "kernels" (the wrappers as they are,
    each kernel's first calls held in situ): errors to the golden, launch
    counts and seconds."""
    import torch
    from gaussctrl_tpu_torch import golden as g
    from gaussctrl_tpu_torch.ops import launch_counts, reset_launch_counts
    in_situ = None
    if route == "plain":
        entries = plain_routes()
    else:
        attn, in_situ = attention_holds(CERTIFY_HELD_PER_SHAPE)
        splat, splat_situ = splat_holds(MESH_SPLAT_HELD)
        entries = attn + splat
        in_situ.update(splat_situ)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with _patched(entries):
        out = g.port_case(case, g.case_inputs(case), DEVICE, **kw)
    torch.cuda.synchronize()
    rec = dict(seconds=time.perf_counter() - t0, launches=dict(launch_counts),
               errors=g.compare(out, golden, case))
    if case == "reopt_step":
        rec["flips_on_signal"] = g.flips_on_signal(out, golden)
    if in_situ is not None:
        rec["in_situ"] = in_situ
    return rec


def check_golden(card: str):
    """The port on the card against the JAX package's golden
    (tests/golden/torch_sd15.npz, made on the CPU in float32 by
    scripts/torch_golden.py): the seeded SD-1.5 weight files are rewritten
    from their seed and refused unless every sha256 is the golden's; then
    every case runs three ways: (a) the plain versions in float32 (TF32
    off), which must meet the CPU's tolerance (`golden.tolerances()`), so
    that the card's cuDNN and cuBLAS paths compute the reference's
    function; (b) the plain versions in the pipeline's bf16; (c) the main
    path as it runs, K1-K6 in bf16, whose relative RMS to the golden must be
    at most GOLDEN_RATIO times (b)'s on the outputs bf16 reaches, with exact
    launch counts and the first calls of each kernel held in situ against
    its plain version. The splat path is float32 on every route, so
    `render` and `reopt_step` have no (b) and their (c) meets the CPU's
    tolerance (and `reopt_step` steps no entry another way where the
    gradient is signal); `run`'s renders do too, and on the bf16 routes its
    re-optimised rows stay within what its Adam steps can move."""
    import numpy as np
    import torch
    from gaussctrl_tpu_torch import golden as g
    from gaussctrl_tpu_torch.diffusion import weights as tw
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    from gaussctrl_tpu_torch.diffusion.sample import SDModels
    t0 = time.perf_counter()
    with np.load(GOLDEN_PATH) as f:
        golden = {k: f[k] for k in f.files}
    ddim_steps = int(golden["meta.run_ddim_steps"])
    root = tempfile.mkdtemp(prefix="gaussctrl_golden_")
    cases, failures = {}, []
    try:
        t1 = time.perf_counter()
        hashes = tw.write_seeded_sd(root, g.WEIGHTS_SEED)
        write_s = time.perf_counter() - t1
        want = dict(zip(golden["meta.weight_files"].tolist(),
                        golden["meta.weight_sha256"].tolist()))
        scene = g.scene_arrays()
        scene_ok = golden["meta.scene_sha256"].tolist() == [
            g.sha256(scene[f]) for f in g.FIELDS]
        del scene
        emit(dict(phase="golden_weights", seconds=write_s,
                  hashes_equal=hashes == want, scene_hashes_equal=scene_ok,
                  hashes=hashes))
        if hashes != want or not scene_ok:
            raise AssertionError(f"the seeded inputs differ from the golden's: "
                                 f"{hashes} != {want} or scene {scene_ok}")
        dirs = (os.path.join(root, tw.SEEDED_SD_DIR),
                os.path.join(root, tw.SEEDED_CN_DIR))
        models = SDModels.create(SDConfig.sd15(), device=DEVICE)
        tw.load_sd_models(models, *dirs)
        layers = attention_layer_counts(models)
        kw = dict(background=golden["reopt_step.background"],
                  backgrounds=golden["run.backgrounds"], ddim_steps=ddim_steps,
                  sd_dirs=dirs)
        for case in g.CASES:
            cases[case] = dict(expected=golden_expected(
                case, layers, g.RUN_VIEWS, ddim_steps))
        for case in g.DIFFUSION_CASES:
            cases[case]["fp32_plain"] = _golden_route(case, "plain", golden,
                                                      models=models, **kw)
        for m in models.modules():
            m.to(torch.bfloat16)
        for case in g.DIFFUSION_CASES:
            cases[case]["bf16_plain"] = _golden_route(case, "plain", golden,
                                                      models=models, **kw)
            cases[case]["bf16_kernels"] = _golden_route(case, "kernels", golden,
                                                        models=models, **kw)
        del models
        torch.cuda.empty_cache()
        for case in GOLDEN_FP32_CASES:
            cases[case]["fp32_plain"] = _golden_route(case, "plain", golden, **kw)
            cases[case]["fp32_kernels"] = _golden_route(case, "kernels", golden,
                                                        **kw)
        cases["run"]["fp32_plain"] = _golden_route("run", "plain", golden, **kw)
        torch.cuda.empty_cache()
        for route in ("plain", "kernels"):
            cases["run"][f"bf16_{route}"] = _golden_route(
                "run", route, golden, dtype=torch.bfloat16, **kw)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    for case, rec in cases.items():
        kern = rec.get("bf16_kernels") or rec["fp32_kernels"]
        checks = dict(
            fp32_plain_within_cpu_tolerance=not g.over_tolerance(
                case, rec["fp32_plain"]["errors"]),
            plain_launched_nothing=all(
                not any(r["launches"].values()) for key, r in rec.items()
                if key.endswith("_plain")),
            exact_launches=kern["launches"] == rec["expected"],
            held_in_situ=golden_held_ok(rec["expected"], kern["in_situ"]))
        if case in GOLDEN_FP32_CASES:
            checks["kernels_within_cpu_tolerance"] = not g.over_tolerance(
                case, kern["errors"])
        else:
            plain = rec["bf16_plain"]["errors"]
            checks["kernels_within_ratio_of_bf16_plain"] = all(
                kern["errors"][n]["rel_rms"]
                <= GOLDEN_RATIO * plain[n]["rel_rms"]
                for n in GOLDEN_BF16_OUTPUTS[case])
            rec["ratio"] = {n: kern["errors"][n]["rel_rms"]
                            / max(plain[n]["rel_rms"], 1e-30)
                            for n in GOLDEN_BF16_OUTPUTS[case]}
        if case == "run":
            errs = {n: kern["errors"][n] for n in GOLDEN_RUN_FP32_OUTPUTS}
            checks["kernel_renders_within_cpu_tolerance"] = not g.over_tolerance(
                case, errs)
            checks["reoptimised_within_adam_bound"] = not any(
                g.over_tolerance(case, {n: e for n, e in r["errors"].items()
                                        if n.startswith("after_")})
                for key, r in rec.items() if key.startswith("bf16_"))
        if case == "reopt_step":
            checks["no_flips_on_signal"] = all(
                not any(r["flips_on_signal"].values())
                for key, r in rec.items() if key.startswith("fp32_"))
        rec["checks"] = checks
        emit(dict(phase="golden_case", case=case, card=card, **rec))
        failures += [(case, k) for k, ok in checks.items() if not ok]
    rec = dict(phase="golden", card=card, seconds=time.perf_counter() - t0,
               weights_write_s=write_s, run_ddim_steps=ddim_steps,
               jax_package_tree=str(golden["meta.jax_package_tree"]),
               summary={case: {route: {n: e["rel_rms"] for n, e in
                                       r["errors"].items()}
                               for route, r in c.items()
                               if isinstance(r, dict) and "errors" in r}
                        for case, c in cases.items()},
               failures=failures)
    emit(rec)
    if failures:
        raise AssertionError(f"the port disagrees with the golden: {failures}")
    return dict(rec, cases=cases)


# ---------------------------------------------------------------------------
# phase 6a: SD-1.5 weights through a diffusers layout on disk
# ---------------------------------------------------------------------------

# the VAE mid-block's attention under the names of older diffusers files
LEGACY_VAE_ATTN = {"to_q": "query", "to_k": "key", "to_v": "value",
                   "to_out.0": "proj_attn"}
# a small CLIP-style BPE vocabulary for tokenizer/ (ids far below 49,406)
MINI_VOCAB = ["a", "b", "e", "h", "o", "p", "r", "s", "t", "</w>", "a</w>",
              "o</w>", "r</w>", "t</w>", "ph", "ot", "phot", "photo</w>",
              "be", "ar</w>", "bear</w>"]
MINI_MERGES = ["p h", "o t", "ph ot", "phot o</w>", "b e", "a r</w>",
               "be ar</w>"]


def write_diffusers_dirs(root: str):
    """The seeded random SD-1.5 weights (`init_params(WEIGHTS_SEED)`) in a
    diffusers layout under `root`: unet/, vae/ and controlnet/ as fp16
    `diffusion_pytorch_model.safetensors` from the port's writer, the VAE
    mid-block under the legacy query/key/value/proj_attn names with nonzero
    q/k/v biases (seeded; the networks' own are zero), text_encoder/ as an
    fp16 `pytorch_model.bin` with a `position_ids` buffer (the loader asks
    for `model.*` and falls back), and tokenizer/{vocab.json,merges.txt}.
    Beside the pipeline, text_encoder_st/ holds the same text encoder as
    transformers saves it today: `model.safetensors` with the I64
    `position_ids` buffer. Returns ((sd_dir, cn_dir), {relative file: the
    dict written}, seconds to write)."""
    import torch
    from gaussctrl_tpu_torch.diffusion import weights as w
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    from gaussctrl_tpu_torch.diffusion.sample import SDModels
    models = SDModels.create(SDConfig.sd15(), device=DEVICE)
    models.init_params(WEIGHTS_SEED)
    sds = {name: {k: v.to("cpu", torch.float16)
                  for k, v in mod.state_dict().items()}
           for name, mod in zip(("unet", "controlnet", "vae", "text"),
                                models.modules())}
    del models
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(5)
    vae = {}
    for k, v in sds["vae"].items():
        head, leaf = k.rsplit(".", 1)
        if ".mid_block.attentions.0." in k:
            if leaf == "bias" and head.endswith(("to_q", "to_k", "to_v")):
                v = (0.05 * torch.randn(v.shape, generator=gen)).half()
            for new, old in LEGACY_VAE_ATTN.items():
                if head.endswith("." + new):
                    head = head[: -len(new)] + old
        vae[f"{head}.{leaf}"] = v
    text = dict(sds["text"])
    n_pos = text["text_model.embeddings.position_embedding.weight"].shape[0]
    text["text_model.embeddings.position_ids"] = torch.arange(n_pos)[None]
    sd_dir, cn_dir = os.path.join(root, "sd15"), os.path.join(root, "controlnet")
    files = {"sd15/unet/diffusion_pytorch_model.safetensors": sds["unet"],
             "sd15/vae/diffusion_pytorch_model.safetensors": vae,
             "controlnet/diffusion_pytorch_model.safetensors": sds["controlnet"],
             "sd15/text_encoder/pytorch_model.bin": text,
             "text_encoder_st/model.safetensors": text}
    t0 = time.perf_counter()
    for rel, sd in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if rel.endswith(".bin"):
            torch.save(sd, path)
        else:
            w.save_safetensors(path, sd)
    tok = os.path.join(sd_dir, "tokenizer")
    os.makedirs(tok)
    vocab = {t: i for i, t in enumerate(MINI_VOCAB)}
    with open(os.path.join(tok, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(tok, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(MINI_MERGES) + "\n")
    return (sd_dir, cn_dir), files, time.perf_counter() - t0


def check_weights(root: str):
    """Write the diffusers layout, read every file back with the port's
    loader (`weights.load_state_dict`, its own safetensors reader) and hold
    every tensor bit for bit against what was written, floats widened to
    float32 and the I64 `position_ids` as stored; then load the
    safetensors text encoder strictly into an SD-1.5 text model (its
    `position_ids` dropped) and hold every weight against the file."""
    import torch
    from gaussctrl_tpu_torch.diffusion import weights as w
    from gaussctrl_tpu_torch.diffusion.clip import CLIPTextModel
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    t0 = time.perf_counter()
    dirs, files, write_s = write_diffusers_dirs(root)
    nbytes = sum(os.path.getsize(os.path.join(root, rel)) for rel in files)
    t1 = time.perf_counter()
    mismatched, checked = [], 0
    for rel, sd in files.items():
        d = os.path.dirname(os.path.join(root, rel))
        stem = "model" if "text_encoder" in rel else "diffusion_pytorch_model"
        got = w.load_state_dict(d, stem)
        if got.keys() != sd.keys():
            mismatched.append((rel, "keys"))
        for k, v in sd.items():
            checked += 1
            want = v.to(torch.float32) if v.is_floating_point() else v
            if got[k].dtype != want.dtype or not torch.equal(got[k], want):
                mismatched.append((rel, k))
    read_s = time.perf_counter() - t1
    text_file = files["text_encoder_st/model.safetensors"]
    with torch.device(DEVICE):
        text_model = CLIPTextModel(SDConfig.sd15().text)
    w.load_module(text_model, "text", w.load_state_dict(
        os.path.join(root, "text_encoder_st"), "model"))
    text_params = text_model.state_dict()
    if text_params.keys() != set(text_file) - {
            "text_model.embeddings.position_ids"}:
        mismatched.append(("text_encoder_st -> CLIPTextModel", "keys"))
    for k, v in text_params.items():
        if not torch.equal(v.cpu(), text_file[k].to(torch.float32)):
            mismatched.append(("text_encoder_st -> CLIPTextModel", k))
    del text_model, text_params
    rec = dict(phase="weights", bytes=nbytes, files=len(files),
               tensors=checked, write_s=write_s, read_s=read_s,
               write_gb_per_s=nbytes / write_s / 1e9,
               read_gb_per_s=nbytes / read_s / 1e9, mismatched=mismatched[:8],
               seconds=time.perf_counter() - t0)
    emit(rec)
    if mismatched:
        raise AssertionError(f"weights read back differ from those written: "
                             f"{mismatched[:8]}")
    return rec, dirs, files


# ---------------------------------------------------------------------------
# phase 8: from-scratch pre-training with densification at full width
# ---------------------------------------------------------------------------

# 16 orbit views at 512x512 of the smoke scene; 100,000 of its means,
# jittered, as grey seeds in 151,552 slots; 401 steps crossing 128, 256 and
# 512 px, refines at 100, 150 and 300 (the pause after the opacity reset
# at 200 skips 200 and 250), cull-only passes at 350 and 400. The
# statistic's threshold sits near its 80th percentile at the first refine
# (splatfacto's 2e-4 is past the 99.7th on these random views), so the
# refines split tens of thousands of gaussians, fill the buffer past 80%
# by step 150 and double it, and the step-300 refine places its children
# in the grown buffer; the opacity cull is below the seeds' 0.1 (at
# splatfacto's 0.1 the first refine culls half of them).
PRETRAIN_VIEWS, PRETRAIN_SEEDS, PRETRAIN_STEPS = 16, 100_000, 401
PRETRAIN_GRAD_THRESH, PRETRAIN_CULL_OPACITY = 5e-6, 0.02
# the split/duplicate candidates from K4's statistic and from the plain
# backward's must agree for every gaussian whose (plain) statistic lies
# outside ±DECISION_BAND × grad_thresh. K4's rows sit within ~6e-5 of the
# largest row of their group; a gaussian near the threshold has a small
# gradient summed from rows that cancel, so its relative error is larger,
# and the band allows 1%.
DECISION_BAND = 1e-2


def pretrain_config():
    from gaussctrl_tpu_torch.splat.densify import DensifyConfig
    from gaussctrl_tpu_torch.splat.pretrain import PretrainConfig
    return PretrainConfig(
        num_steps=PRETRAIN_STEPS, eval_every=200, sh_degree_interval=100,
        num_downscales=2, resolution_schedule=100,
        densify=DensifyConfig(warmup=50, refine_every=50, stop_at=350,
                              reset_alpha_every=200,
                              grad_thresh=PRETRAIN_GRAD_THRESH,
                              cull_opacity=PRETRAIN_CULL_OPACITY))


def window_refines(d, n_views: int) -> list:
    """The steps of `pretrain`'s refines inside the densify window (those
    that split and duplicate): every refine_every steps in (warmup,
    stop_at), paused for n_views + refine_every steps after each opacity
    reset."""
    return [s for s in range(d.refine_every, d.stop_at, d.refine_every)
            if s > d.warmup and (s % d.reset_alpha_every if d.reset_alpha_every
                                 else s) > n_views + d.refine_every]


def densify_agreement(avg_k, avg_p, alive, thresh: float, band: float) -> dict:
    """The refine's split/duplicate candidates (alive, statistic above
    `thresh`) from the kernel's statistic `avg_k` against those from the
    plain one `avg_p`: how many differ outside and inside the band
    ±band·thresh around the threshold, how many lie inside it, and the
    statistic's relative error near the threshold (plain in [thresh/2,
    2·thresh])."""
    hk = (avg_k > thresh) & alive
    hp = (avg_p > thresh) & alive
    inside = alive & ((avg_p - thresh).abs() <= band * thresh)
    differ = hk != hp
    near = alive & (avg_p >= 0.5 * thresh) & (avg_p <= 2 * thresh)
    rel = ((avg_k - avg_p).abs() / avg_p.clamp_min(1e-30))[near]
    return dict(alive=int(alive.sum()), candidates=int(hk.sum()),
                candidates_plain=int(hp.sum()), inside_band=int(inside.sum()),
                disagree_outside=int((differ & ~inside).sum()),
                disagree_inside=int((differ & inside).sum()),
                near_threshold=int(near.sum()),
                max_rel_err_near=float(rel.max()) if rel.numel() else 0.0)


def check_pretrain():
    """`splat.pretrain.pretrain` at full width: ground truth rendered from
    the smoke scene (200,000 gaussians, SH 3) at PRETRAIN_VIEWS orbit views,
    seeds from PRETRAIN_SEEDS of its means jittered by 0.01, in grey;
    every step through K1 and K4. At each resolution the first K1 and K4
    calls are held in situ against their plain versions on their own
    inputs (K1_TOL, K4_SCALED_TOL). Until the window's last refine every
    step's K4 rows are also replayed by the plain backward and summed per
    gaussian, so a shadow DensifyState accumulates the plain statistic; at
    each window refine the candidates of the two must agree outside
    ±DECISION_BAND of grad_thresh. The buffer must grow inside the window,
    and each growth must move Adam onto the new leaves with every group's
    step kept, its moments' old rows kept and its new rows zero. Then ms
    per step at each resolution, on the trained scene, by CUDA events
    (warmed, 10 steps, unsynchronised as the loop runs)."""
    import importlib
    import numpy as np
    import torch
    from gaussctrl_tpu_torch.ops import launch_counts, reset_launch_counts
    from gaussctrl_tpu_torch.ops import splat_blend as sb
    from gaussctrl_tpu_torch.splat.densify import init_state
    from gaussctrl_tpu_torch.splat.render import render_camera
    from gaussctrl_tpu_torch.splat.trainer import make_optimizer, trainable
    pre = importlib.import_module("gaussctrl_tpu_torch.splat.pretrain")
    rast = importlib.import_module("gaussctrl_tpu_torch.splat.rasterize")
    t0 = time.perf_counter()
    gt_scene = smoke_scene(GAUSSIANS, DEVICE)
    cams = orbit_cameras(PRETRAIN_VIEWS, SIZE, DEVICE)
    black = torch.zeros(3, device=DEVICE)
    with torch.no_grad():
        images = torch.stack([render_camera(gt_scene, cams, i, black)["rgb"]
                              for i in range(len(cams))]).cpu().numpy()
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    seeds = (gt_scene.means[:PRETRAIN_SEEDS] + 0.01 * torch.randn(
        (PRETRAIN_SEEDS, 3), generator=gen, device=DEVICE)).cpu().numpy()
    del gt_scene
    cfg = pretrain_config()
    d = cfg.densify
    shadow_until = max(window_refines(d, PRETRAIN_VIEWS))
    st = dict(step=0, shadow=None, plain_rows=None, plain_xy=None)
    held, decisions, log, losses, growths = {}, [], [], [], []
    orig = dict(step=pre.pretrain_step, acc=pre.accumulate, refine=pre.refine,
                adopt=pre.adopt_params, blend=rast.blend, bwd=rast.blend_bwd,
                reduce=rast.reduce_by_slot)

    def step_held(scene, opt, dstate, lr_step, *a, **kw):
        st["step"] = lr_step
        dstate, m, g = orig["step"](scene, opt, dstate, lr_step, *a, **kw)
        losses.append(m["loss"])
        return dstate, m, g

    def shadow_on():
        return st["step"] <= shadow_until

    def adopt_held(opt, scene):
        """Adam's state before and after it moves onto the grown leaves."""
        before = {g["name"]: {k: torch.as_tensor(v).clone() for k, v in
                              opt.state[g["params"][0]].items()}
                  for g in opt.param_groups}
        orig["adopt"](opt, scene)
        rec, ok = dict(step=st["step"], capacity=scene.num_gaussians), True
        for g in opt.param_groups:
            leaf, old = g["params"][0], before[g["name"]]
            new = opt.state.get(leaf, {})
            n = old["exp_avg"].shape[0]
            ok &= (leaf is getattr(scene, g["name"])
                   and leaf.shape[0] == scene.num_gaussians
                   and float(new["step"]) == float(old["step"])
                   and all(torch.equal(new[k][:n], old[k])
                           and not new[k][n:].any()
                           for k in ("exp_avg", "exp_avg_sq")))
        rec.update(adam_kept=bool(ok), steps=sorted(
            {float(opt.state[g["params"][0]]["step"])
             for g in opt.param_groups}))
        growths.append(rec)

    def blend_held(*a, **kw):
        out = orig["blend"](*a, **kw)
        key = f"k1@{a[8] * 16}x{a[9] * 16}"
        if key not in held:
            ref_tiles, ref_alpha = sb.blend_plain(*a[:10])
            held[key] = max((out[0] - ref_tiles).abs().max().item(),
                            (out[1] - ref_alpha).abs().max().item())
        return out

    def bwd_held(*a):
        rows, g_bg = orig["bwd"](*a)
        key = f"k4@{a[-2] * 16}x{a[-1] * 16}"
        if key not in held or shadow_on():
            ref_rows, ref_bg = sb.blend_bwd_plain(*a)
            if key not in held:
                used = int(a[2][-1].item())
                held[key] = k4_errors(rows[:used], g_bg, ref_rows[:used],
                                      ref_bg)
            if shadow_on():
                st["plain_rows"] = ref_rows
        return rows, g_bg

    def reduce_held(rows, *rest):
        out = orig["reduce"](rows, *rest)
        if st["plain_rows"] is not None:
            st["plain_xy"] = orig["reduce"](st["plain_rows"], *rest)[:, 0:2]
            st["plain_rows"] = None
        return out

    def acc_held(dstate, g, visible, width, height, radii=None):
        out = orig["acc"](dstate, g, visible, width, height, radii=radii)
        if shadow_on():
            if st["shadow"] is None:
                st["shadow"] = dstate
            st["shadow"] = orig["acc"](st["shadow"], st["plain_xy"], visible,
                                       width, height, radii=radii)
        return out

    def refine_held(scene, dstate, generator, dcfg, **kw):
        if st["shadow"] is not None and not kw.get("cull_only"):
            rec = densify_agreement(dstate.avg_grad(), st["shadow"].avg_grad(),
                                    dstate.alive, dcfg.grad_thresh,
                                    DECISION_BAND)
            decisions.append(dict(step=st["step"], **rec))
        st["shadow"] = None
        return orig["refine"](scene, dstate, generator, dcfg, **kw)

    patches = [(pre, "pretrain_step", step_held), (pre, "accumulate", acc_held),
               (pre, "refine", refine_held), (pre, "adopt_params", adopt_held),
               (rast, "blend", blend_held),
               (rast, "blend_bwd", bwd_held),
               (rast, "reduce_by_slot", reduce_held)]
    torch.cuda.synchronize()
    reset_launch_counts()
    t1 = time.perf_counter()
    with _patched(patches):
        scene, metrics = pre.pretrain(
            cams, images, seeds, np.full_like(seeds, 0.5), cfg, sh_degree=3,
            seed=0, log_fn=lambda s, m: log.append((s, m)), device=DEVICE)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t1
    counts = dict(launch_counts)
    n_evals = len(range(0, PRETRAIN_STEPS, cfg.eval_every)) + 1
    expected = dict.fromkeys(counts, 0)
    expected["splat_blend_fwd"] = PRETRAIN_STEPS + 4 * n_evals
    expected["splat_blend_bwd"] = PRETRAIN_STEPS

    # the buffer's start as pretrain sizes it, then every growth
    capacity = min(int(cfg.capacity_mult * PRETRAIN_SEEDS),
                   -(-int(1.5 * PRETRAIN_SEEDS) // 4096) * 4096)
    capacity_start, refines, quantiles = capacity, [], []
    for s, m in log:
        if "capacity" in m:
            capacity = m["capacity"]
            refines[-1]["capacity"] = capacity
        if "n_born" in m:
            refines.append(dict(step=s, capacity=capacity, **m))
        if "grad_p50" in m:
            quantiles.append(dict(step=s, **m))
    evals = [dict(step=s, **m) for s, m in log if "eval_psnr" in m]
    isect = max(m["isect_frac"] for _, m in log if "isect_frac" in m)
    loss_t = torch.stack(losses).float().cpu()

    # ms per step at each resolution, on the trained scene
    tscene = trainable(init_state(scene, scene.num_gaussians)[0])
    opt = make_optimizer(tscene, cfg.train)
    dst = init_state(scene, scene.num_gaussians)[1]
    pyramid = pre._pyramid(images, cfg, DEVICE)
    step_ms = {}
    for f in (4, 2, 1):
        def one(f=f):
            pre.pretrain_step(tscene, opt, dst, 0, cams.c2w[0],
                              cams.fx[0] / f, cams.fy[0] / f, cams.cx[0] / f,
                              cams.cy[0] / f, pyramid[f][0], black, SIZE // f,
                              SIZE // f, 3)
        step_ms[f"{SIZE // f}px"] = cuda_ms(one, 10)
    del tscene, opt, pyramid

    k4_worst = {}
    for k, errs in held.items():
        if k.startswith("k4"):
            for g, v in errs.items():
                if g != "max_abs_err":
                    k4_worst[g] = max(k4_worst.get(g, 0.0), v)
    rec = dict(phase="pretrain", views=PRETRAIN_VIEWS, seeds=PRETRAIN_SEEDS,
               steps=PRETRAIN_STEPS, size=SIZE,
               gaussians_end=scene.num_gaussians,
               capacity_start=capacity_start, capacity_end=capacity,
               refines=refines, grad_quantiles=quantiles, evals=evals,
               eval_psnr_start=evals[0]["eval_psnr"],
               eval_psnr_end=evals[-1]["eval_psnr"],
               isect_frac_max=isect, loss_first=float(loss_t[0]),
               loss_last=float(loss_t[-1]),
               losses_finite=bool(torch.isfinite(loss_t).all()),
               n_born=sum(r["n_born"] for r in refines),
               in_situ=held, in_situ_tol=dict(k1=K1_TOL, k4=K4_SCALED_TOL),
               growths=growths, decisions=decisions,
               decision_band=DECISION_BAND,
               grad_thresh=d.grad_thresh, launches=counts,
               expected_launches=expected, loop_s=loop_s,
               step_ms=step_ms, seconds=time.perf_counter() - t0)
    emit(rec)
    sizes = [f"{SIZE // f}x{SIZE // f}" for f in (4, 2, 1)]
    bad = [k for k in (f"k{i}@{s}" for i in (1, 4) for s in sizes)
           if k not in held]
    bad += [k for k, v in held.items() if k.startswith("k1") and not v <= K1_TOL]
    bad += [k for k, v in k4_worst.items() if not v <= K4_SCALED_TOL]
    bad += [f"decisions@{r['step']}" for r in decisions if r["disagree_outside"]]
    if [r["step"] for r in decisions] != window_refines(d, PRETRAIN_VIEWS):
        bad.append(f"refines held at {[r['step'] for r in decisions]}, "
                   f"expected {window_refines(d, PRETRAIN_VIEWS)}")
    if not any(g["step"] < shadow_until for g in growths):
        bad.append("the buffer did not grow before the window's last refine")
    bad += [f"adam@{g['step']}" for g in growths if not g["adam_kept"]]
    if capacity != capacity_start * 2 ** len(growths):
        bad.append(f"capacity {capacity} after {len(growths)} growths")
    if not rec["losses_finite"] or not math.isfinite(rec["eval_psnr_end"]):
        bad.append("non-finite loss")
    if rec["n_born"] == 0:
        bad.append("no births")
    if not rec["eval_psnr_end"] > rec["eval_psnr_start"]:
        bad.append("eval PSNR did not rise")
    if counts != expected:
        bad.append(f"launches {counts} != {expected}")
    if bad:
        raise AssertionError(f"pre-training failed its checks: {bad}")
    return rec


# ---------------------------------------------------------------------------
# phase 9: the pre-training CLI on the example scene
# ---------------------------------------------------------------------------

# 300 steps at 50, 100 and 200 px (both ends with partial tiles), one
# refine at step 200 (the window is 50-250 and the pause 12 + 100 steps)
SPLAT_TRAIN_FLAGS = ["--trainer.num_steps", "300",
                     "--trainer.num_downscales", "2",
                     "--trainer.resolution_schedule", "100",
                     "--trainer.eval_every", "100",
                     "--trainer.densify.warmup", "50",
                     "--trainer.densify.refine_every", "100",
                     "--trainer.densify.stop_at", "250",
                     "--trainer.densify.reset_alpha_every", "1000"]


def check_splat_train(out_root: str):
    """`python -m gaussctrl_tpu_torch.cli.splat_train --data
    data/example_scene` in a subprocess on the card: it exits 0 and writes
    the final checkpoint (loaded back by `core.ckpt.load_scene_npz`, finite),
    dataparser_transforms.json, events.jsonl with one refine, and four
    renders."""
    import torch
    from gaussctrl_tpu_torch.core.ckpt import load_scene_npz
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "gaussctrl_tpu_torch.cli.splat_train",
           "--data", os.path.join(HERE, "data", "example_scene"),
           "--output-dir", out_root, *SPLAT_TRAIN_FLAGS]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"splat_train exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    (run,) = os.listdir(os.path.join(out_root, "example_scene", "splat"))
    run = os.path.join(out_root, "example_scene", "splat", run)
    ckpt = os.path.join(run, "ckpts", "step-000000300.npz")
    renders = sorted(os.listdir(os.path.join(run, "final_renders")))
    with open(os.path.join(run, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    scene = load_scene_npz(ckpt)
    finite = all(bool(torch.isfinite(getattr(scene, k)).all())
                 for k in TRAIN_FIELDS)
    refines = [e for e in events if "n_born" in e]
    evals = [e for e in events if "eval_psnr" in e]
    rec = dict(phase="splat_train", seconds=time.perf_counter() - t0,
               ckpt=ckpt,
               gaussians=scene.num_gaussians, finite=finite, renders=renders,
               refines=refines, eval_psnr=[e["eval_psnr"] for e in evals],
               transforms=os.path.exists(
                   os.path.join(run, "dataparser_transforms.json")),
               stdout_tail=proc.stdout.strip().splitlines()[-3:])
    emit(rec)
    if not (finite and len(renders) == 4 and len(refines) == 1
            and rec["transforms"] and scene.num_gaussians > 0):
        raise AssertionError(f"splat_train's outputs fail their checks: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phase 10: the render entry point (cli.render) through K1
# ---------------------------------------------------------------------------

# perspective camera-path frames at SIZE, the equirectangular frame's size,
# the CLI's default strips a panorama, spiral frames, timing reps
RENDER_FRAMES, PANO_W, PANO_H, PANO_STRIPS = 8, 1024, 512, 32
SPIRAL_FRAMES, RENDER_REPS = 8, 10
# the strip of the equirectangular frame held against the CPU's plain blend
PANO_HELD_STRIP = 16


def camera_path_file(path: str, cams, camera_type: str, w: int, h: int):
    """A nerfstudio camera-path JSON of `cams`' poses (their vertical field
    of view), at `w`×`h` and of `camera_type`."""
    import numpy as np
    c2w = cams.c2w.cpu().numpy()
    fov = math.degrees(2 * math.atan(cams.height / (2 * float(cams.fy[0]))))
    frames = [{"camera_to_world": np.concatenate(
        [m, [[0.0, 0.0, 0.0, 1.0]]]).reshape(-1).tolist(), "fov": fov}
        for m in c2w]
    with open(path, "w") as f:
        json.dump({"render_height": h, "render_width": w, "fps": 24,
                   "camera_type": camera_type, "camera_path": frames}, f)
    return path


def run_cli(main_fn, argv) -> tuple:
    """(seconds, K1 launches) of one in-process CLI call on the card."""
    import torch
    from gaussctrl_tpu_torch.ops import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    main_fn(argv)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(launch_counts)


def k1_trace_events(trace_dir: str) -> int:
    """K1 kernels named in the newest Chrome trace of `trace_dir`."""
    newest = max((os.path.join(trace_dir, f) for f in os.listdir(trace_dir)),
                 key=os.path.getmtime)
    with open(newest) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel"
               and "splat_blend_fwd_kernel" in e.get("name", ""))


def check_render(card: str, run_ckpt: str, smoke_npz: str, root: str,
                 out_dir: str):
    """`python -m gaussctrl_tpu_torch.cli.render` on the card, in process:
    `dataset` on data/example_scene from the checkpoint phase `splat_train`
    wrote (rgb, depth, accumulation, --save-depth-npy; the reference's own
    use) and, on the 200,000-gaussian smoke scene saved as .npz,
    `camera-path` (RENDER_FRAMES perspective views at SIZE², then one
    frame each of equirectangular PANO_W×PANO_H, ODS and VR180), `spiral`
    and `interpolate` over the example scene's cameras. K1's launches are
    held exactly (one a view; a panorama one a strip: PANO_STRIPS, ODS
    2·PANO_STRIPS, VR180 2·max(PANO_STRIPS // 2, 4)); each shape K1 gets
    here is held against the plain blend on the CPU: view 0 of the
    perspective path, one 45×1532 strip of the equirectangular frame (the
    VR180 strips have that shape too), one 45×768 strip of an ODS eye and
    one 200×200 dataset view of the example scene; ms a 512² view and a
    panorama frame are timed; and one render is traced with `cuda_trace`,
    whose trace must name K1 as often as the counter."""
    import numpy as np
    import torch
    from PIL import Image
    from gaussctrl_tpu_torch.cameras import stereo
    from gaussctrl_tpu_torch.cameras.camera import make_cameras
    from gaussctrl_tpu_torch.cli import render as cli
    from gaussctrl_tpu_torch.core.ckpt import load_scene_npz
    from gaussctrl_tpu_torch.core.writer import cuda_trace
    from gaussctrl_tpu_torch.ops import launch_counts, reset_launch_counts
    from gaussctrl_tpu_torch.splat.render import render_rgbd
    t_phase = time.perf_counter()
    example = os.path.join(HERE, "data", "example_scene")
    checks, calls = {}, {}

    def expect(name, secs_counts, k1, frames):
        secs, counts = secs_counts
        want = dict.fromkeys(counts, 0)
        want["splat_blend_fwd"] = k1
        calls[name] = dict(seconds=secs, frames=frames, launches=counts,
                           expected_launches=want)
        checks[f"{name}_launches"] = counts == want

    # 1. the dataset views of the pre-trained example scene
    out = os.path.join(root, "dataset")
    expect("dataset", run_cli(cli.main, [
        "dataset", "--load-checkpoint", run_ckpt, "--data", example,
        "--output-path", out, "--rendered-output-names", "rgb", "depth",
        "accumulation", "--save-depth-npy"]), 12, 12)
    depths = [np.load(os.path.join(out, "depth_npy", f))
              for f in sorted(os.listdir(os.path.join(out, "depth_npy")))]
    checks["dataset_files"] = all(
        len(os.listdir(os.path.join(out, o))) == 12
        for o in ("rgb", "depth", "accumulation")) and len(depths) == 12
    checks["dataset_depth_npy"] = all(d.shape == (200, 200, 1)
                                      and bool(np.isfinite(d).all())
                                      for d in depths)

    # 2. camera paths on the smoke scene
    cams = orbit_cameras(RENDER_FRAMES, SIZE, "cpu")
    persp = camera_path_file(os.path.join(root, "persp.json"), cams,
                             "perspective", SIZE, SIZE)
    out = os.path.join(root, "persp")
    expect("camera_path", run_cli(cli.main, [
        "camera-path", "--load-checkpoint", smoke_npz,
        "--camera-path-filename", persp, "--output-path", out,
        "--rendered-output-names", "rgb", "depth"]),
        RENDER_FRAMES, RENDER_FRAMES)
    frame0 = np.asarray(Image.open(os.path.join(out, "rgb", "00000.png")))
    checks["camera_path_frames"] = (
        len(os.listdir(os.path.join(out, "rgb"))) == RENDER_FRAMES
        and frame0.shape == (SIZE, SIZE, 3) and int(frame0.max()) > 0)
    panos = {"equirectangular": (PANO_STRIPS, (PANO_H, PANO_W, 3)),
             "omni-directional-stereo": (2 * PANO_STRIPS, (PANO_H, PANO_W, 3)),
             "vr180": (2 * max(PANO_STRIPS // 2, 4), (PANO_H, PANO_W, 3))}
    for kind, (k1, shape) in panos.items():
        path = camera_path_file(os.path.join(root, f"{kind}.json"), cams[:1],
                                kind, PANO_W, PANO_H)
        out = os.path.join(root, kind)
        expect(kind, run_cli(cli.main, [
            "camera-path", "--load-checkpoint", smoke_npz,
            "--camera-path-filename", path, "--output-path", out,
            "--pano-strips", str(PANO_STRIPS)]), k1, 1)
        img = np.asarray(Image.open(os.path.join(out, "rgb_00000.png")))
        checks[f"{kind}_frame"] = img.shape == shape and int(img.max()) > 0

    # 3. trajectories through the example scene's cameras; the spiral as an
    # mp4 where OpenCV is installed (the CLI's video writer), else images
    import importlib.util
    video = importlib.util.find_spec("cv2") is not None
    out = os.path.join(root, "spiral")
    expect("spiral", run_cli(cli.main, [
        "spiral", "--load-checkpoint", smoke_npz, "--data", example,
        "--frames", str(SPIRAL_FRAMES), "--radius", "0.2",
        "--output-format", "video" if video else "images",
        "--output-path", out]), SPIRAL_FRAMES, SPIRAL_FRAMES)
    if video:
        import cv2
        cap = cv2.VideoCapture(os.path.join(out, "rgb.mp4"))
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        checks["spiral_mp4_frames"] = n == SPIRAL_FRAMES
    else:
        checks["spiral_frames"] = len(os.listdir(
            os.path.join(out, "rgb"))) == SPIRAL_FRAMES
    expect("interpolate", run_cli(cli.main, [
        "interpolate", "--load-checkpoint", smoke_npz, "--data", example,
        "--interpolation-steps", "1",
        "--output-path", os.path.join(root, "interpolate")]), 11, 11)

    # 4. K1 against the CPU's plain blend at each shape the path gives it:
    # perspective view 0, the strip at PANO_HELD_STRIP of an equirectangular
    # (and VR180) frame, the same strip of an ODS eye (its panorama is
    # PANO_H // 2 high), and dataset view 0 of the pre-trained example scene
    scene = load_scene_npz(smoke_npz, device=DEVICE)
    cams = cams.to(DEVICE)
    theta = -math.pi + (PANO_HELD_STRIP + 0.5) * 2 * math.pi / PANO_STRIPS
    base_c2w = cams.c2w[0].cpu().double().numpy()

    def strip(eye, height):
        fx, fy, w, h = stereo.strip_size(PANO_W, height, strips=PANO_STRIPS)
        c2w = stereo._strip_camera(base_c2w, theta, eye, 0.063)
        return make_cameras(c2w[None], fx, fy, w / 2, h / 2, w, h, DEVICE)

    example_scene = cli._load_scene(run_ckpt, device=DEVICE)
    held_views = dict(view_512=(scene, cams),
                      pano_strip=(scene, strip(0.0, PANO_H)),
                      ods_strip=(scene, strip(-1.0, PANO_H // 2)),
                      dataset_view=(example_scene, cli._dataset_cameras(
                          example, device=DEVICE)))
    held = {name: dict(shape=[c.height, c.width], max_abs_err=k1_held(
                splat_inputs(s, c)[0], "cpu")[1])
            for name, (s, c) in held_views.items()}
    checks["k1_vs_cpu_plain"] = all(h["max_abs_err"] <= K1_TOL
                                    for h in held.values())

    # 5. ms a 512x512 view (render_rgbd, synchronised) and a panorama frame
    bg = torch.zeros(3, device=DEVICE)

    def view(i=0):
        with torch.no_grad():
            return render_rgbd(scene, cams.c2w[i], cams.fx[i], cams.fy[i],
                               cams.cx[i], cams.cy[i], SIZE, SIZE, bg)

    view()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(RENDER_REPS):
        view(i % RENDER_FRAMES)
    torch.cuda.synchronize()
    view_ms = (time.perf_counter() - t0) / RENDER_REPS * 1e3
    c2w0 = cams.c2w[0].cpu().numpy()
    pano_ms = {}
    for kind, fn in (("equirectangular", stereo.render_pano),
                     ("omni-directional-stereo", stereo.render_ods),
                     ("vr180", stereo.render_vr180)):
        kw = dict(strips=PANO_STRIPS) if kind != "vr180" else dict(
            strips=max(PANO_STRIPS // 2, 4))
        t0 = time.perf_counter()
        fn(scene, c2w0, PANO_W, PANO_H, (0.0, 0.0, 0.0), **kw)
        pano_ms[kind] = (time.perf_counter() - t0) * 1e3

    # 6. one trace of three views: K1 named as often as counted
    trace_dir = os.path.join(out_dir or root, "render_trace")
    reset_launch_counts()
    with cuda_trace(trace_dir):
        for i in range(3):
            view(i)
        torch.cuda.synchronize()
    traced = dict(counted=launch_counts["splat_blend_fwd"],
                  in_trace=k1_trace_events(trace_dir))
    checks["trace_names_k1"] = traced["counted"] == traced["in_trace"] == 3

    rec = dict(phase="render", card=card, gaussians=GAUSSIANS, size=SIZE,
               spiral_format="video" if video else "images",
               pano=[PANO_W, PANO_H], pano_strips=PANO_STRIPS,
               calls=calls, k1_vs_cpu_plain=held,
               k1_tol=K1_TOL, view_ms=view_ms, pano_frame_ms=pano_ms,
               trace=traced, checks=checks,
               seconds=time.perf_counter() - t_phase)
    emit(rec)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"render failed {bad}")
    return rec


# ---------------------------------------------------------------------------
# phase 11: the viewer server on the card
# ---------------------------------------------------------------------------

VIEWER_QUERIES = [
    {"az": 0.3, "el": 0.2, "r": 3.5, "center": [0, 0, 0], "mode": "rgb"},
    {"az": 0.3, "el": 0.2, "r": 3.5, "center": [0, 0, 0], "mode": "depth"},
    {"az": 1.1, "el": 0.4, "r": 3.0, "center": [0, 0, 0], "mode": "alpha"},
    {"az": 0.3, "el": 0.3, "r": 8.0, "center": [0, 0, 0], "mode": "rgb",
     "markers": True},
    {"az": 0, "el": 0, "r": 0, "center": [0, 0, 0], "mode": "rgb",
     "view": 2},
    {"az": 0, "el": 0, "r": 0, "center": [0, 0, 0], "mode": "depth",
     "markers": True, "view": 1},
]
VIEWER_LATENCY_REQUESTS = 20


def check_viewer(card: str, scene):
    """`viewer.ViewerServer` on the smoke scene at SIZE² with 4 orbit
    training cameras, serving on 127.0.0.1 (a free port): GET / and /info,
    POSTs in rgb, depth and alpha modes, with markers and with view jumps
    (one K1 launch each, and each answer the JPEG of `_frame_array` of the
    request), two POSTs sent at once from two threads, and the latency of
    sequential requests."""
    import threading
    import urllib.request
    import numpy as np
    import torch
    from gaussctrl_tpu_torch.ops import launch_counts, reset_launch_counts
    from gaussctrl_tpu_torch.viewer import ViewerServer
    t_phase = time.perf_counter()
    cams = orbit_cameras(4, SIZE, DEVICE)
    srv = ViewerServer(scene, SIZE, SIZE, port=0, cameras=cams,
                       host="127.0.0.1")
    srv.serve(blocking=False)
    base = f"http://127.0.0.1:{srv.port}"

    def get(path):
        return urllib.request.urlopen(base + path, timeout=120).read()

    def post(q):
        req = urllib.request.Request(base + "/render",
                                     data=json.dumps(q).encode())
        return urllib.request.urlopen(req, timeout=120).read()

    checks = {}
    try:
        checks["page"] = b"<img id=\"v\"" in get("/")
        info = json.loads(get("/info"))
        checks["info"] = info == {"num_views": 4, "num_gaussians": GAUSSIANS}
        reset_launch_counts()
        answers = [post(q) for q in VIEWER_QUERIES]
        counts = dict(launch_counts)
        expected = dict.fromkeys(counts, 0)
        expected["splat_blend_fwd"] = len(VIEWER_QUERIES)
        checks["launches"] = counts == expected
        frames = [srv._frame_array(q) for q in VIEWER_QUERIES]
        checks["answers_are_the_frames"] = all(
            a == srv._jpeg(f) for a, f in zip(answers, frames))
        checks["markers_drawn"] = all(
            bool((f == (0, 255, 90)).all(-1).any())
            for q, f in zip(VIEWER_QUERIES, frames) if q.get("markers"))
        checks["frames_not_blank"] = all(int(f.max()) > 0 for f in frames)

        # two requests at once
        pair = [VIEWER_QUERIES[0], VIEWER_QUERIES[5]]
        got = [None, None]
        go = threading.Barrier(2)

        def send(i):
            go.wait(timeout=60)
            got[i] = post(pair[i])

        threads = [threading.Thread(target=send, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        checks["concurrent_done"] = not any(t.is_alive() for t in threads)
        checks["concurrent_answers"] = all(
            got[i] == srv._jpeg(srv._frame_array(pair[i])) for i in range(2))

        # latency of sequential requests (host clock around each answer)
        lat = []
        for i in range(VIEWER_LATENCY_REQUESTS):
            q = dict(VIEWER_QUERIES[0], az=0.1 * i)
            t0 = time.perf_counter()
            post(q)
            lat.append((time.perf_counter() - t0) * 1e3)
        frame_ms = cuda_ms(lambda: srv._frame_array(VIEWER_QUERIES[0]), 5)
    finally:
        srv.shutdown()
    torch.cuda.synchronize()
    rec = dict(phase="viewer", card=card, size=SIZE, gaussians=GAUSSIANS,
               requests=len(VIEWER_QUERIES), request_ms_mean=float(np.mean(lat)),
               request_ms_median=float(np.median(lat)),
               request_ms_min=float(np.min(lat)), frame_array_ms=frame_ms,
               jpeg_bytes=[len(a) for a in answers], launches=counts,
               expected_launches=expected, checks=checks,
               seconds=time.perf_counter() - t_phase)
    emit(rec)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"viewer failed {bad}")
    return rec


# ---------------------------------------------------------------------------
# phase 12: the export entry point
# ---------------------------------------------------------------------------

def check_export(card: str, scenes: dict, root: str):
    """`python -m gaussctrl_tpu_torch.cli.export` on the card, in process,
    for each scene file of `scenes` to a gaussian-splat PLY (read back by
    `read_gaussian_ply`: every field bit for bit) and a point-cloud PLY
    (the means of the gaussians whose opacity passes 0.05, bit for bit)."""
    import numpy as np
    import torch
    from gaussctrl_tpu_torch.cli import export as cli
    from gaussctrl_tpu_torch.cli.render import _load_scene
    from gaussctrl_tpu_torch.data.ply import read_gaussian_ply, read_ply
    t_phase = time.perf_counter()
    checks, seconds = {}, {}
    for name, path in scenes.items():
        scene = _load_scene(path)
        for fmt in ("gaussian-splat", "point-cloud"):
            out = os.path.join(root, f"{name}_{fmt}.ply")
            t0 = time.perf_counter()
            cli.main(["--load-checkpoint", path, "--output", out,
                      "--format", fmt])
            seconds[f"{name}_{fmt}"] = time.perf_counter() - t0
            if fmt == "gaussian-splat":
                back = read_gaussian_ply(out)
                checks[f"{name}_{fmt}"] = all(
                    torch.equal(getattr(back, k), getattr(scene, k))
                    for k in TRAIN_FIELDS)
            else:
                pts = read_ply(out)
                keep = (torch.sigmoid(scene.opacities[:, 0]) > 0.05).numpy()
                xyz = np.stack([pts["x"], pts["y"], pts["z"]], 1)
                checks[f"{name}_{fmt}"] = bool(np.array_equal(
                    xyz, scene.means.numpy()[keep]))
    rec = dict(phase="export", card=card, scenes=list(scenes),
               seconds_per_call=seconds, checks=checks,
               seconds=time.perf_counter() - t_phase)
    emit(rec)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"export failed {bad}")
    return rec


# ---------------------------------------------------------------------------
# phase 13: the real-weight battery (cli.certify) at full width
# ---------------------------------------------------------------------------

# DDIM steps of the battery's invert/denoise (its default is 20)
CERTIFY_STEPS = 10
# checks that random weights fail by design: recorded, not asserted
CERTIFY_RANDOM_FAILS = ("vae_roundtrip", "invert_denoise_roundtrip",
                        "cross_view_edit", "mask_iou")
CERTIFY_MUST_PASS = ("alpha_schedule", "controlnet_nonzero",
                     "controlnet_scale_response")
# calls of each argument signature of K2/K3/K5/K6 held against the plain
# versions during the battery (every signature is held)
CERTIFY_HELD_PER_SHAPE = 2
CERTIFY_CHECKS = ("check_tokenizer", "check_sd_stack", "check_cross_view_edit",
                  "check_sam", "check_mask_iou", "check_dino")
# the ControlNet's zero-initialised output convs (those `zero_init_convs`
# zeroes), given seeded values so that the files read as a trained one's
CONTROLNET_OUTPUT_CONVS = ("controlnet_down_blocks.", "controlnet_mid_block.",
                           "controlnet_cond_embedding.conv_out.")


def write_trained_controlnet(cn_dir: str, root: str) -> str:
    """A copy of the ControlNet directory whose output convs hold seeded
    values (N(0, 0.02²), fp16) in place of the zeros of an initialisation."""
    import torch
    from gaussctrl_tpu_torch.diffusion import weights as w
    sd = w.read_safetensors(os.path.join(cn_dir,
                                         "diffusion_pytorch_model.safetensors"))
    gen = torch.Generator().manual_seed(7)
    for k, v in sd.items():
        if k.startswith(CONTROLNET_OUTPUT_CONVS):
            sd[k] = 0.02 * torch.randn(v.shape, generator=gen)
    out = os.path.join(root, "controlnet_trained")
    os.makedirs(out)
    w.save_safetensors(os.path.join(out, "diffusion_pytorch_model.safetensors"),
                       {k: v.half() for k, v in sd.items()})
    return out


def certify_expected(steps: int) -> dict:
    """The exact kernel launches of the battery's SD checks at SD-1.5 width
    over `steps` DDIM steps, from the layer counts. check_sd_stack: two
    eps calls and `steps` each of inversion and unguided denoise at B=1
    (no processor: every self-attention to K2, every text cross-attention
    to its kernel), three VAE calls (encode, two decodes). check_cross_view
    _edit: the inversion at B=2, the CFG denoise at B=4 with the cross-view
    processors (one reference, K3 at the fused levels, the composed 64-token
    level: the UNet's self branch to K2, one reference call in both
    networks) and again without them, an encode and two decodes."""
    from gaussctrl_tpu_torch.ops import launch_counts
    n_unet = sum(u for u, _ in LAYERS_PER_LEVEL.values())
    n_cn = sum(c for _, c in LAYERS_PER_LEVEL.values())
    plain_fwd = (2 + 2 * steps) + steps + steps     # no processor
    xview_fwd = steps
    want = dict.fromkeys(launch_counts, 0)
    want["flash_attention_t"] = plain_fwd * (n_unet + n_cn)
    for t, c in LEVELS:
        u, n = LAYERS_PER_LEVEL[t]
        want[std_kernel(c // HEADS, TEXT_TOKENS)] += (plain_fwd + xview_fwd) * (u + n)
        if str(t) in fused_levels():
            want["cross_view_attention"] += xview_fwd * (u + n)
        else:
            want["flash_attention_t"] += xview_fwd * u
            want[std_kernel(c // HEADS, t)] += xview_fwd * 1 * (u + n)
    want[std_kernel(VAE_WIDTH, VAE_TOKENS)] += 3 + 3
    return want


def _non_finite(obj, path="") -> list:
    if isinstance(obj, dict):
        return [p for k, v in obj.items() for p in _non_finite(v, f"{path}/{k}")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj) for p in _non_finite(v, f"{path}/{i}")]
    if isinstance(obj, float) and not math.isfinite(obj):
        return [path]
    return []


def check_certify(card: str, ckpt_dirs, seg_files: dict, root: str):
    """`python -m gaussctrl_tpu_torch.cli.certify`, in process on the card,
    on the SD-1.5 diffusers directories of phase `weights` (the ControlNet
    given trained-like output convs) and the SAM ViT-H and GroundingDINO
    Swin-B files of phase `masked_edit`, with CERTIFY_STEPS DDIM steps. The
    battery never raises; this phase fails on any check that carries an
    error or a non-finite number, on CERTIFY_MUST_PASS not ok, on
    K2/K3/K5/K6 launches other than `certify_expected`'s, and unless each
    of the four, held against its plain version on the battery's own
    inputs (the first CERTIFY_HELD_PER_SHAPE calls of each argument
    signature: K3 at one reference and two CFG groups, K2/K5 at batch 1, 2
    and 4, K6 in the VAE), agrees within the attention tolerances. The
    checks that random weights fail by design are recorded. Each check's
    seconds leave out the time spent holding its calls, which is recorded
    apart."""
    import torch
    from gaussctrl_tpu_torch import certify as battery
    from gaussctrl_tpu_torch.cli import certify as cli
    from gaussctrl_tpu_torch.ops import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    cn_dir = write_trained_controlnet(ckpt_dirs[1], root)
    cn_s = time.perf_counter() - t0
    out = os.path.join(root, "certify.json")
    argv = ["--diffusers-dir", ckpt_dirs[0], "--controlnet-dir", cn_dir,
            "--sam-ckpt", seg_files["sam"], "--dino-ckpt", seg_files["dino"],
            "--dino-vocab", seg_files["vocab"],
            "--num-inference-steps", str(CERTIFY_STEPS), "--out", out]
    holds, in_situ = attention_holds(CERTIFY_HELD_PER_SHAPE)
    # each check timed where the battery calls it (a module global), less
    # the seconds its calls spent being held against the plain versions
    seconds, held_seconds, saved = {}, {}, {}

    def hold_s():
        return sum(w.get("hold_s", 0.0) for w in in_situ.values())

    def timed(name, fn):
        def call(*a, **kw):
            t, h = time.perf_counter(), hold_s()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                held_seconds[name] = hold_s() - h
                seconds[name] = time.perf_counter() - t - held_seconds[name]
        return call

    for name in CERTIFY_CHECKS:
        saved[name] = getattr(battery, name)
        setattr(battery, name, timed(name, saved[name]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with _patched(holds):
            rc = cli.main(argv)
    finally:
        for name, fn in saved.items():
            setattr(battery, name, fn)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = dict(launch_counts)
    with open(out) as f:
        verdict = json.load(f)
    expected = certify_expected(CERTIFY_STEPS)
    checks_ = verdict["checks"]
    # a crashed SD stack check merges its {"ok", "error"} into the checks
    # themselves, as the JAX battery does
    errors = {k: v["error"] for k, v in checks_.items()
              if isinstance(v, dict) and "error" in v}
    if "error" in checks_:
        errors["sd_stack"] = checks_["error"]
    non_finite = _non_finite(verdict)
    checks = dict(
        no_errors=not errors, finite=not non_finite,
        must_pass=all(checks_.get(k, {}).get("ok") for k in CERTIFY_MUST_PASS),
        every_check_ran=set(checks_) >= {
            "alpha_schedule", "tokenizer_goldens", "vae_roundtrip",
            "controlnet_nonzero", "controlnet_scale_response",
            "invert_denoise_roundtrip", "cross_view_edit", "sam", "mask_iou",
            "dino"} and not verdict["skipped"],
        exit_code=rc == (0 if verdict["all_ok"] else 1),
        launch_counts=counts == expected,
        kernels_vs_plain=all(w.get("calls") and attn_ok(w)
                             for w in in_situ.values()))
    rec = dict(phase="certify", card=card, steps=CERTIFY_STEPS, exit_code=rc,
               verdict=verdict, errors=errors, non_finite=non_finite,
               random_weights_fail_by_design={
                   k: checks_.get(k, {}).get("ok") for k in CERTIFY_RANDOM_FAILS},
               check_seconds=seconds, held_seconds=held_seconds,
               in_situ=in_situ, attn_tol=dict(scaled=ATTN_SCALED_TOL,
                                              rel_rms=ATTN_REL_RMS_TOL),
               controlnet_write_s=cn_s, run_s=run_s,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
               launches=counts, expected_launches=expected, checks=checks,
               seconds=time.perf_counter() - t_phase)
    emit(rec)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"certify failed {bad}: errors {errors}, "
                             f"non-finite {non_finite}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reopt-steps", type=int, default=REOPT_STEPS,
                    help="re-optimisation steps (the reference runs 500)")
    ap.add_argument("--out", default="", help="directory for the full report")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import gaussctrl_tpu_torch  # noqa: F401
        from gaussctrl_tpu_torch.ops import _lib
    except ImportError as e:
        print(f"chip_smoke: the gaussctrl_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 1

    # 1. environment
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    card = f"{name}, {smi.split(',')[-1].strip()}"
    print(smi, flush=True)
    import importlib.util
    emit(dict(phase="environment", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, device_count=torch.cuda.device_count(),
              pil=importlib.util.find_spec("PIL") is not None,
              seconds=time.perf_counter() - t_start))

    # 2. build
    t0 = time.perf_counter()
    _lib.library()
    build = dict(phase="build", seconds=time.perf_counter() - t0,
                 nvcc_seconds=_lib.build_seconds, library=_lib.library_path())
    emit(build)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "nvcc.log"), "w") as f:
            f.write(_lib.build_log)

    sass = check_sass(_lib.build_log, args.out)

    # comparisons in full float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    scene = smoke_scene(GAUSSIANS, DEVICE)
    cams = orbit_cameras(args.views, SIZE, DEVICE)
    k1 = check_k1(scene, cams, REPS)
    k4 = check_k4(scene, cams, REPS)
    k2 = check_k2(min(args.views, K2_MAX_TIMED_BATCH), REPS)
    k3 = check_k3(REFS + CHUNK, REFS, REPS)
    k5 = check_k5(args.views, REPS)
    k6 = check_k6(args.views, REPS)
    del scene, cams
    torch.cuda.empty_cache()
    emit(dict(phase="kernels_done", seconds=time.perf_counter() - t0))

    # 4. tiny pipeline: card against CPU
    check_small()

    # 5. tiny re-optimisation: card against CPU
    train = check_train()

    # 5b. a full-width re-optimisation step, split
    split = reopt_split()
    torch.cuda.empty_cache()

    # 5c. the port against the JAX package's golden at SD-1.5 widths
    golden = check_golden(card)
    torch.cuda.empty_cache()

    # 6a. SD-1.5 weights through a diffusers layout on disk, and
    # 6. the main path on them; the files are kept for phase 13
    weights_root = tempfile.mkdtemp(prefix="gaussctrl_sd15_")
    seg_root = tempfile.mkdtemp(prefix="gaussctrl_seg_")
    try:
        weights, ckpt_dirs, written = check_weights(weights_root)
        mp, pipe = main_path(args, card, ckpt_dirs, written)
        del written

        # 7. the composed cross-view route against the fused one
        composed = check_composed(pipe, args.steps, REPS // 4)

        # 7a. the device mesh: entry(), a world of one, two ranks
        mesh = check_mesh(pipe, card, weights_root)

        # 7b. the masked edit: SAM ViT-H, GroundingDINO Swin-B, CLIP ViT-L/14
        masked, seg_files = check_masked_edit(pipe, card, seg_root)
        del pipe
        torch.cuda.empty_cache()

        # 13. the real-weight battery on the files of phases 6a and 7b
        certify = check_certify(card, ckpt_dirs, seg_files, weights_root)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(weights_root, ignore_errors=True)
        shutil.rmtree(seg_root, ignore_errors=True)

    # 8. from-scratch pre-training with densification at full width
    pretrain = check_pretrain()
    torch.cuda.empty_cache()

    # 9. the pre-training CLI on the example scene, and on its checkpoint
    # and the smoke scene 10. render, 11. viewer, 12. export
    splat_root = tempfile.mkdtemp(prefix="gaussctrl_splat_")
    try:
        splat_train = check_splat_train(splat_root)
        from gaussctrl_tpu_torch.core.ckpt import load_scene_npz, save_pytree
        smoke_npz = os.path.join(splat_root, "smoke_scene.npz")
        save_pytree(smoke_npz, smoke_scene(GAUSSIANS, DEVICE))
        render = check_render(card, splat_train["ckpt"], smoke_npz,
                              splat_root, args.out)
        viewer = check_viewer(card, load_scene_npz(smoke_npz, device=DEVICE))
        export = check_export(card, {"example_trained": splat_train["ckpt"],
                                     "smoke": smoke_npz}, splat_root)
    finally:
        shutil.rmtree(splat_root, ignore_errors=True)
    torch.cuda.empty_cache()

    # per-kernel summary: K2/K3/K5 times are per DDIM step of the main path
    # (each level's time times its self-attention layers in UNet + ControlNet)
    per_level = LAYERS_PER_LEVEL
    layers = mp["self_attention_layers"]
    if [sum(x) for x in zip(*per_level.values())] != [layers["unet"],
                                                     layers["controlnet"]]:
        raise AssertionError(f"layer counts {layers} != {per_level}")

    def step_sum(recs, key, coeff_of=None):
        total = 0.0
        for rec in recs:
            if key not in rec or rec.get(key) is None:
                continue
            n_unet, n_cn = per_level[rec["T"]]
            if coeff_of is None:
                total += rec[key] * (n_unet + n_cn)
            else:
                total += rec[key] * (n_unet if rec["self_coeff"] else n_cn)
        return total

    def bound_by(recs, weight):
        """The term (operations, bytes, exponentials) that bounds the shapes
        holding most of the step's bound; `weight(rec)` counts calls."""
        share = {}
        for rec in recs:
            if "bound_by" in rec:
                share[rec["bound_by"]] = (share.get(rec["bound_by"], 0.0)
                                          + rec["bound_ms"] * weight(rec))
        return max(share, key=share.get)

    def layers_of(rec):
        return sum(per_level[rec["T"]])

    def k3_layers(rec):
        n_unet, n_cn = per_level[rec["T"]]
        return n_unet if rec["self_coeff"] else n_cn

    # K5 per edit step (the edit batch): the text cross-attention of every
    # transformer block, and r reference calls per 64-token layer
    def k5_calls(rec):
        if rec["use"] == "text":
            return sum(per_level[rec["T"]])
        return 0 if str(rec["T"]) in fused_levels() else REFS * sum(per_level[rec["T"]])

    k5_step = {key: sum(rec[key] * k5_calls(rec) for rec in k5 if key in rec)
               for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                           "ops_ms", "bytes_ms", "exp_ms")}
    # K6 per call of the main path: the VAE mid-block at B = views
    vae = next(rec for rec in k6 if rec["use"] == "vae")

    # `redesigned`: rebuilt for the card after its first port, the attention
    # kernels on the TMA + wgmma core of csrc/flash_core.cuh, K1 and K4 on
    # cp.async-staged records with one replay in K4
    launches = mp["launches"]
    masked_launches = masked["launches"]
    kernels = [
        dict(name="splat_blend_fwd", route="cuda", redesigned=True,
             source="gaussctrl_tpu_torch/csrc/splat_blend_fwd.cu",
             replaces="gaussctrl_tpu/ops/splat_blend.py:218",
             launches=launches["splat_blend_fwd"],
             masked_launches=masked_launches["splat_blend_fwd"],
             max_abs_err=k1["max_abs_err"], ms=k1["kernel_ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="splat_blend_bwd", route="cuda", redesigned=True,
             source="gaussctrl_tpu_torch/csrc/splat_blend_bwd.cu",
             replaces="gaussctrl_tpu/ops/splat_blend.py:261",
             launches=launches["splat_blend_bwd"],
             masked_launches=masked_launches["splat_blend_bwd"],
             max_abs_err=k4["max_abs_err"], ms=k4["kernel_ms"],
             plain_ms=k4["plain_ms"], bound_ms=k4["bound_ms"],
             bound_by=k4["bound_by"], library_ms=None),
        dict(name="flash_attention_t", route="cuda", redesigned=True,
             source="gaussctrl_tpu_torch/csrc/flash_hopper.cu",
             replaces="gaussctrl_tpu/ops/flash_attention.py:106",
             launches=launches["flash_attention_t"],
             masked_launches=masked_launches["flash_attention_t"],
             max_abs_err=max(r["max_abs_err"] for r in k2),
             ms=step_sum(k2, "kernel_ms"), plain_ms=step_sum(k2, "plain_ms"),
             bound_ms=step_sum(k2, "bound_ms"), bound_by=bound_by(k2, layers_of),
             library_ms=step_sum(k2, "library_ms")),
        dict(name="cross_view_attention", route="cuda", redesigned=True,
             source="gaussctrl_tpu_torch/csrc/cross_view_hopper.cu",
             replaces="gaussctrl_tpu/ops/flash_attention.py:194",
             launches=launches["cross_view_attention"],
             masked_launches=masked_launches["cross_view_attention"],
             max_abs_err=max(r["max_abs_err"] for r in k3),
             ms=step_sum(k3, "kernel_ms", True),
             plain_ms=step_sum(k3, "plain_ms", True),
             bound_ms=step_sum(k3, "bound_ms", True), bound_by=bound_by(k3, k3_layers),
             library_ms=step_sum(k3, "library_ms", True)),
        dict(name="attention_full", route="cuda", redesigned=True,
             source="gaussctrl_tpu_torch/csrc/attention_full_hopper.cu",
             replaces="gaussctrl_tpu/ops/flash_attention.py:81",
             launches=launches["attention_full"],
             masked_launches=masked_launches["attention_full"],
             max_abs_err=max(r["max_abs_err"] for r in k5),
             ms=k5_step["kernel_ms"], plain_ms=k5_step["plain_ms"],
             bound_ms=k5_step["bound_ms"],
             bound_by=bound_by(k5, k5_calls),
             library_ms=k5_step["library_ms"]),
        dict(name="attention_stream", route="cuda", redesigned=True,
             source="gaussctrl_tpu_torch/csrc/flash_hopper.cu",
             replaces="gaussctrl_tpu/ops/flash_attention.py:40",
             launches=launches["attention_stream"],
             masked_launches=masked_launches["attention_stream"],
             max_abs_err=max(r["max_abs_err"] for r in k6),
             ms=vae["kernel_ms"], plain_ms=vae["plain_ms"],
             bound_ms=vae["bound_ms"], bound_by=vae["bound_by"],
             library_ms=vae["library_ms"]),
    ]
    # launches on this slice's paths: the render CLI's calls, the viewer's
    # requests and the battery
    for k in kernels:
        k["render_launches"] = sum(c["launches"][k["name"]]
                                   for c in render["calls"].values())
        k["viewer_launches"] = viewer["launches"][k["name"]]
        k["certify_launches"] = certify["launches"][k["name"]]
        k["mesh_launches"] = mesh["world_one"]["mesh"]["counts"][k["name"]]
        k["entry_launches"] = mesh["entry"]["launches"][k["name"]]
        k["golden_launches"] = sum(
            (c.get("bf16_kernels") or c["fp32_kernels"])["launches"][k["name"]]
            for c in golden["cases"].values())
    total_s = time.perf_counter() - t_start
    emit(dict(phase="done", card=card, total_s=total_s))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, build=build, k1=k1, k4=k4, k2=k2, k3=k3,
                           k5=k5, k6=k6, sass=sass, train=train,
                           reopt_split=split, golden=golden, weights=weights,
                           main_path=mp, composed=composed, mesh=mesh,
                           masked_edit=masked, certify=certify,
                           pretrain=pretrain, splat_train=splat_train,
                           render=render, viewer=viewer, export=export,
                           kernels=kernels, total_s=total_s),
                      f, indent=1)
    emit({"kernels": kernels})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
