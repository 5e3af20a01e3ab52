#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gaussctrl_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                     # 8 views x 10 DDIM steps
    python3 chip_smoke.py --views 40 --steps 20   # the reference protocol

Phases, each printing one JSON line with its wall time:

  1. environment  card name and power limit (nvidia-smi), torch and CUDA;
  2. build        the kernel library (one nvcc call over csrc/*.cu);
  3. kernels      K1 (splat blend), K2 (inversion attention) and K3 (cross-
                  view attention) held against their plain PyTorch versions
                  on the card at the main path's shapes, with the tolerance
                  stated, and timed beside their plain versions, one PyTorch
                  library call where one computes the same function, and
                  their bound at 989 TFLOP/s bf16 / 67 TFLOP/s fp32 /
                  3.35 TB/s;
  4. small        a tiny-config pipeline on the card against the same
                  pipeline on the CPU (plain versions), both bf16, with
                  each K2/K3 call on the card also held against its plain
                  version on its own inputs;
  5. main path    render_reverse() then edit_images() at SD-1.5 width with
                  seeded random weights in bf16 on a seeded random scene of
                  200,000 gaussians: finite outputs of the right shapes and
                  exact launch counts for every kernel.

Then a `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failure raises and exits non-zero, and
without a card or without the package beside it the script exits non-zero
before printing any result. This script imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the rate
# of their type.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

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
# K2/K3 against the CPU's), and the random tiny networks amplify that: on an
# H100 they read a relative RMS of 0.031 (z_T) and 0.038 (edited), held to
# 0.05 and 0.06. The kernels' own share is held sharply in situ.
SMALL_REL_TOL = dict(z_T=0.05, edited=0.06)
# the plain attention materialises [B, 8, T, T] float32 scores; K2's timing
# batch is capped so that they fit beside the kernel's inputs
K2_MAX_TIMED_BATCH = 8
# self-attention layers per level in (UNet, ControlNet): down blocks 0-2 hold
# two each, the mid block one, up blocks 1-3 three each (UNet only)
LAYERS_PER_LEVEL = {4096: (5, 2), 1024: (5, 2), 256: (5, 2), 64: (1, 1)}


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


def bound_ms(flops: float, peak: float, nbytes: float):
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_fields(flops: float, peak: float, nbytes: float) -> dict:
    t, by = bound_ms(flops, peak, nbytes)
    return dict(bound_ms=t, bound_by=by, ops_ms=flops / peak * 1e3,
                bytes_ms=nbytes / PEAK_BYTES * 1e3)


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


def check_k1(scene, cams, reps):
    """K1 on one 512x512 view of the smoke scene against blend_plain."""
    import importlib
    import torch
    from gaussctrl_tpu_torch.cameras.camera import view_matrix
    from gaussctrl_tpu_torch.ops import splat_blend as sb
    from gaussctrl_tpu_torch.splat.project import project_gaussians
    from gaussctrl_tpu_torch.splat.sh import eval_sh
    rast = importlib.import_module("gaussctrl_tpu_torch.splat.rasterize")

    c2w = cams.c2w[0]
    W, H = cams.width, cams.height
    opac = torch.sigmoid(scene.opacities[:, 0])
    proj = project_gaussians(scene.means, torch.exp(scene.scales), scene.quats,
                             view_matrix(c2w), cams.fx[0], cams.fy[0],
                             cams.cx[0], cams.cy[0], W, H, opacities=opac)
    dirs = scene.means - c2w[:3, 3][None]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True).clamp_min(1e-8)
    rgb = torch.clamp_min(eval_sh(3, dirs, scene.colors) + 0.5, 0.0)
    colors = torch.cat([rgb, proj.depths[:, None]], -1).contiguous()
    radii = torch.where(opac >= rast.ALPHA_THRESH, proj.radii,
                        torch.zeros_like(proj.radii))
    ntx, nty = (W + 15) // 16, (H + 15) // 16
    cfg = rast.RasterConfig()
    b = rast._bin_and_sort(proj.xys, proj.depths, radii, ntx, nty, cfg)
    bg = torch.zeros(4, device=c2w.device)
    args = (b.gauss_idx, b.starts, b.ends, proj.xys.contiguous(),
            proj.conics.contiguous(), colors, opac.contiguous(), bg, ntx, nty)
    tiles, alpha, done = sb.blend(*args, return_done=True)
    ref_tiles, ref_alpha = sb.blend_plain(*args)
    torch.cuda.synchronize()
    err = max((tiles - ref_tiles).abs().max().item(),
              (alpha - ref_alpha).abs().max().item())
    # tolerance: same fp32 arithmetic, the transmittance product taken in
    # another order; depth (channel 4) reaches ~5, so 1e-3 absolute
    tol = 1e-3
    pairs = float(done.sum().item()) * 256
    used = int(b.ends[-1].item())
    n = proj.xys.shape[0]
    ch = colors.shape[1]
    # each input read once (the used index range, the per-gaussian rows,
    # the ranges), each output written once (tiles ch + T per pixel)
    nbytes = (4 * used + 8 * ntx * nty + 4 * n * (2 + 3 + ch + 1)
              + 4 * ntx * nty * 256 * (ch + 1))
    ms = cuda_ms(lambda: sb.blend(*args), reps)
    plain = cuda_ms(lambda: sb.blend_plain(*args), max(1, reps // 10))
    rec = dict(phase="kernels", kernel="splat_blend_fwd", shape=[H, W, ch],
               n_isect=int(b.n_isect.item()), isect_budget=b.gauss_idx.shape[0],
               max_tile=int((b.ends - b.starts).max().item()),
               pairs_blended=pairs, max_abs_err=err, tol=tol, kernel_ms=ms,
               plain_ms=plain, library_ms=None,
               **bound_fields(pairs * 30, PEAK_FP32, nbytes))
    emit(rec)
    if not err <= tol:
        raise AssertionError(f"K1 disagrees with its plain version: {err} > {tol}")
    return rec


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
            d = c // HEADS
            flops = 4.0 * batch * HEADS * t * t * d
            nbytes = 4.0 * batch * t * c * 2
            qs, ks, vs = (_sdpa_layout(x, HEADS) for x in (q, k, v))
            rec.update(
                B_timed=batch,
                kernel_ms=cuda_ms(lambda: fa.flash_attention_t(q, k, v, HEADS), reps),
                plain_ms=cuda_ms(lambda: fa.attention_plain(q, k, v, HEADS),
                                 max(1, reps // 5)),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs),
                                   reps))
            rec.update(bound_fields(flops, PEAK_BF16, nbytes))
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
                flops = 4.0 * b * HEADS * t * t * d * panels
                rec.update(bound_fields(flops, PEAK_BF16, 4.0 * b * t * c * 2))
            emit(rec)
            recs.append(rec)
    bad = [(r["T"], r["self_coeff"]) for r in recs if not attn_ok(r)]
    if bad:
        raise AssertionError(f"K3 disagrees with its plain version at (T, c)={bad}")
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


def _held_to_plain(kernel, plain, worst: dict):
    """`kernel` that also holds each of its outputs against `plain` on the
    same inputs, keeping the worst errors and the number of calls."""
    def call(*args):
        out = kernel(*args)
        e = attn_errors(out, plain(*args))
        worst["calls"] = worst.get("calls", 0) + 1
        for key in ("scaled_err", "rel_rms_err"):
            worst[key] = max(worst.get(key, 0.0), e[key])
        return out
    return call


def check_small():
    """The tiny pipeline on the card (kernels) against the same pipeline on
    the CPU (plain versions), both bf16 with the same weights. On the card,
    each K2/K3 call is also held against its plain version on its own
    inputs, which covers the tiny config's head widths (16 and 32)."""
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
    cpu = tiny_pipeline("cpu", state)
    in_situ = {"flash_attention_t": {}, "cross_view_attention": {}}
    saved = processors.flash_attention_t, processors.cross_view_attention
    processors.flash_attention_t = _held_to_plain(
        fa.flash_attention_t, fa.attention_plain, in_situ["flash_attention_t"])
    processors.cross_view_attention = _held_to_plain(
        fa.cross_view_attention, fa.cross_view_attention_plain,
        in_situ["cross_view_attention"])
    try:
        card = tiny_pipeline(DEVICE, state)
    finally:
        processors.flash_attention_t, processors.cross_view_attention = saved
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
# phase 5: the main path
# ---------------------------------------------------------------------------

def main_path(args, card):
    import torch
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    from gaussctrl_tpu_torch.ops import launch_counts, reset_launch_counts
    from gaussctrl_tpu_torch.pipeline.gaussctrl import (GaussCtrlConfig,
                                                        GaussCtrlPipeline)
    t0 = time.perf_counter()
    scene = smoke_scene(GAUSSIANS, DEVICE)
    cams = orbit_cameras(args.views, SIZE, DEVICE)
    cfg = GaussCtrlConfig(edit_prompt="a photo of a polar bear",
                          reverse_prompt="a photo of a bear statue",
                          guidance_scale=5.0, num_inference_steps=args.steps,
                          chunk_size=CHUNK, ref_view_num=REFS)
    pipe = GaussCtrlPipeline(cfg, scene, cams, sd_config=SDConfig.sd15(),
                             dtype=torch.bfloat16, device=DEVICE,
                             weights_seed=WEIGHTS_SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    layers = attention_layer_counts(pipe.models)
    n_self = len(layers["unet"]) + len(layers["controlnet"])
    V, R = args.views, cfg.ref_view_num
    # the reference's draw may repeat a view (inclusive randint), so the
    # chunks are counted from the views that are not references
    others = [i for i in range(V) if i not in pipe.ref_indices]
    n_chunks = -(-len(others) // cfg.chunk_size)
    expected = {"splat_blend_fwd": V,
                "flash_attention_t": args.steps * n_self,   # one inversion batch
                "cross_view_attention": args.steps * n_self * n_chunks}

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t1 = time.perf_counter()
    pipe.render_reverse()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    pipe.edit_images()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = dict(launch_counts)

    s, H = pipe.sd_config.sample_size, SIZE
    shapes = dict(unedited=(V, H, H, 3), depths=(V, H, H, 1), z_T=(V, s, s, 4),
                  edited=(V, H, H, 3))
    finite = {k: bool(torch.isfinite(getattr(pipe, k)).all()) for k in shapes}
    rec = dict(phase="main_path", card=card, views=V, steps=args.steps,
               gaussians=GAUSSIANS, size=H, refs=pipe.ref_indices,
               edit_batches=n_chunks,
               chunk_size=cfg.chunk_size, setup_s=setup_s,
               render_reverse_s=t2 - t1, edit_images_s=t3 - t2,
               render_reverse_views_per_s=V / (t2 - t1),
               edit_images_views_per_s=V / (t3 - t2),
               views_per_s=V / (t3 - t1),
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
    if counts != expected:
        raise AssertionError(f"launch counts {counts} != expected {expected}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
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
    emit(dict(phase="environment", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, device_count=torch.cuda.device_count(),
              seconds=time.perf_counter() - t_start))

    # 2. build
    t0 = time.perf_counter()
    _lib.library()
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              nvcc_seconds=_lib.build_seconds, library=_lib.library_path()))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "nvcc.log"), "w") as f:
            f.write(_lib.build_log)

    # comparisons in full float32: no TF32 in matmuls or cuDNN convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    scene = smoke_scene(GAUSSIANS, DEVICE)
    cams = orbit_cameras(args.views, SIZE, DEVICE)
    k1 = check_k1(scene, cams, REPS)
    k2 = check_k2(min(args.views, K2_MAX_TIMED_BATCH), REPS)
    k3 = check_k3(REFS + CHUNK, REFS, REPS)
    del scene, cams
    torch.cuda.empty_cache()
    emit(dict(phase="kernels_done", seconds=time.perf_counter() - t0))

    # 4. tiny pipeline: card against CPU
    check_small()

    # 5. the main path
    mp = main_path(args, card)

    # per-kernel summary: K2/K3 times are per DDIM step of the main path
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

    def bound_by(recs, coeff_of=None):
        ops = step_sum(recs, "ops_ms", coeff_of)
        return "operations" if ops >= step_sum(recs, "bytes_ms", coeff_of) else "bytes"

    launches = mp["launches"]
    kernels = [
        dict(name="splat_blend_fwd", route="cuda",
             source="gaussctrl_tpu_torch/csrc/splat_blend_fwd.cu",
             replaces="gaussctrl_tpu/ops/splat_blend.py:218",
             launches=launches["splat_blend_fwd"],
             max_abs_err=k1["max_abs_err"], ms=k1["kernel_ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="flash_attention_t", route="cuda",
             source="gaussctrl_tpu_torch/csrc/attention.cu",
             replaces="gaussctrl_tpu/ops/flash_attention.py:137",
             launches=launches["flash_attention_t"],
             max_abs_err=max(r["max_abs_err"] for r in k2),
             ms=step_sum(k2, "kernel_ms"), plain_ms=step_sum(k2, "plain_ms"),
             bound_ms=step_sum(k2, "bound_ms"), bound_by=bound_by(k2),
             library_ms=step_sum(k2, "library_ms")),
        dict(name="cross_view_attention", route="cuda",
             source="gaussctrl_tpu_torch/csrc/attention.cu",
             replaces="gaussctrl_tpu/ops/flash_attention.py:248",
             launches=launches["cross_view_attention"],
             max_abs_err=max(r["max_abs_err"] for r in k3),
             ms=step_sum(k3, "kernel_ms", True),
             plain_ms=step_sum(k3, "plain_ms", True),
             bound_ms=step_sum(k3, "bound_ms", True), bound_by=bound_by(k3, True),
             library_ms=step_sum(k3, "library_ms", True)),
    ]
    total_s = time.perf_counter() - t_start
    emit(dict(phase="done", card=card, total_s=total_s))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(dict(card=card, k1=k1, k2=k2, k3=k3, main_path=mp,
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
