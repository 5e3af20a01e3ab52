"""Write the cross-package golden: the JAX package's outputs of every case of
`gaussctrl_tpu_torch/golden.py`, at SD-1.5 widths and on a 200,000-gaussian
scene at 512², computed on the CPU in float32.

    JAX_PLATFORMS=cpu python scripts/torch_golden.py \
        [--out tests/golden/torch_sd15.npz] [--ddim-steps 2]

The SD-1.5 weights are written from their seed by
`gaussctrl_tpu_torch.diffusion.weights.write_seeded_sd` (2.7 GB of fp16
safetensors, to a temporary directory removed afterwards) and read by the
JAX package's `load_sd_params`. Takes ~12 min and ~48 GB at its peak on an
8-core CPU; `--ddim-steps` sets the `run` case's DDIM steps (2). The
JAX package runs its own CPU route: the einsum attention (its inversion
processor is None off the TPU, and the cross-view processor and
`nn.attention` take Pallas only on the TPU) and the XLA blend. No
`GAUSSCTRL_*` variable is read or set here.

The file is one compressed npz of at most 16 MB: `<case>.<output>` arrays
(512² images at every 2nd row and column, `KEEP_ROWS` seeded rows of each
scene field), the inputs the port cannot draw itself (`reopt_step.background`,
`run.backgrounds`, the JAX `jax.random` draws) and `meta.*`: the seeds, the
sha256 of every weight file and scene array, the shapes, the run's DDIM
steps, the seconds of each case, the JAX version and the git tree of
`gaussctrl_tpu/`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "tests", "golden", "torch_sd15.npz")
MAX_BYTES = 16 * 2**20


def _git(*args) -> str:
    try:
        return subprocess.run(["git", *args], cwd=ROOT, capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def _log(msg: str) -> None:
    print(f"[torch_golden] {msg}", flush=True)


def diffusion_cases(sd_dir: str, cn_dir: str, results: dict,
                    seconds: dict) -> None:
    """text, vae_encode, invert_step, edit_step, vae_decode."""
    import jax
    import jax.numpy as jnp

    from gaussctrl_tpu.diffusion import sample as js
    from gaussctrl_tpu.diffusion.config import SDConfig
    from gaussctrl_tpu.diffusion.ddim import DDIMSchedule
    from gaussctrl_tpu.diffusion.processors import CrossViewAttnProcessor
    from gaussctrl_tpu.diffusion.weights import load_sd_params
    from gaussctrl_tpu.pipeline.gaussctrl import GaussCtrlConfig
    from gaussctrl_tpu_torch import golden as g

    t0 = time.perf_counter()
    models = js.SDModels.create(SDConfig.sd15())
    params = jax.tree_util.tree_map(jnp.asarray, load_sd_params(sd_dir, cn_dir))
    _log(f"weights loaded in {time.perf_counter() - t0:.1f} s")
    sched = DDIMSchedule.sd15()
    cfg = GaussCtrlConfig()

    def invert_step(p, lat, ctx, cond):
        # the pipeline's inversion processor is None off the TPU
        return js.invert(models, p, sched, lat, ctx, cond, 1,
                         cfg.conditioning_scale, easyinv_rho=cfg.easyinv_rho,
                         unet_processor=None, controlnet_processor=None)

    def edit_step(p, lat, ctx_p, ctx_n, cond):
        return js.denoise(
            models, p, sched, lat, ctx_p, ctx_n, cond, g.GUIDANCE, 1,
            cfg.conditioning_scale,
            unet_processor=CrossViewAttnProcessor(
                g.EDIT_REFS, cfg.self_attn_coeff, 2, allow_fused=True),
            controlnet_processor=CrossViewAttnProcessor(
                g.EDIT_REFS, 0.0, 2, allow_fused=True))

    fns = dict(
        text=lambda p, x: dict(hidden=js.encode_text(models, p, x["ids"])),
        vae_encode=lambda p, x: dict(
            latents=js.vae_encode(models, p, x["images"])),
        invert_step=lambda p, x: dict(z=invert_step(
            p, x["latents"], x["context"], x["cond"])),
        edit_step=lambda p, x: dict(z=edit_step(
            p, x["latents"], x["context_pos"], x["context_neg"], x["cond"])),
        vae_decode=lambda p, x: dict(images=g.keep(
            js.vae_decode(models, p, x["latents"]))))
    for case, fn in fns.items():
        t0 = time.perf_counter()
        x = {k: jnp.asarray(v) for k, v in g.case_inputs(case).items()}
        out = jax.jit(fn)(params, x)
        for k, v in out.items():
            results[f"{case}.{k}"] = np.asarray(v, np.float32)
        seconds[case] = time.perf_counter() - t0
        _log(f"{case}: {seconds[case]:.1f} s")
    del params


def _jscene(x):
    import jax.numpy as jnp

    from gaussctrl_tpu.splat.scene import GaussianScene
    from gaussctrl_tpu_torch import golden as g
    return GaussianScene(**{k: jnp.asarray(x[k]) for k in g.FIELDS})


def _jcameras(x):
    from gaussctrl_tpu.cameras.camera import make_cameras
    size, f = int(x["size"]), float(x["focal"])
    return make_cameras(x["c2ws"], f, f, size / 2, size / 2, size, size)


def splat_cases(results: dict, seconds: dict) -> None:
    """render and reopt_step."""
    import jax
    import jax.numpy as jnp

    from gaussctrl_tpu.splat import losses, trainer
    from gaussctrl_tpu.splat.render import render_rgbd
    from gaussctrl_tpu_torch import golden as g

    t0 = time.perf_counter()
    x = g.case_inputs("render")
    scene, cams = _jscene(x), _jcameras(x)
    outs = [render_rgbd(scene, cams.c2w[i], cams.fx[i], cams.fy[i],
                        cams.cx[i], cams.cy[i], cams.width, cams.height,
                        jnp.zeros(3), g.SH_DEGREE, return_stats=True)
            for i in range(len(cams))]
    for k in ("rgb", "depth", "accumulation"):
        results[f"render.{k}"] = g.keep(np.stack(
            [np.asarray(o[k], np.float32) for o in outs]))
    for k in ("n_isect", "isect_budget"):
        results[f"render.{k}"] = np.asarray(
            [int(o["stats"][k]) for o in outs], np.float32)
    seconds["render"] = time.perf_counter() - t0
    _log(f"render: {seconds['render']:.1f} s")

    t0 = time.perf_counter()
    x = g.case_inputs("reopt_step")
    cams = _jcameras(x)
    key = jax.random.PRNGKey(g.INPUT_SEED)
    bg = jax.random.uniform(key, (3,))
    target = jnp.asarray(x["target"])
    view = (cams.c2w[0], cams.fx[0], cams.fy[0], cams.cx[0], cams.cy[0])

    def loss_fn(s):
        out = render_rgbd(s, *view, cams.width, cams.height, bg,
                          g.SH_DEGREE)
        return losses.splat_loss(out["rgb"], target)[0]

    grads = jax.grad(loss_fn)(_jscene(x))
    scene = _jscene(x)
    scene, _, metrics = trainer.train_step(
        scene, trainer.init_optimizer_state(scene), *view, target, key,
        cams.width, cams.height, g.SH_DEGREE)
    rows = g.kept_rows(x["means"].shape[0])
    results["reopt_step.background"] = np.asarray(bg, np.float32)
    results["reopt_step.loss"] = np.asarray([metrics["loss"]], np.float32)
    for f in g.FIELDS:
        results[f"reopt_step.grad_{f}"] = np.asarray(
            getattr(grads, f), np.float32)[rows]
        results[f"reopt_step.after_{f}"] = np.asarray(
            getattr(scene, f), np.float32)[rows]
    seconds["reopt_step"] = time.perf_counter() - t0
    _log(f"reopt_step: {seconds['reopt_step']:.1f} s")


def run_case(sd_dir: str, cn_dir: str, ddim_steps: int, results: dict,
             seconds: dict) -> None:
    """`GaussCtrlPipeline.run()` in float32."""
    import jax
    import jax.numpy as jnp

    from gaussctrl_tpu.pipeline.gaussctrl import (GaussCtrlConfig,
                                                  GaussCtrlPipeline)
    from gaussctrl_tpu_torch import golden as g

    t0 = time.perf_counter()
    x = g.case_inputs("run")
    cfg = GaussCtrlConfig(**g.run_config(sd_dir, cn_dir, ddim_steps))
    pipe = GaussCtrlPipeline(cfg, _jscene(x), _jcameras(x), dtype=jnp.float32)
    metrics = pipe.run(log_fn=lambda *a: _log(f"run: {a[-1]}"))
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.render_rate)
    results["run.backgrounds"] = np.stack(
        [np.asarray(jax.random.uniform(k, (3,)), np.float32) for k in keys])
    results["run.refs"] = np.asarray(pipe.ref_indices, np.float32)
    for k in ("unedited", "depths", "edited"):
        results[f"run.{k}"] = g.keep(np.asarray(getattr(pipe, k), np.float32))
    results["run.z_T"] = np.asarray(pipe.z_T, np.float32)
    results["run.loss_last"] = np.asarray([metrics["loss"]], np.float32)
    rows = g.kept_rows(x["means"].shape[0])
    for f in g.FIELDS:
        results[f"run.after_{f}"] = np.asarray(getattr(pipe.scene, f),
                                               np.float32)[rows]
    seconds["run"] = time.perf_counter() - t0
    _log(f"run: {seconds['run']:.1f} s")


def main() -> int:
    from gaussctrl_tpu_torch import golden as g

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--ddim-steps", type=int, default=g.RUN_DDIM_STEPS,
                    help="DDIM steps of the run case")
    args = ap.parse_args()

    import jax
    if jax.default_backend() != "cpu":
        print("torch_golden: run with JAX_PLATFORMS=cpu", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    wdir = tempfile.mkdtemp(prefix="gaussctrl_golden_")
    try:
        from gaussctrl_tpu_torch.diffusion import weights as tw
        t0 = time.perf_counter()
        hashes = tw.write_seeded_sd(wdir, g.WEIGHTS_SEED)
        _log(f"weights written in {time.perf_counter() - t0:.1f} s")
        sd_dir = os.path.join(wdir, tw.SEEDED_SD_DIR)
        cn_dir = os.path.join(wdir, tw.SEEDED_CN_DIR)
        results, seconds = {}, {}
        diffusion_cases(sd_dir, cn_dir, results, seconds)
        splat_cases(results, seconds)
        run_case(sd_dir, cn_dir, args.ddim_steps, results, seconds)
    finally:
        shutil.rmtree(wdir, ignore_errors=True)

    scene = g.scene_arrays()
    files = sorted(hashes)
    meta = {
        "meta.seeds": np.asarray([g.WEIGHTS_SEED, g.INPUT_SEED]),
        "meta.weight_files": np.asarray(files),
        "meta.weight_sha256": np.asarray([hashes[f] for f in files]),
        "meta.scene_fields": np.asarray(g.FIELDS),
        "meta.scene_sha256": np.asarray([g.sha256(scene[f]) for f in g.FIELDS]),
        "meta.cases": np.asarray(g.CASES),
        "meta.case_seconds": np.asarray([seconds[c] for c in g.CASES]),
        "meta.run_ddim_steps": np.asarray(args.ddim_steps),
        "meta.shapes": np.asarray([f"{k}:{list(v.shape)}"
                                   for k, v in sorted(results.items())]),
        "meta.jax_version": np.asarray(jax.__version__),
        "meta.jax_package_tree": np.asarray(_git("rev-parse",
                                                 "HEAD:gaussctrl_tpu")),
        "meta.commit": np.asarray(_git("rev-parse", "HEAD")),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        np.savez_compressed(f, **results, **meta)
    size = os.path.getsize(args.out)
    _log(f"wrote {args.out}: {size} bytes, {len(results)} arrays, "
         f"{time.perf_counter() - t_start:.1f} s")
    if size > MAX_BYTES:
        print(f"torch_golden: {args.out} is {size} bytes, over {MAX_BYTES}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
