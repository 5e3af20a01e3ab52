"""The port's side of the cross-package golden at the reference's widths.

`scripts/torch_golden.py` runs the JAX package once, on the CPU in float32,
on the inputs this module makes, and writes its outputs to
`tests/golden/torch_sd15.npz`. `tests/test_torch_golden.py` (the port on
the CPU in float32) and `chip_smoke.py` phase `golden` (the port on the
card) run the same cases through `port_case` and compare with `compare`.

Every input is drawn with numpy from a seed: the SD-1.5 weights by
`diffusion.weights.write_seeded_sd` (fp16 safetensors both packages read),
the rest by `case_inputs`, each case from its own generator
(`default_rng([INPUT_SEED, crc32(case)])`). The cases:

  text         the CLIP text encoder on 2 × 77 seeded token ids
  vae_encode   VAE encode (× 0.18215) of 2 seeded 512² images
  invert_step  one DDIM inversion step (ControlNet + UNet, depth
               condition, the pipeline's EasyInv ρ) of 2 latents at 64²
  edit_step    one CFG-5 denoise step of R = 2 refs + F = 1 view (6 rows)
               with the cross-view processors as the pipeline builds them
  vae_decode   VAE decode of 2 seeded latents at 64²
  render       `render_rgbd` of a 200,000-gaussian scene (SH degree 3) from
               two orbit cameras at 512², with the rasterizer's counters
  reopt_step   one re-optimisation step (L1 + SSIM, Adam) of that scene on
               a seeded target and background: the loss, and the gradient
               and stepped value of `KEEP_ROWS` seeded rows of each field
  run          `GaussCtrlPipeline.run()`: 3 views, 2 refs (the draw gives
               view 1 twice), chunks of 1 view, `RUN_DDIM_STEPS` DDIM steps,
               `RUN_REOPT_STEPS` re-optimisation steps on the JAX package's
               backgrounds. The JAX package pads every chunk to
               `chunk_size` views; at chunks of 3 its CPU edit batch of
               10 rows at 4096 tokens passes 57 GB, so the chunks hold one
               view (6 rows, as in edit_step)

Images of 512² are kept at every `STRIDE`-th row and column (`keep`).
"""

from __future__ import annotations

import functools
import hashlib
import math
import zlib
from typing import Dict

import numpy as np
import torch

CASES = ("text", "vae_encode", "invert_step", "edit_step", "vae_decode",
         "render", "reopt_step", "run")
DIFFUSION_CASES = ("text", "vae_encode", "invert_step", "edit_step",
                   "vae_decode")
WEIGHTS_SEED, INPUT_SEED = 0, 15
BATCH = 2                      # rows of text, vae_encode, invert_step, vae_decode
EDIT_REFS, EDIT_VIEWS = 2, 1   # edit_step: B = 2 · (R + F) = 6
GUIDANCE = 5.0
GAUSSIANS, SIZE, SH_DEGREE = 200_000, 512, 3
RENDER_VIEWS = 2
KEEP_ROWS = 4096
STRIDE = 2
RUN_VIEWS, RUN_REFS, RUN_CHUNK = 3, 2, 1
RUN_DDIM_STEPS, RUN_REOPT_STEPS = 2, 2
PROMPTS = dict(edit_prompt="a photo of a polar bear",
               reverse_prompt="a photo of a bear statue")
FIELDS = ("means", "scales", "quats", "opacities", "features_dc",
          "features_rest")


def learning_rate(field: str) -> float:
    """A scene field's Adam lr in the re-optimisation (the means' schedule
    sits at its final value there)."""
    from gaussctrl_tpu_torch.splat.trainer import TrainConfig
    cfg = TrainConfig()
    return dict(means=cfg.lr_means_final, scales=cfg.lr_scales,
                quats=cfg.lr_quats, opacities=cfg.lr_opacities,
                features_dc=cfg.lr_features_dc,
                features_rest=cfg.lr_features_rest)[field]


def adam_bound(field: str, steps: int) -> float:
    """The most `steps` Adam steps can part two runs in one entry of a
    scene field: with eps 1e-15 a step moves every entry whose gradient is
    not exactly zero by about its lr whatever the gradient's size, so a
    gradient that is float noise (below ~1e-6 of its field's largest here)
    takes either sign, and two runs part by at most 2·lr a step (1% over
    for the bias corrections). The quats are renormalised after every
    step, which divides a move by the norm of the drawn quat: 4/min|q0|
    more for them, over the kept rows."""
    bound = 2.0 * learning_rate(field) * steps * 1.01
    if field == "quats":
        q0 = scene_arrays()["quats"][kept_rows(GAUSSIANS)]
        bound *= 4.0 / min(1.0, float(np.linalg.norm(q0, axis=1).min()))
    return bound


# a re-optimisation step may go another way than the golden's only where
# the golden's gradient is below this fraction of its field's largest
SIGNAL = 1e-3


@functools.lru_cache(maxsize=None)
def tolerances() -> Dict[str, Dict[str, tuple]]:
    """{case: {output: (relative RMS or None, largest absolute error)}} of
    the port in float32 against the golden, on the CPU and on the card's
    plain float32 route (and its kernels on the float32 splat path).

    Relative RMS 1e-4 for every float output (the tiny parity tests' 1e-4;
    the CPU reads 8.5e-8 to 3.2e-5), 1e-3 for the gradients. Largest
    absolute error: 1e-4 of the output's largest value for the diffusion
    stages (the CPU reads up to 7.6e-6 on the decoded images); for `run`,
    whose z_T and edits compound a render, an encode, two inversion and two
    edit steps, 2e-3 and 4e-3 (the CPU reads 3.6e-4 and 7.4e-4). The
    renders hold a step: a gaussian blends where its alpha reaches 1/255,
    so float32 arithmetic that differs by an ulp (the card's, or K1's
    ex2.approx) adds or drops a 1/255 layer at a few hundred of the
    393,216 values, and the renders' limit is 1/255 of their largest value
    (4e-3 for colour and accumulation, 2e-2 for depths up to 5); the same
    steps move the gradients of the gaussians they touch, held to 1e-2 of
    each field's largest golden gradient. The counters and the reference
    views exactly. The stepped scene rows have no relative limit: their
    largest error is what the steps can move (`adam_bound`), and for
    `reopt_step` no entry may go another way where the gradient is signal
    (`flips_on_signal`)."""
    grad_max = dict(means=8.84e-4, scales=2.59e-5, quats=3.63e-5,
                    opacities=2.45e-5, features_dc=4.97e-5,
                    features_rest=8.76e-5)

    def after(steps):
        return {f"after_{f}": (None, adam_bound(f, steps)) for f in FIELDS}

    return {
        "text": {"hidden": (1e-4, 4e-4)},
        "vae_encode": {"latents": (1e-4, 4e-5)},
        "invert_step": {"z": (1e-4, 4.3e-4)},
        "edit_step": {"z": (1e-4, 4.5e-4)},
        "vae_decode": {"images": (1e-4, 1e-4)},
        "render": {"rgb": (1e-4, 4e-3), "depth": (1e-4, 2e-2),
                   "accumulation": (1e-4, 4e-3), "n_isect": (0.0, 0.0),
                   "isect_budget": (0.0, 0.0)},
        "reopt_step": {"loss": (1e-5, 1e-5),
                       **{f"grad_{f}": (1e-3, 1e-2 * m)
                          for f, m in grad_max.items()},
                       **after(1)},
        "run": {"refs": (0.0, 0.0), "unedited": (1e-4, 4e-3),
                "depths": (1e-4, 2e-2), "z_T": (1e-4, 2e-3),
                "edited": (1e-4, 4e-3), "loss_last": (1e-4, 1e-4),
                **after(RUN_REOPT_STEPS)},
    }


def flips_on_signal(got: Dict[str, np.ndarray], golden) -> Dict[str, int]:
    """`reopt_step`: per field (the renormalised quats aside) the entries
    whose golden gradient is above `SIGNAL` of the field's largest and
    whose stepped value parts from the golden's by more than the field's
    lr, i.e. whose step went the other way."""
    out = {}
    for f in FIELDS:
        if f == "quats":
            continue
        g = np.abs(np.asarray(golden[f"reopt_step.grad_{f}"]))
        moved = np.abs(got[f"after_{f}"]
                       - np.asarray(golden[f"reopt_step.after_{f}"]))
        out[f] = int(((g > SIGNAL * g.max()) & (moved > learning_rate(f))).sum())
    return out


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng([INPUT_SEED, zlib.crc32(name.encode())])


def keep(x):
    """Every `STRIDE`-th row and column of [N, H, W, C] images."""
    return x[:, ::STRIDE, ::STRIDE]


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def scene_arrays() -> Dict[str, np.ndarray]:
    """A random scene of `GAUSSIANS` at `SH_DEGREE` with the distributions
    of `splat.scene.random_scene` (extent 1), drawn with numpy."""
    rng = _rng("scene")
    n, k = GAUSSIANS, (SH_DEGREE + 1) ** 2 - 1
    return dict(
        means=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        scales=np.log(rng.uniform(0.005, 0.05, (n, 3))).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacities=rng.normal(size=(n, 1)).astype(np.float32),
        features_dc=(rng.normal(size=(n, 3)) * 0.5).astype(np.float32),
        features_rest=(rng.normal(size=(n, k, 3)) * 0.05).astype(np.float32))


def orbit_c2ws(n: int, size: int, radius: float = 3.5, fov_deg: float = 50.0):
    """(c2w [n, 3, 4], focal) of `n` cameras on a circle at height 0.6,
    looking at the origin (the smoke run's orbit)."""
    c2ws = []
    for i in range(n):
        a = 2 * math.pi * i / n
        pos = np.array([math.sin(a) * radius, 0.6, math.cos(a) * radius])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2ws.append(np.stack([right, up, -fwd, pos], axis=1))
    return (np.asarray(c2ws, np.float32),
            size / (2 * math.tan(math.radians(fov_deg) / 2)))


def kept_rows(n: int) -> np.ndarray:
    """The `KEEP_ROWS` seeded gaussians whose values are kept, sorted."""
    return np.sort(_rng("rows").choice(n, min(KEEP_ROWS, n), replace=False))


def case_inputs(case: str) -> Dict[str, np.ndarray]:
    """The numpy inputs of one case at SD-1.5 widths; the splat cases on
    `scene_arrays()` with views of `SIZE`²."""
    from gaussctrl_tpu_torch.diffusion.config import SDConfig
    cfg = SDConfig.sd15()
    rng = _rng(case)
    s, t = cfg.sample_size, cfg.text.max_position_embeddings
    ctx_w = cfg.unet.cross_attention_dim

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    def uniform(*shape):
        return rng.uniform(size=shape).astype(np.float32)

    if case == "text":
        return dict(ids=rng.integers(0, cfg.text.vocab_size, (BATCH, t))
                    .astype(np.int32))
    if case == "vae_encode":
        return dict(images=uniform(BATCH, 8 * s, 8 * s, 3))
    if case == "invert_step":
        return dict(latents=normal(BATCH, s, s, 4), context=normal(BATCH, t, ctx_w),
                    cond=uniform(BATCH, 8 * s, 8 * s, 3))
    if case == "edit_step":
        v = EDIT_REFS + EDIT_VIEWS
        return dict(latents=normal(v, s, s, 4), context_pos=normal(v, t, ctx_w),
                    context_neg=normal(v, t, ctx_w),
                    cond=uniform(v, 8 * s, 8 * s, 3))
    if case == "vae_decode":
        return dict(latents=normal(BATCH, s, s, 4))
    if case in ("render", "reopt_step", "run"):
        views = dict(render=RENDER_VIEWS, reopt_step=1, run=RUN_VIEWS)[case]
        c2ws, focal = orbit_c2ws(views, SIZE)
        out = dict(scene_arrays(), c2ws=c2ws, focal=np.float32(focal),
                   size=np.int32(SIZE))
        if case == "reopt_step":
            # a smooth target: a coarse random grid repeated to full size
            coarse = uniform(SIZE // 8, SIZE // 8, 3)
            out["target"] = np.repeat(np.repeat(coarse, 8, 0), 8, 1)
        return out
    raise ValueError(f"unknown case {case!r}")


def rel_rms(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def max_abs(got, ref) -> float:
    return float(np.abs(np.asarray(got, np.float64)
                        - np.asarray(ref, np.float64)).max())


def compare(got: Dict[str, np.ndarray], golden, case: str) -> Dict[str, dict]:
    """{output: {rel_rms, max_abs}} of the port's outputs of `case` against
    the golden's (`golden[f"{case}.{name}"]`)."""
    out = {}
    for name, value in got.items():
        ref = np.asarray(golden[f"{case}.{name}"])
        if tuple(np.shape(value)) != ref.shape:
            raise AssertionError(f"{case}.{name}: shape {np.shape(value)} "
                                 f"!= the golden's {ref.shape}")
        out[name] = dict(rel_rms=rel_rms(value, ref), max_abs=max_abs(value, ref))
    return out


def over_tolerance(case: str, errs: Dict[str, dict]):
    """[(output, measure, value, limit)] of `compare`'s errors over
    `tolerances()[case]`."""
    bad = []
    for name, e in errs.items():
        for measure, limit in zip(("rel_rms", "max_abs"),
                                  tolerances()[case][name]):
            if limit is not None and not e[measure] <= limit:
                bad.append((name, measure, e[measure], limit))
    return bad


# ---------------------------------------------------------------------------
# the port's side of each case
# ---------------------------------------------------------------------------

def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().cpu().numpy()


def _diffusion_case(case: str, models, x: Dict[str, np.ndarray]):
    from gaussctrl_tpu_torch.diffusion import sample
    from gaussctrl_tpu_torch.diffusion.ddim import DDIMSchedule
    from gaussctrl_tpu_torch.diffusion.processors import (
        CrossViewAttnProcessor, FlashSelfAttnProcessor)
    from gaussctrl_tpu_torch.pipeline.gaussctrl import GaussCtrlConfig
    dev = models.device

    def t(name):
        return torch.as_tensor(x[name], device=dev)

    if case == "text":
        return dict(hidden=sample.encode_text(models, t("ids")))
    if case == "vae_encode":
        return dict(latents=sample.vae_encode(models, t("images")))
    if case == "vae_decode":
        return dict(images=keep(sample.vae_decode(models, t("latents"))))
    sched = DDIMSchedule.sd15()
    if case == "invert_step":
        proc = FlashSelfAttnProcessor()
        return dict(z=sample.invert(
            models, sched, t("latents"), t("context"), t("cond"), 1, 1.0,
            easyinv_rho=GaussCtrlConfig().easyinv_rho, unet_processor=proc,
            controlnet_processor=proc))
    if case == "edit_step":
        cfg = GaussCtrlConfig()
        return dict(z=sample.denoise(
            models, sched, t("latents"), t("context_pos"), t("context_neg"),
            t("cond"), GUIDANCE, 1, cfg.conditioning_scale,
            unet_processor=CrossViewAttnProcessor(
                EDIT_REFS, cfg.self_attn_coeff, 2, allow_fused=True),
            controlnet_processor=CrossViewAttnProcessor(
                EDIT_REFS, 0.0, 2, allow_fused=True)))
    raise ValueError(f"unknown case {case!r}")


def _scene(x, device):
    from gaussctrl_tpu_torch.splat.scene import GaussianScene
    return GaussianScene.from_numpy(x, device=device)


def _cameras(x, device):
    from gaussctrl_tpu_torch.cameras.camera import make_cameras
    size, f = int(x["size"]), float(x["focal"])
    return make_cameras(x["c2ws"], f, f, size / 2, size / 2, size, size,
                        device=device)


def _render_case(x, device):
    from gaussctrl_tpu_torch.splat.render import render_rgbd
    scene, cams = _scene(x, device), _cameras(x, device)
    outs = [render_rgbd(scene, cams.c2w[i], cams.fx[i], cams.fy[i], cams.cx[i],
                        cams.cy[i], cams.width, cams.height,
                        torch.zeros(3, device=device), SH_DEGREE,
                        return_stats=True) for i in range(len(cams))]
    res = {k: keep(torch.stack([o[k] for o in outs]))
           for k in ("rgb", "depth", "accumulation")}
    res["n_isect"] = torch.stack([o["stats"]["n_isect"] for o in outs])
    res["isect_budget"] = torch.tensor(
        [int(o["stats"]["isect_budget"]) for o in outs])
    return res


def _reopt_case(x, background, device):
    from gaussctrl_tpu_torch.splat import trainer
    scene = trainer.trainable(_scene(x, device))
    cams = _cameras(x, device)
    opt = trainer.make_optimizer(scene)
    metrics = trainer.train_step(
        scene, opt, 0, cams.c2w[0], cams.fx[0], cams.fy[0], cams.cx[0],
        cams.cy[0], torch.as_tensor(x["target"], device=device),
        torch.as_tensor(background, device=device), cams.width, cams.height,
        SH_DEGREE)
    rows = torch.as_tensor(kept_rows(x["means"].shape[0]), device=device)
    res = dict(loss=metrics["loss"].reshape(1))
    for f in FIELDS:
        leaf = getattr(scene, f)
        res[f"grad_{f}"] = leaf.grad[rows]
        res[f"after_{f}"] = leaf[rows]
    return res


def run_config(sd_dir: str, cn_dir: str, ddim_steps: int = RUN_DDIM_STEPS):
    """The `GaussCtrlConfig` fields of the `run` case."""
    return dict(PROMPTS, num_inference_steps=ddim_steps,
                ref_view_num=RUN_REFS, chunk_size=RUN_CHUNK,
                render_rate=RUN_REOPT_STEPS, diffusion_ckpt=sd_dir,
                controlnet_ckpt=cn_dir)


def _run_case(x, sd_dirs, backgrounds, device, dtype, ddim_steps: int):
    from gaussctrl_tpu_torch.pipeline.gaussctrl import (GaussCtrlConfig,
                                                        GaussCtrlPipeline)
    cfg = GaussCtrlConfig(**run_config(*sd_dirs, ddim_steps=ddim_steps))
    pipe = GaussCtrlPipeline(cfg, _scene(x, device), _cameras(x, device),
                             dtype=dtype, device=device)
    metrics = pipe.run(backgrounds=torch.as_tensor(backgrounds, device=device))
    rows = torch.as_tensor(kept_rows(x["means"].shape[0]), device=device)
    res = dict(refs=torch.tensor(pipe.ref_indices),
               unedited=keep(pipe.unedited), depths=keep(pipe.depths),
               z_T=pipe.z_T, edited=keep(pipe.edited),
               loss_last=metrics["loss_history"][-1:])
    for f in FIELDS:
        res[f"after_{f}"] = getattr(pipe.scene, f)[rows]
    return res


def port_case(case: str, x: Dict[str, np.ndarray], device, models=None,
              sd_dirs=None, background=None, backgrounds=None,
              dtype=torch.float32,
              ddim_steps: int = RUN_DDIM_STEPS) -> Dict[str, np.ndarray]:
    """The port's outputs of `case` on its inputs `x` (`case_inputs`), as
    float32 numpy arrays under the golden's names: the diffusion cases
    through `models` (a `sample.SDModels`), `reopt_step` with the golden's
    `background` [3], `run` from the weight directories `sd_dirs` (sd, cn)
    with the golden's `backgrounds` [steps, 3], the pipeline in `dtype`."""
    if case in DIFFUSION_CASES:
        with torch.no_grad():
            out = _diffusion_case(case, models, x)
    elif case == "render":
        with torch.no_grad():
            out = _render_case(x, device)
    elif case == "reopt_step":
        out = _reopt_case(x, background, device)
    else:
        out = _run_case(x, sd_dirs, backgrounds, device, dtype, ddim_steps)
    return {k: _np(v) for k, v in out.items()}

