"""The roles of the repository's root `__graft_entry__.py`, in PyTorch.

`entry()` returns the flagship forward step with example arguments: one
cross-view, CFG-guided, ControlNet-conditioned denoise step at SD-1.5 widths
on 64x64 latents (the inner loop of the edit), on zero weights.

`dryrun_multichip(n)` spawns n ranks that join one process group and runs,
at small sizes:
  1. the cross-view edit (`denoise`) sharded over the views, against the
     same edit of the whole batch on every rank;
  1b. one CFG-doubled cross-view epsilon evaluation of the SD-1.5 topology
     at its 4096/1024/256/64-token ladder (`SDConfig.nano`), sharded over
     the views;
  2. the re-optimisation `train_step` with the gaussians sharded over the
     ranks, against the unsharded step, on every leaf;
  3. a whole view-sharded `GaussCtrlPipeline.run()` at 5 views, which pads
     the views to a multiple of the ranks, then its edit in chunks.
with the JAX dry run's tolerances, in float32 on the CPU; on the card the
diffusion stack runs in bfloat16 (its attention kernels take it), and the
edit of stage 1 is held by relative RMS instead. Its inputs may be given,
so that the ranks' results can be held against another implementation's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gaussctrl_tpu_torch.core.mesh import make_mesh, shard_with_refs, spawn_ranks
from gaussctrl_tpu_torch.device import resolve_device
from gaussctrl_tpu_torch.diffusion.config import SDConfig
from gaussctrl_tpu_torch.diffusion.ddim import (DDIMSchedule, ddim_step,
                                                timestep_pairs)
from gaussctrl_tpu_torch.diffusion.processors import CrossViewAttnProcessor
from gaussctrl_tpu_torch.diffusion.sample import SDModels, denoise, eps_model


def entry(device=None, sd_config: SDConfig | None = None,
          dtype=torch.bfloat16):
    """(fn, (models, latents, ctx, disp)): `fn` is one CFG denoise step
    (guidance 5) of 1 reference + 1 edited view through the cross-view
    processors (c = 0.6 on the UNet, 0 on the ControlNet) at the first of
    20 DDIM timesteps; weights and inputs are zeros. `sd_config` defaults
    to SD-1.5. Runs on the card unless `device="cpu"`."""
    cfg = sd_config or SDConfig.sd15()
    models = SDModels.create(cfg, dtype=dtype, device=device)
    with torch.no_grad():
        for m in models.modules():
            for p in m.parameters():
                p.zero_()
    sched = DDIMSchedule.sd15()
    ts, ts_prev = timestep_pairs(20)
    b, s = 2, cfg.sample_size
    kw = dict(dtype=dtype, device=models.device)
    latents = torch.zeros((b, s, s, 4), **kw)
    ctx = torch.zeros((2 * b, cfg.text.max_position_embeddings,
                       cfg.unet.cross_attention_dim), **kw)
    disp = torch.zeros((2 * b, s * 8, s * 8, 3), **kw)

    @torch.no_grad()
    def fn(models, latents, ctx, disp):
        """One CFG denoise step with cross-view attention (guidance 5)."""
        eps = eps_model(models, torch.cat([latents, latents]), ts[0], ctx,
                        disp, 1.0,
                        unet_processor=CrossViewAttnProcessor(1, 0.6, 2),
                        controlnet_processor=CrossViewAttnProcessor(1, 0.0, 2))
        eps_u, eps_c = eps.chunk(2)
        eps = eps_u + 5.0 * (eps_c - eps_u)
        return ddim_step(sched, latents, eps.to(latents.dtype), ts[0],
                         ts_prev[0])

    return fn, (models, latents, ctx, disp)


def ring_c2ws(n: int) -> np.ndarray:
    """[n, 3, 4] camera-to-worlds on a ring of radius 2 looking at the
    origin, as the JAX dry run places its views."""
    c2ws = []
    for i in range(n):
        a = 2 * np.pi * i / n
        pos = np.array([np.sin(a) * 2, 0.0, np.cos(a) * 2])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2ws.append(np.stack([right, up, -fwd, pos], axis=1))
    return np.asarray(c2ws, np.float32)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _close(name, got, ref, rtol, atol):
    _check(torch.allclose(got, ref, rtol=rtol, atol=atol),
           f"{name}: sharded differs from replicated by "
           f"{float((got - ref).abs().max()):.3g} (rtol {rtol}, atol {atol})")


# a bfloat16 edit against the same edit batched otherwise: the relative RMS
# gap that bf16 rounding leaves in a short edit under random weights
BF16_EDIT_REL_RMS = 0.06


def sd_dtype(device) -> torch.dtype:
    """The diffusion stack's dtype in the dry run: bfloat16 on the card,
    whose attention kernels take it; float32 on the CPU, as in the JAX dry
    run."""
    cuda = torch.device(device).type == "cuda"
    return torch.bfloat16 if cuda else torch.float32


# stage 2: 64 gaussians a rank, SH 1, one 32x32 view
STEP_VIEW = dict(fx=40.0, fy=40.0, cx=16.0, cy=16.0, width=32, height=32,
                 sh_degree=1)
# stage 3: 5 ring views at 64x64 (5 views over 2 or 4 ranks take the
# padding path), SDConfig.tiny() in `sd_dtype`
RUN_VIEWS, RUN_SIZE = 5, 64
RUN_CONFIG = dict(edit_prompt="a red scene", reverse_prompt="a scene",
                  num_inference_steps=2, ref_view_num=2, render_batch=4,
                  chunk_size=0, render_rate=2)
RUN_ARTIFACTS = ("unedited", "depths", "z_T", "masks")


def dryrun_pipeline(scene, sd_params=None, device=None, mesh=None):
    """Stage 3's pipeline on `scene`: the JAX-layout `sd_params` (seeded
    random weights without them) and `mesh` (none: one process)."""
    from gaussctrl_tpu_torch.cameras.camera import make_cameras
    from gaussctrl_tpu_torch.pipeline import GaussCtrlConfig, GaussCtrlPipeline
    s = RUN_SIZE
    cams = make_cameras(ring_c2ws(RUN_VIEWS), s, s, s / 2, s / 2, s, s,
                        device=device)
    return GaussCtrlPipeline(GaussCtrlConfig(**RUN_CONFIG), scene, cams,
                             sd_config=SDConfig.tiny(), sd_params=sd_params,
                             dtype=sd_dtype(resolve_device(device)),
                             device=device, mesh=mesh)


def run_artifacts(pipe) -> dict:
    """`pipe.run()` (chunk_size 0), then `edit_images()` again with chunk
    size 2: the artifacts, both edits, the re-optimised means and the
    loss, as numpy."""
    metrics = pipe.run()
    out = {k: getattr(pipe, k).float().cpu().numpy() for k in RUN_ARTIFACTS}
    out.update(edited_chunk0=pipe.edited.float().cpu().numpy(),
               means=pipe.scene.means.detach().cpu().numpy(),
               loss=float(metrics["loss"]))
    pipe.config.chunk_size = 2
    pipe.edit_images()
    out["edited_chunk2"] = pipe.edited.float().cpu().numpy()
    pipe.config.chunk_size = RUN_CONFIG["chunk_size"]
    return out


def _dryrun_rank(device: str, inputs: dict | None) -> dict:
    """The stages of `dryrun_multichip` on one rank of the group."""
    from gaussctrl_tpu_torch.core.mesh import gather_rows
    from gaussctrl_tpu_torch.splat.scene import (_FIELDS, GaussianScene,
                                                 random_scene)
    from gaussctrl_tpu_torch.splat.trainer import (make_optimizer, shard_scene,
                                                   train_step, trainable)

    mesh = make_mesh(device)
    n = mesh.size()
    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    inputs = inputs or {}
    report = {}

    # 1. view-sharded cross-view edit == the whole batch on one rank
    dt = sd_dtype(dev)
    cfg = SDConfig.tiny()
    models = SDModels.create(cfg, dtype=dt, device=dev)
    models.init_params(0)
    sched = DDIMSchedule.sd15()
    V, s = n, cfg.sample_size
    g = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn((V, s, s, 4), generator=g, device=dev).to(dt)
    ctx = torch.zeros((V, cfg.text.max_position_embeddings,
                       cfg.unet.cross_attention_dim), dtype=dt, device=dev)
    disp = torch.zeros((V, s * 8, s * 8, 3), dtype=dt, device=dev)

    def edit(z, cp, cn, d):
        return denoise(models, sched, z, cp, cn, d, guidance_scale=5.0,
                       num_steps=2,
                       unet_processor=CrossViewAttnProcessor(1, 0.6, 2),
                       controlnet_processor=CrossViewAttnProcessor(1, 0.0, 2))

    refs, others = shard_with_refs(edit, [0], list(range(1, V)), mesh,
                                   z, ctx, ctx, disp)
    sharded = torch.cat([refs, others])
    _check(sharded.shape == z.shape, f"edit shape {tuple(sharded.shape)}")
    whole = edit(z, ctx, ctx, disp)
    if dt == torch.float32:
        _close("edit", sharded, whole, 2e-4, 2e-5)
    else:
        rel = float((sharded.float() - whole.float()).norm()
                    / whole.float().norm().clamp_min(1e-30))
        _check(rel <= BF16_EDIT_REL_RMS, f"edit: sharded differs from "
               f"replicated by {rel:.3g} relative RMS ({BF16_EDIT_REL_RMS})")
    report["edit"] = "sharded == replicated"

    # 1b. the SD-1.5 token ladder at nano width: one CFG-doubled eps
    # evaluation of max(V, 8) rows, each view's two rows kept together
    ncfg = SDConfig.nano()
    nmodels = SDModels.create(ncfg, dtype=dt, device=dev)
    nmodels.init_params(4)
    nb, ns = max(V, 8), ncfg.sample_size
    g = torch.Generator(device=dev).manual_seed(5)
    nz = (torch.randn((nb, ns, ns, 4), generator=g, device=dev) * 0.1).to(dt)
    nctx = torch.zeros((nb, ncfg.text.max_position_embeddings,
                        ncfg.unet.cross_attention_dim), dtype=dt, device=dev)
    ndisp = torch.zeros((nb, ns * 8, ns * 8, 3), dtype=dt, device=dev)

    def by_view(x):            # [2F, ...] (uncond | cond) → [F, 2, ...]
        return x.reshape(2, nb // 2, *x.shape[1:]).transpose(0, 1)

    def eval_views(z, c, d):
        def flat(x):
            return x.transpose(0, 1).reshape(-1, *x.shape[2:])
        out = eps_model(nmodels, flat(z), 500, flat(c), flat(d), 1.0,
                        unet_processor=CrossViewAttnProcessor(1, 0.6, 2),
                        controlnet_processor=CrossViewAttnProcessor(1, 0.0, 2))
        return out.reshape(2, -1, *out.shape[1:]).transpose(0, 1)

    nrefs, nothers = shard_with_refs(eval_views, [0], list(range(1, nb // 2)),
                                     mesh, by_view(nz), by_view(nctx),
                                     by_view(ndisp))
    nout = torch.cat([nrefs, nothers])
    _check(nout.shape == by_view(nz).shape, f"eps shape {tuple(nout.shape)}")
    _check(bool(torch.isfinite(nout).all()), "nano eps eval not finite")
    report["nano_eps"] = "finite"
    del models, nmodels

    # 2. the gaussian-sharded re-optimisation step == the unsharded step,
    # every leaf (the gather's backward carries each rank's gradients)
    if "step_scene" in inputs:
        scene = GaussianScene.from_numpy(inputs["step_scene"], dev)
        bg = torch.tensor(inputs["step_background"], device=dev)
    else:
        scene = random_scene(torch.Generator(device=dev).manual_seed(2),
                             64 * n, sh_degree=1, device=dev)
        bg = torch.rand(3, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(3))
    c2w = torch.eye(4, device=dev)[:3]
    c2w[2, 3] = 2.0
    kw = dict(c2w=c2w, gt_image=torch.zeros((32, 32, 3), device=dev),
              background=bg, **STEP_VIEW)
    local = trainable(shard_scene(scene, mesh))
    m_s = train_step(local, make_optimizer(local), 0, mesh=mesh, **kw)
    full = trainable(scene)
    m_r = train_step(full, make_optimizer(full), 0, **kw)
    _close("loss", m_s["loss"], m_r["loss"], 1e-5, 0.0)
    rows = {k: gather_rows(getattr(local, k).detach(), mesh) for k in _FIELDS}
    for k in _FIELDS:
        _close(k, rows[k], getattr(full, k).detach(), 1e-4, 1e-6)
    report["train_step"] = dict(
        loss=float(m_s["loss"]), unsharded_loss=float(m_r["loss"]),
        rows={k: v.cpu().numpy() for k, v in rows.items()},
        unsharded={k: getattr(full, k).detach().cpu().numpy()
                   for k in _FIELDS})

    # 3. a whole view-sharded run(), then its edit in chunks: 5 views over
    # n ranks take the padding path
    if "run_scene" in inputs:
        pscene = GaussianScene.from_numpy(inputs["run_scene"], dev)
    else:
        pscene = random_scene(torch.Generator(device=dev).manual_seed(7), 200,
                              sh_degree=1, extent=0.5, device=dev)
    run = run_artifacts(dryrun_pipeline(pscene, inputs.get("sd_params"), dev,
                                        mesh))
    _check(run["edited_chunk0"].shape == (RUN_VIEWS, RUN_SIZE, RUN_SIZE, 3),
           f"edited shape {run['edited_chunk0'].shape}")
    for k in ("edited_chunk0", "edited_chunk2", "means", "loss"):
        _check(bool(np.isfinite(run[k]).all()), f"{k} not finite")
    report["run"] = run
    return report


def dryrun_multichip(n_devices: int, device=None, inputs: dict | None = None
                     ) -> list:
    """Run the dry-run stages on `n_devices` spawned ranks: NCCL on the
    card (one card a rank) unless `device="cpu"`, then gloo. `inputs` may
    give stage 2's scene (`step_scene`, numpy arrays of 64·n rows) and
    `step_background`, and stage 3's `run_scene` and JAX-layout
    `sd_params`; otherwise they are drawn from seeds. Raises with the
    failing rank's traceback; returns each rank's report, which holds
    stage 2's stepped leaves (sharded, gathered, and unsharded) and stage
    3's artifacts (`run_artifacts`)."""
    device = str(resolve_device(device))
    reports = spawn_ranks(_dryrun_rank, n_devices, args=(device, inputs),
                          device=device)
    print(f"dryrun_multichip({n_devices}) OK: view-sharded edit == "
          f"replicated, nano production-geometry eps eval finite, "
          f"gaussian-sharded train step == unsharded, sharded run() at "
          f"{RUN_VIEWS} views", flush=True)
    return reports
