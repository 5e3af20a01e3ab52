"""The GaussCtrl editing method: render + invert → cross-view edit →
re-optimise.

Counterpart of `gaussctrl_tpu/pipeline/gaussctrl.py`:

  render_reverse  renders every view's RGB and depth (kernel K1 per view on
                  the card), VAE-encodes the renders and DDIM-inverts them
                  under the reverse prompt with guidance 0; every UNet and
                  ControlNet self-attention goes through kernel K2.
  edit_images     denoises with CFG under the edit prompt while every
                  self-attention also attends to the reference views
                  (kernel K3), either in reference-style chunks with the refs
                  prepended (`chunk_size` > 0) or all views at once
                  (`chunk_size` = 0); then VAE-decodes and composites under
                  the masks: the edit where a mask is 1, the unedited render
                  where it is 0. With `langsam_obj` and a `masker`
                  (`seg.grounding.GroundedSAMMasker`) the masks are the
                  object's, made from the unedited renders at the end of
                  render_reverse; otherwise all ones.
  reoptimize      `render_rate` single-view L1 + SSIM steps of the scene
                  against the edits (`splat/trainer.py`; kernels K1 and K4
                  on the card).

The diffusion stack runs at the camera size rounded up to its
divisibility (64 for SD-1.5): views are resized into and out of it with
`resize_bilinear`, which is `jax.image.resize`'s antialiased bilinear.

With a `mesh` (`core/mesh.py`) every rank holds the scene, the weights and
the cameras, and the views are sharded: each rank renders, encodes, inverts
and masks its contiguous share of the views (padded to a multiple of the
mesh size by repeating the last view), and the artifacts are gathered to
every rank. The all-at-once edit gives each rank the reference views plus
its share of the others in one batch (`mesh.shard_with_refs`), so K3 finds
the refs in its own batch; the chunked edit gives rank r the chunks whose
index is r modulo the mesh size. Each rank decodes its share of the edited
latents. Re-optimisation is not sharded: every rank takes the same steps
from the same seed on the gathered edits.

Prompt handling and the reference-view draw match the reference pipeline.
Arrays keep the JAX package's NHWC layout: unedited [V,H,W,3], depths
[V,H,W,1], z_T [V,h,w,4], edited [V,H,W,3].
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from gaussctrl_tpu_torch.cameras.camera import Cameras
from gaussctrl_tpu_torch.core.mesh import (gather_rows, gather_share, share_of,
                                           shard_with_refs)
from gaussctrl_tpu_torch.device import resolve_device
from gaussctrl_tpu_torch.diffusion.bridge import load_flax_params
from gaussctrl_tpu_torch.diffusion.clip import (NEGATIVE_PROMPT, POSITIVE_SUFFIX,
                                                load_tokenizer)
from gaussctrl_tpu_torch.diffusion.config import SDConfig
from gaussctrl_tpu_torch.diffusion.ddim import DDIMSchedule
from gaussctrl_tpu_torch.diffusion.processors import (CrossViewAttnProcessor,
                                                      FlashSelfAttnProcessor)
from gaussctrl_tpu_torch.diffusion.sample import (SDModels, denoise,
                                                  encode_text, invert,
                                                  vae_decode, vae_encode)
from gaussctrl_tpu_torch.diffusion.weights import load_sd_models
from gaussctrl_tpu_torch.splat.rasterize import RasterConfig
from gaussctrl_tpu_torch.splat.render import render_rgbd
from gaussctrl_tpu_torch.splat.scene import GaussianScene
from gaussctrl_tpu_torch.splat.trainer import TrainConfig, reoptimize


@dataclasses.dataclass
class GaussCtrlConfig:
    """Public flags, with the names of the reference's pipeline config."""
    edit_prompt: str = ""
    reverse_prompt: str = "a photo"
    langsam_obj: str = ""
    guidance_scale: float = 5.0
    num_inference_steps: int = 20
    chunk_size: int = 3           # 0 = all views in one batch
    ref_view_num: int = 4
    diffusion_ckpt: str = ""      # local diffusers dir ('' = random init)
    controlnet_ckpt: str = ""
    render_rate: int = 500
    self_attn_coeff: float = 0.6
    conditioning_scale: float = 1.0
    seed: int = 13789
    render_batch: int = 20        # views per VAE-encode batch
    invert_batch: int = 0         # views per inversion batch; 0 = all
    easyinv_rho: float = 0.0      # EasyInv blend (0 = reference behaviour)


def depth_to_disparity(depth: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """[V,H,W,1] depth → [V,H,W,3] disparity, each view normalised by its max."""
    disp = 1.0 / (depth + eps)
    m = disp.amax(dim=(1, 2, 3), keepdim=True)
    disp = disp / torch.clamp_min(m, eps)
    return disp.repeat(1, 1, 1, 3)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Resize [B, H, W, C] to [B, height, width, C] as `jax.image.resize`
    with "bilinear" does: half-pixel centres, and a triangle kernel widened
    by the scale when downsampling (antialias). Computed in float32 and
    returned in x's dtype."""
    if tuple(x.shape[1:3]) == (height, width):
        return x
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=(height, width),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def select_ref_views(num_views: int, ref_view_num: int,
                     seed: int = 13789) -> List[int]:
    """One random view per contiguous subset, drawn as the reference does
    (floor-div anchors, seeded inclusive `randint`), with the last subset's
    upper bound clamped to the last valid view."""
    rng = random.Random(seed)
    anchors = [(num_views * i) // ref_view_num
               for i in range(ref_view_num)] + [num_views]
    return [min(rng.randint(lo, hi), num_views - 1)
            for lo, hi in zip(anchors[:-1], anchors[1:])]


class GaussCtrlPipeline:
    """Orchestrates the render → inversion → cross-view edit of a scene.

    `sd_params`: a JAX-layout parameter tree of numpy arrays, carried across
    with `bridge.load_flax_params`. Without it, `config.diffusion_ckpt` (a
    diffusers pipeline directory) and `config.controlnet_ckpt` are loaded
    with `weights.load_sd_models`, and the tokenizer is the BPE one when
    `<diffusion_ckpt>/tokenizer/{vocab.json,merges.txt}` exist; with neither,
    random weights are drawn from `weights_seed`. `masker`: a
    `seg.MaskProvider`, called with `config.langsam_obj`. `mesh`: a 1-D
    `DeviceMesh` (`core.mesh.make_mesh`) over which the views are sharded,
    or None. Runs on the card unless `device="cpu"`."""

    def __init__(self, config: GaussCtrlConfig, scene: GaussianScene,
                 cameras: Cameras, sd_config: Optional[SDConfig] = None,
                 sd_params: Optional[Dict[str, Any]] = None,
                 dtype=torch.bfloat16, raster_cfg: RasterConfig = RasterConfig(),
                 device=None, weights_seed: int = 0, masker=None, mesh=None):
        self.device = resolve_device(device)
        self.config = config
        self.masker = masker
        self.mesh = mesh
        self.scene = GaussianScene(**{f.name: getattr(scene, f.name).to(self.device)
                                      for f in dataclasses.fields(scene)})
        self.cameras = cameras.to(self.device)
        self.raster_cfg = raster_cfg
        self.sd_config = sd_config or SDConfig.sd15()
        if config.controlnet_ckpt and not config.diffusion_ckpt:
            raise ValueError("controlnet_ckpt is read with diffusion_ckpt; "
                             "set both or neither")
        self.models = SDModels.create(self.sd_config, dtype=torch.float32,
                                      device=self.device)
        if sd_params is not None:
            load_flax_params(self.models, sd_params)
        elif config.diffusion_ckpt:
            load_sd_models(self.models, config.diffusion_ckpt,
                           config.controlnet_ckpt)
        else:
            self.models.init_params(weights_seed)
        # float32 weights (fp16 files are widened exactly) rounded once
        for m in self.models.modules():
            m.to(dtype)
        self.sched = DDIMSchedule.sd15()
        self.tokenizer = load_tokenizer(config.diffusion_ckpt or None,
                                        self.sd_config.text)
        self.ref_indices = select_ref_views(len(cameras), config.ref_view_num,
                                            config.seed)
        self._ctx_cache: Dict[str, torch.Tensor] = {}
        self.unedited: Optional[torch.Tensor] = None   # [V,H,W,3]
        self.depths: Optional[torch.Tensor] = None     # [V,H,W,1]
        self.disparity: Optional[torch.Tensor] = None  # [V,H,W,3]
        self.z_T: Optional[torch.Tensor] = None        # [V,h,w,4]
        self.masks: Optional[torch.Tensor] = None      # [V,H,W,1]
        self.edited: Optional[torch.Tensor] = None     # [V,H,W,3]

    def _diffusion_hw(self) -> tuple[int, int]:
        """The camera size rounded up to the diffusion stack's divisibility:
        the VAE's 8× times the UNet's 2^(levels − 1) (64 for SD-1.5)."""
        div = 8 * 2 ** (len(self.sd_config.unet.block_out_channels) - 1)
        h, w = self.cameras.height, self.cameras.width
        return -(-h // div) * div, -(-w // div) * div

    def _to_diffusion_res(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(x, *self._diffusion_hw())

    def _from_diffusion_res(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear(x, self.cameras.height, self.cameras.width)

    def load_artifacts(self, train_data) -> bool:
        """Adopt precomputed edit artifacts (the resume path): each item of
        `train_data` holds unedited_image, depth_image ([1,H,W] or [H,W,1])
        and z_0_image ([(1,)4,h,w] or [h,w,4]), and optionally mask_image.
        Returns True when every view is covered, so that render_reverse()
        can be skipped."""
        needed = ("unedited_image", "depth_image", "z_0_image")
        if not train_data or not all(all(k in d for k in needed)
                                     for d in train_data):
            return False

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=self.device)

        def fix_depth(x):
            x = t(x)
            if x.ndim == 3 and x.shape[0] == 1:
                x = x[0]
            return x if x.ndim == 3 else x[..., None]

        def fix_z0(x):
            x = t(x)
            if x.ndim == 4:
                x = x[0]
            if x.shape[0] == 4 and x.shape[-1] != 4:
                x = x.permute(1, 2, 0)
            return x

        self.unedited = torch.stack([t(d["unedited_image"]) for d in train_data])
        self.depths = torch.stack([fix_depth(d["depth_image"]) for d in train_data])
        self.z_T = torch.stack([fix_z0(d["z_0_image"]) for d in train_data])
        if all("mask_image" in d for d in train_data):
            m = torch.stack([t(d["mask_image"]) for d in train_data])
            self.masks = m if m.ndim == 4 else m[..., None]
        else:
            self.masks = torch.ones(self.unedited.shape[:3] + (1,),
                                    device=self.device)
        self.disparity = depth_to_disparity(self.depths)
        return True

    def _ctx(self, prompt: str, batch: int) -> torch.Tensor:
        if prompt not in self._ctx_cache:
            ids = torch.tensor(self.tokenizer.encode(prompt)[None],
                               device=self.device)
            self._ctx_cache[prompt] = encode_text(self.models, ids)
        ctx = self._ctx_cache[prompt]
        return ctx.expand(batch, *ctx.shape[1:])

    # -- stage 1: render + invert -------------------------------------------
    @torch.no_grad()
    def render_reverse(self, log_fn=None):
        cams, cfg = self.cameras, self.config
        V = len(cams)
        mine = share_of(list(range(V)), self.mesh)   # this rank's views
        n = len(mine)
        bg = torch.zeros(3, device=self.device)
        rgbs, depths = [], []
        for i in mine:
            out = render_rgbd(self.scene, cams.c2w[i], cams.fx[i], cams.fy[i],
                              cams.cx[i], cams.cy[i], cams.width, cams.height,
                              bg, self.scene.sh_degree, self.raster_cfg)
            rgbs.append(out["rgb"])
            depths.append(out["depth"])
        if log_fn:
            log_fn(f"rendered {n} views")
        unedited, depths = torch.stack(rgbs), torch.stack(depths)
        disparity = depth_to_disparity(depths)

        bs = max(1, min(cfg.render_batch, n))
        z0 = torch.cat([vae_encode(self.models,
                                   self._to_diffusion_res(unedited[lo:lo + bs]))
                        for lo in range(0, n, bs)])
        reverse = cfg.reverse_prompt + POSITIVE_SUFFIX
        proc = FlashSelfAttnProcessor()
        ibs = n if cfg.invert_batch <= 0 else min(cfg.invert_batch, n)
        zs = []
        for lo in range(0, n, ibs):
            hi = min(lo + ibs, n)
            zs.append(invert(self.models, self.sched, z0[lo:hi],
                             self._ctx(reverse, hi - lo),
                             self._to_diffusion_res(disparity[lo:hi]),
                             cfg.num_inference_steps, cfg.conditioning_scale,
                             easyinv_rho=cfg.easyinv_rho,
                             unet_processor=proc, controlnet_processor=proc))
            if log_fn:
                log_fn(f"inverted views {mine[lo]}..{mine[hi - 1]}")
        if cfg.langsam_obj and self.masker is not None:
            masks = self.masker(unedited, cfg.langsam_obj).to(
                self.device, unedited.dtype)
        else:
            masks = torch.ones(unedited.shape[:3] + (1,), dtype=unedited.dtype,
                               device=self.device)
        self.unedited = gather_share(unedited, V, self.mesh)
        self.depths = gather_share(depths, V, self.mesh)
        self.disparity = gather_share(disparity, V, self.mesh)
        self.z_T = gather_share(torch.cat(zs), V, self.mesh)
        self.masks = gather_share(masks, V, self.mesh)
        if cfg.langsam_obj and self.masker is not None and log_fn:
            log_fn(f"masked '{cfg.langsam_obj}' in "
                   f"{int((self.masks.flatten(1).amax(1) > 0).sum())} "
                   f"of {V} views")
        return self

    # -- stage 2: cross-view edit -------------------------------------------
    @torch.no_grad()
    def edit_images(self, log_fn=None):
        assert self.z_T is not None, "run render_reverse() first"
        cfg = self.config
        V = len(self.cameras)
        refs = self.ref_indices
        R = len(refs)
        others = [i for i in range(V) if i not in refs]
        edit_prompt = cfg.edit_prompt + POSITIVE_SUFFIX
        groups = 2 if cfg.guidance_scale > 1.0 else 1

        # allow_fused: every rank runs K3 on its own batch, mesh or not (the
        # JAX package turns it off under a mesh: Pallas has no partition rules)
        def run_batch(z, disp):
            b = z.shape[0]
            return denoise(
                self.models, self.sched, z, self._ctx(edit_prompt, b),
                self._ctx(NEGATIVE_PROMPT, b), disp, cfg.guidance_scale,
                cfg.num_inference_steps, cfg.conditioning_scale,
                unet_processor=CrossViewAttnProcessor(
                    R, cfg.self_attn_coeff, groups, allow_fused=True),
                controlnet_processor=CrossViewAttnProcessor(
                    R, 0.0, groups, allow_fused=True))

        # the ControlNet hint follows the latent geometry
        disparity = self._to_diffusion_res(self.disparity)
        edited: List[Optional[torch.Tensor]] = [None] * V
        if cfg.chunk_size <= 0:
            ref_out, others_out = shard_with_refs(
                run_batch, refs, others, self.mesh, self.z_T, disparity)
            for pos, i in enumerate(refs):
                edited[i] = ref_out[pos]
            for pos, i in enumerate(others):
                edited[i] = others_out[pos]
            if log_fn:
                log_fn(f"edited all {V} views in one batch")
        else:
            world = 1 if self.mesh is None else self.mesh.size()
            rank = 0 if self.mesh is None else self.mesh.get_local_rank()
            owner = [0] * V        # the rank whose chunk edits each view
            ref_z, ref_disp = self.z_T[refs], disparity[refs]
            for c, lo in enumerate(range(0, len(others), cfg.chunk_size)):
                chunk = others[lo:lo + cfg.chunk_size]
                for i in chunk:
                    owner[i] = c % world
                if c % world != rank:
                    continue
                out = run_batch(torch.cat([ref_z, self.z_T[chunk]]),
                                torch.cat([ref_disp, disparity[chunk]]))
                for pos, i in enumerate(chunk):
                    edited[i] = out[R + pos]
                if lo == 0:            # the refs' outputs from the first chunk
                    for pos, i in enumerate(refs):
                        edited[i] = out[pos]
                if log_fn:
                    log_fn(f"edited chunk {chunk}")
            if self.mesh is not None:
                zero = torch.zeros_like(self.z_T[0])
                local = torch.stack([zero if e is None else e for e in edited])
                every = gather_rows(local, self.mesh).reshape(world, *local.shape)
                edited = list(every[torch.tensor(owner, device=self.device),
                                    torch.arange(V, device=self.device)])
        lat = torch.stack(edited)
        mine = share_of(list(range(V)), self.mesh)
        imgs = gather_share(vae_decode(self.models, lat[mine]), V, self.mesh)
        imgs = self._from_diffusion_res(imgs)
        m = self.masks
        self.edited = m * imgs + (1.0 - m) * self.unedited
        return self

    # -- stage 3: re-optimisation -------------------------------------------
    def reoptimize(self, num_steps: Optional[int] = None,
                   train_cfg: TrainConfig = TrainConfig(), log_fn=None,
                   ckpt_every: int = 0, ckpt_fn=None,
                   backgrounds: Optional[torch.Tensor] = None):
        """`render_rate` (or `num_steps`) steps against the edits; the
        scene is replaced by the re-optimised one. `backgrounds` [steps, 3]
        replaces the seeded random backgrounds (`splat.trainer.reoptimize`).
        Returns the metrics."""
        assert self.edited is not None, "run edit_images() first"
        steps = num_steps if num_steps is not None else self.config.render_rate
        self.scene, metrics = reoptimize(
            self.scene, self.cameras, self.edited.float(), steps,
            seed=self.config.seed, raster_cfg=self.raster_cfg,
            train_cfg=train_cfg, log_fn=log_fn, ckpt_every=ckpt_every,
            ckpt_fn=ckpt_fn, backgrounds=backgrounds)
        return metrics

    def run(self, log_fn=None, train_cfg: TrainConfig = TrainConfig(),
            backgrounds: Optional[torch.Tensor] = None):
        """The whole edit: render_reverse → edit_images → reoptimize."""
        self.render_reverse(log_fn)
        self.edit_images(log_fn)
        step_log = None if log_fn is None else (
            lambda step, m: log_fn(f"re-opt step {step}: {m}"))
        return self.reoptimize(train_cfg=train_cfg, log_fn=step_log,
                               backgrounds=backgrounds)
