"""The GaussCtrl editing method: render + invert, then the cross-view edit.

Counterpart of `gaussctrl_tpu/pipeline/gaussctrl.py` (stages 1 and 2;
re-optimisation belongs to a later slice):

  render_reverse  renders every view's RGB and depth (kernel K1 per view on
                  the card), VAE-encodes the renders and DDIM-inverts them
                  under the reverse prompt with guidance 0; every UNet and
                  ControlNet self-attention goes through kernel K2.
  edit_images     denoises with CFG under the edit prompt while every
                  self-attention also attends to the reference views
                  (kernel K3), either in reference-style chunks with the refs
                  prepended (`chunk_size` > 0) or all views at once
                  (`chunk_size` = 0); then VAE-decodes and composites under
                  the masks (all ones: text-prompted segmentation is not
                  part of this port yet).

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

from gaussctrl_tpu_torch.cameras.camera import Cameras
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
from gaussctrl_tpu_torch.splat.rasterize import RasterConfig
from gaussctrl_tpu_torch.splat.render import render_rgbd
from gaussctrl_tpu_torch.splat.scene import GaussianScene


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
    with `bridge.load_flax_params`; None draws random weights from
    `weights_seed`. Runs on the card unless `device="cpu"`."""

    def __init__(self, config: GaussCtrlConfig, scene: GaussianScene,
                 cameras: Cameras, sd_config: Optional[SDConfig] = None,
                 sd_params: Optional[Dict[str, Any]] = None,
                 dtype=torch.bfloat16, raster_cfg: RasterConfig = RasterConfig(),
                 device=None, weights_seed: int = 0):
        self.device = resolve_device(device)
        self.config = config
        self.scene = GaussianScene(**{f.name: getattr(scene, f.name).to(self.device)
                                      for f in dataclasses.fields(scene)})
        self.cameras = cameras.to(self.device)
        self.raster_cfg = raster_cfg
        self.sd_config = sd_config or SDConfig.sd15()
        div = 8 * 2 ** (len(self.sd_config.unet.block_out_channels) - 1)
        if cameras.height % div or cameras.width % div:
            raise ValueError(
                f"camera size {cameras.width}x{cameras.height} is not a "
                f"multiple of {div}; resizing into the diffusion stack is "
                f"not ported yet")
        if config.diffusion_ckpt or config.controlnet_ckpt:
            raise NotImplementedError("loading diffusers checkpoints is not "
                                      "ported yet; pass sd_params or none")
        self.models = SDModels.create(self.sd_config, dtype=torch.float32,
                                      device=self.device)
        if sd_params is not None:
            load_flax_params(self.models, sd_params)
        else:
            self.models.init_params(weights_seed)
        for m in self.models.modules():
            m.to(dtype)
        self.sched = DDIMSchedule.sd15()
        self.tokenizer = load_tokenizer(None, self.sd_config.text)
        self.ref_indices = select_ref_views(len(cameras), config.ref_view_num,
                                            config.seed)
        self._ctx_cache: Dict[str, torch.Tensor] = {}
        self.unedited: Optional[torch.Tensor] = None   # [V,H,W,3]
        self.depths: Optional[torch.Tensor] = None     # [V,H,W,1]
        self.disparity: Optional[torch.Tensor] = None  # [V,H,W,3]
        self.z_T: Optional[torch.Tensor] = None        # [V,h,w,4]
        self.masks: Optional[torch.Tensor] = None      # [V,H,W,1]
        self.edited: Optional[torch.Tensor] = None     # [V,H,W,3]

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
        bg = torch.zeros(3, device=self.device)
        rgbs, depths = [], []
        for i in range(V):
            out = render_rgbd(self.scene, cams.c2w[i], cams.fx[i], cams.fy[i],
                              cams.cx[i], cams.cy[i], cams.width, cams.height,
                              bg, self.scene.sh_degree, self.raster_cfg)
            rgbs.append(out["rgb"])
            depths.append(out["depth"])
        if log_fn:
            log_fn(f"rendered {V} views")
        self.unedited = torch.stack(rgbs)
        self.depths = torch.stack(depths)
        self.disparity = depth_to_disparity(self.depths)

        bs = max(1, min(cfg.render_batch, V))
        z0 = torch.cat([vae_encode(self.models, self.unedited[lo:lo + bs])
                        for lo in range(0, V, bs)])
        reverse = cfg.reverse_prompt + POSITIVE_SUFFIX
        proc = FlashSelfAttnProcessor()
        ibs = V if cfg.invert_batch <= 0 else min(cfg.invert_batch, V)
        zs = []
        for lo in range(0, V, ibs):
            hi = min(lo + ibs, V)
            zs.append(invert(self.models, self.sched, z0[lo:hi],
                             self._ctx(reverse, hi - lo), self.disparity[lo:hi],
                             cfg.num_inference_steps, cfg.conditioning_scale,
                             easyinv_rho=cfg.easyinv_rho,
                             unet_processor=proc, controlnet_processor=proc))
            if log_fn:
                log_fn(f"inverted views {lo}..{hi - 1}")
        self.z_T = torch.cat(zs)
        self.masks = torch.ones(self.unedited.shape[:3] + (1,),
                                dtype=self.unedited.dtype, device=self.device)
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

        def run_batch(z, disp):
            b = z.shape[0]
            return denoise(
                self.models, self.sched, z, self._ctx(edit_prompt, b),
                self._ctx(NEGATIVE_PROMPT, b), disp, cfg.guidance_scale,
                cfg.num_inference_steps, cfg.conditioning_scale,
                unet_processor=CrossViewAttnProcessor(R, cfg.self_attn_coeff,
                                                      groups),
                controlnet_processor=CrossViewAttnProcessor(R, 0.0, groups))

        edited: List[Optional[torch.Tensor]] = [None] * V
        if cfg.chunk_size <= 0:
            order = refs + others
            out = run_batch(self.z_T[order], self.disparity[order])
            for pos, i in enumerate(order):
                edited[i] = out[pos]
            if log_fn:
                log_fn(f"edited all {V} views in one batch")
        else:
            ref_z, ref_disp = self.z_T[refs], self.disparity[refs]
            for lo in range(0, len(others), cfg.chunk_size):
                chunk = others[lo:lo + cfg.chunk_size]
                out = run_batch(torch.cat([ref_z, self.z_T[chunk]]),
                                torch.cat([ref_disp, self.disparity[chunk]]))
                for pos, i in enumerate(chunk):
                    edited[i] = out[R + pos]
                if lo == 0:            # the refs' outputs from the first chunk
                    for pos, i in enumerate(refs):
                        edited[i] = out[pos]
                if log_fn:
                    log_fn(f"edited chunk {chunk}")
        lat = torch.stack(edited)
        imgs = vae_decode(self.models, lat)
        m = self.masks
        self.edited = m * imgs + (1.0 - m) * self.unedited
        return self
