"""Inference loops: ControlNet-guided DDIM denoise and DDIM inversion.

Counterpart of `gaussctrl_tpu/diffusion/sample.py`. The public functions
keep the JAX package's NHWC layout at their boundaries and run NCHW inside;
the 20-step `lax.scan` becomes a Python loop, CFG is an explicit doubled
batch [uncond | cond] (the layout `CrossViewAttnProcessor` expects), and the
ControlNet hint is embedded once per loop, outside the steps.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from gaussctrl_tpu_torch.device import resolve_device
from gaussctrl_tpu_torch.diffusion.clip import CLIPTextModel
from gaussctrl_tpu_torch.diffusion.config import SDConfig
from gaussctrl_tpu_torch.diffusion.controlnet import ControlNet, zero_init_convs
from gaussctrl_tpu_torch.diffusion.ddim import (DDIMSchedule, ddim_inverse_step,
                                                ddim_step, timestep_pairs)
from gaussctrl_tpu_torch.diffusion.unet import UNet
from gaussctrl_tpu_torch.diffusion.vae import VAE


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


_TRUNC = 0.87962566103423978   # std of a unit normal truncated to [-2, 2]


def _trunc_normal_(w: torch.Tensor, std: float, g: torch.Generator) -> None:
    """Normal(0, std) truncated to ±2 std by inverting the CDF."""
    a = math.erf(2.0 / math.sqrt(2.0))
    w.uniform_(-a, a, generator=g).erfinv_().mul_(std * math.sqrt(2.0))


@dataclasses.dataclass
class SDModels:
    """The four networks of the stack (inference only, eval mode)."""
    cfg: SDConfig
    unet: UNet
    controlnet: ControlNet
    vae: VAE
    text: CLIPTextModel

    @classmethod
    def create(cls, cfg: SDConfig, dtype=torch.float32,
               device=None) -> "SDModels":
        dev = resolve_device(device)
        with dev:      # build on the device (SD-1.5 holds 1.3 G parameters)
            m = cls(cfg, UNet(cfg.unet), ControlNet(cfg.controlnet),
                    VAE(cfg.vae), CLIPTextModel(cfg.text))
        for mod in m.modules():
            mod.to(device=dev, dtype=dtype).eval().requires_grad_(False)
        return m

    def modules(self):
        return (self.unet, self.controlnet, self.vae, self.text)

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> None:
        """Random weights as flax initialises them: lecun-normal (truncated)
        kernels, zero biases, unit norms, N(0, 1/V) token and N(0, 0.01²)
        position embeddings, zeroed ControlNet output convs. Drawn in
        float32 from one seeded generator on the models' device."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        for model in self.modules():
            for mod in model.modules():
                if isinstance(mod, (nn.Linear, nn.Conv2d)):
                    w = torch.empty(mod.weight.shape, device=self.device)
                    fan_in = mod.weight[0].numel()
                    _trunc_normal_(w, 1.0 / math.sqrt(fan_in) / _TRUNC, g)
                    mod.weight.copy_(w)
                    if mod.bias is not None:
                        mod.bias.zero_()
                elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
            emb = model.text_model.embeddings if model is self.text else None
            if emb is not None:
                v = emb.token_embedding.weight
                w = torch.empty(v.shape, device=self.device)
                emb.token_embedding.weight.copy_(
                    w.normal_(generator=g) / math.sqrt(v.shape[0]))
                w = torch.empty(emb.position_embedding.weight.shape,
                                device=self.device)
                emb.position_embedding.weight.copy_(w.normal_(generator=g) * 0.01)
        zero_init_convs(self.controlnet)


@torch.no_grad()
def encode_text(models: SDModels, input_ids: torch.Tensor) -> torch.Tensor:
    return models.text(input_ids.to(models.device, torch.long))


@torch.no_grad()
def vae_encode(models: SDModels, images: torch.Tensor) -> torch.Tensor:
    """images [B,H,W,3] in [0,1] → scaled latents [B,H/8,W/8,4]."""
    return nchw_to_nhwc(models.vae.encode(nhwc_to_nchw(images) * 2.0 - 1.0))


@torch.no_grad()
def vae_decode(models: SDModels, latents: torch.Tensor) -> torch.Tensor:
    """scaled latents [B,h,w,4] → images [B,8h,8w,3] in [0,1]."""
    img = models.vae.decode(nhwc_to_nchw(latents))
    return nchw_to_nhwc(torch.clamp(img * 0.5 + 0.5, 0.0, 1.0))


@torch.no_grad()
def embed_hint(models: SDModels, cond_image: torch.Tensor) -> torch.Tensor:
    """The ControlNet's hint ladder alone, [B,H,W,3] → [B,h,w,C0]. The hint
    does not depend on the timestep, so the loops embed it once."""
    emb = models.controlnet.controlnet_cond_embedding
    return nchw_to_nhwc(emb(nhwc_to_nchw(cond_image).to(models.dtype)))


def _eps(models: SDModels, x, t: int, context, hint, conditioning_scale,
         unet_processor, controlnet_processor):
    """ControlNet residuals + UNet epsilon, NCHW in and out."""
    tb = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
    down, mid = models.controlnet(x, tb, context, None, conditioning_scale,
                                  controlnet_processor, hint=hint)
    return models.unet(x, tb, context, unet_processor, down, mid)


@torch.no_grad()
def eps_model(models: SDModels, latents, t: int, context, cond_image=None,
              conditioning_scale: float = 1.0, unet_processor=None,
              controlnet_processor=None, hint=None) -> torch.Tensor:
    """ControlNet residuals + UNet epsilon for one timestep (NHWC)."""
    if hint is None:
        hint = embed_hint(models, cond_image)
    eps = _eps(models, nhwc_to_nchw(latents), t, context, nhwc_to_nchw(hint),
               conditioning_scale, unet_processor, controlnet_processor)
    return nchw_to_nhwc(eps)


@torch.no_grad()
def invert(models: SDModels, sched: DDIMSchedule, latents, context,
           cond_image, num_steps: int = 20, conditioning_scale: float = 1.0,
           easyinv_rho: float = 0.0, easyinv_t_min: int = 400,
           unet_processor=None, controlnet_processor=None) -> torch.Tensor:
    """DDIM inversion z_0 → z_T with guidance 0, walking the denoise pairs
    in ascending t; `easyinv_rho` > 0 blends high-noise iterates with the
    previous one (EasyInv), 0 is the reference behaviour. NHWC in and out."""
    ts, ts_prev = timestep_pairs(num_steps)
    hint = nhwc_to_nchw(embed_hint(models, cond_image))
    context = context.to(models.dtype)
    x = nhwc_to_nchw(latents)
    for t, t_prev in zip(ts[::-1], ts_prev[::-1]):
        eps = _eps(models, x, t, context, hint, conditioning_scale,
                   unet_processor, controlnet_processor)
        x_new = ddim_inverse_step(sched, x, eps.to(x.dtype), t, t_prev)
        if easyinv_rho > 0.0 and t >= easyinv_t_min:
            x_new = easyinv_rho * x_new + (1 - easyinv_rho) * x
        x = x_new
    return nchw_to_nhwc(x)


@torch.no_grad()
def denoise(models: SDModels, sched: DDIMSchedule, latents, context_pos,
            context_neg, cond_image, guidance_scale: float = 5.0,
            num_steps: int = 20, conditioning_scale: float = 1.0,
            unet_processor=None, controlnet_processor=None) -> torch.Tensor:
    """CFG DDIM denoise z_T → z_0 (eta 0). The batch doubles to
    [uncond | cond] inside each step. NHWC in and out."""
    ts, ts_prev = timestep_pairs(num_steps)
    guided = guidance_scale > 1.0
    context = torch.cat([context_neg, context_pos]) if guided else context_pos
    context = context.to(models.dtype)
    hint = nhwc_to_nchw(embed_hint(models, cond_image))
    if guided:
        hint = torch.cat([hint, hint])
    x = nhwc_to_nchw(latents)
    for t, t_prev in zip(ts, ts_prev):
        xin = torch.cat([x, x]) if guided else x
        eps = _eps(models, xin, t, context, hint, conditioning_scale,
                   unet_processor, controlnet_processor)
        if guided:
            eps_u, eps_c = eps.chunk(2)
            eps = eps_u + guidance_scale * (eps_c - eps_u)
        x = ddim_step(sched, x, eps.to(x.dtype), t, t_prev)
    return nchw_to_nhwc(x)
