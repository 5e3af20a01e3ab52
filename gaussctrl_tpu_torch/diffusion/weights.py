"""Diffusers checkpoints from disk into the port's networks.

Counterpart of `gaussctrl_tpu/diffusion/weights.py`: the SD-1.5 stack
(`unet/`, `vae/`, `text_encoder/` of a diffusers pipeline directory, and a
ControlNet directory) is read offline from safetensors or torch `.bin`
files. The port's modules carry the diffusers key names
(`diffusion/nn.py`), so loading is a strict `load_state_dict` after a few
renames:

  legacy VAE attention  query/key/value/proj_attn → to_q/to_k/to_v/to_out.0
  [O, I, 1, 1] into a Linear, [O, I] into a 1×1 Conv2d  reshaped
  text_model.embeddings.position_ids  dropped (a buffer, not a weight)
  text encoder keys outside text_model.  skipped (vision tower, projections)

Any other missing or unexpected key raises, naming it. The VAE's mid-block
q/k/v biases load into the port's VAE (the JAX package drops them).

Safetensors files are read by this module itself (an 8-byte little-endian
header length, a JSON header, then raw little-endian bytes), so no
`safetensors` package is needed. F32, F16 and BF16 are read as float32;
integer tensors (a transformers text encoder's I64 `position_ids` buffer)
are read as they are stored, and any other float type raises.
`save_safetensors` writes the same format.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import torch

_ST_FLOATS = {"F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16}
_ST_INTS = {"I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
            "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in {**_ST_FLOATS, **_ST_INTS}.items()}

# stems that name the same weights across library versions; a diffusers
# stem never falls back to a transformers stem or back
_EQUIV_STEMS = {
    "model": ("model", "pytorch_model"),
    "pytorch_model": ("pytorch_model", "model"),
    "diffusion_pytorch_model": ("diffusion_pytorch_model",),
}

_LEGACY_VAE_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v",
                    "proj_attn": "to_out.0"}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """{key: tensor} of a safetensors file: F32, F16 and BF16 as float32,
    integer and bool tensors as stored; other float types raise."""
    raw = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        f.readinto(raw)
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n].decode("utf-8"))
    base = 8 + n
    buf = memoryview(raw)
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        dtype = _ST_FLOATS.get(info["dtype"]) or _ST_INTS.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {key!r} has dtype "
                             f"{info['dtype']}; of the float types only F32, "
                             "F16 and BF16 are read")
        lo, hi = info["data_offsets"]
        shape = tuple(info["shape"])
        if hi > lo:
            t = torch.frombuffer(buf[base + lo:base + hi], dtype=dtype)
        else:
            t = torch.empty((0,), dtype=dtype)
        out[key] = t.reshape(shape).to(
            torch.float32 if dtype.is_floating_point else dtype, copy=True)
    return out


def save_safetensors(path, tensors: Dict[str, torch.Tensor]) -> int:
    """Write {key: tensor} (F32, F16, BF16 or an integer type) as a
    safetensors file; returns the bytes written. The header is padded with
    spaces to 8 bytes."""
    header, blobs, offset = {}, [], 0
    for key, t in tensors.items():
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{key}: dtype {t.dtype} has no safetensors name "
                             "here")
        data = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
        nbytes = data.numel()
        header[key] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + nbytes]}
        blobs.append(data.numpy().tobytes())
        offset += nbytes
    head = json.dumps(header, separators=(",", ":")).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for b in blobs:
            f.write(b)
    return 8 + len(head) + offset


def load_state_dict(model_dir: str, filename_stem: str = "diffusion_pytorch_model"
                    ) -> Dict[str, torch.Tensor]:
    """A flat {key: tensor} from a model directory, floats widened to
    float32 and integer buffers as stored: `{stem}.safetensors` first, then
    `{stem}.bin`, over the stems equivalent to `filename_stem`; a fallback
    stem is logged."""
    stems = _EQUIV_STEMS.get(filename_stem, (filename_stem,))
    tried = []
    for stem in stems:
        st_path = os.path.join(model_dir, f"{stem}.safetensors")
        bin_path = os.path.join(model_dir, f"{stem}.bin")
        tried += [st_path, bin_path]
        if stem != filename_stem and (os.path.exists(st_path)
                                      or os.path.exists(bin_path)):
            print(f"[weights] {model_dir}: '{filename_stem}.*' absent, "
                  f"loading equivalent '{stem}.*'")
        if os.path.exists(st_path):
            return read_safetensors(st_path)
        if os.path.exists(bin_path):
            sd = torch.load(bin_path, map_location="cpu", weights_only=True)
            return {k: v.to(torch.float32) if v.is_floating_point() else v
                    for k, v in sd.items()}
    raise FileNotFoundError(f"no state dict in {model_dir} (tried {tried})")


def _rename_vae(key: str) -> str:
    parts = key.split(".")
    if len(parts) >= 3 and parts[-2] in _LEGACY_VAE_ATTN \
            and "attentions" in parts:
        parts[-2] = _LEGACY_VAE_ATTN[parts[-2]]
        return ".".join(parts)
    return key


def _rename_text(key: str):
    if not key.startswith("text_model."):
        return None
    if key.endswith("embeddings.position_ids"):
        return None
    return key


_RENAMES = {"unet": lambda k: k, "controlnet": lambda k: k,
            "vae": _rename_vae, "text": _rename_text}


@torch.no_grad()
def load_module(module: torch.nn.Module, kind: str,
                sd: Dict[str, torch.Tensor]) -> None:
    """Copy a diffusers/transformers state dict into one network (`kind` ∈
    unet/controlnet/vae/text), strictly: every parameter filled, every
    file key used, shapes equal up to the 1×1 reshape."""
    rename = _RENAMES[kind]
    params = module.state_dict()
    unexpected, seen = [], set()
    for key, value in sd.items():
        name = rename(key)
        if name is None:
            continue
        if name not in params:
            unexpected.append(key)
            continue
        dst = params[name]
        if not value.is_floating_point():
            raise ValueError(f"{kind}: {key} holds {value.dtype}, the "
                             f"module's {name} is a float tensor")
        if value.dim() == 4 and dst.dim() == 2 and value.shape[2:] == (1, 1):
            value = value[:, :, 0, 0]
        elif value.dim() == 2 and dst.dim() == 4 and dst.shape[2:] == (1, 1):
            value = value[:, :, None, None]
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"{kind}: {key} has shape {tuple(value.shape)}, "
                             f"the module's {name} wants {tuple(dst.shape)}")
        dst.copy_(value)
        seen.add(name)
    missing = sorted(set(params) - seen)
    if missing or unexpected:
        raise KeyError(f"{kind}: missing keys {missing[:8]}"
                       f"{' …' if len(missing) > 8 else ''}, unexpected keys "
                       f"{sorted(unexpected)[:8]}"
                       f"{' …' if len(unexpected) > 8 else ''}")


def load_sd_models(models, sd_dir: str, controlnet_dir: str) -> None:
    """Fill `models` (a `sample.SDModels`) from a diffusers SD pipeline
    directory (unet/, vae/, text_encoder/) and a ControlNet directory."""
    if not controlnet_dir:
        raise ValueError("a diffusers checkpoint needs its ControlNet "
                         "directory (controlnet_ckpt)")
    load_module(models.unet, "unet",
                load_state_dict(os.path.join(sd_dir, "unet")))
    load_module(models.vae, "vae", load_state_dict(os.path.join(sd_dir, "vae")))
    load_module(models.text, "text",
                load_state_dict(os.path.join(sd_dir, "text_encoder"), "model"))
    load_module(models.controlnet, "controlnet", load_state_dict(controlnet_dir))
