"""Carry the JAX package's parameter trees into the port's modules.

`load_flax_params(models, params_np)` takes the tree that the JAX package's
`SDModels.init_params` returns (nested dicts of numpy arrays, keys `unet`,
`controlnet`, `vae`, `text`) and fills the port's `nn.Module`s, whose
parameter names are the diffusers/transformers checkpoint keys. The mapping
inverts the JAX package's checkpoint rules (`diffusion/weights.py`):

  diffusers conv  [O,I,kh,kw]  ← flax conv kernel [kh,kw,I,O]
  diffusers linear [O,I]       ← flax dense kernel [I,O]
  1×1 proj_in/proj_out conv    ← flax dense kernel (Transformer2D)
  norm weight/bias             ← scale/bias
  `a.0.b` index segments       ← `a_0/b`; the UNet's encoder half lives
                                 under `encoder/` in the flax tree

Every leaf on both sides must be used exactly once, or it raises, with one
exception: the JAX VAE has no mid-block q/k/v biases, so a tree without
`attn/to_q/bias` (and k, v) leaves sets the port's to zero, and a tree that
has them (`weights.convert_vae` emits them) fills them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

_NORM_HINTS = ("norm", "layer_norm", "group_norm")
_ENCODER_OWNED = ("conv_in/", "time_embedding/", "down_blocks_", "mid_block/")


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(dict(v.items()), p))
        else:
            out[p] = np.asarray(v)
    return out


def _merge_indices(key: str) -> str:
    """'down_blocks.0.resnets.1.conv1.weight' → 'down_blocks_0/resnets_1/conv1/weight'."""
    merged = []
    for p in key.split("."):
        if p.isdigit() and merged:
            merged[-1] = f"{merged[-1]}_{p}"
        else:
            merged.append(p)
    return "/".join(merged)


def _rename_unet(path: str) -> str:
    path = path.replace("/to_out_0/", "/to_out/")
    if path.startswith(_ENCODER_OWNED):
        path = "encoder/" + path
    return path


def _rename_controlnet(path: str) -> str:
    return _rename_unet(path.replace("controlnet_cond_embedding/",
                                     "cond_embedding/"))


def _rename_vae(path: str) -> str:
    for side in ("encoder", "decoder"):
        pre = f"{side}/"
        if path.startswith(pre):
            rest = path[len(pre):]
            if rest.startswith(("down_blocks_", "up_blocks_")):
                rest = rest.replace("/resnets_", "_resnets_", 1)
            rest = rest.replace("/downsamplers_0/conv", "_downsample", 1)
            rest = rest.replace("/upsamplers_0/conv", "_upsample/conv", 1)
            path = pre + rest
    for name in ("to_q", "to_k", "to_v"):
        path = path.replace(f"/attentions_0/{name}/", f"/attentions_0/attn/{name}/")
    return path.replace("/attentions_0/to_out_0/", "/attentions_0/attn/to_out/")


def _rename_text(path: str) -> str:
    path = path[len("text_model/"):]
    path = path.replace("embeddings/token_embedding", "token_embedding")
    path = path.replace("embeddings/position_embedding/weight",
                        "position_embedding")
    path = path.replace("encoder/layers_", "layers_")
    return path.replace("/mlp/", "/")


_RENAME: Dict[str, Tuple[Callable[[str], str], Tuple[str, ...]]] = {
    "unet": (_rename_unet, ("proj_in", "proj_out")),
    "controlnet": (_rename_controlnet, ("proj_in", "proj_out")),
    "vae": (_rename_vae, ()),
    "text": (_rename_text, ()),
}


def flax_source(kind: str, key: str, shape) -> Tuple[str, Callable]:
    """(flax leaf path, flax array → torch array) for one state-dict key."""
    rename, dense_1x1_mods = _RENAME[kind]
    path = rename(_merge_indices(key))
    if kind == "text":
        if path == "position_embedding":
            return path, lambda a: a
        if path.endswith("token_embedding/weight"):
            return path.replace("/weight", "/embedding"), lambda a: a
    head, leaf = path.rsplit("/", 1)
    last_mod = head.rsplit("/", 1)[-1]
    ndim = len(shape)
    if leaf == "bias":
        return head + "/bias", lambda a: a
    if any(h in last_mod for h in _NORM_HINTS) and ndim == 1:
        return head + "/scale", lambda a: a
    if ndim == 4:
        dense_1x1 = any(path.endswith(f"{m}/weight") or f"/{m}/" in path
                        for m in dense_1x1_mods)
        if dense_1x1 and shape[2] == shape[3] == 1:
            return head + "/kernel", lambda a: a.T[:, :, None, None]
        return head + "/kernel", lambda a: a.transpose(3, 2, 0, 1)
    if ndim == 2:
        return head + "/kernel", lambda a: a.T
    return head + "/scale", lambda a: a


def _is_vae_qkv_bias(path: str) -> bool:
    return path.endswith(("/attn/to_q/bias", "/attn/to_k/bias",
                          "/attn/to_v/bias"))


@torch.no_grad()
def load_module(module: torch.nn.Module, kind: str,
                tree: Dict[str, Any]) -> None:
    """Fill one network (`kind` ∈ unet/controlnet/vae/text) from its tree."""
    flat = _flatten(tree)
    used = set()
    for key, param in module.state_dict().items():
        path, convert = flax_source(kind, key, tuple(param.shape))
        if path not in flat and kind == "vae" and _is_vae_qkv_bias(path):
            param.zero_()
            continue
        if path not in flat:
            raise KeyError(f"{kind}: no flax leaf {path!r} for {key!r}")
        arr = np.ascontiguousarray(convert(flat[path]))
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{kind}: {key} wants {tuple(param.shape)}, flax "
                             f"{path} gives {arr.shape}")
        param.copy_(torch.tensor(arr, dtype=param.dtype))
        used.add(path)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"{kind}: flax leaves left unused: {unused[:8]}"
                       f"{' …' if len(unused) > 8 else ''}")


def load_flax_params(models, params_np: Dict[str, Any]) -> None:
    """Fill `models` (a `sample.SDModels`) from the JAX package's parameter
    tree as nested dicts of numpy arrays. Raises on any unused leaf."""
    if set(params_np) != {"unet", "controlnet", "vae", "text"}:
        raise KeyError(f"expected unet/controlnet/vae/text, got {sorted(params_np)}")
    load_module(models.unet, "unet", params_np["unet"])
    load_module(models.controlnet, "controlnet", params_np["controlnet"])
    load_module(models.vae, "vae", params_np["vae"])
    load_module(models.text, "text", params_np["text"])
