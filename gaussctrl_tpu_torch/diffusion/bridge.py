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

The segmentation and metric networks are carried the same way, each by its
own renaming of the checkpoint keys onto the JAX tree and the same leaf
rules, decided by the type of the port's module (Linear, Conv2d,
ConvTranspose2d [I,O,kh,kw] ← [kh,kw,I,O], norms, Embedding tables as they
are, any other parameter as it is):

  load_sam_params    `seg.sam.SAM` ← {image_encoder, prompt_encoder,
                     mask_decoder} (`gaussctrl_tpu.seg.sam.SAM.params`)
  load_clip_params   `diffusion.clip.CLIPModel` ← {vision, text,
                     visual_projection, text_projection}
  load_dino_params   `seg.dino.GroundingDINO` ← its flax tree
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import re

import numpy as np
import torch
from torch import nn

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


# ---------------------------------------------------------------------------
# segmentation and metric networks
# ---------------------------------------------------------------------------

def _ident(a):
    return a


def _typed_source(module: nn.Module, key: str, path: str) -> Tuple[str, Callable]:
    """(flax leaf path, converter) for state-dict `key` of `module`, whose
    renamed flax path (leaf name still the torch one) is `path`."""
    prefix, leaf = key.rsplit(".", 1) if "." in key else ("", key)
    mod = module.get_submodule(prefix)
    head = path.rsplit("/", 1)[0]
    if isinstance(mod, nn.Embedding):
        return head, _ident
    if isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
        return head + ("/scale" if leaf == "weight" else "/bias"), _ident
    if leaf == "weight" and isinstance(mod, nn.Linear):
        return head + "/kernel", lambda a: a.T
    if leaf == "weight" and isinstance(mod, nn.ConvTranspose2d):
        return head + "/kernel", lambda a: a.transpose(2, 3, 0, 1)
    if leaf == "weight" and isinstance(mod, nn.Conv2d):
        return head + "/kernel", lambda a: a.transpose(3, 2, 0, 1)
    return path, _ident


def _renamer(rules):
    def rename(path: str) -> str:
        for pat, rep in rules:
            path = re.sub(pat, rep, path)
        return path
    return rename


def _hyper(m):
    return f"hyper_{m.group(1)}_lin{int(m.group(2)) + 1}"


def _plus_one(name):
    return lambda m: f"{name}{int(m.group(1)) + 1}"


_SAM_RENAME = _renamer([
    (r"patch_embed/proj/", "patch_embed/"),
    (r"/mlp/lin", "/mlp_lin"),
    (r"neck_0/", "neck_conv1/"), (r"neck_1/", "neck_ln1/"),
    (r"neck_2/", "neck_conv2/"), (r"neck_3/", "neck_ln2/"),
    (r"pe_layer/positional_encoding_gaussian_matrix", "pe_gaussian"),
    (r"^mask_decoder/transformer/", "mask_decoder/"),
    (r"cross_attn_token_to_image", "cross_attn_t2i"),
    (r"cross_attn_image_to_token", "cross_attn_i2t"),
    (r"final_attn_token_to_image", "final_attn"),
    (r"norm_final_attn", "norm_final"),
    (r"output_upscaling_0/", "upscale_conv1/"),
    (r"output_upscaling_1/", "upscale_ln/"),
    (r"output_upscaling_3/", "upscale_conv2/"),
    (r"output_hypernetworks_mlps_(\d+)/layers_(\d+)", _hyper),
    (r"iou_prediction_head/layers_(\d+)", _plus_one("iou_lin")),
])


def _sam_source(module, key):
    m = re.match(r"prompt_encoder\.point_embeddings\.(\d)\.weight$", key)
    if m:
        i = int(m.group(1))
        return "prompt_encoder/point_embed", lambda a: a[i:i + 1]
    if key == "prompt_encoder.no_mask_embed.weight":
        return "prompt_encoder/no_mask_embed", lambda a: a[None]
    return _typed_source(module, key, _SAM_RENAME(_merge_indices(key)))


_VISION_RENAME = _renamer([
    (r"^vision_model/", "vision/"), (r"/embeddings/", "/"),
    (r"/encoder/layers_", "/layers_"), (r"/mlp/", "/"),
])


def _clip_source(module, key):
    if key in ("visual_projection.weight", "text_projection.weight"):
        return key.split(".")[0], lambda a: a.T
    path = _merge_indices(key)
    if key.startswith("text_model."):
        flat = "text/" + _rename_text(path)
        if flat == "text/position_embedding":
            return flat, _ident
        if flat.endswith("token_embedding/weight"):
            return flat.replace("/weight", "/embedding"), _ident
        return _typed_source(module, key, flat)
    return _typed_source(module, key, _VISION_RENAME(path))


def _bert_sub(m):
    return {"attention/self/query": "q", "attention/self/key": "k",
            "attention/self/value": "v", "attention/output/dense": "attn_out",
            "attention/output/LayerNorm": "attn_norm",
            "intermediate/dense": "ff1", "output/dense": "ff2",
            "output/LayerNorm": "ff_norm"}[m.group(2)]


_DINO_RENAME = _renamer([
    (r"^backbone_0/patch_embed/proj/", "backbone/patch_embed/"),
    (r"^backbone_0/patch_embed/norm/", "backbone/patch_norm/"),
    (r"^backbone_0/layers_(\d+)/blocks_(\d+)/", r"backbone/stage\1_block\2/"),
    (r"/mlp/fc", "/mlp_fc"),
    (r"^backbone_0/layers_(\d+)/downsample/", r"backbone/downsample\1/"),
    (r"^backbone_0/norm(\d+)/", r"backbone/out_norm\1/"),
    (r"^input_proj_(\d+)_0/", r"input_proj\1_conv/"),
    (r"^input_proj_(\d+)_1/", r"input_proj\1_gn/"),
    (r"^bert/embeddings/LayerNorm/", "bert/embed_norm/"),
    (r"^bert/embeddings/", "bert/"),
    (r"^bert/encoder/layer_(\d+)/(attention/self/query|attention/self/key|"
     r"attention/self/value|attention/output/dense|attention/output/LayerNorm|"
     r"intermediate/dense|output/dense|output/LayerNorm)/",
     lambda m: f"bert/layer{m.group(1)}/{_bert_sub(m)}/"),
    (r"^transformer/level_embed", "level_embed"),
    (r"^transformer/encoder/layers_(\d+)/", r"enc\1/"),
    (r"^transformer/encoder/text_layers_(\d+)/self_attn/", r"enc\1/text_attn/"),
    (r"^transformer/encoder/text_layers_(\d+)/linear(\d)/", r"enc\1/text_ff\2/"),
    (r"^transformer/encoder/text_layers_(\d+)/norm(\d)/", r"enc\1/text_norm\2/"),
    (r"^transformer/encoder/fusion_layers_(\d+)/attn/", r"enc\1/fusion/"),
    (r"^transformer/encoder/fusion_layers_(\d+)/", r"enc\1/fusion/"),
    (r"^transformer/enc_out_bbox_embed/layers_(\d+)/", r"enc_out_bbox_embed/lin\1/"),
    (r"^transformer/(enc_output|enc_output_norm|tgt_embed)/", r"\1/"),
    (r"^transformer/decoder/layers_(\d+)/", r"dec\1/"),
    (r"^transformer/decoder/ref_point_head/layers_(\d+)/", r"ref_point_head/lin\1/"),
    (r"^transformer/decoder/norm/", "dec_norm/"),
    (r"^bbox_embed_0/layers_(\d+)/", r"bbox_embed/lin\1/"),
])


def _dino_source(module, key):
    return _typed_source(module, key, _DINO_RENAME(_merge_indices(key)))


@torch.no_grad()
def carry_tree(module: nn.Module, tree: Dict[str, Any], source,
               what: str) -> None:
    """Fill every parameter and persistent buffer of `module` from the flax
    `tree`; `source(module, key)` gives each key's leaf path and converter.
    Raises on a missing leaf, a shape that differs or a leaf left unused."""
    flat = _flatten(tree)
    used = set()
    for key, param in module.state_dict().items():
        path, convert = source(module, key)
        if path not in flat:
            raise KeyError(f"{what}: no flax leaf {path!r} for {key!r}")
        arr = np.ascontiguousarray(convert(flat[path]))
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{what}: {key} wants {tuple(param.shape)}, flax "
                             f"{path} gives {arr.shape}")
        param.copy_(torch.tensor(arr, dtype=param.dtype))
        used.add(path)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"{what}: flax leaves left unused: {unused[:8]}"
                       f"{' …' if len(unused) > 8 else ''}")


def load_sam_params(sam, params_np: Dict[str, Any]) -> None:
    """`seg.sam.SAM` ← the JAX SAM's {image_encoder, prompt_encoder,
    mask_decoder} tree."""
    carry_tree(sam, params_np, _sam_source, "sam")


def load_clip_params(clip, params_np: Dict[str, Any]) -> None:
    """`diffusion.clip.CLIPModel` ← {vision, text, visual_projection,
    text_projection} (the JAX `load_clip_model` layout)."""
    carry_tree(clip, params_np, _clip_source, "clip")


def load_dino_params(dino, params_np: Dict[str, Any]) -> None:
    """`seg.dino.GroundingDINO` ← the JAX GroundingDINO's tree."""
    carry_tree(dino, params_np, _dino_source, "dino")
