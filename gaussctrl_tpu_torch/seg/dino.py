"""GroundingDINO (Swin-B), open-vocabulary text-conditioned detection.

Counterpart of `gaussctrl_tpu/seg/dino.py`, as torch.nn modules named after
the official `groundingdino_swinb_cogcoor.pth` keys (`backbone.0.layers.0.
blocks.0.attn.qkv`, `transformer.encoder.fusion_layers.0.attn.v_proj`, ...):

  * a Swin backbone (window 12, stages (2,2,18,2)) giving three feature
    levels, plus one stride-2 convolution level, all projected to d = 256;
  * BERT with per-phrase attention masks and position ids;
  * the feature enhancer: image<->text bi-attention, text self-attention,
    multi-scale deformable image self-attention;
  * language-guided query selection (the top `num_queries` locations by
    their best text logit) into a box-refining decoder, with dot-product
    logits against the text.

The computation is the JAX package's, in float32: flax's LayerNorm and
GroupNorm eps (1e-6; BERT's 1e-12), exact GELU, the fixed square input
whose every Swin stage tiles the window, and the deformable sampling as
`F.grid_sample` (bilinear, zero padding, align_corners=False), which is what
the JAX package's gathers compute.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussctrl_tpu_torch.core.init import random_init_
from gaussctrl_tpu_torch.device import at_least_fp32 as _up
from gaussctrl_tpu_torch.device import exact_fp32

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DinoConfig:
    img_size: int = 768               # 768 = 2·12·32: every level tiles window 12
    patch_size: int = 4
    swin_dim: int = 128
    swin_depths: Tuple[int, ...] = (2, 2, 18, 2)
    swin_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window: int = 12
    out_indices: Tuple[int, ...] = (1, 2, 3)
    d_model: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_ff: int = 2048
    num_queries: int = 900
    num_points: int = 4
    vocab_size: int = 30522
    bert_hidden: int = 768
    bert_layers: int = 12
    bert_heads: int = 12
    bert_ff: int = 3072
    max_text_len: int = 256

    @property
    def num_levels(self) -> int:
        return len(self.out_indices) + 1

    @classmethod
    def swin_b(cls) -> "DinoConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "DinoConfig":
        return cls(img_size=64, swin_dim=16, swin_depths=(1, 1), swin_heads=(2, 2),
                   window=2, out_indices=(0, 1), d_model=32, nheads=4,
                   enc_layers=1, dec_layers=2, dim_ff=64, num_queries=20,
                   vocab_size=64, bert_hidden=32, bert_layers=1, bert_heads=2,
                   bert_ff=64, max_text_len=16)


def _ln(d: int, eps: float = LN_EPS) -> nn.LayerNorm:
    return nn.LayerNorm(d, eps=eps)


def _softmax32(x):
    return torch.softmax(_up(x), -1)


# --------------------------------------------------------------------------
# Swin backbone
# --------------------------------------------------------------------------

class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        w = window
        coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                      indexing="ij")).reshape(2, -1)
        rel = coords[:, :, None] - coords[:, None, :] + (w - 1)
        self.register_buffer("_index", torch.as_tensor(
            rel[0] * (2 * w - 1) + rel[1], dtype=torch.long), persistent=False)

    def forward(self, x, mask=None):
        """x [nW, w*w, C]; mask [nGroups, w*w, w*w] or None."""
        nw, t, c = x.shape
        hd = c // self.heads
        qkv = self.qkv(x).reshape(nw, t, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                     # [nW, h, t, hd]
        attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
        attn = attn + self.relative_position_bias_table[self._index].permute(
            2, 0, 1)[None]
        if mask is not None:
            g = mask.shape[0]
            attn = (attn.reshape(nw // g, g, self.heads, t, t)
                    + mask[None, :, None]).reshape(nw, self.heads, t, t)
        out = _softmax32(attn).to(v.dtype) @ v
        return self.proj(out.transpose(1, 2).reshape(nw, t, c))


class _SwinMlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _shift_mask(h, w, ws, shift):
    """Attention mask for shifted windows: [nW_per_img, ws*ws, ws*ws]."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs_ in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, vs_] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3
                                                          ).reshape(-1, ws * ws)
    diff = win[:, :, None] != win[:, None, :]
    return np.where(diff, -1e9, 0.0).astype(np.float32)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = _ln(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = _ln(dim)
        self.mlp = _SwinMlp(dim)

    def forward(self, x):                                       # [B, H, W, C]
        b, h, w, c = x.shape
        ws, s = self.window, self.shift
        res = x
        x = self.norm1(x)
        if s:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
        xw = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        mask = None
        if s:
            mask = torch.as_tensor(_shift_mask(h, w, ws, s), device=x.device)
        x = self.attn(xw, mask)
        x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(
            0, 1, 3, 2, 4, 5).reshape(b, h, w, c)
        if s:
            x = torch.roll(x, (s, s), dims=(1, 2))
        x = res + x
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = _ln(4 * dim)

    def forward(self, x):                                       # [B, H, W, C]
        # the official order: (0::2,0::2), (1::2,0::2), (0::2,1::2), (1::2,1::2)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x))


class _SwinStage(nn.Module):
    def __init__(self, dim, depth, heads, window, last):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinBlock(dim, heads, window, 0 if b % 2 == 0 else window // 2)
            for b in range(depth)])
        self.downsample = None if last else PatchMerging(dim)


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.swin_dim, cfg.patch_size, cfg.patch_size)
        self.norm = _ln(cfg.swin_dim)


class SwinBackbone(nn.Module):
    """Swin encoder returning the `out_indices` stage maps (NHWC)."""

    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = _PatchEmbed(cfg)
        n = len(cfg.swin_depths)
        self.layers = nn.ModuleList([
            _SwinStage(cfg.swin_dim * 2 ** s, depth, cfg.swin_heads[s],
                       cfg.window, s == n - 1)
            for s, depth in enumerate(cfg.swin_depths)])
        for s in cfg.out_indices:
            self.add_module(f"norm{s}", _ln(cfg.swin_dim * 2 ** s))

    def forward(self, x):                                       # [B, H, W, 3]
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = self.patch_embed.norm(x)
        outs = []
        for s, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x)
            if s in self.cfg.out_indices:
                outs.append(getattr(self, f"norm{s}")(x))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


# --------------------------------------------------------------------------
# BERT with per-phrase masking
# --------------------------------------------------------------------------

class _BertEmbeddings(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.bert_hidden)
        self.position_embeddings = nn.Embedding(512, cfg.bert_hidden)
        self.token_type_embeddings = nn.Embedding(2, cfg.bert_hidden)
        self.LayerNorm = _ln(cfg.bert_hidden, 1e-12)


class _Dense(nn.Module):
    """`dense` (+ `LayerNorm`): the BERT output sublayers' names."""

    def __init__(self, din: int, dout: int, norm: bool):
        super().__init__()
        self.dense = nn.Linear(din, dout)
        if norm:
            self.LayerNorm = _ln(dout, 1e-12)


class _BertSelf(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class _BertAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.self = _BertSelf(d)
        self.output = _Dense(d, d, True)


class BertLayer(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.heads = cfg.bert_heads
        self.attention = _BertAttention(cfg.bert_hidden)
        self.intermediate = _Dense(cfg.bert_hidden, cfg.bert_ff, False)
        self.output = _Dense(cfg.bert_ff, cfg.bert_hidden, True)

    def forward(self, x, attn_bias):                   # [B,T,C], [B,1,T,T]
        b, t, c = x.shape
        hd = c // self.heads
        sa = self.attention.self
        q, k, v = (m(x).reshape(b, t, self.heads, hd).transpose(1, 2)
                   for m in (sa.query, sa.key, sa.value))
        attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
        out = (_softmax32(attn + attn_bias).to(v.dtype) @ v)
        out = out.transpose(1, 2).reshape(b, t, c)
        ao = self.attention.output
        x = ao.LayerNorm(x + ao.dense(out))
        y = self.output.dense(F.gelu(self.intermediate.dense(x)))
        return self.output.LayerNorm(x + y)


class _BertEncoder(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg)
                                    for _ in range(cfg.bert_layers)])


class BertEncoder(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.embeddings = _BertEmbeddings(cfg)
        self.encoder = _BertEncoder(cfg)

    def forward(self, ids, position_ids, attn_mask):
        """ids [B,T]; position_ids [B,T]; attn_mask [B,T,T] bool (True=attend)."""
        e = self.embeddings
        x = (e.word_embeddings(ids) + e.position_embeddings(position_ids)
             + e.token_type_embeddings(torch.zeros_like(ids)))
        x = e.LayerNorm(x)
        bias = torch.where(attn_mask[:, None], 0.0, -1e9)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


def phrase_masks(ids: np.ndarray, special: Sequence[int]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """GroundingDINO's generate_masks_with_special_tokens: tokens attend
    within their '.'-separated phrase; special tokens attend only to
    themselves; position ids restart at 0 inside each phrase.

    ids [B,T] -> (attn_mask [B,T,T] bool, position_ids [B,T])."""
    b, t = ids.shape
    is_special = np.isin(ids, list(special))
    mask = np.tile(np.eye(t, dtype=bool), (b, 1, 1))
    pos = np.zeros((b, t), np.int64)
    for bi in range(b):
        prev = 0
        for col in range(t):
            if is_special[bi, col]:
                mask[bi, col, col] = True
                pos[bi, col] = 0
                if col > prev + 1:
                    mask[bi, prev + 1:col + 1, prev + 1:col + 1] = True
                    pos[bi, prev + 1:col + 1] = np.arange(col - prev)
                prev = col
    return mask, pos


# --------------------------------------------------------------------------
# Multi-scale deformable attention
# --------------------------------------------------------------------------

def deform_sample(value, shapes, locs, weights):
    """Bilinear samples of `value` at `locs`, weighted and summed over levels
    × points.

    value [B, L, H, D] (levels flattened); shapes [(h, w), ...]; locs
    [B, Q, H, nlev, P, 2] normalised; weights [B, Q, H, nlev, P] -> [B, Q, H*D]
    in float32. Samples outside a level contribute zero."""
    b, _, nh, d = value.shape
    q = locs.shape[1]
    out = _up(torch.zeros(b * nh, d, q, dtype=value.dtype, device=value.device))
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        v = _up(value[:, start:start + h * w])                 # [B,hw,H,D]
        start += h * w
        v = v.permute(0, 2, 3, 1).reshape(b * nh, d, h, w)
        grid = _up(locs[:, :, :, lvl]).to(v.dtype) * 2.0 - 1.0  # [B,Q,H,P,2]
        grid = grid.permute(0, 2, 1, 3, 4).reshape(b * nh, q, -1, 2)
        s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)                  # [BH,D,Q,P]
        wgt = _up(weights[:, :, :, lvl]).permute(0, 2, 1, 3).reshape(
            b * nh, 1, q, -1)
        out = out + (s * wgt).sum(-1)
    return out.reshape(b, nh, d, q).permute(0, 3, 1, 2).reshape(b, q, nh * d)


class MSDeformAttn(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.cfg = cfg
        d, nh, nl, npt = cfg.d_model, cfg.nheads, cfg.num_levels, cfg.num_points
        self.sampling_offsets = nn.Linear(d, nh * nl * npt * 2)
        self.attention_weights = nn.Linear(d, nh * nl * npt)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)

    def forward(self, query, refpoints, value, shapes):
        """query [B,Q,C]; refpoints [B,Q,nlev,2] or [B,Q,4] (cxcywh);
        value [B,L,C]; shapes [(h,w)…]."""
        c = self.cfg
        nh, nl, npnt = c.nheads, c.num_levels, c.num_points
        b, q, _ = query.shape
        v = self.value_proj(value).reshape(b, -1, nh, c.d_model // nh)
        off = self.sampling_offsets(query).reshape(b, q, nh, nl, npnt, 2)
        aw = _softmax32(self.attention_weights(query).reshape(
            b, q, nh, nl * npnt)).reshape(b, q, nh, nl, npnt)
        if refpoints.shape[-1] == 2:                  # per-level grid refs
            norm = torch.tensor([(w, h) for h, w in shapes], dtype=query.dtype,
                                device=query.device)
            locs = refpoints[:, :, None, :, None] + off / norm[:, None]
        else:                                         # cxcywh boxes
            xy = refpoints[:, :, None, None, None, :2]
            wh = refpoints[:, :, None, None, None, 2:]
            locs = xy + off / npnt * wh * 0.5
        out = deform_sample(v, shapes, locs, aw)
        return self.output_proj(out.to(query.dtype))


# --------------------------------------------------------------------------
# torch MultiheadAttention layout (fused in_proj)
# --------------------------------------------------------------------------

class TorchMHA(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, bias=None):
        b, tq, _ = q.shape
        d, nh = self.dim, self.heads
        hd = d // nh
        w, bi = self.in_proj_weight, self.in_proj_bias
        qp = (q @ w[:d].T + bi[:d]).reshape(b, tq, nh, hd).transpose(1, 2)
        kp = (k @ w[d:2 * d].T + bi[d:2 * d]).reshape(b, -1, nh, hd).transpose(1, 2)
        vp = (v @ w[2 * d:].T + bi[2 * d:]).reshape(b, -1, nh, hd).transpose(1, 2)
        attn = (qp @ kp.transpose(-1, -2)) * (hd ** -0.5)
        if bias is not None:
            attn = attn + bias
        out = (_softmax32(attn).to(vp.dtype) @ vp).transpose(1, 2).reshape(b, tq, d)
        return self.out_proj(out)


# --------------------------------------------------------------------------
# Feature enhancer (encoder)
# --------------------------------------------------------------------------

class _BiAttention(nn.Module):
    def __init__(self, d: int, edim: int):
        super().__init__()
        self.v_proj = nn.Linear(d, edim)
        self.l_proj = nn.Linear(d, edim)
        self.values_v_proj = nn.Linear(d, edim)
        self.values_l_proj = nn.Linear(d, edim)
        self.out_v_proj = nn.Linear(edim, d)
        self.out_l_proj = nn.Linear(edim, d)


class BiFusion(nn.Module):
    """Image<->text bi-attention with layer-scale residuals."""

    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.gamma_v = nn.Parameter(torch.full((d,), 1 / 6))
        self.gamma_l = nn.Parameter(torch.full((d,), 1 / 6))
        self.layer_norm_v = _ln(d)
        self.layer_norm_l = _ln(d)
        self.attn = _BiAttention(d, cfg.dim_ff // 2)

    def forward(self, img, txt, txt_mask):
        c = self.cfg
        a = self.attn
        edim = c.dim_ff // 2
        nh = max(c.nheads // 2, 1)
        hd = edim // nh
        vi, li = self.layer_norm_v(img), self.layer_norm_l(txt)
        b, ti, _ = img.shape
        tt = txt.shape[1]

        def sh(z, t):                                   # -> [B, h, t, hd]
            return z.reshape(b, t, nh, hd).transpose(1, 2)

        qv = sh(a.v_proj(vi) * (hd ** -0.5), ti)
        kl = sh(a.l_proj(li), tt)
        vv, vl = sh(a.values_v_proj(vi), ti), sh(a.values_l_proj(li), tt)
        attn = _up(qv @ kl.transpose(-1, -2))           # [B, h, ti, tt]
        attn = torch.clamp(attn - attn.max(), -50000, 50000)
        a_v = torch.softmax(attn + torch.where(txt_mask[:, None, None, :],
                                               0.0, -1e9), -1)
        dv = (a_v @ _up(vl)).transpose(1, 2).reshape(b, ti, -1)
        a_l = torch.softmax(torch.clamp(attn - attn.max(), -50000, 50000
                                        ).transpose(-1, -2), -1)
        dl = (a_l @ _up(vv)).transpose(1, 2).reshape(b, tt, -1)
        img = img + self.gamma_v * a.out_v_proj(dv.to(img.dtype))
        txt = txt + self.gamma_l * a.out_l_proj(dl.to(txt.dtype))
        return img, txt


class _FFN(nn.Module):
    """`linear1`/`linear2` (+ ReLU) of a transformer layer."""

    def __init__(self, d: int, ff: int):
        super().__init__()
        self.linear1 = nn.Linear(d, ff)
        self.linear2 = nn.Linear(ff, d)

    def ffn(self, x):
        return self.linear2(F.relu(self.linear1(x)))


class EncoderLayer(_FFN):
    """Deformable image self-attention (`transformer.encoder.layers.i`)."""

    def __init__(self, cfg: DinoConfig):
        super().__init__(cfg.d_model, cfg.dim_ff)
        self.self_attn = MSDeformAttn(cfg)
        self.norm1 = _ln(cfg.d_model)
        self.norm2 = _ln(cfg.d_model)

    def forward(self, img, img_pos, refs, shapes):
        img = self.norm1(img + self.self_attn(img + img_pos, refs, img, shapes))
        return self.norm2(img + self.ffn(img))


class TextLayer(_FFN):
    """Text self-attention (`transformer.encoder.text_layers.i`)."""

    def __init__(self, cfg: DinoConfig):
        super().__init__(cfg.d_model, cfg.dim_ff // 2)
        self.self_attn = TorchMHA(cfg.d_model, max(cfg.nheads // 2, 1))
        self.norm1 = _ln(cfg.d_model)
        self.norm2 = _ln(cfg.d_model)

    def forward(self, txt, txt_bias):
        txt = self.norm1(txt + self.self_attn(txt, txt, txt, txt_bias))
        return self.norm2(txt + self.ffn(txt))


class _Encoder(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        n = cfg.enc_layers
        self.layers = nn.ModuleList([EncoderLayer(cfg) for _ in range(n)])
        self.text_layers = nn.ModuleList([TextLayer(cfg) for _ in range(n)])
        self.fusion_layers = nn.ModuleList([BiFusion(cfg) for _ in range(n)])


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, din: int, hidden: int, out: int, n: int):
        super().__init__()
        dims = [din] + [hidden] * (n - 1) + [out]
        self.layers = nn.ModuleList([nn.Linear(a, b)
                                     for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class DecoderLayer(_FFN):
    def __init__(self, cfg: DinoConfig):
        super().__init__(cfg.d_model, cfg.dim_ff)
        d = cfg.d_model
        self.self_attn = TorchMHA(d, cfg.nheads)
        self.norm2 = _ln(d)
        self.ca_text = TorchMHA(d, cfg.nheads)
        self.catext_norm = _ln(d)
        self.cross_attn = MSDeformAttn(cfg)
        self.norm1 = _ln(d)
        self.norm3 = _ln(d)

    def forward(self, tgt, qpos, txt, txt_mask, img, refs, shapes):
        q = tgt + qpos
        tgt = self.norm2(tgt + self.self_attn(q, q, tgt))
        bias = torch.where(txt_mask[:, None, None, :], 0.0, -1e9)
        tgt = self.catext_norm(tgt + self.ca_text(tgt + qpos, txt, txt, bias))
        tgt = self.norm1(tgt + self.cross_attn(tgt + qpos, refs, img, shapes))
        return self.norm3(tgt + self.ffn(tgt))


class _Decoder(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        d = cfg.d_model
        self.layers = nn.ModuleList([DecoderLayer(cfg)
                                     for _ in range(cfg.dec_layers)])
        self.ref_point_head = MLP(2 * d, d, d, 2)
        self.norm = _ln(d)


class _Transformer(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        d = cfg.d_model
        self.level_embed = nn.Parameter(torch.zeros(cfg.num_levels, d))
        self.encoder = _Encoder(cfg)
        self.enc_output = nn.Linear(d, d)
        self.enc_output_norm = _ln(d)
        self.enc_out_bbox_embed = MLP(d, d, 4, 3)
        self.tgt_embed = nn.Embedding(cfg.num_queries, d)
        self.decoder = _Decoder(cfg)


def sine_embed(box, dim=128, temperature=10000.0, scale=2 * math.pi):
    """gen_sineembed_for_position: [..., 4] (cx,cy,w,h) in [0,1] ->
    [..., 4*dim] in torch's (y, x, w, h) order, sin/cos interleaved."""
    x = box[..., (1, 0, 2, 3)]
    i = torch.arange(dim, device=box.device)
    t = temperature ** (2 * (i // 2) / dim)
    ang = x[..., None] * scale / t
    emb = torch.where(i % 2 == 0, torch.sin(ang), torch.cos(ang))
    return emb.reshape(*x.shape[:-1], x.shape[-1] * dim)


def _inv_sigmoid(x, eps=1e-3):
    x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


def _contrastive(q, txt, txt_mask):
    """Dot-product logits, padded text masked to -1e9."""
    logit = _up(q) @ _up(txt).transpose(-1, -2)
    return torch.where(txt_mask[:, None, :], logit, -1e9)


def _sine_pos_hw(h, w, num_pos_feats, device, temperature=20.0):
    """PositionEmbeddingSineHW (normalize=True, temperature 20) -> [h, w, 2*npf]."""
    f32 = torch.float32
    ys = (torch.arange(h, dtype=f32, device=device) + 1) / (h + 1e-6) * 2 * math.pi
    xs = (torch.arange(w, dtype=f32, device=device) + 1) / (w + 1e-6) * 2 * math.pi
    i = torch.arange(num_pos_feats, device=device)
    dim_t = temperature ** (2 * (i // 2) / num_pos_feats)
    py, px = ys[:, None] / dim_t, xs[:, None] / dim_t
    py = torch.where(i % 2 == 0, torch.sin(py), torch.cos(py))
    px = torch.where(i % 2 == 0, torch.sin(px), torch.cos(px))
    return torch.cat([py[:, None].expand(h, w, num_pos_feats),
                      px[None, :].expand(h, w, num_pos_feats)], -1)


def _level_grid(h, w, device):
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device),
                          indexing="ij")
    return (x.reshape(-1) + 0.5) / w, (y.reshape(-1) + 0.5) / h


def _grid_refs(shapes, device):
    """Encoder reference points: each location's centre, tiled over levels
    -> [L, nlev, 2]."""
    pts = torch.cat([torch.stack(_level_grid(h, w, device), -1)
                     for h, w in shapes], 0)
    return pts[:, None].expand(pts.shape[0], len(shapes), 2)


def _grid_proposals(shapes, device):
    """gen_encoder_output_proposals: per-location (cx,cy,w,h) anchors in
    inverse-sigmoid space and their validity -> ([L,4], [L] bool)."""
    out = []
    for lvl, (h, w) in enumerate(shapes):
        cx, cy = _level_grid(h, w, device)
        wh = torch.full_like(cx, 0.05 * 2 ** lvl)
        out.append(torch.stack([cx, cy, wh, wh], -1))
    p = torch.cat(out, 0)
    valid = torch.all((p > 0.01) & (p < 0.99), -1)
    return _inv_sigmoid(p), valid


class GroundingDINO(nn.Module):
    def __init__(self, cfg: DinoConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.backbone = nn.ModuleList([SwinBackbone(cfg)])
        chans = [c.swin_dim * 2 ** s for s in c.out_indices]
        groups = 32 if c.d_model % 32 == 0 else 1
        projs = [nn.Sequential(nn.Conv2d(ch, c.d_model, 1),
                               nn.GroupNorm(groups, c.d_model, eps=LN_EPS))
                 for ch in chans]
        projs.append(nn.Sequential(nn.Conv2d(chans[-1], c.d_model, 3, 2, 1),
                                   nn.GroupNorm(groups, c.d_model, eps=LN_EPS)))
        self.input_proj = nn.ModuleList(projs)
        self.bert = BertEncoder(cfg)
        self.feat_map = nn.Linear(c.bert_hidden, c.d_model)
        self.transformer = _Transformer(cfg)
        # the box head is shared across decoder layers (one copy is loaded)
        self.bbox_embed = nn.ModuleList([MLP(c.d_model, c.d_model, 4, 3)])

    @classmethod
    def create(cls, cfg: DinoConfig, seed: int = 0, device="cpu"):
        """Random weights from `seed` (see `core/init.py`), float32."""
        return random_init_(cls(cfg).to(device), seed,
                            {"level_embed": 1.0, "tgt_embed": 1.0}).eval()

    def level_meta(self):
        c = self.cfg
        sizes = [c.img_size // (c.patch_size * 2 ** si) for si in c.out_indices]
        sizes.append(sizes[-1] // 2)                  # the extra stride level
        return [(s, s) for s in sizes]

    @torch.no_grad()
    def forward(self, images, ids, position_ids, attn_mask, txt_mask):
        """images [B,S,S,3] ImageNet-normalised; ids, position_ids [B,T];
        attn_mask [B,T,T] and txt_mask [B,T] bool (True = attend / real).

        Returns (logits [B, nq, T], boxes [B, nq, 4] cxcywh in [0,1])."""
        with exact_fp32():
            img, txt = self.encode(images, ids, position_ids, attn_mask,
                                   txt_mask)
            return self.decode(img, txt, txt_mask, self.select(img, txt, txt_mask))

    def encode(self, images, ids, position_ids, attn_mask, txt_mask):
        """Backbone, BERT and the feature enhancer -> (image memory [B,L,d],
        text memory [B,T,d])."""
        c = self.cfg
        dev = images.device
        shapes = self.level_meta()
        tr = self.transformer
        b = images.shape[0]

        feats = self.backbone[0](images)
        srcs = []
        for i, proj in enumerate(self.input_proj):
            f = feats[min(i, len(feats) - 1)].permute(0, 3, 1, 2)
            srcs.append(proj(f).permute(0, 2, 3, 1))

        flat, pos = [], []
        for li, s in enumerate(srcs):
            h, w = s.shape[1:3]
            flat.append(s.reshape(b, h * w, c.d_model))
            pos.append(_sine_pos_hw(h, w, c.d_model // 2, dev).to(s.dtype).reshape(
                1, h * w, c.d_model) + tr.level_embed[li])
        img = torch.cat(flat, 1)
        img_pos = torch.cat(pos, 1).to(img.dtype)

        txt = self.feat_map(self.bert(ids, position_ids, attn_mask))
        txt_bias = torch.where(attn_mask[:, None], 0.0, -1e9).to(txt.dtype)

        refs2d = _grid_refs(shapes, dev).to(img.dtype).expand(b, -1, -1, -1)
        enc = tr.encoder
        for i in range(c.enc_layers):
            img, txt = enc.fusion_layers[i](img, txt, txt_mask)
            txt = enc.text_layers[i](txt, txt_bias)
            img = enc.layers[i](img, img_pos, refs2d, shapes)
        return img, txt

    def select(self, img, txt, txt_mask):
        """Language-guided query selection: the locations [B, nq] whose best
        text logit is highest, best first."""
        _, valid = _grid_proposals(self.level_meta(), img.device)
        mem = self._memory(img, valid)
        cls = _contrastive(mem, txt, txt_mask)                # [B, L, T]
        score = torch.where(valid[None, :], cls.max(-1).values, -1e9)
        return torch.topk(score, self.cfg.num_queries, dim=1).indices

    def _memory(self, img, valid):
        tr = self.transformer
        return tr.enc_output_norm(tr.enc_output(
            torch.where(valid[:, None], img, 0.0)))

    def decode(self, img, txt, txt_mask, top):
        """The box-refining decoder from the selected locations `top` ->
        (logits [B, nq, T], boxes [B, nq, 4])."""
        c = self.cfg
        shapes = self.level_meta()
        tr = self.transformer
        props, valid = _grid_proposals(shapes, img.device)
        mem = self._memory(img, valid)
        sel = torch.gather(mem, 1, top[..., None].expand(-1, -1, mem.shape[-1]))
        ref = torch.sigmoid(tr.enc_out_bbox_embed(sel) + props.to(img.dtype)[top])
        tgt = tr.tgt_embed.weight[None].expand(img.shape[0], -1, -1)

        dec = tr.decoder
        bbox_mlp = self.bbox_embed[0]
        ref_before = ref
        for layer in dec.layers:
            qpos = dec.ref_point_head(sine_embed(ref, dim=c.d_model // 2))
            tgt = layer(tgt, qpos, txt, txt_mask, img, ref, shapes)
            ref_before = ref
            # in-loop refinement steers from the raw output; the reported
            # boxes re-derive the delta from the normed state against the
            # pre-update reference
            ref = torch.sigmoid(bbox_mlp(tgt) + _inv_sigmoid(ref))
        normed = dec.norm(tgt)
        boxes = torch.sigmoid(bbox_mlp(normed) + _inv_sigmoid(ref_before))
        return _contrastive(normed, txt, txt_mask), boxes


# --------------------------------------------------------------------------
# Tokenizer and the box proposer
# --------------------------------------------------------------------------

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class WordPieceTokenizer:
    """Minimal BERT WordPiece tokenizer (lowercase, greedy longest match)
    over a `vocab.txt`, one token per line."""

    def __init__(self, vocab_path: str):
        with open(vocab_path, encoding="utf-8") as f:
            self.vocab = {t.rstrip("\n"): i for i, t in enumerate(f)}
        self.cls = self.vocab["[CLS]"]
        self.sep = self.vocab["[SEP]"]
        self.unk = self.vocab["[UNK]"]
        self.pad = self.vocab.get("[PAD]", 0)
        self.specials = (self.cls, self.sep, self.vocab.get(".", self.unk),
                         self.vocab.get("?", self.unk))

    def _wordpiece(self, word: str):
        if word in self.vocab:
            return [self.vocab[word]]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            out.append(cur)
            start = end
        return out

    def encode(self, text: str):
        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower().strip())
        ids = [self.cls]
        for w in words:
            ids.extend(self._wordpiece(w))
        ids.append(self.sep)
        return ids

    def decode(self, ids) -> str:
        inv = getattr(self, "_inv", None)
        if inv is None:
            inv = self._inv = {i: t for t, i in self.vocab.items()}
        out = ""
        for i in ids:
            if int(i) in self.specials or int(i) == self.pad:
                continue
            t = inv.get(int(i), "")
            if t.startswith("##"):
                out += t[2:]
            elif t and not t.startswith("["):
                out += (" " if out else "") + t
        return out


class DinoBoxProposer:
    """Text -> each view's best xyxy box via GroundingDINO (box_threshold 0.3
    as the reference's lang_sam); plugs into GroundedSAMMasker."""

    def __init__(self, model: GroundingDINO, tokenizer,
                 box_threshold: float = 0.3, batch: int = 4):
        self.model = model
        self.tokenizer = tokenizer
        self.box_threshold = box_threshold
        self.batch = batch

    @property
    def device(self):
        return self.model.transformer.level_embed.device

    def _prep_text(self, text: str):
        cap = text.lower().strip()
        if not cap.endswith("."):
            cap = cap + "."
        ids = self.tokenizer.encode(cap)[: self.model.cfg.max_text_len]
        t = self.model.cfg.max_text_len
        ids_np = np.full((1, t), self.tokenizer.pad, np.int32)
        ids_np[0, : len(ids)] = ids
        attn, pos = phrase_masks(ids_np, self.tokenizer.specials)
        txt_mask = np.zeros((1, t), bool)
        txt_mask[0, : len(ids)] = True
        # padded tokens attend only to themselves (all-False rows are NaN)
        return ids_np, pos.astype(np.int32), attn | np.eye(t, dtype=bool), \
            txt_mask

    def forward(self, images: torch.Tensor, text):
        """[n,H,W,3] in [0,1] -> (sigmoid scores [n, nq, T], boxes [n, nq, 4])
        on the device; `text` is `_prep_text`'s tuple."""
        from gaussctrl_tpu_torch.pipeline.gaussctrl import resize_bilinear
        size = self.model.cfg.img_size
        dev = self.device
        n = images.shape[0]
        im = resize_bilinear(images.to(dev, torch.float32), size, size)
        im = (im - im.new_tensor(IMAGENET_MEAN)) / im.new_tensor(IMAGENET_STD)
        ids, pos, attn, tmask = (torch.as_tensor(x, device=dev).expand(
            n, *x.shape[1:]) for x in text)
        logits, bx = self.model(im, ids.long(), pos.long(), attn, tmask)
        return torch.sigmoid(logits), bx

    def predict_boxes(self, image, prompt: str, box_threshold: float = 0.3,
                      text_threshold: float = 0.25):
        """All detections on one image: (boxes [K,4] xyxy px, scores [K],
        phrases [K]) for queries whose best token clears `box_threshold`,
        best first; a phrase is the tokens above `text_threshold`."""
        h, w, _ = np.shape(image)
        text = self._prep_text(prompt)
        probs, bx = self.forward(torch.as_tensor(np.asarray(image, np.float32)
                                                 )[None], text)
        probs, bx = probs[0].cpu().numpy(), bx[0].cpu().numpy()
        score = probs.max(-1)
        keep = np.nonzero(score > box_threshold)[0]
        keep = keep[np.argsort(-score[keep])]
        boxes, phrases = [], []
        ids0 = text[0][0]
        for q in keep:
            cx, cy, bw, bh = bx[q]
            boxes.append([(cx - bw / 2) * w, (cy - bh / 2) * h,
                          (cx + bw / 2) * w, (cy + bh / 2) * h])
            phrases.append(self.tokenizer.decode(ids0[probs[q] > text_threshold]))
        return (np.asarray(boxes, np.float32).reshape(-1, 4),
                score[keep], phrases)

    def __call__(self, images, prompt: str) -> np.ndarray:
        """images [V,H,W,3] in [0,1] -> boxes [V,4] xyxy px (−1s = none)."""
        v, h, w, _ = images.shape
        images = torch.as_tensor(images)
        text = self._prep_text(prompt)
        boxes = np.full((v, 4), -1.0, np.float32)
        for lo in range(0, v, self.batch):
            hi = min(lo + self.batch, v)
            probs, bx = self.forward(images[lo:hi], text)
            score = probs.max(-1).values.cpu().numpy()              # [n, nq]
            bx = bx.cpu().numpy()
            for i in range(hi - lo):
                j = int(score[i].argmax())
                if score[i, j] < self.box_threshold:
                    continue
                cx, cy, bw, bh = bx[i, j]
                boxes[lo + i] = [(cx - bw / 2) * w, (cy - bh / 2) * h,
                                 (cx + bw / 2) * w, (cy + bh / 2) * h]
        return boxes
