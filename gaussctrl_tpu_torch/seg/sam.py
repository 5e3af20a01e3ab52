"""SAM (Segment Anything), box-prompted, as torch.nn modules.

Counterpart of `gaussctrl_tpu/seg/sam.py`: the windowed ViT image encoder
with decomposed relative positions, the random-Fourier prompt encoder and
the two-way mask decoder. Modules and parameters carry the names of the
facebook `sam_vit_*.pth` state dicts (`image_encoder.blocks.0.attn.qkv`,
`mask_decoder.transformer.layers.0.cross_attn_token_to_image`, ...), so a
checkpoint loads with a strict `load_state_dict` (`seg/weights.py`). The
prompt encoder's mask-prompt modules (`not_a_point_embed`,
`mask_downscaling`) are absent: only box prompts are used.

The computation is the JAX package's, in float32 (TF32 off on the card),
NHWC between the layers:

  * LayerNorms use eps 1e-6 and the MLPs the tanh GELU (flax's defaults);
  * the decoder's 2×2 transposed convolutions compute what flax's
    `ConvTranspose` computes with the converted kernel, which is
    `conv_transpose2d` with the kernel flipped in both spatial axes;
  * the global-attention blocks (64×64 = 4096 tokens at 1024 px) are
    computed in blocks of query rows, so the scores and the relative
    position bias never take more than [B, heads, QUERY_BLOCK, 4096].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gaussctrl_tpu_torch.core.init import random_init_
from gaussctrl_tpu_torch.device import at_least_fp32 as _up
from gaussctrl_tpu_torch.device import exact_fp32

LN_EPS = 1e-6
QUERY_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    out_chans: int = 256          # neck / prompt / decoder channel
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_mask_tokens: int = 4      # 1 + multimask 3

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @classmethod
    def vit_h(cls) -> "SAMConfig":
        return cls()

    @classmethod
    def vit_l(cls) -> "SAMConfig":
        return cls(embed_dim=1024, depth=24, num_heads=16,
                   global_attn_indexes=(5, 11, 17, 23))

    @classmethod
    def vit_b(cls) -> "SAMConfig":
        return cls(embed_dim=768, depth=12, num_heads=12,
                   global_attn_indexes=(2, 5, 8, 11))

    @classmethod
    def tiny(cls) -> "SAMConfig":
        return cls(img_size=64, patch_size=8, embed_dim=32, depth=2,
                   num_heads=2, window_size=4, global_attn_indexes=(1,),
                   out_chans=16, decoder_mlp_dim=32)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over NHWC maps (SAM's LayerNorm2d: `weight`/`bias`)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias


def _rel_pos_bias(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """[2*size-1, d] table -> [q_size, k_size, d] gathered offsets."""
    dev = rel_pos.device
    coords = (torch.arange(q_size, device=dev)[:, None]
              - torch.arange(k_size, device=dev)[None, :] + (k_size - 1))
    return rel_pos[coords]


class Attention(nn.Module):
    """qkv attention with decomposed relative position bias (`ViTAttention`)."""

    def __init__(self, dim: int, num_heads: int, input_size: int):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd))

    def forward(self, x):                               # [B, H, W, C]
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                # [B, nh, HW, hd]
        rh = _rel_pos_bias(self.rel_pos_h, h, h)        # [h, h', hd]
        rw = _rel_pos_bias(self.rel_pos_w, w, w)        # [w, w', hd]
        qr = q.reshape(b, nh, h, w, hd)
        bias_h = torch.einsum("bnxyd,xud->bnxyu", qr, rh)   # [B,nh,h,w,h']
        bias_w = torch.einsum("bnxyd,yvd->bnxyv", qr, rw)   # [B,nh,h,w,w']
        kt = k.transpose(-1, -2)
        out = torch.empty_like(q)
        rows = max(1, QUERY_BLOCK // w)
        for y0 in range(0, h, rows):
            y1 = min(h, y0 + rows)
            s = (q[:, :, y0 * w:y1 * w] @ kt) * (hd ** -0.5)
            s = (s.reshape(b, nh, y1 - y0, w, h, w)
                 + bias_h[:, :, y0:y1, :, :, None]
                 + bias_w[:, :, y0:y1, :, None, :])
            p = torch.softmax(_up(s.reshape(b, nh, (y1 - y0) * w, h * w)), -1)
            out[:, :, y0 * w:y1 * w] = p.to(v.dtype) @ v
        return self.proj(out.transpose(1, 2).reshape(b, h, w, c))


def window_partition(x, ws):
    """[B,H,W,C] -> ([B·nW, ws, ws, C], padded (Hp, Wp)); pads at the end."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(win, ws, pad_hw, hw):
    """Inverse of `window_partition`, cropped back to `hw`."""
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // (hp * wp // ws // ws)
    x = win.reshape(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=gelu_tanh):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class Block(nn.Module):
    def __init__(self, cfg: SAMConfig, window_size: int):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        self.attn = Attention(cfg.embed_dim, cfg.num_heads,
                              window_size if window_size > 0 else cfg.grid)
        self.norm2 = nn.LayerNorm(cfg.embed_dim, eps=LN_EPS)
        self.mlp = MLPBlock(cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio))

    def forward(self, x):
        h = self.norm1(x)
        if self.window_size > 0:
            hw = h.shape[1:3]
            h, pad_hw = window_partition(h, self.window_size)
            h = window_unpartition(self.attn(h), self.window_size, pad_hw, hw)
        else:
            h = self.attn(h)
        x = x + h
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size)


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        c = cfg
        self.patch_embed = _PatchEmbed(c)
        self.pos_embed = nn.Parameter(torch.zeros(1, c.grid, c.grid, c.embed_dim))
        self.blocks = nn.ModuleList([
            Block(c, 0 if i in c.global_attn_indexes else c.window_size)
            for i in range(c.depth)])
        self.neck = nn.Sequential(
            nn.Conv2d(c.embed_dim, c.out_chans, 1, bias=False),
            LayerNorm2d(c.out_chans),
            nn.Conv2d(c.out_chans, c.out_chans, 3, padding=1, bias=False),
            LayerNorm2d(c.out_chans))

    def forward(self, x):                      # [B, S, S, 3] normalised
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x = x + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        conv1, ln1, conv2, ln2 = self.neck
        x = ln1(conv1(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        x = conv2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return ln2(x)                            # [B, g, g, out_chans]


class _PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.zeros(2, num_pos_feats))


class PromptEncoder(nn.Module):
    """Box prompts -> sparse corner embeddings + the dense no-mask embedding."""

    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.out_chans
        self.pe_layer = _PositionEmbeddingRandom(c // 2)
        # 0: negative point, 1: positive point, 2/3: box corners
        self.point_embeddings = nn.ModuleList([nn.Embedding(1, c)
                                               for _ in range(4)])
        self.no_mask_embed = nn.Embedding(1, c)

    def _pe(self, coords01: torch.Tensor) -> torch.Tensor:
        g = self.pe_layer.positional_encoding_gaussian_matrix
        x = (2.0 * coords01.to(g.dtype) - 1.0) @ g * (2.0 * np.pi)
        return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)

    def dense_pe(self) -> torch.Tensor:
        """Positional encoding of the image-embedding grid [g, g, C]."""
        g = self.cfg.grid
        dev = self.no_mask_embed.weight.device
        t = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
        ys, xs = torch.meshgrid(t, t, indexing="ij")
        return self._pe(torch.stack([xs, ys], -1))

    def forward(self, boxes: torch.Tensor):
        """boxes [B, 4] xyxy in encoder pixels -> sparse [B,2,C], dense [B,g,g,C]."""
        c = self.cfg
        b = boxes.shape[0]
        corners = (boxes.reshape(b, 2, 2) + 0.5) / c.img_size
        point = torch.cat([e.weight for e in self.point_embeddings])
        sparse = self._pe(corners) + point[None, 2:4]
        dense = self.no_mask_embed.weight[0].expand(b, c.grid, c.grid,
                                                    c.out_chans)
        return sparse, dense


class DecoderAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        d = dim // downsample
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, d)
        self.k_proj = nn.Linear(dim, d)
        self.v_proj = nn.Linear(dim, d)
        self.out_proj = nn.Linear(d, dim)

    def forward(self, q, k, v):
        qq, kk, vv = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, tq, d = qq.shape
        tk = kk.shape[1]
        nh = self.num_heads
        hd = d // nh
        qq = qq.reshape(b, tq, nh, hd).transpose(1, 2)
        kk = kk.reshape(b, tk, nh, hd).transpose(1, 2)
        vv = vv.reshape(b, tk, nh, hd).transpose(1, 2)
        a = torch.softmax(_up(qq @ kk.transpose(-1, -2)) * (hd ** -0.5), -1)
        o = (a.to(vv.dtype) @ vv).transpose(1, 2).reshape(b, tq, d)
        return self.out_proj(o)


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, cfg: SAMConfig, skip_first_layer_pe: bool):
        super().__init__()
        c = cfg.out_chans
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(c, cfg.decoder_heads)
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS)
        self.cross_attn_token_to_image = DecoderAttention(c, cfg.decoder_heads, 2)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS)
        self.mlp = MLPBlock(c, cfg.decoder_mlp_dim, act=F.relu)
        self.norm3 = nn.LayerNorm(c, eps=LN_EPS)
        self.norm4 = nn.LayerNorm(c, eps=LN_EPS)
        self.cross_attn_image_to_token = DecoderAttention(c, cfg.decoder_heads, 2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        c = cfg.out_chans
        self.layers = nn.ModuleList([TwoWayAttentionBlock(cfg, i == 0)
                                     for i in range(cfg.decoder_depth)])
        self.final_attn_token_to_image = DecoderAttention(c, cfg.decoder_heads, 2)
        self.norm_final_attn = nn.LayerNorm(c, eps=LN_EPS)


class MLP(nn.Module):
    """`layers` Linears with ReLU between them (SAM's decoder heads)."""

    def __init__(self, dim: int, hidden: int, out: int, n: int):
        super().__init__()
        dims = [dim] + [hidden] * (n - 1) + [out]
        self.layers = nn.ModuleList([nn.Linear(a, b)
                                     for a, b in zip(dims[:-1], dims[1:])])

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.out_chans
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(cfg.num_mask_tokens, c)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, 2), LayerNorm2d(c // 4),
            nn.GELU(approximate="tanh"), nn.ConvTranspose2d(c // 4, c // 8, 2, 2),
            nn.GELU(approximate="tanh"))
        self.output_hypernetworks_mlps = nn.ModuleList([
            MLP(c, c, c // 8, 3) for _ in range(cfg.num_mask_tokens)])
        self.iou_prediction_head = MLP(c, c, cfg.num_mask_tokens, 3)

    @staticmethod
    def _up(conv: nn.ConvTranspose2d, x):
        """flax ConvTranspose on NHWC (the kernel flipped, see the module doc)."""
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), conv.weight.flip(2, 3),
                               conv.bias, stride=2)
        return y.permute(0, 2, 3, 1)

    def forward(self, image_embedding, image_pe, sparse_prompt, dense_prompt):
        """image_embedding [B,g,g,C] -> (masks [B,M,4g,4g], iou [B,M])."""
        c = self.cfg
        b, g, _, ch = image_embedding.shape
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse_prompt], 1)
        src = (image_embedding + dense_prompt).reshape(b, g * g, ch)
        pos_src = image_pe.reshape(1, g * g, ch).expand(b, -1, -1)
        t = self.transformer
        queries, keys = tokens, src
        for layer in t.layers:
            queries, keys = layer(queries, keys, tokens, pos_src)
        q, k = queries + tokens, keys + pos_src
        queries = t.norm_final_attn(
            queries + t.final_attn_token_to_image(q, k, keys))
        iou_out = queries[:, 0]
        mask_out = queries[:, 1:1 + c.num_mask_tokens]

        conv1, ln, act1, conv2, act2 = self.output_upscaling
        up = keys.reshape(b, g, g, ch)
        up = act1(ln(self._up(conv1, up)))
        up = act2(self._up(conv2, up))                   # [B, 4g, 4g, ch/8]
        hyper = torch.stack([mlp(mask_out[:, m]) for m, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.einsum("bmc,bxyc->bmxy", hyper, up)
        return masks, self.iou_prediction_head(iou_out)


# ImageNet normalisation SAM applies (pixel scale 0..255)
SAM_MEAN = (123.675, 116.28, 103.53)
SAM_STD = (58.395, 57.12, 57.375)

# raw parameters drawn N(0, 1) in a random SAM (the JAX package's inits)
_RAW_STD = {"point_embeddings": 1.0, "no_mask_embed": 1.0, "iou_token": 1.0,
            "mask_tokens": 1.0, "positional_encoding_gaussian_matrix": 1.0}


class SAM(nn.Module):
    """The three SAM modules with `encode` and `predict_boxes`."""

    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)

    @classmethod
    def create(cls, cfg: SAMConfig, seed: int = 0, device="cpu") -> "SAM":
        """Random weights from `seed` (see `core/init.py`), float32."""
        return random_init_(cls(cfg).to(device), seed, _RAW_STD, 0.02).eval()

    @property
    def device(self) -> torch.device:
        return self.mask_decoder.iou_token.weight.device

    @torch.no_grad()
    def encode(self, images01: torch.Tensor) -> torch.Tensor:
        """images [B,S,S,3] in [0,1] at encoder size -> embeddings [B,g,g,C]."""
        mean = images01.new_tensor(SAM_MEAN)
        std = images01.new_tensor(SAM_STD)
        with exact_fp32():
            return self.image_encoder((images01 * 255.0 - mean) / std)

    @torch.no_grad()
    def predict_boxes(self, embeddings: torch.Tensor, boxes: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """embeddings [B,g,g,C], boxes [B,4] xyxy (encoder pixels) ->
        (mask logits [B,4g,4g], iou [B]) with multimask_output=False."""
        with exact_fp32():
            sparse, dense = self.prompt_encoder(boxes)
            masks, iou = self.mask_decoder(
                embeddings, self.prompt_encoder.dense_pe(), sparse, dense)
        return masks[:, 0], iou[:, 0]

