"""CLIP text and vision towers (torch.nn) and the offline tokenizers.

Counterpart of `gaussctrl_tpu/diffusion/clip.py`: causal self-attention,
quick-GELU, learned position embeddings and a final layer norm in the text
tower; the ViT image tower with a class token, a pre-LN and a post-LN over
every token; and `CLIPModel`, both towers with their projections into the
joint space, which the CLIP box proposer (`seg/grounding.py`) and the edit
metrics (`metrics/`) use. Parameter names are the transformers keys
(`text_model.encoder.layers.0.self_attn.q_proj`, `vision_model.embeddings.
patch_embedding`, `visual_projection`, …). Prompts are augmented with the
reference's suffix and paired with its negative prompt; `HashTokenizer`
gives CRC32 word ids when no vocabulary files are present.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import os
import re
import zlib
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from gaussctrl_tpu_torch.diffusion.config import CLIPTextConfig

POSITIVE_SUFFIX = ", best quality, extremely detailed"
NEGATIVE_PROMPT = ("longbody, lowres, bad anatomy, bad hands, missing fingers,"
                   " extra digit, fewer digits, cropped, worst quality,"
                   " low quality")


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x, mask=None):
        b, t, c = x.shape
        d = c // self.heads

        def split(y):
            return y.reshape(b, t, self.heads, d).transpose(1, 2)

        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        s = (q.float() @ k.float().transpose(-1, -2)) / np.sqrt(d)
        if mask is not None:
            s = torch.where(mask[None, None], s, torch.full_like(s, -1e9))
        w = torch.softmax(s, dim=-1).to(v.dtype)
        out = (w @ v).transpose(1, 2).reshape(b, t, c)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, hidden: int, inter: int):
        super().__init__()
        self.fc1 = nn.Linear(hidden, inter)
        self.fc2 = nn.Linear(inter, hidden)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """One pre-LN transformer layer of either tower (`cfg` is a
    CLIPTextConfig or a CLIPVisionConfig)."""

    def __init__(self, cfg: Union[CLIPTextConfig, "CLIPVisionConfig"]):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_layers)])


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        t = input_ids.shape[1]
        x = (self.embeddings.token_embedding(input_ids)
             + self.embeddings.position_embedding.weight[None, :t])
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                       device=input_ids.device))
        for layer in self.encoder.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)

    def embed(self, input_ids: torch.Tensor, projection: torch.Tensor
              ) -> torch.Tensor:
        """Pooled text embedding in the joint space: the hidden state at the
        EOS position (the highest token id) times `projection` [hidden, D]."""
        h = self(input_ids)
        eos = torch.argmax(input_ids, dim=-1)
        return h[torch.arange(h.shape[0], device=h.device), eos] @ projection


class CLIPTextModel(nn.Module):
    """input_ids [B, T] → last hidden state [B, T, hidden] (final LN applied)."""

    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.text_model(input_ids)

    def embed(self, input_ids: torch.Tensor, projection: torch.Tensor
              ) -> torch.Tensor:
        return self.text_model.embed(input_ids, projection)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def vit_l14(cls) -> "CLIPVisionConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
                   num_heads=2, intermediate_size=64, projection_dim=16)


# CLIP image normalisation (OpenAI statistics, [0,1] pixels)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(1 + cfg.grid ** 2,
                                               cfg.hidden_size)


class CLIPVisionTransformer(nn.Module):
    """images [B, S, S, 3] CLIP-normalised -> tokens [B, 1+P, hidden], the
    post-LN applied to every token (token 0 is the class token)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size,
                                           eps=cfg.layer_norm_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        e = self.embeddings
        x = e.patch_embedding(images.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)                       # [B, P, hidden]
        cls = e.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], 1) + e.position_embedding.weight[None]
        x = self.pre_layrnorm(x)
        for layer in self.encoder.layers:
            x = layer(x)
        return self.post_layernorm(x)


class CLIPModel(nn.Module):
    """Both CLIP towers and their joint-space projections (the transformers
    `CLIPModel` keys, less `logit_scale`)."""

    def __init__(self, vision: CLIPVisionConfig, text: CLIPTextConfig):
        super().__init__()
        self.vision_cfg, self.text_cfg = vision, text
        self.vision_model = CLIPVisionTransformer(vision)
        self.text_model = CLIPTextTransformer(text)
        self.visual_projection = nn.Linear(vision.hidden_size,
                                           vision.projection_dim, bias=False)
        self.text_projection = nn.Linear(text.hidden_size,
                                         vision.projection_dim, bias=False)

    def image_tokens(self, images: torch.Tensor) -> torch.Tensor:
        """CLIP-normalised [B,S,S,3] -> every token in the joint space
        [B, 1+P, D] (post-LN, then the visual projection)."""
        return self.vision_model(images) @ self.visual_projection.weight.T

    def text_embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, T] ids -> pooled text embeddings in the joint space [B, D]."""
        return self.text_model.embed(input_ids, self.text_projection.weight.T)


# ---------------------------------------------------------------------------
# Tokenizers
# ---------------------------------------------------------------------------

def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class CLIPTokenizer:
    """The CLIP byte-level BPE tokenizer (lowercase, </w> word markers), from
    a tokenizer directory's `vocab.json` + `merges.txt`."""

    BOS = 49406
    EOS = 49407

    def __init__(self, vocab_path: str, merges_path: str, max_length: int = 77):
        opener = gzip.open if vocab_path.endswith(".gz") else open
        with opener(vocab_path, "rt", encoding="utf-8") as f:
            self.encoder = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version")]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self.cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> np.ndarray:
        pat = re.compile(
            r"""'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
            re.IGNORECASE)
        text = " ".join(text.lower().strip().split())
        ids = [self.BOS]
        for tok in pat.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder.get(t, self.EOS - 1) for t in self._bpe(tok))
        ids = ids[: self.max_length - 1] + [self.EOS]
        ids += [self.EOS] * (self.max_length - len(ids))
        return np.asarray(ids, np.int32)


class HashTokenizer:
    """Deterministic tokenizer for weight-free runs: CRC32 word ids, with
    BOS/EOS the two highest ids as in the real vocabulary."""

    def __init__(self, vocab_size: int, max_length: int = 77):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.BOS = vocab_size - 2
        self.EOS = vocab_size - 1

    def encode(self, text: str) -> np.ndarray:
        words = text.lower().split()
        ids = [self.BOS] + [zlib.crc32(w.encode()) % (self.vocab_size - 2)
                            for w in words]
        ids = ids[: self.max_length - 1] + [self.EOS]
        ids += [self.EOS] * (self.max_length - len(ids))
        return np.asarray(ids, np.int32)


def load_tokenizer(model_dir: Optional[str], cfg: CLIPTextConfig):
    """CLIPTokenizer if vocab files exist under model_dir/tokenizer, else hash."""
    if model_dir:
        tok_dir = os.path.join(model_dir, "tokenizer")
        vocab = os.path.join(tok_dir, "vocab.json")
        merges = os.path.join(tok_dir, "merges.txt")
        if os.path.exists(vocab) and os.path.exists(merges):
            return CLIPTokenizer(vocab, merges, cfg.max_position_embeddings)
    return HashTokenizer(cfg.vocab_size, cfg.max_position_embeddings)
