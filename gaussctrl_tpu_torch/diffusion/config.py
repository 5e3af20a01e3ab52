"""Model configurations for the diffusion stack.

A copy of `gaussctrl_tpu/diffusion/config.py` (the port imports nothing of
the JAX package): `sd15()` pins the Stable-Diffusion-1.5 + depth-ControlNet
architecture, `tiny()` and `nano()` give CPU-sized miniatures of the same
topology.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    # block kinds, outermost-first; True = has cross-attn transformer
    down_block_attn: Tuple[bool, ...] = (True, True, True, False)
    num_heads: int = 8
    cross_attention_dim: int = 768
    transformer_layers: int = 1
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    freq_shift: int = 0
    flip_sin_to_cos: bool = True

    @property
    def up_block_attn(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.down_block_attn))

    @classmethod
    def sd15(cls) -> "UNetConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "UNetConfig":
        return cls(
            block_out_channels=(32, 64),
            down_block_attn=(True, False),
            num_heads=2,
            cross_attention_dim=32,
            norm_num_groups=8,
        )

    @classmethod
    def nano(cls) -> "UNetConfig":
        """Full sd15 TOPOLOGY at minimum width: all four resolution levels
        with sd15's attention pattern, so at sample_size 64 the attention
        token ladder is the production 4096/1024/256/64."""
        return cls(
            block_out_channels=(16, 16, 32, 32),
            layers_per_block=1,
            down_block_attn=(True, True, True, False),
            num_heads=2,
            cross_attention_dim=32,
            norm_num_groups=8,
        )


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """ControlNet = UNet encoder copy + conditioning embedder + zero convs."""
    unet: UNetConfig = UNetConfig()
    # conv channel ladder of the conditioning embedder (input: 3-ch hint image)
    cond_embed_channels: Tuple[int, ...] = (16, 32, 96, 256)

    @classmethod
    def sd15(cls) -> "ControlNetConfig":
        return cls(unet=UNetConfig.sd15())

    @classmethod
    def tiny(cls) -> "ControlNetConfig":
        return cls(unet=UNetConfig.tiny(), cond_embed_channels=(8, 8, 16, 16))

    @classmethod
    def nano(cls) -> "ControlNetConfig":
        return cls(unet=UNetConfig.nano(), cond_embed_channels=(8, 8, 16, 16))


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215  # gc_pipeline.py:244 latent scale

    @classmethod
    def sd15(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "VAEConfig":
        # 4 blocks -> 8x downsample, matching SD's image:latent ratio (the
        # ControlNet hint ladder and the pipeline rely on it)
        return cls(block_out_channels=(16, 16, 16, 32), norm_num_groups=8,
                   layers_per_block=1)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5

    @classmethod
    def sd15(cls) -> "CLIPTextConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, max_position_embeddings=16)


@dataclasses.dataclass(frozen=True)
class SDConfig:
    """The full Stable-Diffusion + ControlNet stack."""
    unet: UNetConfig = UNetConfig()
    controlnet: ControlNetConfig = ControlNetConfig()
    vae: VAEConfig = VAEConfig()
    text: CLIPTextConfig = CLIPTextConfig()
    sample_size: int = 64  # latent H=W; 512px images

    @classmethod
    def sd15(cls) -> "SDConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "SDConfig":
        return cls(unet=UNetConfig.tiny(), controlnet=ControlNetConfig.tiny(),
                   vae=VAEConfig.tiny(), text=CLIPTextConfig.tiny(), sample_size=8)

    @classmethod
    def nano(cls) -> "SDConfig":
        """sd15 topology (4 levels, production 64x64 latent geometry) at
        minimum width — see UNetConfig.nano()."""
        return cls(unet=UNetConfig.nano(), controlnet=ControlNetConfig.nano(),
                   vae=VAEConfig.tiny(), text=CLIPTextConfig.tiny(),
                   sample_size=64)
