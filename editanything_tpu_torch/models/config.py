"""Model configurations, mirrored from ``editanything_tpu/models/config.py``.

Mirrored rather than imported: importing that module runs
``editanything_tpu/models/__init__.py``, which loads the JAX models. A test
holds the fields and defaults of both against each other
(tests/test_torch_models.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """diffusers-layout UNet2DCondition architecture (SD1.5 defaults)."""
    in_channels: int = 4                 # 9 for the inpainting UNet
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768       # 1024 for SD2.1
    attention_head_dim: Tuple[int, ...] = (8, 8, 8, 8)   # heads per block (SD1.5)
    use_linear_projection: bool = False
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D", "DownBlock2D")
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D", "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D", "CrossAttnUpBlock2D")
    norm_num_groups: int = 32
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads_for_block(self, block_index: int) -> int:
        return self.attention_head_dim[block_index]


def sd15_unet() -> UNetConfig:
    return UNetConfig()


def sd15_inpaint_unet() -> UNetConfig:
    return dataclasses.replace(sd15_unet(), in_channels=9)


def sd21_unet() -> UNetConfig:
    """SD2.1: context 1024, 64-wide heads (5/10/20/20 per block), linear
    transformer projections."""
    return UNetConfig(cross_attention_dim=1024,
                      attention_head_dim=(5, 10, 20, 20),
                      use_linear_projection=True)


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    """ControlNet = UNet encoder copy + hint embedding + zero convs."""
    unet: UNetConfig = dataclasses.field(default_factory=sd15_unet)
    conditioning_channels: int = 3
    conditioning_embedding_channels: Tuple[int, ...] = (16, 32, 96, 256)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL (z = 4, latent scale 0.18215)."""
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text tower, ViT-L/14 (SD1.5) defaults."""
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"      # "gelu" for OpenCLIP-H
    # which hidden state feeds the UNet: 0 = final, 1 = penultimate, ...
    layer_skip: int = 0
    eos_token_id: int = 49407

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def clip_vit_l() -> CLIPTextConfig:
    return CLIPTextConfig()


def openclip_vit_h() -> CLIPTextConfig:
    """SD2.1's text tower: OpenCLIP ViT-H's penultimate output, kept as 23
    layers with the final LayerNorm (layer_skip 0), gelu."""
    return CLIPTextConfig(hidden_size=1024, intermediate_size=4096,
                          num_layers=23, num_heads=16, hidden_act="gelu",
                          layer_skip=0)
