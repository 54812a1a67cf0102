"""SD UNet (4-channel input, 9 for the inpainting UNet), diffusers module
names, NCHW.

Counterpart of ``editanything_tpu/models/unet.py``: ``time_embed``,
``context_kv``, ``encode``, ``middle``, ``decode`` and ``forward`` (the JAX
``apply``), with ControlNet residual injection. The down and mid blocks are
shared with the ControlNet (models/controlnet.py), as the JAX package
shares its encoder functions. Reference-only control (engine/refctrl.py)
hooks each transformer block's self-attention at its weight from
``unet_attn_weights`` and, with AdaIN, the output of each plain down and up
block's resnets and of the mid block.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from editanything_tpu_torch.core import layers as L
from editanything_tpu_torch.engine import refctrl
from editanything_tpu_torch.models import blocks as B
from editanything_tpu_torch.models.config import UNetConfig


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


class DownBlock(nn.Module):
    """CrossAttnDownBlock2D or DownBlock2D: resnets (+ spatial transformers)
    and an optional stride-2 downsampler."""

    def __init__(self, cfg: UNetConfig, in_ch: int, out_ch: int, *,
                 has_attn: bool, add_downsample: bool, heads: int):
        super().__init__()
        g, temb = cfg.norm_num_groups, cfg.time_embed_dim
        self.resnets = nn.ModuleList([
            B.ResnetBlock2D(in_ch if li == 0 else out_ch, out_ch, temb,
                            num_groups=g)
            for li in range(cfg.layers_per_block)])
        self.attentions = nn.ModuleList([
            B.Transformer2DModel(out_ch, cfg.cross_attention_dim, heads=heads,
                                 use_linear=cfg.use_linear_projection,
                                 num_groups=g)
            for _ in range(cfg.layers_per_block)]) if has_attn else None
        self.downsamplers = (nn.ModuleList([B.Downsample2D(out_ch)])
                             if add_downsample else None)


class MidBlock(nn.Module):
    """resnet -> spatial transformer -> resnet."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        cm, g = cfg.block_out_channels[-1], cfg.norm_num_groups
        heads = cfg.heads_for_block(len(cfg.block_out_channels) - 1)
        self.resnets = nn.ModuleList([
            B.ResnetBlock2D(cm, cm, cfg.time_embed_dim, num_groups=g)
            for _ in range(2)])
        self.attentions = nn.ModuleList([
            B.Transformer2DModel(cm, cfg.cross_attention_dim, heads=heads,
                                 use_linear=cfg.use_linear_projection,
                                 num_groups=g)])

    def forward(self, h, temb, context, *, kv=None, ref=None,
                attn_weight: float = 0.0):
        h = self.resnets[0](h, temb)
        h = self.attentions[0](h, context, kv=kv, ref=ref,
                               attn_weight=attn_weight)
        # the AdaIN hook wraps the whole mid block, at weight 0
        return refctrl.gn_hook(ref, self.resnets[1](h, temb), 0.0)


class UpBlock(nn.Module):
    """CrossAttnUpBlock2D or UpBlock2D over concatenated skips."""

    def __init__(self, cfg: UNetConfig, prev_out: int, out_ch: int,
                 skip_ch: int, *, has_attn: bool, add_upsample: bool,
                 heads: int):
        super().__init__()
        g, temb = cfg.norm_num_groups, cfg.time_embed_dim
        n = cfg.layers_per_block + 1
        self.resnets = nn.ModuleList([
            B.ResnetBlock2D((prev_out if li == 0 else out_ch)
                            + (skip_ch if li == n - 1 else out_ch),
                            out_ch, temb, num_groups=g)
            for li in range(n)])
        self.attentions = nn.ModuleList([
            B.Transformer2DModel(out_ch, cfg.cross_attention_dim, heads=heads,
                                 use_linear=cfg.use_linear_projection,
                                 num_groups=g)
            for _ in range(n)]) if has_attn else None
        self.upsamplers = (nn.ModuleList([B.Upsample2D(out_ch)])
                           if add_upsample else None)


def make_down_blocks(cfg: UNetConfig) -> nn.ModuleList:
    blocks, prev = [], cfg.block_out_channels[0]
    last = len(cfg.block_out_channels) - 1
    for bi, (bo, btype) in enumerate(zip(cfg.block_out_channels,
                                         cfg.down_block_types)):
        blocks.append(DownBlock(cfg, prev, bo,
                                has_attn=btype == "CrossAttnDownBlock2D",
                                add_downsample=bi < last,
                                heads=cfg.heads_for_block(bi)))
        prev = bo
    return nn.ModuleList(blocks)


def time_embed(module, cfg: UNetConfig, timesteps, dtype):
    """Sinusoidal embedding -> ``module.time_embedding`` MLP."""
    t = L.timestep_embedding(timesteps, cfg.block_out_channels[0],
                             flip_sin_to_cos=cfg.flip_sin_to_cos,
                             downscale_freq_shift=cfg.freq_shift, dtype=dtype)
    return module.time_embedding(t)


def encode_blocks(down_blocks: nn.ModuleList, h, temb, context, ctx_kv, *,
                  ref=None, attn_w=None):
    """Down path after conv_in. Returns (hidden, residuals list). `ref`
    hooks the blocks at the weights `attn_w` (down.{bi}.{li} keys) and, on
    plain blocks, at 1 - bi / (number of blocks)."""
    residuals = [h]
    n_down = len(down_blocks)
    for bi, blk in enumerate(down_blocks):
        for li, resnet in enumerate(blk.resnets):
            h = resnet(h, temb)
            if blk.attentions is not None:
                key = f"down.{bi}.{li}"
                h = blk.attentions[li](h, context, kv=ctx_kv.get(key), ref=ref,
                                       attn_weight=attn_w[key] if attn_w else 0.0)
            else:
                h = refctrl.gn_hook(ref, h, refctrl.gn_weight_down(bi, n_down))
            residuals.append(h)
        if blk.downsamplers is not None:
            h = blk.downsamplers[0](h)
            residuals.append(h)
    return h, residuals


def encoder_context_kv(down_blocks: nn.ModuleList, mid_block: MidBlock,
                       context):
    """Cross-attention (k, v) of the down and mid blocks, keyed
    down.{bi}.{li} / mid as in the JAX package."""
    kv = {}
    for bi, blk in enumerate(down_blocks):
        if blk.attentions is not None:
            for li, attn in enumerate(blk.attentions):
                kv[f"down.{bi}.{li}"] = attn.context_kv(context)
    kv["mid"] = mid_block.attentions[0].context_kv(context)
    return kv


class UNet2DConditionModel(nn.Module):
    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(cfg.in_channels, c0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(c0, cfg.time_embed_dim)
        self.down_blocks = make_down_blocks(cfg)
        self.mid_block = MidBlock(cfg)
        rev = list(reversed(cfg.block_out_channels))
        n_up = len(cfg.up_block_types)
        ups, prev = [], rev[0]
        for bi, btype in enumerate(cfg.up_block_types):
            ups.append(UpBlock(cfg, prev, rev[bi], rev[min(bi + 1, len(rev) - 1)],
                               has_attn=btype == "CrossAttnUpBlock2D",
                               add_upsample=bi < n_up - 1,
                               heads=cfg.heads_for_block(n_up - 1 - bi)))
            prev = rev[bi]
        self.up_blocks = nn.ModuleList(ups)
        self.conv_norm_out = L.GroupNorm(c0, cfg.norm_num_groups)
        self.conv_out = nn.Conv2d(c0, cfg.out_channels, 3, padding=1)

    def time_embed(self, timesteps, dtype):
        return time_embed(self, self.cfg, timesteps, dtype)

    def context_kv(self, context):
        """Every cross-attention (k, v) projection of `context`, computed
        once per edit (keys down.{bi}.{li} / mid / up.{bi}.{li})."""
        kv = encoder_context_kv(self.down_blocks, self.mid_block, context)
        for bi, blk in enumerate(self.up_blocks):
            if blk.attentions is not None:
                for li, attn in enumerate(blk.attentions):
                    kv[f"up.{bi}.{li}"] = attn.context_kv(context)
        return kv

    def encode(self, sample, temb, context, *, ctx_kv=None, ref=None,
               attn_w=None):
        """conv_in + down path. Returns (hidden, residuals)."""
        return encode_blocks(self.down_blocks, self.conv_in(sample), temb,
                             context, ctx_kv or {}, ref=ref, attn_w=attn_w)

    def middle(self, h, temb, context, *, ctx_kv=None, ref=None, attn_w=None):
        return self.mid_block(h, temb, context, kv=(ctx_kv or {}).get("mid"),
                              ref=ref,
                              attn_weight=attn_w["mid"] if attn_w else 0.0)

    def decode(self, h, residuals, temb, context, *, ctx_kv=None, ref=None,
               attn_w=None):
        residuals = list(residuals)
        ctx_kv = ctx_kv or {}
        n_up = len(self.up_blocks)
        for bi, blk in enumerate(self.up_blocks):
            for li, resnet in enumerate(blk.resnets):
                h = resnet(torch.cat([h, residuals.pop()], dim=1), temb)
                if blk.attentions is not None:
                    key = f"up.{bi}.{li}"
                    h = blk.attentions[li](
                        h, context, kv=ctx_kv.get(key), ref=ref,
                        attn_weight=attn_w[key] if attn_w else 0.0)
                else:
                    h = refctrl.gn_hook(ref, h, refctrl.gn_weight_up(bi, n_up))
            if blk.upsamplers is not None:
                h = blk.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h, silu=True))

    def forward(self, sample, timesteps, encoder_hidden_states, *,
                down_block_residuals=None, mid_block_residual=None,
                ctx_kv=None, ref=None):
        """(B, C_in, H, W) latents -> (B, C_out, H, W) prediction.
        ControlNet residual stacks arrive pre-summed. `ref`: a
        ``refctrl.RefState`` of the write or the read pass."""
        attn_w = refctrl.unet_attn_weights(self.cfg) if ref is not None else None
        temb = self.time_embed(timesteps, sample.dtype)
        h, residuals = self.encode(sample, temb, encoder_hidden_states,
                                   ctx_kv=ctx_kv, ref=ref, attn_w=attn_w)
        h = self.middle(h, temb, encoder_hidden_states, ctx_kv=ctx_kv, ref=ref,
                        attn_w=attn_w)
        if down_block_residuals is not None:
            residuals = [r + c.to(r.dtype)
                         for r, c in zip(residuals, down_block_residuals)]
        if mid_block_residual is not None:
            h = h + mid_block_residual.to(h.dtype)
        return self.decode(h, residuals, temb, encoder_hidden_states,
                           ctx_kv=ctx_kv, ref=ref, attn_w=attn_w)
