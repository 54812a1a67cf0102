"""ControlNet: the UNet encoder copy, hint embedding and zero convs (NCHW).

Counterpart of ``editanything_tpu/models/controlnet.py``: the one-shot hint
stack (``_hint_embedding_oneshot``, :93-101), the scalar and per-pixel
conditioning scales (``_resize_corners``, ``_scale_residual``, :174-204),
guess mode's residual scales (:278-283), ``context_kv``, ``apply`` (here
``forward``) and ``multi_controlnet_apply`` (:291-317), with the
reference-only control hooks on the last net (engine/refctrl.py). The
JAX package's tiled hint stack (``_hint_embedding_tiled``) computes the
same function in row bands for the TPU's lane padding; the one-shot stack
runs at every size here (at (2, 3, 4096, 4096) in bf16 it holds 4 GiB
above its input on an H100 80GB, chip_smoke.py phase 4d).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from editanything_tpu_torch.engine import refctrl
from editanything_tpu_torch.models import unet as U
from editanything_tpu_torch.models.config import ControlNetConfig


class ControlNetConditioningEmbedding(nn.Module):
    """(B, 3, H, W) image-space hint -> (B, C0, H/8, W/8): conv_in, pairs of
    (3x3, 3x3 stride 2) convs with SiLU, zero-initialised conv_out."""

    def __init__(self, cfg: ControlNetConfig):
        super().__init__()
        chans = cfg.conditioning_embedding_channels
        self.conv_in = nn.Conv2d(cfg.conditioning_channels, chans[0], 3,
                                 padding=1)
        blocks = []
        for i in range(len(chans) - 1):
            blocks.append(nn.Conv2d(chans[i], chans[i], 3, padding=1))
            blocks.append(nn.Conv2d(chans[i], chans[i + 1], 3, stride=2,
                                    padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = nn.Conv2d(chans[-1], cfg.unet.block_out_channels[0], 3,
                                  padding=1)

    def forward(self, cond):
        h = F.silu(self.conv_in(cond))
        for blk in self.blocks:
            h = F.silu(blk(h))
        return self.conv_out(h)


def _as_dtype_scalar(scale: float, dtype) -> float:
    """The scale rounded to the residual dtype, as the JAX package casts it."""
    return float(torch.tensor(float(scale), dtype=dtype))


def _resize_corners(img, h: int, w: int):
    """(B, Hi, Wi) -> (B, h, w): bilinear with align_corners=True (output
    pixel i samples source coordinate i * (in - 1) / (out - 1)), no
    antialias."""
    if tuple(img.shape[-2:]) == (h, w):
        return img
    return F.interpolate(img[:, None], size=(h, w), mode="bilinear",
                         align_corners=True)[:, 0]


def _scale_residual(res, scale: float, scale_map=None):
    """The scalar conditioning scale and, when given, the per-pixel map
    (B, Hm, Wm), resized to the residual's size in fp32, on one residual."""
    out = res * _as_dtype_scalar(scale, res.dtype)
    if scale_map is not None:
        m = _resize_corners(scale_map.float(), *res.shape[-2:])
        out = out * m[:, None].to(res.dtype)
    return out


def guess_mode_scales(n: int):
    """logspace(-1, 0, n + 1) as float32, the weakest at the shallowest of
    the n down residuals, the last for the mid residual."""
    return torch.logspace(-1.0, 0.0, n + 1, dtype=torch.float64).float()


class ControlNetModel(nn.Module):
    def __init__(self, cfg: ControlNetConfig):
        super().__init__()
        self.cfg = cfg
        ucfg = cfg.unet
        c0 = ucfg.block_out_channels[0]
        self.conv_in = nn.Conv2d(ucfg.in_channels, c0, 3, padding=1)
        self.time_embedding = U.TimestepEmbedding(c0, ucfg.time_embed_dim)
        self.down_blocks = U.make_down_blocks(ucfg)
        self.mid_block = U.MidBlock(ucfg)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(cfg)
        zero = [c0]
        for bi, bo in enumerate(ucfg.block_out_channels):
            zero += [bo] * ucfg.layers_per_block
            if bi < len(ucfg.block_out_channels) - 1:
                zero.append(bo)
        self.controlnet_down_blocks = nn.ModuleList(
            [nn.Conv2d(c, c, 1) for c in zero])
        cm = ucfg.block_out_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(cm, cm, 1)

    def hint_embedding(self, cond):
        return self.controlnet_cond_embedding(cond)

    def context_kv(self, context):
        """Cross-attention (k, v) of the encoder and mid blocks."""
        return U.encoder_context_kv(self.down_blocks, self.mid_block, context)

    def forward(self, sample, timesteps, encoder_hidden_states,
                controlnet_cond=None, *, conditioning_scale: float = 1.0,
                conditioning_scale_map=None, guess_mode: bool = False,
                hint_embedding=None, ctx_kv=None, ref=None):
        """Returns (down residuals tuple, mid residual). ``hint_embedding``
        is the precomputed hint stack output (loop-invariant across steps);
        without it ``controlnet_cond`` (B, 3, 8h, 8w) in [0, 1] is encoded.
        ``conditioning_scale_map`` (B, Hm, Wm) scales every residual per
        pixel; ``guess_mode`` scales them by ``guess_mode_scales`` first.
        ``ref``: a ``refctrl.RefState`` hooking the blocks at
        ``controlnet_attn_weights``."""
        ucfg = self.cfg.unet
        attn_w = (refctrl.controlnet_attn_weights(self.cfg)
                  if ref is not None else None)
        ctx_kv = ctx_kv or {}
        temb = U.time_embed(self, ucfg, timesteps, sample.dtype)
        if hint_embedding is None:
            hint_embedding = self.hint_embedding(controlnet_cond.to(sample.dtype))
        h = self.conv_in(sample) + hint_embedding.to(sample.dtype)
        h, residuals = U.encode_blocks(self.down_blocks, h, temb,
                                       encoder_hidden_states, ctx_kv, ref=ref,
                                       attn_w=attn_w)
        h = self.mid_block(h, temb, encoder_hidden_states,
                           kv=ctx_kv.get("mid"), ref=ref,
                           attn_weight=attn_w["mid"] if attn_w else 0.0)
        down = [conv(r) for conv, r in zip(self.controlnet_down_blocks,
                                           residuals)]
        mid = self.controlnet_mid_block(h)
        if guess_mode:
            # float32 scales promote the residuals to float32, as JAX's
            # float32 logspace does, before the conditioning scale and map
            scales = guess_mode_scales(len(down)).tolist()
            down = [r.float() * s for r, s in zip(down, scales)]
            mid = mid.float() * scales[-1]
        return (tuple(_scale_residual(r, conditioning_scale,
                                      conditioning_scale_map) for r in down),
                _scale_residual(mid, conditioning_scale,
                                conditioning_scale_map))


def multi_controlnet_apply(controlnets: Sequence[ControlNetModel], sample,
                           timesteps, encoder_hidden_states, conds, scales,
                           scale_map_list: Optional[Sequence] = None,
                           guess_mode: bool = False,
                           hint_embeddings: Optional[Sequence] = None,
                           ctx_kvs: Optional[Sequence] = None, ref=None):
    """Sum the residual stacks of several ControlNets ([SAM, inpaint] on
    the edit path); ``scale_map_list`` holds one map or None per net. `ref`
    hooks the last (the inpaint) net only."""
    n = len(controlnets)
    scale_map_list = scale_map_list or [None] * n
    hint_embeddings = hint_embeddings or [None] * n
    ctx_kvs = ctx_kvs or [None] * n
    conds = conds or [None] * n
    down_acc = mid_acc = None
    for i, (net, cond, s, smap, hint, kv) in enumerate(zip(
            controlnets, conds, scales, scale_map_list, hint_embeddings,
            ctx_kvs)):
        down, mid = net(sample, timesteps, encoder_hidden_states, cond,
                        conditioning_scale=s, conditioning_scale_map=smap,
                        guess_mode=guess_mode, hint_embedding=hint,
                        ctx_kv=kv, ref=ref if i == n - 1 else None)
        if down_acc is None:
            down_acc, mid_acc = list(down), mid
        else:
            down_acc = [a + b for a, b in zip(down_acc, down)]
            mid_acc = mid_acc + mid
    return tuple(down_acc), mid_acc
