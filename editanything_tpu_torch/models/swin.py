"""Swin Transformer backbone and detectron2's FPN, for the detectors.

Counterpart of ``editanything_tpu/models/swin.py`` (GroundingDINO's Swin-T
and VLPart's Swin-B with its FPN). The modules carry the published
checkpoints' names (``patch_embed.proj``, ``layers.N.blocks.M.attn.qkv``,
``attn.relative_position_bias_table``, ``layers.N.downsample.reduction``,
``normI``; the FPN's ``lateral.I``/``output.I``), so a backbone's state dict
loads as it is once ``relative_position_index`` and ``attn_mask`` buffers
are dropped (``checkpoints/convert.py::swin_state_dict``).

- windowed attention with the relative-position bias, the shifted windows
  by a roll and the shift mask built on the host at the padded size; a
  stage whose padded side is a single window does not shift;
- the window attention adds its bias to fp32 logits and computes its own
  products, as the JAX package does (``swin.py:163-185``; its docstring's
  "through core.layers.attention" does not match its code), so no kernel
  runs it;
- patch merging (2x2 concat -> LN -> 4C -> 2C), LayerNorm eps 1e-5 every
  where (the JAX package's ``L.layer_norm`` default);
- the FPN's top-down path upsamples "nearest" with ``jax.image.resize``'s
  fp32 source indices, so odd sizes pick the same rows.

Activations are NCHW at the interfaces and (B, H*W, C) tokens inside.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from editanything_tpu_torch.core import layers as L


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 128                      # Swin-B (T: 96)
    depths: Tuple[int, ...] = (2, 2, 18, 2)   # (T: (2, 2, 6, 2))
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 7
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)

    def stage_dim(self, i: int) -> int:
        return int(self.embed_dim * 2 ** i)


def swin_base() -> SwinConfig:
    return SwinConfig()


def swin_tiny() -> SwinConfig:
    return SwinConfig(embed_dim=96, depths=(2, 2, 6, 2),
                      num_heads=(3, 6, 12, 24))


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------

class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = L.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = L.LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = nn.Linear(int(dim * mlp_ratio), dim)


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = L.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)


class SwinStage(nn.Module):
    def __init__(self, cfg: SwinConfig, i: int):
        super().__init__()
        dim = cfg.stage_dim(i)
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[i], cfg.window_size, cfg.mlp_ratio)
            for _ in range(cfg.depths[i]))
        if i < len(cfg.depths) - 1:
            self.downsample = PatchMerging(dim)


class Swin(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(cfg.in_chans, cfg.embed_dim,
                                          cfg.patch_size,
                                          stride=cfg.patch_size)
        self.patch_embed.norm = L.LayerNorm(cfg.embed_dim)
        self.layers = nn.ModuleList(SwinStage(cfg, i)
                                    for i in range(len(cfg.depths)))
        for i in cfg.out_indices:
            self.add_module(f"norm{i}", L.LayerNorm(cfg.stage_dim(i)))


class FPN(nn.Module):
    """detectron2's FPN convolutions: 1x1 laterals, 3x3 outputs."""

    def __init__(self, in_dims: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.lateral = nn.ModuleList(nn.Conv2d(d, out_channels, 1)
                                     for d in in_dims)
        self.output = nn.ModuleList(
            nn.Conv2d(out_channels, out_channels, 3, padding=1)
            for _ in in_dims)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rel_pos_index(window: int) -> np.ndarray:
    """(W^2, W^2) indices into the (2W-1)^2 bias table (standard Swin)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (window - 1)
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


@functools.lru_cache(maxsize=None)
def _shift_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(num_windows, N, N) bool, True = attend: the SW-MSA regions of the
    rolled (h, w) map, equal within a window only where both tokens come
    from one region."""
    img = np.zeros((h, w))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window, window, w // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    return win[:, None, :] == win[:, :, None]


def _window_partition(x, w: int):
    """(B, H, W, C) -> (B * nH * nW, w * w, C)."""
    b, h, ww, c = x.shape
    x = x.view(b, h // w, w, ww // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def _window_merge(x, w: int, b: int, h: int, ww: int):
    c = x.shape[-1]
    x = x.view(b, h // w, ww // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, ww, c)


def _window_attention(attn: WindowAttention, x, heads: int, window: int,
                      mask=None):
    """x (nWB, N, C); mask (nW, N, N) bool or None. Logits in fp32 with the
    bias added, masked to fp32's lowest, softmax cast to v's dtype."""
    nwb, n, c = x.shape
    q, k, v = attn.qkv(x).view(nwb, n, 3, heads, c // heads) \
        .permute(2, 0, 3, 1, 4).unbind(0)                # (nWB, H, N, dh)
    idx = torch.from_numpy(_rel_pos_index(window)).to(x.device)
    bias = attn.relative_position_bias_table[idx].permute(2, 0, 1)[None]
    scale = (c // heads) ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    logits = logits + bias.float()
    if mask is not None:
        nw = mask.shape[0]
        keep = torch.from_numpy(mask).to(x.device)[None, :, None]
        logits = logits.view(nwb // nw, nw, heads, n, n).masked_fill(
            ~keep, torch.finfo(torch.float32).min).view(nwb, heads, n, n)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(nwb, n, c)
    return attn.proj(out)


def _swin_block(blk: SwinBlock, x, hw, heads: int, window: int, shift: int):
    """x (B, H*W, C) at the unpadded (H, W) = hw."""
    h, w = hw
    b, _, c = x.shape
    res = x
    x = blk.norm1(x).view(b, h, w, c)
    pad_b, pad_r = (window - h % window) % window, (window - w % window) % window
    if pad_b or pad_r:
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    hp, wp = h + pad_b, w + pad_r
    use_shift = shift > 0 and (hp > window or wp > window)
    mask = None
    if use_shift:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = _shift_mask(hp, wp, window, shift)
    wins = _window_attention(blk.attn, _window_partition(x, window), heads,
                             window, mask)
    x = _window_merge(wins, window, b, hp, wp)
    if use_shift:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = res + x[:, :h, :w].reshape(b, h * w, c)
    y = blk.mlp.fc2(F.gelu(blk.mlp.fc1(blk.norm2(x))))
    return x + y


def _patch_merging(p: PatchMerging, x, hw):
    """(B, H*W, C) -> (B, ceil(H/2) * ceil(W/2), 2C), the new (h, w)."""
    h, w = hw
    b, _, c = x.shape
    x = x.view(b, h, w, c)
    if h % 2 or w % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1)
    nh, nw = x.shape[1], x.shape[2]
    return p.reduction(p.norm(x.reshape(b, nh * nw, 4 * c))), (nh, nw)


def swin_forward(model: Swin, pixels) -> Dict[str, torch.Tensor]:
    """(B, 3, H, W) normalised pixels -> {"swin{i}": (B, C_i, H/2^(2+i),
    W/2^(2+i))} for the configured out indices (sides rounded up)."""
    cfg = model.cfg
    ps = cfg.patch_size
    h0, w0 = pixels.shape[-2:]
    proj = model.patch_embed.proj
    x = pixels.to(proj.weight.dtype)
    if h0 % ps or w0 % ps:
        x = F.pad(x, (0, (ps - w0 % ps) % ps, 0, (ps - h0 % ps) % ps))
    x = proj(x)
    b, _, h, w = x.shape
    x = model.patch_embed.norm(x.flatten(2).transpose(1, 2))
    outs = {}
    hw = (h, w)
    for i, stage in enumerate(model.layers):
        for bi, blk in enumerate(stage.blocks):
            shift = 0 if bi % 2 == 0 else cfg.window_size // 2
            x = _swin_block(blk, x, hw, cfg.num_heads[i], cfg.window_size,
                            shift)
        if i in cfg.out_indices:
            y = getattr(model, f"norm{i}")(x)
            outs[f"swin{i}"] = y.transpose(1, 2).reshape(
                b, cfg.stage_dim(i), *hw)
        if hasattr(stage, "downsample"):
            x, hw = _patch_merging(stage.downsample, x, hw)
    return outs


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """jax.image.resize "nearest" source rows: floor((i + 0.5) * in / out)
    in fp32, as JAX computes them."""
    pos = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
           * np.float32(n_in) / np.float32(n_out))
    return torch.from_numpy(np.floor(pos).astype(np.int64)).to(device)


def fpn_forward(fpn: FPN, feats: Sequence[torch.Tensor], *,
                extra_maxpool: bool = True) -> Dict[str, torch.Tensor]:
    """feats fine -> coarse (NCHW) -> {"p2".."p5", "p6"} (stride 4..64):
    laterals summed top-down with nearest upsampling, 3x3 outputs, and
    LastLevelMaxPool's 1x1 / stride-2 pool of the coarsest output."""
    n = len(feats)
    lat = [fpn.lateral[i](f) for i, f in enumerate(feats)]
    for i in range(n - 2, -1, -1):
        (h, w), (h1, w1) = lat[i].shape[-2:], lat[i + 1].shape[-2:]
        up = lat[i + 1].index_select(2, _nearest_index(h1, h, lat[i].device))
        lat[i] = lat[i] + up.index_select(3, _nearest_index(w1, w,
                                                            lat[i].device))
    outs = {f"p{i + 2}": fpn.output[i](lat[i]) for i in range(n)}
    if extra_maxpool:
        outs[f"p{n + 2}"] = outs[f"p{n + 1}"][:, :, ::2, ::2]
    return outs
