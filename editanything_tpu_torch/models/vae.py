"""AutoencoderKL, SD's VAE (NCHW, diffusers module names).

Counterpart of ``editanything_tpu/models/vae.py``: ``encode`` (to a
``GaussianPosterior``), ``decode``, ``encode_to_latents`` (posterior mode)
and ``decode_from_latents``, one-shot or tiled: ``decode_tiled`` and
``encode_tiled`` (:154-295) run the same Decoder/Encoder over overlapping
tiles, each tile with its own GroupNorm statistics, and add the tiles,
weighted by a separable linear ramp over the overlaps, into an fp32 canvas
that is divided by the summed weights at the end. On CUDA every tile runs
kernel B (the mid-block attention) and kernel A (every GroupNorm) as the
one-shot model does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn as nn

from editanything_tpu_torch.models import blocks as B
from editanything_tpu_torch.core import layers as L
from editanything_tpu_torch.models.config import VAEConfig


class GaussianPosterior(NamedTuple):
    """Diagonal Gaussian over the latents (fp32)."""
    mean: torch.Tensor
    logvar: torch.Tensor

    def mode(self):
        return self.mean

    def sample(self, noise):
        """mean + std * `noise` (a draw of the latents' shape, passed in),
        the log-variance clipped to [-30, 20] (ldm's
        DiagonalGaussianDistribution, as the JAX package samples it)."""
        std = torch.exp(0.5 * torch.clamp(self.logvar, -30.0, 20.0))
        return self.mean + std * noise.to(self.mean.dtype)


class _VAEMidBlock(nn.Module):
    def __init__(self, ch: int, g: int):
        super().__init__()
        self.resnets = nn.ModuleList(
            [B.ResnetBlock2D(ch, ch, None, num_groups=g, eps=1e-6)
             for _ in range(2)])
        self.attentions = nn.ModuleList([B.VAEAttention(ch, num_groups=g)])

    def forward(self, h):
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class _VAEBlock(nn.Module):
    """Resnets plus an optional down- or upsampler."""

    def __init__(self, chans, g: int, *, down: bool = False, up: bool = False):
        super().__init__()
        self.resnets = nn.ModuleList(
            [B.ResnetBlock2D(cin, cout, None, num_groups=g, eps=1e-6)
             for cin, cout in chans])
        out = chans[-1][1]
        self.downsamplers = nn.ModuleList([B.Downsample2D(out)]) if down else None
        self.upsamplers = nn.ModuleList([B.Upsample2D(out)]) if up else None

    def forward(self, h):
        for resnet in self.resnets:
            h = resnet(h)
        if self.downsamplers is not None:
            h = self.downsamplers[0](h)
        if self.upsamplers is not None:
            h = self.upsamplers[0](h)
        return h


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        cbs, g = cfg.block_out_channels, cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, cbs[0], 3, padding=1)
        blocks, ch = [], cbs[0]
        for bi, bo in enumerate(cbs):
            chans = [(ch if li == 0 else bo, bo)
                     for li in range(cfg.layers_per_block)]
            blocks.append(_VAEBlock(chans, g, down=bi < len(cbs) - 1))
            ch = bo
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _VAEMidBlock(ch, g)
        self.conv_norm_out = L.GroupNorm(ch, g, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(self.conv_norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev, g = list(reversed(cfg.block_out_channels)), cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _VAEMidBlock(rev[0], g)
        blocks, ch = [], rev[0]
        for bi, bo in enumerate(rev):
            chans = [(ch if li == 0 else bo, bo)
                     for li in range(cfg.layers_per_block + 1)]
            blocks.append(_VAEBlock(chans, g, up=bi < len(rev) - 1))
            ch = bo
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = L.GroupNorm(rev[-1], g, eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(self.conv_norm_out(h, silu=True))


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        zc = cfg.latent_channels
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = nn.Conv2d(2 * zc, 2 * zc, 1)
        self.post_quant_conv = nn.Conv2d(zc, zc, 1)

    def encode(self, x) -> GaussianPosterior:
        """(B, 3, H, W) in [-1, 1] -> posterior over (B, 4, H/8, W/8)."""
        h = self.quant_conv(self.encoder(x))
        mean, logvar = h.float().chunk(2, dim=1)
        return GaussianPosterior(mean, logvar)

    def decode(self, z):
        """(B, 4, h, w) unscaled latents -> (B, 3, 8h, 8w) in [-1, 1]."""
        return self.decoder(self.post_quant_conv(z))

    def encode_to_latents(self, x, *, tile=None, overlap: int = 256):
        """Image -> scaled latents (posterior mode), fp32; `tile` (image px)
        switches to ``encode_tiled``."""
        post = (self.encode(x) if tile is None
                else encode_tiled(self, x, tile=tile, overlap=overlap))
        return post.mode() * self.cfg.scaling_factor

    def decode_from_latents(self, z, *, tile=None, overlap: int = 32):
        """Scaled latents -> image; `tile` (latent px) switches to
        ``decode_tiled``."""
        z = z / self.cfg.scaling_factor
        if tile is None:
            return self.decode(z)
        return decode_tiled(self, z, tile=tile, overlap=overlap)


# ---- tiled encode/decode ---------------------------------------------------

def _tile_starts(size: int, tile: int, stride: int):
    """Start offsets covering [0, size) with full-size tiles; the last tile
    is clamped to end exactly at `size`."""
    if size <= tile:
        return [0]
    starts = list(range(0, size - tile, stride))
    starts.append(size - tile)
    return starts


def _ramp(tile_px: int, ov_px: int) -> np.ndarray:
    """1-D blend profile: a linear ramp over the overlap at both ends, 1 in
    the interior (single-cover borders divide out exactly)."""
    r = np.ones((tile_px,), np.float32)
    if ov_px > 0:
        ramp = (np.arange(ov_px, dtype=np.float32) + 1.0) / (ov_px + 1.0)
        r[:ov_px] = ramp
        r[tile_px - ov_px:] = ramp[::-1]
    return r


def _blend_weight(th_px: int, tw_px: int, ov_h_px: int, ov_w_px: int):
    """(th, tw) separable pyramid, per dimension (a dimension that fits one
    tile has no ramp)."""
    return torch.from_numpy(_ramp(th_px, ov_h_px)[:, None]
                            * _ramp(tw_px, ov_w_px)[None, :])


def _tile_plan(h: int, w: int, tile: int, overlap: int):
    """(th, tw, ov_h, ov_w, [(y, x)]): a dimension that fits the tile gets
    one clamped tile and no overlap; the other may still be tiled."""
    th, tw = min(tile, h), min(tile, w)
    ov_h = overlap if h > th else 0
    ov_w = overlap if w > tw else 0
    pos = [(y, x) for y in _tile_starts(h, th, th - ov_h)
           for x in _tile_starts(w, tw, tw - ov_w)]
    return th, tw, ov_h, ov_w, pos


def _scale_factor(cfg: VAEConfig) -> int:
    return 2 ** (len(cfg.block_out_channels) - 1)


def decode_tiled(vae: AutoencoderKL, z, tile: int = 128, overlap: int = 32):
    """Tiled ``decode``: (B, zc, h, w) unscaled latents -> (B, 3, f*h, f*w).
    `tile`/`overlap` in latent pixels; one-shot where one tile covers z."""
    b, _, h, w = z.shape
    if h <= tile and w <= tile:
        return vae.decode(z)
    f = _scale_factor(vae.cfg)
    th, tw, ov_h, ov_w, pos = _tile_plan(h, w, tile, overlap)
    wt = _blend_weight(th * f, tw * f, ov_h * f, ov_w * f).to(z.device)
    canvas = torch.zeros(b, vae.cfg.out_channels, h * f, w * f,
                         dtype=torch.float32, device=z.device)
    wsum = torch.zeros(h * f, w * f, dtype=torch.float32, device=z.device)
    for y, x in pos:
        img = vae.decode(z[:, :, y:y + th, x:x + tw])
        oy, ox = y * f, x * f
        canvas[:, :, oy:oy + th * f, ox:ox + tw * f] += img.float() * wt
        wsum[oy:oy + th * f, ox:ox + tw * f] += wt
    return (canvas / wsum).to(img.dtype)


def encode_tiled(vae: AutoencoderKL, x, tile: int = 1024,
                 overlap: int = 256) -> GaussianPosterior:
    """Tiled ``encode``; `tile`/`overlap` in image pixels, multiples of the
    scale factor f, as the image's sides. The posterior's mean and log
    variance blend in latent space with the ramps of ``decode_tiled``."""
    b, _, h, w = x.shape
    if h <= tile and w <= tile:
        return vae.encode(x)
    f = _scale_factor(vae.cfg)
    if tile % f or overlap % f or h % f or w % f:
        raise ValueError(f"tile/overlap/image dims must be multiples of {f}")
    th, tw, ov_h, ov_w, pos = _tile_plan(h, w, tile, overlap)
    wt = _blend_weight(th // f, tw // f, ov_h // f, ov_w // f).to(x.device)
    lh, lw, zc = h // f, w // f, vae.cfg.latent_channels
    mean = torch.zeros(b, zc, lh, lw, dtype=torch.float32, device=x.device)
    logvar = torch.zeros_like(mean)
    wsum = torch.zeros(lh, lw, dtype=torch.float32, device=x.device)
    for y, xx in pos:
        post = vae.encode(x[:, :, y:y + th, xx:xx + tw])
        oy, ox = y // f, xx // f
        win = (slice(None), slice(None), slice(oy, oy + th // f),
               slice(ox, ox + tw // f))
        mean[win] += post.mean * wt
        logvar[win] += post.logvar * wt
        wsum[win[2:]] += wt
    return GaussianPosterior(mean / wsum, logvar / wsum)
