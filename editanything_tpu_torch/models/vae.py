"""AutoencoderKL, SD's VAE (NCHW, diffusers module names).

Counterpart of ``editanything_tpu/models/vae.py``: ``encode`` (to a
``GaussianPosterior``), ``decode``, ``encode_to_latents`` (posterior mode)
and ``decode_from_latents``, one-shot. The tiled encode/decode for images
above 2048^2 is not ported yet (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

from typing import NamedTuple

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

    def encode_to_latents(self, x):
        """Image -> scaled latents (posterior mode), fp32."""
        return self.encode(x).mode() * self.cfg.scaling_factor

    def decode_from_latents(self, z):
        return self.decode(z / self.cfg.scaling_factor)
