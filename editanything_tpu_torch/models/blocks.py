"""Shared UNet/VAE building blocks (NCHW shapes, diffusers module names;
channels-last memory where the conv weights are, models/layout.py).

Counterpart of ``editanything_tpu/models/blocks.py``. Module attribute paths
are the diffusers names the JAX parameter trees follow (``norm1``,
``attn1.to_out.0``, ``ff.net.0.proj``, ...), so one state dict serves both
packages (checkpoints/convert.py). Under the JAX package's opt-in switch
``EA_RESNET_FUSED=1`` (read at every call, default off) every resnet block
runs as one call of kernel E (``kernels.resnet_fused``: six device launches,
up to ten where the small blocks split their convs over K, with the conv
weights packed tap-major once per weight and cached); otherwise the composed
ops (cuDNN convs and the GroupNorm kernel).
"""

from __future__ import annotations

import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from editanything_tpu_torch.core import kernels as K
from editanything_tpu_torch.core import layers as L


class ResnetBlock2D(nn.Module):
    """GroupNorm-SiLU-Conv x2 with additive time embedding and skip.
    eps 1e-5 in the UNet, 1e-6 in the VAE."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch=None, *,
                 num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = L.GroupNorm(in_ch, num_groups, eps)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_ch, out_ch) if temb_ch else None
        self.norm2 = L.GroupNorm(out_ch, num_groups, eps)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1)
                              if in_ch != out_ch else None)

    def forward(self, x, temb=None):
        trow = None
        if temb is not None and self.time_emb_proj is not None:
            trow = self.time_emb_proj(F.silu(temb))
        if os.environ.get("EA_RESNET_FUSED", "0") == "1":
            sc = self.conv_shortcut
            return K.resnet_fused(
                x, self.norm1.weight, self.norm1.bias, self.conv1.weight,
                self.conv1.bias, trow, self.norm2.weight, self.norm2.bias,
                self.conv2.weight, self.conv2.bias,
                None if sc is None else sc.weight,
                None if sc is None else sc.bias,
                num_groups=self.norm1.num_groups, eps=self.norm1.eps)
        h = self.conv1(self.norm1(x, silu=True))
        if trow is not None:
            h = h + trow[:, :, None, None].to(h.dtype)
        h = self.conv2(self.norm2(h, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    """Multi-head attention over (B, N, C), optionally across a context."""

    def __init__(self, query_dim: int, context_dim=None, *, heads: int):
        super().__init__()
        context_dim = context_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(context_dim, query_dim, bias=False)
        self.to_v = nn.Linear(context_dim, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def project_kv(self, context):
        """The K/V projections of a context; a denoise loop computes them
        once per edit and passes them back as ``kv``."""
        return self.to_k(context), self.to_v(context)

    def forward(self, x, context=None, *, kv=None):
        """The head width comes from `x`'s whole width and the head count
        from the projections': under tensor parallelism
        (parallel/sharding.py) they hold this rank's heads alone."""
        b, n, c = x.shape
        q = self.to_q(x)
        if kv is not None:
            k, v = kv[0].to(x.dtype), kv[1].to(x.dtype)
        else:
            k, v = self.project_kv(x if context is None else context)
        d = c // self.heads
        q = q.view(b, n, -1, d).transpose(1, 2)
        k = k.view(b, k.shape[1], -1, d).transpose(1, 2)
        v = v.view(b, v.shape[1], -1, d).transpose(1, 2)
        out = L.attention(q, k, v)
        out = out.transpose(1, 2).reshape(b, n, -1)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    """Gated GELU of the SD transformer FFN: project to 2x, gate with GELU.
    Under tensor parallelism ``proj`` holds this rank's slice of each half
    (parallel/sharding.py's ``geglu`` placement), so ``chunk(2)`` still
    pairs them."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """``net.0`` GEGLU, ``net.1`` dropout slot (identity at inference),
    ``net.2`` output projection, as diffusers numbers them."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    """Self-attention, cross-attention, GEGLU feed-forward."""

    def __init__(self, dim: int, context_dim: int, *, heads: int):
        super().__init__()
        self.norm1 = L.LayerNorm(dim)
        self.attn1 = Attention(dim, None, heads=heads)
        self.norm2 = L.LayerNorm(dim)
        self.attn2 = Attention(dim, context_dim, heads=heads)
        self.norm3 = L.LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, *, kv=None, ref=None,
                attn_weight: float = 0.0, hw=None):
        """`ref` (engine/refctrl.py ``RefState``) hooks the self-attention
        when active at `attn_weight`: the write pass banks norm1(x) of the
        (h, w) = `hw` token grid, the read pass attends over the banks."""
        norm_x = self.norm1(x)
        if ref is not None and ref.attn_active(attn_weight):
            if ref.mode == "write":
                ref.write_attn(norm_x, hw)
                a = self.attn1(norm_x)
            else:
                a = ref.read_attn(self.attn1, norm_x, hw)
        else:
            a = self.attn1(norm_x)
        x = x + a
        x = x + self.attn2(self.norm2(x), context, kv=kv)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    """Spatial transformer: GroupNorm (eps 1e-6, no SiLU), projection in,
    transformer blocks over the H*W tokens, projection out, residual."""

    def __init__(self, channels: int, context_dim: int, *, heads: int,
                 depth: int = 1, use_linear: bool = False,
                 num_groups: int = 32):
        super().__init__()
        self.use_linear = use_linear
        self.norm = L.GroupNorm(channels, num_groups, eps=1e-6)
        proj = (lambda: nn.Linear(channels, channels)) if use_linear else \
            (lambda: nn.Conv2d(channels, channels, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, context_dim, heads=heads)
             for _ in range(depth)])
        self.proj_out = proj()

    def context_kv(self, context):
        """{block index: (k, v)} cross-attention projections of `context`."""
        return {str(i): blk.attn2.project_kv(context)
                for i, blk in enumerate(self.transformer_blocks)}

    def forward(self, x, context, *, kv=None, ref=None,
                attn_weight: float = 0.0):
        b, c, h, w = x.shape
        hidden = self.norm(x, silu=False)
        if self.use_linear:
            hidden = self.proj_in(hidden.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            hidden = self.proj_in(hidden).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for i, blk in enumerate(self.transformer_blocks):
            hidden = blk(hidden, context, kv=kv[str(i)] if kv else None,
                         ref=ref, attn_weight=attn_weight, hw=(h, w))
        if self.use_linear:
            hidden = self.proj_out(hidden)
        # back to x's layout: a view where x is channels-last, where the
        # token rows already lie as NHWC
        hidden = hidden.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last if K.is_channels_last(x)
            else torch.contiguous_format)
        if not self.use_linear:
            hidden = self.proj_out(hidden)
        return hidden + x


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv, padding 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample2D(nn.Module):
    """2x nearest upsampling, then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class VAEAttention(nn.Module):
    """The VAE mid-block's single-head attention (plain GroupNorm, eps 1e-6,
    as in the JAX package)."""

    def __init__(self, channels: int, *, num_groups: int = 32):
        super().__init__()
        self.num_groups = num_groups
        self.group_norm = L.GroupNorm(channels, num_groups, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, c, h, w = x.shape
        hidden = L.group_norm(x, self.group_norm.weight, self.group_norm.bias,
                              num_groups=self.num_groups, eps=1e-6)
        hidden = hidden.permute(0, 2, 3, 1).reshape(b, h * w, c)
        q = self.to_q(hidden)[:, None]
        k = self.to_k(hidden)[:, None]
        v = self.to_v(hidden)[:, None]
        out = L.attention(q, k, v)[:, 0]
        out = self.to_out[0](out.reshape(b, h * w, c))
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)
