"""Primitives of the port: NCHW activations, fp32 normalisation statistics.

Counterpart of ``editanything_tpu/core/layers.py``. Convolutions and linear
layers are ``nn.Conv2d``/``nn.Linear`` (cuDNN and cuBLAS, as XLA does them
in the JAX package), so that package's TPU conv lowering
(``_conv2d_9shift``, layers.py:97-122) has no counterpart. Normalisation
statistics are fp32 and results are cast back to the input dtype. The two
modules here that hold parameters are named like torch's, so diffusers
state dicts load as they are.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from editanything_tpu_torch.core import flash_attention
from editanything_tpu_torch.core import kernels
# the plain attention (mask optional), under the JAX package's name
from editanything_tpu_torch.core.flash_attention import (
    flash_attention_reference as attention_reference)


def quick_gelu(x):
    """CLIP's GELU variant: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


class GroupNorm(nn.Module):
    """GroupNorm parameters (``weight``/``bias``) applied through the
    GroupNorm(+SiLU) kernel: ``norm(x, silu=True)`` is the fused form."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, *, silu: bool):
        return kernels.group_norm_silu(x, self.weight, self.bias,
                                       num_groups=self.num_groups,
                                       eps=self.eps, apply_silu=silu)


def group_norm(x, weight, bias, *, num_groups: int = 32, eps: float = 1e-5):
    """Plain GroupNorm over NCHW with fp32 statistics and affine, cast back
    to x's dtype: the JAX package's ``layers.group_norm``, which it leaves
    to XLA (the VAE attention's norm); no kernel runs it."""
    return F.group_norm(x.float(), num_groups, weight.float(), bias.float(),
                        eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with fp32 statistics whatever the activation dtype."""

    def forward(self, x):
        out = F.layer_norm(x.float(), self.normalized_shape,
                           self.weight.float(), self.bias.float(), self.eps)
        return out.to(x.dtype)


def timestep_embedding(timesteps, dim: int, *, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       dtype=torch.float32):
    """Sinusoidal timestep embeddings (diffusers ``get_timestep_embedding``
    with its SD defaults; flip_sin_to_cos=False, shift=1 is the LDM form)."""
    t = torch.as_tensor(timesteps)
    if t.dim() == 0:
        t = t[None]
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device)
                      / (half - downscale_freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb.to(dtype)


def attention(q, k, v, *, scale: Optional[float] = None, mask=None):
    """Scaled dot-product attention over (B, H, N, D) with an optional
    boolean mask (True = attend). Unmasked calls go to the flash-attention
    wrapper (the kernel on CUDA tensors, whatever their size); masked ones
    (CLIP's causal mask) to the plain attention, as XLA runs them in the JAX
    package."""
    if mask is not None:
        return attention_reference(q, k, v, scale=scale, mask=mask)
    return flash_attention.flash_attention(q, k, v, scale=scale)
