"""Plain fp32 operations of the reference, and the lower precisions that
its controls run in.

Every product of the reference (linear layers, convolutions, the two
products of attention) goes through ``linear``, ``conv2d``,
``conv_transpose2d`` or ``attention`` here, so that a control can run the
whole reference one precision lower:

- ``precision("fp8")``: both operands of every product rounded to
  float8 e4m3 with a per-tensor scale (amax / 448), the sums in fp32: the
  precision below bf16.
- ``precision("tf32")``: fp32 with TF32 allowed in cuBLAS and cuDNN: the
  precision below fp32 with TF32 off.

Outside those contexts the reference computes in fp32 with TF32 off.
Imports nothing of the port.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_MODE = {"lower": None}
# the S matrix of one block of attention rows, in elements (1 GiB of fp32)
ATTENTION_BLOCK = 2 ** 28


@contextlib.contextmanager
def precision(lower):
    """Run the reference in `lower` ("fp8", "tf32") inside, fp32 outside."""
    if lower not in ("fp8", "tf32"):
        raise ValueError(f"unknown lower precision {lower!r}")
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    _MODE["lower"] = lower
    if lower == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        _MODE["lower"] = None
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def fp32_exact():
    """TF32 off in cuBLAS and cuDNN inside (the reference's own setting)."""
    cuda, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda
        torch.backends.cudnn.allow_tf32 = cudnn


def fp8(x):
    """x rounded to float8 e4m3 under a per-tensor scale, back in fp32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / 448.0
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


def _q(x):
    return fp8(x) if _MODE["lower"] == "fp8" else x.float()


def linear(x, weight, bias=None):
    return F.linear(_q(x), _q(weight), None if bias is None else bias.float())


def conv2d(x, weight, bias=None, stride=1, padding=0):
    return F.conv2d(_q(x), _q(weight), None if bias is None else bias.float(),
                    stride=stride, padding=padding)


def conv_transpose2d(x, weight, bias=None, stride=1):
    return F.conv_transpose2d(_q(x), _q(weight),
                              None if bias is None else bias.float(),
                              stride=stride)


def matmul(a, b):
    return torch.matmul(_q(a), _q(b))


def attention(q, k, v, *, scale=None, mask=None):
    """softmax(q k^T scale) v over (B, H, N, D) in fp32, in blocks of the
    batch-head axis and of the query rows so that no block's logits pass
    ``ATTENTION_BLOCK`` elements. `mask` (broadcast to (B, H, N, M), True =
    attend) is CLIP's causal mask."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    b, h, n, _ = q.shape
    m = k.shape[-2]
    qf, kf, vf = (t.float().reshape(b * h, t.shape[-2], t.shape[-1])
                  for t in (q, k, v))
    rows = max(1, min(n, ATTENTION_BLOCK // max(1, m)))
    heads = max(1, min(b * h, ATTENTION_BLOCK // max(1, rows * m)))
    full = None if mask is None else mask.expand(b, h, n, m).reshape(b * h, n, m)
    out = []
    for i in range(0, b * h, heads):
        part = []
        for r in range(0, n, rows):
            logits = matmul(qf[i:i + heads, r:r + rows],
                            kf[i:i + heads].transpose(-1, -2)) * scale
            if full is not None:
                logits = logits.masked_fill(~full[i:i + heads, r:r + rows],
                                            torch.finfo(torch.float32).min)
            part.append(matmul(torch.softmax(logits, dim=-1), vf[i:i + heads]))
        out.append(torch.cat(part, dim=1))
    return torch.cat(out).reshape(b, h, n, v.shape[-1])


def group_norm(x, weight, bias, num_groups, eps, silu=False):
    y = F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)
    return F.silu(y) if silu else y


def layer_norm(x, weight, bias, eps=1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps)


def layer_norm_2d(x, weight, bias, eps=1e-6):
    """LayerNorm over the channels of NCHW."""
    mu = x.mean(1, keepdim=True)
    var = (x - mu).square().mean(1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * weight.float()[:, None, None] + bias.float()[:, None, None]


def timestep_embedding(t, dim, flip_sin_to_cos=True, shift=0.0):
    """Sinusoidal embedding of timesteps (B,) -> (B, dim), fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - shift))
    args = t.float()[:, None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
