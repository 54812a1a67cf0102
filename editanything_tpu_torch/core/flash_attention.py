"""Flash attention: the CUDA C++ kernel for Hopper and its plain PyTorch twin.

Replaces the Pallas TPU kernel ``editanything_tpu/core/flash_attention.py``
(``_flash_kernel``, :64; ``flash_attention``, :114; ``dispatch``, :207). The
kernel source, with its note on what bounds it on the H100 and how its
design answers that, is ``csrc/flash_attention.cu``; it is built with nvcc
at first use (core/build.py) and called through ctypes.

Dispatch differs from the JAX package on purpose: every unmasked call on a
CUDA tensor goes to the kernel, whatever its size (the JAX ``n < 128`` rule
is a TPU tiling choice). Masked attention (the CLIP causal mask) is the
plain twin with a mask, as it is XLA in the JAX package; ``layers.attention``
makes that choice. A CPU tensor takes the plain twin; any other device
raises. Where autograd records, the kernel runs inside
``core.kernels.TwinVJP``, whose backward recomputes through the twin.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from editanything_tpu_torch.core.kernels import twin_vjp

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q, k, v, *, scale: Optional[float] = None,
                              mask=None):
    """Plain attention over (B, H, N, D), with an optional boolean mask
    (True = attend). Unmasked, it is the kernel's plain twin: on CUDA only
    the tests and chip_smoke.py call it so, to hold the kernel to it. Masked,
    it is the package's only masked attention (CLIP's causal mask), which no
    kernel runs.

    Logits and softmax in fp32 from the storage-dtype inputs (bf16 products
    are exact in fp32), probabilities cast to v's dtype before the product
    with v, as the JAX reference does (core/layers.py:248-263)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    from editanything_tpu_torch.core.build import load_library
    lib = load_library("flash_attention")
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ea_flash_attention.argtypes = (
        [ptr] * 4 + [ll] * 12 + [i32] * 6 + [ctypes.c_float, i32, ptr])
    lib.ea_flash_attention.restype = i32
    lib.ea_cuda_error_string.argtypes = [i32]
    lib.ea_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load the kernel library (first use does this anyway)."""
    _library()


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, N, D) tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention takes fp32 or bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    b, h, _, dqk = q.shape
    if k.shape[:2] != (b, h) or v.shape[:2] != (b, h):
        raise ValueError(f"batch/head mismatch: {q.shape} {k.shape} {v.shape}")
    if k.shape[3] != dqk or v.shape[2] != k.shape[2]:
        raise ValueError(f"shape mismatch: {q.shape} {k.shape} {v.shape}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the last axis of q, k and v must be contiguous")


def _launch(q, k, v, scale: float):
    """One launch of the kernel on checked CUDA q, k, v (counted)."""
    _check(q, k, v)
    b, h, n, dqk = q.shape
    m, dv = v.shape[2], v.shape[3]
    out = torch.empty((b, n, h, dv), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.ea_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], b, h, n, m, dqk, dv, float(scale),
            _DTYPE_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.ea_cuda_error_string(err).decode())
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, scale: Optional[float] = None):
    """softmax(scale q k^T) v over (B, H, N, Dqk) x (B, H, M, Dqk) x
    (B, H, M, Dv) -> (B, H, N, Dv); q/k may be deeper than v.

    CUDA tensors launch the kernel (one launch, counted in
    ``flash_attention.launches``; bf16 takes Dv <= 512 and raises beyond,
    Dv > 160 going to the kernel's wide path), through ``TwinVJP`` where
    autograd records (its backward recomputes through the twin); CPU
    tensors take the plain twin. The result is a (B, H, N, Dv) view of a
    (B, N, H, Dv) buffer, so merging the heads back costs no copy."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for {q.device}")
    return twin_vjp(lambda q, k, v: _launch(q, k, v, scale),
                    functools.partial(flash_attention_reference, scale=scale),
                    q, k, v)


flash_attention.launches = 0
