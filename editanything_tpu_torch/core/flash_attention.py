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
from typing import NamedTuple, Optional

import torch

from editanything_tpu_torch.core.kernels import twin_vjp

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# fp32 launch plans (csrc/flash_attention.cu, flash_f32_narrow_kernel
# and flash_f32_wide_kernel): the narrow kernel's (m16 tiles a warp, keys
# a tile, ring stages) by the n8 tiles of the output it is instantiated for
F32_NARROW = {4: (2, 64, 3), 5: (2, 64, 3), 6: (2, 64, 3), 8: (2, 64, 2),
              10: (2, 32, 2), 12: (2, 32, 2), 16: (1, 64, 2), 20: (1, 64, 2)}
F32_NARROW_MAX_DQK = 256    # deeper q/k take the wide kernel
F32_WIDE_ROWS, F32_WIDE_KEYS, F32_WIDE_WARPS = 64, 16, 8
F32_WIDE_LDS = 24           # row stride of the wide kernel's S and P
F32_MAX_DEPTH = 512
F32_MAX_SPLITS = 16
MAX_SMEM = 232448           # 227 KB, the most a block may use
SM_SMEM = 233472            # 228 KB an SM, 1 KB of it reserved per block
H100_SMS = 132


class FlashF32Plan(NamedTuple):
    """How kernel B takes one fp32 call: ``path`` "narrow" (Dv <= 160,
    q/k no deeper than 256: S, P and O in registers) or "wide"; ``mt`` m16
    tiles a warp (4 when wide: its 64-row block), ``dvt`` n8 tiles of the
    output, ``kb`` keys a tile, ``stages`` of the ring, ``warps`` a block,
    ``rows`` query rows a block; the keys in ``splits`` chunks of
    ``chunk``; ``smem`` bytes of dynamic shared memory a block; ``grid``
    (row tiles, batch x heads, splits)."""
    path: str
    mt: int
    dvt: int
    kb: int
    stages: int
    warps: int
    rows: int
    chunk: int
    splits: int
    smem: int
    grid: tuple

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _a128(x: int) -> int:
    return -(-x // 128) * 128


def _f32_ld(d8: int) -> int:
    """Row stride of a Q or K tile (csrc f32_ld): 8 (mod 16) floats."""
    return d8 if (d8 // 8) % 2 else d8 + 8


def _f32_split(m: int, base: int, unit: int, kb: int, slots: int, sms: int):
    """(chunk, splits) of m keys for `base` blocks before the split: one
    chunk where the blocks reach the SMs; else, of the chunkings whose
    blocks do (all of them where none does), the fewest waves of `slots`
    resident blocks times key tiles a block, then the fewest chunks.
    Chunks are multiples of `unit` keys."""
    if base >= sms:
        return m, 1
    best = None
    for want in range(1, F32_MAX_SPLITS + 1):
        chunk = -(-(-(-m // want)) // unit) * unit
        splits = -(-m // chunk)
        blocks = base * splits
        key = (blocks < sms, -(-blocks // slots) * -(-chunk // kb), splits)
        if best is None or key < best[0]:
            best = (key, chunk if splits > 1 else m, splits)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def flash_f32_plan(b: int, h: int, n: int, m: int, dqk: int, dv: int,
                   sms: int = H100_SMS) -> FlashF32Plan:
    """Kernel B's fp32 launch plan for (B, H, N, Dqk) x (B, H, M, Dqk) x
    (B, H, M, Dv), as csrc/flash_attention.cu takes it (the kernel refuses
    any other). Narrow where Dv <= 160 and Dqk <= 256, with 4 warps a block
    unless fewer warps are what lets the keys' chunks fill `sms` SMs; wide
    otherwise. The keys are split (``_f32_split``) where the blocks are
    fewer than the SMs; every chunk holds at least one key."""
    if min(b, h, n, m, dqk, dv) <= 0:
        raise ValueError(f"flash_f32_plan: empty shape {(b, h, n, m, dqk, dv)}")
    if max(dqk, dv) > F32_MAX_DEPTH:
        raise ValueError(f"flash_attention fp32 takes depths up to "
                         f"{F32_MAX_DEPTH}, got Dqk {dqk}, Dv {dv}")
    dqk8, dv8 = -(-dqk // 8) * 8, -(-dv // 8) * 8
    ldq = _f32_ld(dqk8)
    dvt = min((t for t in F32_NARROW if 8 * t >= dv8), default=None)
    if dvt is not None and dqk8 <= F32_NARROW_MAX_DQK:
        mt, kb, stages = F32_NARROW[dvt]
        stage = _a128(kb * ldq * 4) + _a128(kb * (8 * dvt + 4) * 4)
        fits = [w for w in (4, 2, 1)
                if _a128(w * 16 * mt * ldq * 4) + stages * stage <= MAX_SMEM]
        plans = []
        for warps in fits:
            rows = warps * 16 * mt
            smem = _a128(rows * ldq * 4) + stages * stage
            base = -(-n // rows) * b * h
            slots = sms * max(1, min(SM_SMEM // (smem + 1024),
                                     2048 // (32 * warps)))
            chunk, splits = _f32_split(m, base, 8, kb, slots, sms)
            plans.append(FlashF32Plan("narrow", mt, dvt, kb, stages, warps,
                                      rows, chunk, splits, smem,
                                      (-(-n // rows), b * h, splits)))
        if plans:
            return next((pl for pl in plans if pl.blocks >= sms), plans[0])
    rows = F32_WIDE_ROWS
    smem = (_a128(rows * ldq * 4) + _a128(F32_WIDE_KEYS * ldq * 4)
            + _a128(F32_WIDE_KEYS * (dv8 + 4) * 4)
            + _a128(4 * rows * F32_WIDE_LDS * 4) + _a128(rows * 3 * 4))
    base = -(-n // rows) * b * h
    chunk, splits = _f32_split(m, base, F32_WIDE_KEYS, F32_WIDE_KEYS, sms,
                               sms)
    return FlashF32Plan("wide", rows // 16, dv8 // 8, F32_WIDE_KEYS, 1,
                        F32_WIDE_WARPS, rows, chunk, splits, smem,
                        (-(-n // rows), b * h, splits))


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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built flash_attention library (also an
    older tree's, which may lack the fp32 plan's entry)."""
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.ea_flash_attention.argtypes = (
        [ptr] * 4 + [ll] * 12 + [i32] * 6 + [ctypes.c_float, i32, ptr])
    lib.ea_flash_attention.restype = i32
    if hasattr(lib, "ea_flash_attention_f32"):
        lib.ea_flash_attention_f32.argtypes = (
            [ptr] * 4 + [ll] * 12 + [i32] * 6 + [ctypes.c_float] + [i32] * 9
            + [ptr] * 4)
        lib.ea_flash_attention_f32.restype = i32
    lib.ea_cuda_error_string.argtypes = [i32]
    lib.ea_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    from editanything_tpu_torch.core.build import load_library
    return bind(load_library("flash_attention"))


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


def _launch(q, k, v, scale: float, lib: Optional[ctypes.CDLL] = None,
            plan: Optional[FlashF32Plan] = None):
    """One launch of the kernel (of `lib`, a bound library, else this
    checkout's) on checked CUDA q, k, v (counted); fp32 by `plan`, else
    ``flash_f32_plan``'s."""
    _check(q, k, v)
    b, h, n, dqk = q.shape
    m, dv = v.shape[2], v.shape[3]
    out = torch.empty((b, n, h, dv), dtype=q.dtype,
                      device=q.device).permute(0, 2, 1, 3)
    lib = lib or _library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], b, h, n, m, dqk, dv, float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.bfloat16:
            err = lib.ea_flash_attention(*args, _DTYPE_CODES[q.dtype], stream)
        else:
            plan = plan or flash_f32_plan(b, h, n, m, dqk, dv)
            scratch = [None, None, None]
            if plan.splits > 1:
                rows = plan.splits * b * h * n
                part = torch.empty(rows * (-(-dv // 8) * 8 + 2),
                                   dtype=torch.float32, device=q.device)
                counter = torch.zeros(plan.grid[0] * b * h, dtype=torch.int32,
                                      device=q.device)
                scratch = [part.data_ptr(),
                           part.data_ptr() + 4 * (part.numel() - 2 * rows),
                           counter.data_ptr()]
            err = lib.ea_flash_attention_f32(
                *args, int(plan.path == "wide"), plan.mt, plan.dvt, plan.kb,
                plan.stages, plan.warps, plan.chunk, plan.splits, plan.smem,
                *scratch, stream)
    if err != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.ea_cuda_error_string(err).decode())
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, *, scale: Optional[float] = None):
    """softmax(scale q k^T) v over (B, H, N, Dqk) x (B, H, M, Dqk) x
    (B, H, M, Dv) -> (B, H, N, Dv); q/k may be deeper than v.

    CUDA tensors launch the kernel (one launch, counted in
    ``flash_attention.launches``), through ``TwinVJP`` where autograd
    records (its backward recomputes through the twin); CPU tensors take
    the plain twin. bf16 takes Dv <= 512 and raises beyond, Dv > 160
    going to the kernel's wide path. fp32 (the trainers' dtype) takes
    depths up to 512 and raises beyond: products in 3xTF32 on the tensor
    cores, by the plan of ``flash_f32_plan`` (narrow or wide; where the
    blocks are fewer than the SMs, the keys in chunks folded together by
    the launch's last block of each row tile, the chunks' partials in
    scratch allocated here). The result is a (B, H, N, Dv) view of a
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
