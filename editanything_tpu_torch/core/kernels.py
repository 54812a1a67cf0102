"""The port's kernels beside ``editanything_tpu/core/kernels.py``, each with
its plain PyTorch twin, all CUDA C++ bound through ctypes: GroupNorm(+SiLU)
(``group_norm_silu``, ``csrc/group_norm.cu``), SAM's mask decoder kernels
(``sam_twoway``, ``sam_upscale_hyper``; ``csrc/sam_twoway.cu``,
``csrc/sam_upscale.cu``) and the fused SD resnet block (``resnet_fused``,
``csrc/resnet_fused.cu``; ``resnet_plan`` is its launch plan: channels-last
implicit-GEMM convs over tap-major packed weights). Each source opens with
a note on the TPU kernel it replaces, what bounds it on an H100 and what
its design does about that.

GroupNorm(+SiLU) replaces the Pallas TPU kernel ``editanything_tpu/core/kernels.py``
(``_gn_silu_kernel``, :37; ``_gn_silu_pallas``, :121; ``group_norm_silu``,
:825): GroupNorm with fp32 statistics per (image, group), then the
per-channel affine, then an optional SiLU, in one output write. One launch
per call reads the activation once: one CTA, or a cluster of CTAs, holds
each (image, group) slab on chip; where 16 CTAs cannot hold it, each holds
what fits and reads the rest twice, the second time from L2. A
channels-last activation (the half-precision models' layout,
``models/layout.py``) takes one of the kernel's NHWC paths: the (image,
group) slab read as a group's run of channels in each pixel, or, where
those runs are too short or the activation too large, every image's
pixels across all channels, one co-resident CTA per SM, the statistics
merged at a grid-wide sync.
``group_norm_plan`` is the launch plan, which the wrapper hands to the
kernel.

Training differentiates A, B (core/flash_attention.py) and E as the JAX
package does through its ``custom_vjp``s: where autograd records, each
launch runs inside ``TwinVJP``, a ``torch.autograd.Function`` whose
backward recomputes through the kernel's plain twin; no kernel has a
backward of its own, since the JAX package has none to port.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_GN_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# kernel A's launch plan (csrc/group_norm.cu): a CTA holds at most
# GN_ONCHIP_MAX bytes of shared memory. Where one CTA per slab gives at
# least GN_FILL_CTAS CTAs (about one per SM of an H100), k is the smallest
# power of two that fits; elsewhere the smallest that gives shares of at
# most GN_SHARE_PREF and GN_FILL_CTAS CTAs (not splitting shares below
# GN_SHARE_MIN), up to GN_MAX_CLUSTER: on an H100 a cluster costs ~1.3 us a
# rank, and more CTAs per SM pay that back only on the VAE's few large
# slabs. A slab that GN_MAX_CLUSTER CTAs cannot hold is streamed: each CTA
# holds what fits and reads the rest of its share twice
GN_ONCHIP_MAX = 200 * 1024
GN_SHARE_PREF = 64 * 1024
GN_SHARE_MIN = 8 * 1024
GN_FILL_CTAS = 128
GN_MAX_CLUSTER = 16
GN_MAX_TABLE = 4096          # channels of (scale, bias) a CTA's table holds
# kernel A's NHWC plan: clusters of at most GN_NHWC_MAX_CLUSTER (on an
# H100 a cluster of 4 NHWC CTAs cost 5-10 us more than one of 2, PERF.md);
# the "grid" path (GN_GRID_THREADS-thread CTAs, one per SM) where the
# activation holds GN_GRID_MIN_BYTES, or a slab GN_GRID_MIN_SLAB in packs
# under 8 bytes, and for at most GN_GRID_MAX_GROUPS groups
GN_NHWC_MAX_CLUSTER = 2
GN_GRID_MIN_BYTES = 16 * 2 ** 20
GN_GRID_MIN_SLAB = 64 * 1024
GN_GRID_THREADS = 512
GN_GRID_MAX_GROUPS = 128


class GroupNormPlan(NamedTuple):
    """How kernel A takes one call: ``path`` "single" (one CTA per slab),
    "cluster" (k CTAs per slab, each holding its share on chip), "stream"
    (clusters of k = 16 whose CTAs hold ``held_bytes`` of their share on
    chip and read the rest twice, the second time from L2) or, NHWC only,
    "grid" (one co-resident CTA per SM, k to an image, each a range of its
    pixels across all channels, statistics merged through device memory at
    a grid-wide sync); ``ctas`` in the grid of ``threads``-thread CTAs;
    ``share_bytes``, the part of a slab each CTA owns; ``smem_bytes``, the
    dynamic shared memory of each CTA: the part held, then (NCHW) the
    (scale, bias) table of the channels the share touches. A slab is an
    (image, group) in NCHW and in NHWC's other paths (read in packs of
    ``vec_bytes``: a group's run of channels in each pixel) and an image in
    "grid"."""
    path: str
    k: int
    ctas: int
    share_bytes: int
    held_bytes: int
    smem_bytes: int
    threads: int
    vec_bytes: int = 16


def nhwc_pack(c: int, num_groups: int, itemsize: int):
    """Kernel A's NHWC pack over one group's run of channels in a pixel:
    the widest of 8 bytes, 4 bytes or one element that the run is a whole
    number of (on an H100, 8-byte packs ran as fast as 16-byte ones at
    every NHWC shape of an edit, PERF.md); None where a run holds more than
    256 packs."""
    run = c // num_groups * itemsize
    for vb in dict.fromkeys(b for b in (8, 4, itemsize) if b >= itemsize):
        if run % vb == 0:
            return vb if run // vb <= 256 else None
    return None


def nhwc_grid_fits(c: int, num_groups: int, itemsize: int) -> bool:
    """Whether the "grid" path takes C channels: 16-byte packs across all
    of a pixel's channels, none over more than two groups, at most 512
    packs a pixel and GN_GRID_MAX_GROUPS groups."""
    v = 16 // itemsize
    cpg = c // num_groups
    return (c % v == 0 and c // v <= 512 and num_groups <= GN_GRID_MAX_GROUPS
            and all((col * v + v - 1) // cpg - col * v // cpg <= 1
                    for col in range(c // v)))


@functools.lru_cache(maxsize=None)
def group_norm_plan(n: int, c: int, h: int, w: int, num_groups: int,
                    itemsize: int, nhwc: bool = False, sms: int = 132):
    """Kernel A's launch plan for an (n, c, h, w) activation of `itemsize`
    bytes per element in `num_groups` groups, as csrc/group_norm.cu takes
    it, on a card of `sms` SMs. NCHW: each CTA owns a contiguous share of
    whole 16-byte vectors (single elements where H*W is no multiple of a
    vector) of its (image, group) slab. NHWC (`nhwc`): "grid" where the
    activation reaches GN_GRID_MIN_BYTES, or where a group's run takes packs
    under 8 bytes and its slab reaches GN_GRID_MIN_SLAB (the shapes where
    strided runs of a few bytes could not feed the card, PERF.md); else an
    (image, group) slab in ``nhwc_pack``'s packs, each CTA a range of its
    pixels, k at most GN_NHWC_MAX_CLUSTER (None where no pack fits). k as
    the note on GN_FILL_CTAS says; a CTA still over GN_ONCHIP_MAX at k = 16
    streams what it cannot hold."""
    cpg = c // num_groups
    if nhwc:
        vec_bytes = nhwc_pack(c, num_groups, itemsize)
        slab_bytes = cpg * h * w * itemsize
        if (sms // n >= 1 and nhwc_grid_fits(c, num_groups, itemsize) and (
                n * slab_bytes * num_groups >= GN_GRID_MIN_BYTES
                or ((vec_bytes is None or vec_bytes < 8)
                    and slab_bytes >= GN_GRID_MIN_SLAB))):
            k = sms // n
            share = -(-(h * w) // k) * c * itemsize
            held = min(share, GN_ONCHIP_MAX)
            return GroupNormPlan("grid", k, n * k, share, held, held,
                                 GN_GRID_THREADS, 16)
        if vec_bytes is None:
            return None
        slabs = n * num_groups
        max_k = GN_NHWC_MAX_CLUSTER

        def share(k):                   # bytes: whole pixels of the slab
            return -(-(h * w) // k) * cpg * itemsize

        def table(k):                   # each thread holds its channels'
            return 0
    else:
        vec = 16 // itemsize
        if (h * w) % vec:
            vec = 1
        vec_bytes = vec * itemsize
        slab = cpg * h * w
        slabs = n * num_groups
        max_k = GN_MAX_CLUSTER

        def share(k):                       # bytes
            return -(-(slab // vec) // k) * vec * itemsize

        def table(k):                       # channels the share can touch
            t = min(cpg, -(-share(k) // itemsize // (h * w)) + 1)
            return t if t <= GN_MAX_TABLE else 0

    def smem(k, held):
        return -(-held // 16) * 16 + 8 * table(k)

    k = 1
    if slabs >= GN_FILL_CTAS:
        while k < max_k and smem(k, share(k)) > GN_ONCHIP_MAX:
            k *= 2
    else:
        while k < max_k and (
                share(k) > GN_SHARE_PREF
                or (slabs * k < GN_FILL_CTAS and share(2 * k) >= GN_SHARE_MIN)):
            k *= 2
    held = share(k)
    path = "single" if k == 1 else "cluster"
    if smem(k, held) > GN_ONCHIP_MAX:
        held = (GN_ONCHIP_MAX - 8 * table(k)) // 16 * 16
        path = "stream"
    threads = 512 if held >= 64 * 1024 or held < share(k) else 256
    return GroupNormPlan(path, k, slabs * k, share(k), held, smem(k, held),
                         threads, vec_bytes)


def group_norm_silu_reference(x, weight, bias, *, num_groups: int = 32,
                              eps: float = 1e-5, apply_silu: bool = True):
    """Plain twin of the kernel over NCHW: fp32 statistics and affine, SiLU
    in fp32, one cast to x's dtype."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, num_groups, -1)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, correction=0, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    if apply_silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


@functools.cache
def _gn_library() -> ctypes.CDLL:
    from editanything_tpu_torch.core.build import load_library
    lib = load_library("group_norm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # x, y, w, b, N, C, H, W, groups, eps, silu, dtype, wdtype, bdtype, k,
    # held bytes, device, stream
    lib.ea_group_norm_silu.argtypes = ([ptr] * 4 + [i32] * 5 + [ctypes.c_float]
                                       + [i32] * 5 + [ctypes.c_longlong, i32,
                                                      ptr])
    lib.ea_group_norm_silu.restype = i32
    # x, y, w, b, N, C, H, W, groups, pack bytes, eps, silu, dtype,
    # wdtype, bdtype, k, held bytes, device, stream
    lib.ea_group_norm_silu_nhwc.argtypes = (
        [ptr] * 4 + [i32] * 6 + [ctypes.c_float] + [i32] * 5
        + [ctypes.c_longlong, i32, ptr])
    lib.ea_group_norm_silu_nhwc.restype = i32
    # x, y, w, b, partials, N, C, H, W, groups, CTAs per image, threads,
    # held bytes, eps, silu, dtype, wdtype, bdtype, device, stream
    lib.ea_group_norm_silu_nhwc_grid.argtypes = (
        [ptr] * 5 + [i32] * 7 + [ctypes.c_longlong, ctypes.c_float]
        + [i32] * 5 + [ptr])
    lib.ea_group_norm_silu_nhwc_grid.restype = i32
    lib.ea_group_norm_occupancy.argtypes = [i32, i32, ctypes.c_longlong,
                                            ctypes.POINTER(i32)]
    lib.ea_group_norm_occupancy.restype = i32
    lib.ea_cuda_error_string.argtypes = [i32]
    lib.ea_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build() -> None:
    """Compile and load kernel A's library (first use does this)."""
    _gn_library()


class TwinVJP(torch.autograd.Function):
    """A kernel's forward with the JAX package's backward (its
    ``custom_vjp``s, e.g. editanything_tpu/core/kernels.py:178-185):
    ``launch(*inputs)`` runs the kernel, and the backward recomputes
    ``twin(*inputs)`` under autograd from the saved inputs and
    differentiates it against the output's gradient. A recompute of the
    forward (``torch.utils.checkpoint``) launches the kernel again, and
    counts."""

    @staticmethod
    def forward(ctx, launch, twin, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.twin = twin
        return launch(*inputs)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            got = iter(torch.autograd.grad(
                ctx.twin(*leaves), [t for t, n in zip(leaves, needs) if n],
                grad, allow_unused=True))
        return (None, None) + tuple(next(got) if n else None for n in needs)


def twin_vjp(launch, twin, *inputs):
    """``launch(*inputs)``, through ``TwinVJP`` where autograd records (grad
    mode on and an input that requires grad)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in inputs):
        return TwinVJP.apply(launch, twin, *inputs)
    return launch(*inputs)


def is_channels_last(x) -> bool:
    """A 4-D tensor laid out NHWC (channels-last) and not NCHW-contiguous."""
    return (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last))


def _gn_launch(x, weight, bias, num_groups, eps, apply_silu):
    """One launch of kernel A on checked CUDA inputs (counted): a
    channels-last x takes an NHWC path and gives a channels-last output,
    any other layout the NCHW path."""
    n, c, h, w = x.shape
    dev = x.device.index
    nhwc = is_channels_last(x)
    plan = (group_norm_plan(n, c, h, w, num_groups, x.element_size(),
                            nhwc=True, sms=_sm_count(dev)) if nhwc else None)
    if plan is None:
        nhwc = False
        x = x.contiguous()
        plan = group_norm_plan(n, c, h, w, num_groups, x.element_size())
    elif x.data_ptr() % plan.vec_bytes:
        x = x.clone(memory_format=torch.channels_last)
    lib = _gn_library()
    # held until the launch is queued: the pointers are into these tensors
    weight, bias = weight.contiguous(), bias.contiguous()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    codes = (_GN_DTYPE_CODES[x.dtype], _GN_DTYPE_CODES[weight.dtype],
             _GN_DTYPE_CODES[bias.dtype])
    if not nhwc:
        err = lib.ea_group_norm_silu(
            x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), n,
            c, h, w, num_groups, eps, int(apply_silu), *codes, plan.k,
            plan.held_bytes, dev, stream)
    elif plan.path == "grid":
        part = torch.empty(plan.ctas * num_groups * 3, dtype=torch.float32,
                           device=x.device)
        err = lib.ea_group_norm_silu_nhwc_grid(
            x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            part.data_ptr(), n, c, h, w, num_groups, plan.k, plan.threads,
            plan.held_bytes, eps, int(apply_silu), *codes, dev, stream)
    else:
        err = lib.ea_group_norm_silu_nhwc(
            x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(), n,
            c, h, w, num_groups, plan.vec_bytes, eps, int(apply_silu), *codes,
            plan.k, plan.held_bytes, dev, stream)
    _raise_on(err, lib, "group_norm_silu")
    if nhwc:
        counter = group_norm_silu    # a wrapper put in its place counts on
        counter.launches_nhwc = getattr(counter, "launches_nhwc", 0) + 1
    group_norm_silu.launches += 1
    return y


def group_norm_silu(x, weight, bias, *, num_groups: int = 32,
                    eps: float = 1e-5, apply_silu: bool = True):
    """GroupNorm(+SiLU) over an (N, C, H, W) tensor with (C,) scale and bias.

    CUDA tensors launch kernel A (one launch, counted in
    ``group_norm_silu.launches``, and in ``.launches_nhwc`` where a
    channels-last x takes the NHWC path, whose output is channels-last too)
    with the plan of ``group_norm_plan``,
    through ``TwinVJP`` where autograd records (its backward recomputes
    through the twin); CPU tensors take the plain twin."""
    twin = functools.partial(group_norm_silu_reference, num_groups=num_groups,
                             eps=eps, apply_silu=apply_silu)
    if x.device.type == "cpu":
        return twin(x, weight, bias)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_silu: no kernel for {x.device}")
    if x.dim() != 4:
        raise ValueError(f"group_norm_silu takes NCHW, got {tuple(x.shape)}")
    c = x.shape[1]
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if x.dtype not in _GN_DTYPE_CODES:
        raise TypeError(f"group_norm_silu: unsupported dtype {x.dtype}")
    if weight.shape != (c,) or bias.shape != (c,):
        raise ValueError("scale and bias must be (C,)")
    if not (weight.device == bias.device == x.device):
        raise ValueError("x, scale and bias must be on one device")
    if weight.dtype not in _GN_DTYPE_CODES or bias.dtype not in _GN_DTYPE_CODES:
        raise TypeError(f"group_norm_silu: scale and bias must be fp32, bf16 "
                        f"or fp16, got {weight.dtype} and {bias.dtype}")
    return twin_vjp(
        lambda x, w, b: _gn_launch(x, w, b, num_groups, eps, apply_silu),
        twin, x, weight, bias)


group_norm_silu.launches = 0
group_norm_silu.launches_nhwc = 0     # the launches that took the NHWC path


# ---------------------------------------------------------------------------
# SAM mask decoder: the two-way transformer (kernel D) and the upscale +
# hypernetwork products (kernel C), CUDA C++ through ctypes
# ---------------------------------------------------------------------------

TWOWAY_WIDTH = 256          # SAM's decoder widths, the same in every variant
TWOWAY_HEADS = 8
TWOWAY_MAX_TOKENS = 24      # 5 output tokens + 16 point slots + 2 box corners
TWOWAY_MAX_LAYERS = 4       # csrc/sam_twoway.cu kMaxLayers
TWOWAY_ROW_TILE = 128       # image rows per block of the bf16 row kernel
TWOWAY_FILL_BLOCKS = 132    # row blocks that give each SM of an H100 one


def twoway_row_tile(b: int, m: int, dtype) -> int:
    """Image rows per block of kernel D's row kernels, as
    csrc/sam_twoway.cu row_tile chooses them: in bf16 TWOWAY_ROW_TILE where
    the b prompts' tiles of that size fill the card (the AMG's batches),
    else half of it (the click's one prompt, small images); 32 in fp32. The
    twin merges its token->image partials over the same tiles."""
    if dtype != torch.bfloat16:
        return 32
    if m % TWOWAY_ROW_TILE == 0 and b * (m // TWOWAY_ROW_TILE) >= TWOWAY_FILL_BLOCKS:
        return TWOWAY_ROW_TILE
    return TWOWAY_ROW_TILE // 2


def _twoway_names(n_layers: int):
    """The matrices (weights, (out, in)) and vectors (biases, LayerNorm
    affines) of the packed two-way transformer, in the order
    csrc/sam_twoway.cu indexes them: per layer 14 matrices and 22 vectors,
    then the final attention's 4 matrices and 6 vectors."""
    def attn(a):
        return [f"{a}.{x}_proj" for x in ("q", "k", "v", "out")]
    mats, vecs = [], []
    for l in range(n_layers):
        p = f"layers.{l}."
        layer = (attn(p + "self_attn") + attn(p + "cross_attn_token_to_image")
                 + [p + "mlp.lin1", p + "mlp.lin2"]
                 + attn(p + "cross_attn_image_to_token"))
        mats += layer
        vecs += [m + ".bias" for m in layer]
        vecs += [f"{p}norm{j}.{w}" for j in range(1, 5)
                 for w in ("weight", "bias")]
    final = attn("final_attn_token_to_image")
    mats += final
    vecs += [m + ".bias" for m in final]
    vecs += ["norm_final_attn.weight", "norm_final_attn.bias"]
    return mats, vecs


@dataclasses.dataclass
class TwoWayPacked:
    """The two-way transformer's parameters in two flat buffers: ``w``
    (storage dtype) holds every matrix, ``v`` (fp32) every bias and
    LayerNorm affine, rounded to the storage dtype first, as the Pallas
    kernel casts them (editanything_tpu/core/kernels.py:381-389)."""
    w: torch.Tensor
    v: torch.Tensor
    mats: Dict[str, Tuple[int, Tuple[int, int]]]
    vecs: Dict[str, Tuple[int, int]]
    n_layers: int
    heads: int

    def mat(self, name: str) -> torch.Tensor:
        off, shape = self.mats[name]
        return self.w[off:off + shape[0] * shape[1]].view(shape)

    def vec(self, name: str) -> torch.Tensor:
        off, n = self.vecs[name]
        return self.v[off:off + n]

    def clone(self) -> "TwoWayPacked":
        return dataclasses.replace(self, w=self.w.clone(), v=self.v.clone())


def pack_twoway(transformer, *, heads: int = TWOWAY_HEADS,
                dtype=None) -> TwoWayPacked:
    """Pack a ``TwoWayTransformer`` module (official SAM names) for
    ``sam_twoway``; done once per image and kept out of the AMG's batch loop,
    as the JAX package hoists it (amg.py:203-204). `dtype`: the storage
    dtype (default: the module's)."""
    sd = transformer.state_dict()
    n_layers = len(transformer.layers)
    mat_names, vec_names = _twoway_names(n_layers)
    dt = dtype or sd[mat_names[0] + ".weight"].dtype
    mats, vecs, ws, vs = {}, {}, [], []
    off = 0
    for name in mat_names:
        w = sd[name + ".weight"]
        mats[name] = (off, tuple(w.shape))
        ws.append(w.to(dt).reshape(-1))
        off += w.numel()
    off = 0
    for name in vec_names:
        v = sd[name]
        vecs[name] = (off, v.numel())
        vs.append(v.to(dt).float().reshape(-1))
        off += v.numel()
    return TwoWayPacked(w=torch.cat(ws), v=torch.cat(vs), mats=mats,
                        vecs=vecs, n_layers=n_layers, heads=heads)


def sam_twoway_reference(packed: TwoWayPacked, src1, pe, tokens, *,
                         first_layer_replaces: bool = True,
                         first_keys_with_pe: bool = True):
    """Plain twin of kernel D: SAM's two-way transformer for B prompts that
    share one image input.

    src1 (1, M, d) in the storage dtype; pe (M, d) fp32; tokens (B, T, d)
    fp32 (also the query positional term). Returns (queries (B, T, d),
    keys (B, M, d)) in the storage dtype. The cast points are the Pallas
    kernel's (editanything_tpu/core/kernels.py:347-469): every projection
    takes storage-dtype inputs with fp32 sums, attention probabilities are
    rounded to the storage dtype before the product with v, LayerNorms are
    fp32, the tokens stay fp32 and the keys are stored in the storage dtype
    between layers. Token->image attention runs over the kernel's tiles of
    image rows (``twoway_row_tile``): per tile the exponentials are taken
    against the tile's maximum and rounded before the product with v, then
    the tiles merge (flash-decoding). In fp32 the rounding is exact and the
    result is plain softmax attention.
    ``first_layer_replaces=False`` gives layer 0's self-attention a residual
    instead, and ``first_keys_with_pe=False`` projects layer 0's
    token->image keys from the image rows without pe (faults the chip
    checks must reject; the kernel computes those keys once for every
    prompt)."""
    dt = src1.dtype
    b = tokens.shape[0]
    keys = src1.expand(b, -1, -1)
    pe = pe.float()
    tok0 = tokens.float()

    def lin(x, name):
        return (torch.matmul(x.to(dt).float(), packed.mat(name).float().t())
                + packed.vec(name + ".bias"))

    def ln(x, name):
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + 1e-5) * packed.vec(name + ".weight")
                + packed.vec(name + ".bias"))

    def attn(name, qx, kx, vx, tiled=False):
        q, k, v = (lin(x, f"{name}.{p}_proj")
                   for x, p in ((qx, "q"), (kx, "k"), (vx, "v")))
        n, m, inner = q.shape[1], k.shape[1], q.shape[2]
        hd = inner // packed.heads

        def heads(x, rows):
            return x.to(dt).float().view(b, rows, packed.heads, hd).transpose(1, 2)
        s = torch.matmul(heads(q, n), heads(k, m).transpose(-1, -2)) * hd ** -0.5
        if not tiled:
            p = torch.softmax(s, dim=-1).to(dt).float()
            o = torch.matmul(p, heads(v, m))
        else:
            tile = twoway_row_tile(b, m, dt)
            tile = tile if m % tile == 0 else m
            st = s.unflatten(-1, (m // tile, tile))
            mt = st.amax(-1, keepdim=True)
            e = torch.exp(st - mt)
            vt = heads(v, m).unflatten(2, (m // tile, tile))
            acc = torch.einsum("bhnjt,bhjtd->bhnjd", e.to(dt).float(), vt)
            w = torch.exp(mt - mt.amax(-2, keepdim=True))   # (b, h, n, tiles, 1)
            o = (acc * w).sum(-2) / (e.sum(-1, keepdim=True) * w).sum(-2)
        o = o.transpose(1, 2).reshape(b, n, inner)
        return lin(o, f"{name}.out_proj")

    q = tok0
    for l in range(packed.n_layers):
        p = f"layers.{l}."
        if l == 0:
            a = attn(p + "self_attn", q, q, q)
            q = a if first_layer_replaces else q + a
        else:
            qpe = q + tok0
            q = q + attn(p + "self_attn", qpe, qpe, q)
        q = ln(q, p + "norm1")
        kpe = keys.float() + pe
        kin = kpe if l > 0 or first_keys_with_pe else keys.float()
        q = ln(q + attn(p + "cross_attn_token_to_image", q + tok0, kin, keys,
                        tiled=True), p + "norm2")
        h = torch.relu(lin(q, p + "mlp.lin1"))
        q = ln(q + lin(h, p + "mlp.lin2"), p + "norm3")
        keys = ln(keys.float() + attn(p + "cross_attn_image_to_token",
                                      kpe, q + tok0, q), p + "norm4").to(dt)
    q = q + attn("final_attn_token_to_image", q + tok0, keys.float() + pe,
                 keys, tiled=True)
    return ln(q, "norm_final_attn").to(dt), keys


def bind_twoway(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a kernel D library (``ea_sam_twoway``)."""
    ptr, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # src, src batch stride, pe, tokens, w, v, w offsets, n, v offsets, n,
    # n_layers, keys_out, q_out, q_state, tokkv, tq, partials, B, M, T,
    # dtype, stream
    lib.ea_sam_twoway.argtypes = ([ptr, ll, ptr, ptr, ptr, ptr, ptr, i32,
                                   ptr, i32, i32] + [ptr] * 6
                                  + [i32] * 4 + [ptr])
    lib.ea_sam_twoway.restype = i32
    lib.ea_cuda_error_string.argtypes = [i32]
    lib.ea_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sam_library(name: str) -> ctypes.CDLL:
    from editanything_tpu_torch.core.build import load_library
    lib = load_library(name)
    return bind_twoway(lib) if name == "sam_twoway" else bind_upscale(lib)


def build_sam() -> None:
    """Compile and load both SAM kernel libraries (first use does this)."""
    _sam_library("sam_twoway")
    _sam_library("sam_upscale")


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.ea_cuda_error_string(err).decode())


def _offsets(table: dict) -> ctypes.Array:
    offs = [off for off, _ in table.values()]
    return (ctypes.c_longlong * len(offs))(*offs)


def sam_twoway(packed: TwoWayPacked, src1, pe, tokens):
    """SAM's two-way transformer for B prompts sharing one image input
    (the AMG's grid and the click predictor: the no-mask dense prompt).

    src1 (1, M, 256) in the storage dtype, pe (M, 256) fp32, tokens
    (B, T, 256) fp32 with T <= 24. Returns (queries (B, T, 256), keys
    (B, M, 256)) in the storage dtype. CUDA tensors launch kernel D (eight
    launches per call for SAM's two layers, counted once in
    ``sam_twoway.launches``); CPU tensors take the plain twin."""
    if src1.device.type == "cpu":
        return sam_twoway_reference(packed, src1, pe, tokens)
    if src1.device.type != "cuda":
        raise RuntimeError(f"sam_twoway: no kernel for {src1.device}")
    b, t, d = tokens.shape
    m = src1.shape[1]
    dt = src1.dtype
    if dt not in _DTYPE_CODES or packed.w.dtype != dt:
        raise TypeError(f"sam_twoway takes fp32 or bf16 keys with weights of "
                        f"the same dtype, got {dt} and {packed.w.dtype}")
    if (src1.shape != (1, m, TWOWAY_WIDTH) or pe.shape != (m, d)
            or d != TWOWAY_WIDTH or pe.dtype != torch.float32
            or tokens.dtype != torch.float32):
        raise ValueError(f"sam_twoway takes src1 (1, M, 256), fp32 pe (M, 256) "
                         f"and fp32 tokens (B, T, 256); got "
                         f"{tuple(src1.shape)}, {tuple(pe.shape)} {pe.dtype}, "
                         f"{tuple(tokens.shape)} {tokens.dtype}")
    if not 1 <= t <= TWOWAY_MAX_TOKENS or m % (TWOWAY_ROW_TILE // 2):
        raise ValueError(f"sam_twoway takes 1..{TWOWAY_MAX_TOKENS} tokens and "
                         f"a multiple of {TWOWAY_ROW_TILE // 2} image rows; "
                         f"got T={t}, M={m}")
    if (packed.heads != TWOWAY_HEADS or packed.n_layers > TWOWAY_MAX_LAYERS
            or packed.mats["layers.0.mlp.lin1"][1] != (2048, TWOWAY_WIDTH)):
        raise ValueError("sam_twoway's kernel takes SAM's decoder widths "
                         "(256 wide, 8 heads, MLP 2048, <= 4 layers)")
    devs = {x.device for x in (src1, pe, tokens, packed.w, packed.v)}
    if len(devs) != 1:
        raise ValueError(f"sam_twoway: tensors on several devices {devs}")
    out = _twoway_launch(_sam_library("sam_twoway"), packed, src1.contiguous(),
                         pe.contiguous(), tokens.contiguous())
    sam_twoway.launches += 1
    return out


def _twoway_launch(lib, packed: TwoWayPacked, src1, pe, tokens, *,
                   part_rows=None):
    """Allocate kernel D's outputs and scratch and call ``ea_sam_twoway`` of
    ``lib`` on the current stream (checked, contiguous CUDA inputs). Also
    used by ``tools/bench_twoway.py`` to time a library built from another
    source beside this one, whose row tiles may be smaller: ``part_rows``
    sizes the partials' buffer for tiles of that many rows (default: this
    kernel's)."""
    b, t, d = tokens.shape
    m = src1.shape[1]
    dt = src1.dtype
    rows = part_rows or twoway_row_tile(b, m, dt)
    dev = src1.device
    keys = torch.empty((b, m, d), dtype=dt, device=dev)
    q_out = torch.empty((b, t, d), dtype=dt, device=dev)
    q_state = torch.empty((b, t, d), dtype=torch.float32, device=dev)
    tokkv = torch.empty((b, 2, t, d // 2), dtype=dt, device=dev)
    tq = torch.empty((b, t, d // 2), dtype=dt, device=dev)
    part = torch.empty((b, m // rows, t, TWOWAY_HEADS, 18),
                       dtype=torch.float32, device=dev)
    w_off, v_off = _offsets(packed.mats), _offsets(packed.vecs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ea_sam_twoway(
            src1.data_ptr(), 0, pe.data_ptr(), tokens.data_ptr(),
            packed.w.data_ptr(), packed.v.data_ptr(), w_off, len(w_off),
            v_off, len(v_off), packed.n_layers, keys.data_ptr(),
            q_out.data_ptr(), q_state.data_ptr(), tokkv.data_ptr(),
            tq.data_ptr(), part.data_ptr(), b, m, t, _DTYPE_CODES[dt], stream)
    _raise_on(err, lib, "sam_twoway")
    return q_out, keys


sam_twoway.launches = 0


def layer_norm_2d(x, weight, bias, eps):
    """LayerNorm2d over the channels of NCHW, fp32 statistics (the twin's
    and ``models/sam.py``'s)."""
    xf = x.float()
    mu = xf.mean(1, keepdim=True)
    var = (xf - mu).square().mean(1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float()[:, None, None] + bias.float()[:, None, None]).to(x.dtype)


def sam_upscale_hyper_reference(src, hyper, w1, b1, ln_w, ln_b, w2, b2, *,
                                eps: float = 1e-6):
    """Plain twin of kernel C: ConvTranspose 2x2/s2 -> LayerNorm2d -> exact
    GELU -> ConvTranspose 2x2/s2 -> GELU, then the products with the
    hypernetwork vectors. src (B, e*e, c), hyper (B, nm, c/8); the weights
    are torch ConvTranspose2d's (I, O, 2, 2). Returns (B, nm, 4e, 4e) in
    src's dtype. Products of storage-dtype values with fp32 sums, as the
    Pallas kernel (editanything_tpu/core/kernels.py:209-250)."""
    dt = src.dtype
    b, npix, c = src.shape
    e = math.isqrt(npix)
    x = src.float().transpose(1, 2).reshape(b, c, e, e)
    y = F.conv_transpose2d(x, w1.to(dt).float(), b1.to(dt).float(), stride=2)
    y = F.gelu(layer_norm_2d(y, ln_w.to(dt), ln_b.to(dt), eps)).to(dt).float()
    z = F.conv_transpose2d(y, w2.to(dt).float(), b2.to(dt).float(), stride=2)
    z = F.gelu(z).to(dt).float()
    return torch.einsum("bnc,bchw->bnhw", hyper.to(dt).float(), z).to(dt)


def sam_upscale_hyper(src, hyper, w1, b1, ln_w, ln_b, w2, b2, *,
                      eps: float = 1e-6):
    """The mask decoder's output path (models/sam.py): upscale the (B, e*e,
    256) keys 4x and take the products with the (B, 4, 32) hypernetwork
    vectors -> (B, 4, 4e, 4e) mask logits in src's dtype.

    CUDA tensors launch kernel C (counted in ``sam_upscale_hyper.launches``)
    and take c = 256, nm = 4 only, as every SAM variant has; CPU tensors take
    the plain twin."""
    if src.device.type == "cpu":
        return sam_upscale_hyper_reference(src, hyper, w1, b1, ln_w, ln_b,
                                           w2, b2, eps=eps)
    if src.device.type != "cuda":
        raise RuntimeError(f"sam_upscale_hyper: no kernel for {src.device}")
    dt = src.dtype
    b, npix, c = src.shape
    e = math.isqrt(npix)
    if dt not in _DTYPE_CODES:
        raise TypeError(f"sam_upscale_hyper takes fp32 or bf16, got {dt}")
    if (c != 256 or e * e != npix or hyper.shape != (b, 4, c // 8)
            or w1.shape != (c, c // 4, 2, 2) or w2.shape != (c // 4, c // 8, 2, 2)):
        raise ValueError(f"sam_upscale_hyper's kernel takes src (B, e*e, 256) "
                         f"and hyper (B, 4, 32); got {tuple(src.shape)}, "
                         f"{tuple(hyper.shape)}")
    if hyper.device != src.device or w1.device != src.device:
        raise ValueError("sam_upscale_hyper: tensors on several devices")
    out = _upscale_launch(_sam_library("sam_upscale"), src, hyper, w1, b1,
                          ln_w, ln_b, w2, b2, eps)
    sam_upscale_hyper.launches += 1
    return out


def bind_upscale(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a kernel C library (``ea_sam_upscale``)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # src, w1, b1, ln_w, ln_b, w2, b2, hyper, out, B, M, e, eps, dtype,
    # stream
    lib.ea_sam_upscale.argtypes = ([ptr] * 9 + [i32] * 3
                                   + [ctypes.c_float, i32, ptr])
    lib.ea_sam_upscale.restype = i32
    if hasattr(lib, "ea_sam_upscale_occupancy"):
        lib.ea_sam_upscale_occupancy.argtypes = [ctypes.POINTER(i32)]
        lib.ea_sam_upscale_occupancy.restype = i32
    lib.ea_cuda_error_string.argtypes = [i32]
    lib.ea_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _upscale_launch(lib, src, hyper, w1, b1, ln_w, ln_b, w2, b2, eps):
    """Pack kernel C's weights, allocate its output and call
    ``ea_sam_upscale`` of ``lib`` on the current stream (checked CUDA
    inputs). Also used by ``tools/bench_upscale.py`` to time a library
    built from another source beside this one."""
    dt = src.dtype
    b, npix, c = src.shape
    e = math.isqrt(npix)
    # (tap, out, in) matrices: w1p[di*2+dj, o, i] = w1[i, o, di, dj];
    # w2p[(di2*2+dj2)*32 + o, i] = w2[i, o, di2, dj2]
    w1p = w1.to(dt).permute(2, 3, 1, 0).reshape(4, c // 4, c).contiguous()
    w2p = w2.to(dt).permute(2, 3, 1, 0).reshape(c // 2, c // 4).contiguous()
    vecs = [v.to(dt).float().contiguous() for v in (b1, ln_w, ln_b)]
    b2p = b2.to(dt).float().repeat(4).contiguous()
    src, hyper = src.contiguous(), hyper.to(dt).contiguous()
    out = torch.empty((b, 4, 4 * e, 4 * e), dtype=dt, device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.ea_sam_upscale(
            src.data_ptr(), w1p.data_ptr(), vecs[0].data_ptr(),
            vecs[1].data_ptr(), vecs[2].data_ptr(), w2p.data_ptr(),
            b2p.data_ptr(), hyper.data_ptr(), out.data_ptr(), b, npix, e,
            float(eps), _DTYPE_CODES[dt], stream)
    _raise_on(err, lib, "sam_upscale_hyper")
    return out


sam_upscale_hyper.launches = 0


# ---------------------------------------------------------------------------
# The fused SD resnet block (kernel E), CUDA C++ through ctypes
# ---------------------------------------------------------------------------

RESNET_FAULTS = ("pad_silu_shift", "gn2_groups_shifted", "no_shortcut",
                 "gn2_tile_dropped")
# kernel E's launch plan (csrc/resnet_fused.cu): GEMM rows (output pixels,
# the batch folded in) per tile, K elements per ring stage, the output
# channel tiles it is built for (in order of preference, see
# resnet_channel_tile), a split over K never leaves a CTA fewer than
# RESNET_MIN_SPLIT_STEPS stages, and GN1's statistics take chunks of at
# least RESNET_GN1_CHUNK elements and at most RESNET_GN1_MAX_CHUNKS chunks
# of an (image, group) slab, each a multiple of 8
RESNET_BM = 128
RESNET_BK = 64
RESNET_CHANNEL_TILES = (160, 128, 64)
RESNET_MIN_SPLIT_STEPS = 8
RESNET_GN1_CHUNK = 16384
RESNET_GN1_MAX_CHUNKS = 16


class ResnetPlan(NamedTuple):
    """How kernel E takes one block: output channel tile ``bn``; ``mtiles``
    x ``ntiles`` output tiles of RESNET_BM pixels x bn channels; channel
    strides ``cp_in``/``cp_out`` of the channels-last activations (Cin and
    Cout rounded up to 8); K stages of each conv and the CTAs each is split
    over; ``slots`` (most images one M tile spans) and ``segs`` (most groups
    one channel tile touches), the layout of GN2's partials;
    ``gn1_chunks`` per (image, group) slab; ``launches``, device launches a
    call (kernels and memsets)."""
    bn: int
    mtiles: int
    ntiles: int
    cp_in: int
    cp_out: int
    steps1: int
    steps2: int
    split1: int
    split2: int
    slots: int
    segs: int
    gn1_chunks: int
    launches: int


def resnet_channel_tile(cout: int) -> int:
    """The output channel tile: the least padding, then the earlier of
    RESNET_CHANNEL_TILES (320, 640, 1280 -> 160; 128, 256, 512, 96 -> 128;
    32 -> 64). On an H100 the 160-wide tile ran the UNet's 32x32 and 16x16
    blocks 12-26% faster than 128, where both fit exactly (PERF.md)."""
    return min(RESNET_CHANNEL_TILES,
               key=lambda bn: (-(-cout // bn) * bn - cout,
                               RESNET_CHANNEL_TILES.index(bn)))


@functools.lru_cache(maxsize=None)
def resnet_plan(n: int, cin: int, cout: int, h: int, w: int,
                num_groups: int, shortcut: bool, sms: int = 132) -> ResnetPlan:
    """Kernel E's plan for x (n, cin, h, w) -> (n, cout, h, w) with a 1x1
    shortcut or not, on a card of `sms` SMs: each conv is split over K only
    where its output tiles are fewer than the SMs, into as many splits as
    make about one CTA per SM, or two where the tiles are under a quarter
    of the SMs (the weight-bound 8x8 blocks)."""
    hw, m = h * w, n * h * w
    bn = resnet_channel_tile(cout)
    cp_in, cp_out = -(-cin // 8) * 8, -(-cout // 8) * 8
    mtiles, ntiles = -(-m // RESNET_BM), -(-cout // bn)
    kc_in, kc_out = -(-cp_in // RESNET_BK), -(-cp_out // RESNET_BK)
    steps1 = 9 * kc_in
    steps2 = 9 * kc_out + (kc_in if shortcut else 0)
    tiles = mtiles * ntiles

    def split(steps):
        if tiles >= sms:
            return 1
        want = 2 * sms if 4 * tiles <= sms else sms
        return max(1, min(-(-want // tiles), steps // RESNET_MIN_SPLIT_STEPS))

    split1, split2 = split(steps1), split(steps2)
    slots = max((min(m0 + RESNET_BM, m) - 1) // hw - m0 // hw + 1
                for m0 in range(0, m, RESNET_BM))
    cpg = cout // num_groups
    segs = max((min(c0 + bn, cout) - 1) // cpg - c0 // cpg + 1
               for c0 in range(0, cout, bn))
    slab = cin // num_groups * hw
    per = -(-slab // RESNET_GN1_MAX_CHUNKS)
    chunk = max(RESNET_GN1_CHUNK, -(-per // 8) * 8)
    gn1_chunks = -(-slab // chunk)
    launches = 6 + (2 if split1 > 1 else 0) + (2 if split2 > 1 else 0)
    return ResnetPlan(bn, mtiles, ntiles, cp_in, cp_out, steps1, steps2,
                      split1, split2, slots, segs, gn1_chunks, launches)


# kernel E's scratch buffers in the storage dtype and in fp32, in the order
# of each of the two allocations (core/kernels.py::resnet_scratch)
RESNET_SCRATCH_T = ("xn", "xs", "hn")
RESNET_SCRATCH_F32 = ("h", "part1", "part2", "ss2", "acc")


def resnet_scratch(n: int, cin: int, cout: int, h: int, w: int,
                   num_groups: int, shortcut: bool,
                   plan: ResnetPlan) -> Dict[str, int]:
    """{buffer: elements} of kernel E's scratch: in the storage dtype the
    channels-last xn, raw x (with a 1x1 shortcut) and hn; in fp32 h, GN1's
    chunk partials, GN2's tile partials and its per-channel scale and
    shift, and a split conv2's sums."""
    m = n * h * w
    return {"xn": m * plan.cp_in, "xs": m * plan.cp_in if shortcut else 0,
            "hn": m * plan.cp_out, "h": m * plan.cp_out,
            "part1": n * num_groups * plan.gn1_chunks * 3,
            "part2": plan.mtiles * plan.slots * plan.ntiles * plan.segs * 3,
            "ss2": n * cout * 2, "acc": m * cout if plan.split2 > 1 else 0}


def _scratch_offsets(sizes: Dict[str, int],
                     names) -> Tuple[Dict[str, int], int]:
    """Element offsets of `names` packed one after another, each 16-byte
    aligned (64 elements), and the total."""
    offs, at = {}, 0
    for name in names:
        offs[name] = at
        at += -(-sizes[name] // 64) * 64
    return offs, at


def pack_conv_weight(w, cp: int):
    """(Cout, Cin, kh, kw) -> (Cout, kh, kw, cp), input channels zero-padded
    to cp: the tap-major K order of kernel E's implicit GEMM (k = tap * cp +
    c). A layout change, no arithmetic."""
    out = w.detach().permute(0, 2, 3, 1)
    if cp != w.shape[1]:
        out = F.pad(out, (0, cp - w.shape[1]))
    return out.contiguous()


# packed weights per weight tensor, repacked when its storage, version,
# device or dtype changes; an entry goes with its weight
_PACKED = WeakIdKeyDictionary()


def packed_conv_weight(w, cp: int):
    """``pack_conv_weight(w, cp)``, cached per weight tensor: an in-place
    change (which bumps ``w._version``) or a move is repacked on the next
    call."""
    # a move or cast changes the pointer; a tensor made under
    # torch.inference_mode keeps no version counter
    key = (0 if w.is_inference() else w._version, w.data_ptr(), cp)
    hit = _PACKED.get(w)
    if hit is not None and hit[0] == key:
        return hit[1]
    packed = pack_conv_weight(w, cp)
    _PACKED[w] = (key, packed)
    return packed


def _group_stats(xf, num_groups, eps):
    """Per-(image, channel) mean and 1/std of its group, over fp32 NCHW xf;
    each (N, C, 1, 1)."""
    n, c = xf.shape[:2]
    g = xf.reshape(n, num_groups, -1)
    rep = c // num_groups
    mean = g.mean(-1).repeat_interleave(rep, dim=1)
    rstd = torch.rsqrt(g.var(-1, correction=0) + eps).repeat_interleave(rep, dim=1)
    return mean[:, :, None, None], rstd[:, :, None, None]


def _tiled_group_stats(hf, num_groups, eps, bm, bn, drop_tile=False):
    """``_group_stats`` as kernel E takes GN2's: the NHWC rows (pixels, the
    batch folded in) cut into tiles of bm and the channels into tiles of bn;
    each tile's (count, mean, M2) per (image, group) segment, two passes;
    merged per (image, group) by Chan's formula for many partials (mean =
    sum(n_i mean_i) / n, M2 = sum(M2_i + n_i (mean_i - mean)^2)).
    drop_tile leaves tile (0, 0)'s partials out of the merge."""
    n, c, hh, ww = hf.shape
    hw, m = hh * ww, n * hh * ww
    cpg, ntiles = c // num_groups, -(-c // bn)
    rows = hf.permute(0, 2, 3, 1).reshape(-1)
    r = torch.arange(m, device=hf.device)
    col = torch.arange(c, device=hf.device)
    nck = ntiles * num_groups
    key = (((r // bm) * n + r // hw)[:, None] * nck
           + ((col // bn) * num_groups + col // cpg)[None, :]).reshape(-1)
    size = -(-m // bm) * n * nck

    def scatter(v):
        return torch.zeros(size, device=hf.device).index_add_(0, key, v)
    cnt = scatter(torch.ones_like(rows))
    mean = scatter(rows) / cnt.clamp_min(1)
    m2 = scatter((rows - mean[key]) ** 2)
    part = torch.arange(size, device=hf.device)
    if drop_tile:
        keep = (part // (n * nck) != 0) | ((part % nck) // num_groups != 0)
        cnt = cnt * keep
    target = ((part // nck) % n) * num_groups + part % num_groups

    def merge(v):
        return torch.zeros(n * num_groups, device=hf.device).index_add_(
            0, target, v)
    total = merge(cnt)
    mu = merge(cnt * mean) / total
    var = merge(torch.where(cnt > 0, m2, 0.0)
                + cnt * (mean - mu[target]) ** 2) / total
    rstd = torch.rsqrt(var + eps)
    mu = mu.reshape(n, num_groups).repeat_interleave(cpg, dim=1)
    rstd = rstd.reshape(n, num_groups).repeat_interleave(cpg, dim=1)
    return mu[:, :, None, None], rstd[:, :, None, None]


def resnet_fused_reference(x, norm1_w, norm1_b, w1, b1, trow, norm2_w,
                           norm2_b, w2, b2, wsc=None, bsc=None, *,
                           num_groups: int = 32, eps: float = 1e-5,
                           fault=None, gn2_tiles=None):
    """Plain twin of kernel E over NCHW: GN1 -> SiLU -> conv3x3 -> + b1 +
    trow -> GN2 -> SiLU -> conv3x3 -> + b2 + shortcut (the 1x1 conv
    ``wsc``/``bsc``, or the identity when ``wsc`` is None). Weights in the
    torch layout; ``trow`` (N, Cout) or None (no time embedding, the VAE).

    The rounding points are the Pallas kernel's
    (editanything_tpu/core/kernels.py:645-675), which the CUDA kernel keeps:
    the normalised activations xn and hn are rounded to x's dtype before each
    conv; the conv sums, h, GN2's statistics and the output sum stay fp32
    until one final rounding; the shortcut takes the raw x with fp32 sums.
    Zero padding comes after the normalisation.

    ``gn2_tiles`` (bm, bn) takes GN2's statistics as the kernel does: per
    tile of bm pixels x bn channels, merged by Chan's formula
    (``_tiled_group_stats``); None takes them directly.

    ``fault`` plants one of ``RESNET_FAULTS`` (for the chip checks, which
    must reject each): "pad_silu_shift" pads before normalising, so taps
    outside the image see SiLU(shift) instead of 0; "gn2_groups_shifted"
    takes GN2's group statistics one channel further on; "no_shortcut" drops
    the shortcut; "gn2_tile_dropped" leaves tile (0, 0)'s GN2 partials out
    of the merge (the tiled route, with the plan's tiles unless
    ``gn2_tiles`` names others)."""
    if fault is not None and fault not in RESNET_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    dt = x.dtype
    xf = x.float()
    pad = 0 if fault == "pad_silu_shift" else 1
    h, affine = _resnet_first_half(x, norm1_w, norm1_b, w1, b1, trow,
                                   norm2_w, norm2_b, num_groups, eps, fault,
                                   gn2_tiles)
    scale, shift = affine
    if pad == 0:
        h = F.pad(h, (1, 1, 1, 1))
    y = h * scale + shift
    hn = (y * torch.sigmoid(y)).to(dt).float()
    out = F.conv2d(hn, w2.to(dt).float(), padding=pad) \
        + b2.to(dt).float()[:, None, None]
    if fault != "no_shortcut":
        if wsc is not None:
            out = out + F.conv2d(xf, wsc.to(dt).float()) \
                + bsc.to(dt).float()[:, None, None]
        else:
            out = out + xf
    return out.to(dt)


def _resnet_first_half(x, norm1_w, norm1_b, w1, b1, trow, norm2_w, norm2_b,
                       num_groups, eps, fault, gn2_tiles):
    """The twin up to GN2: h = conv1(xn) + b1 + trow (fp32) and GN2's
    per-channel (scale, shift), each (N, Cout, 1, 1)."""
    dt = x.dtype
    pad = 0 if fault == "pad_silu_shift" else 1
    if fault == "gn2_tile_dropped" and gn2_tiles is None:
        gn2_tiles = (RESNET_BM, resnet_channel_tile(w1.shape[0]))

    def affine(v, weight, bias, shifted=False, tiles=None):
        # GroupNorm as scale = gamma * rstd, shift = beta - mean * scale (the
        # Pallas kernel's _rn_group_stats)
        if shifted:
            mean, rstd = _group_stats(v.roll(-1, dims=1), num_groups, eps)
            mean, rstd = mean.roll(1, dims=1), rstd.roll(1, dims=1)
        elif tiles is not None:
            mean, rstd = _tiled_group_stats(
                v, num_groups, eps, *tiles,
                drop_tile=fault == "gn2_tile_dropped")
        else:
            mean, rstd = _group_stats(v, num_groups, eps)
        scale = weight.to(dt).float()[:, None, None] * rstd
        return scale, bias.to(dt).float()[:, None, None] - mean * scale

    xf = x.float()
    scale, shift = affine(xf, norm1_w, norm1_b)
    if pad == 0:
        xf = F.pad(xf, (1, 1, 1, 1))
    y = xf * scale + shift
    xn = (y * torch.sigmoid(y)).to(dt).float()     # SiLU, rounded to dt
    h = F.conv2d(xn, w1.to(dt).float(), padding=pad)
    if trow is None:
        h = h + b1.to(dt).float()[:, None, None]
    else:
        h = h + (trow.to(dt).float() + b1.to(dt).float())[:, :, None, None]
    return h, affine(h, norm2_w, norm2_b,
                     shifted=fault == "gn2_groups_shifted", tiles=gn2_tiles)


def resnet_gn2_affine_reference(x, norm1_w, norm1_b, w1, b1, trow, norm2_w,
                                norm2_b, *, num_groups: int = 32,
                                eps: float = 1e-5, fault=None,
                                gn2_tiles=None):
    """GN2's per-channel (scale, shift) of the twin, stacked (2, N, Cout) in
    fp32: what kernel E's fin2 pass writes (interleaved) to its ``ss2``
    scratch, with ``fault`` and ``gn2_tiles`` as in
    ``resnet_fused_reference``."""
    _, (scale, shift) = _resnet_first_half(
        x, norm1_w, norm1_b, w1, b1, trow, norm2_w, norm2_b, num_groups, eps,
        fault, gn2_tiles)
    return torch.stack([scale[..., 0, 0], shift[..., 0, 0]])


def bind_resnet(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a kernel E library (``ea_resnet_fused``)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # x, gn1 w/b, w1, b1, trow, gn2 w/b, w2, b2, wsc, bsc, out, xn, xs, h,
    # hn, part1, part2, ss2, acc; N, cin, cout, H, W, groups, cp1, cp2, bn,
    # split1, split2, slots, segs; eps, dtype, stream
    lib.ea_resnet_fused.argtypes = ([ptr] * 21 + [i32] * 13
                                    + [ctypes.c_float, i32, ptr])
    lib.ea_resnet_fused.restype = i32
    lib.ea_resnet_occupancy.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.ea_resnet_occupancy.restype = i32
    lib.ea_cuda_error_string.argtypes = [i32]
    lib.ea_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _resnet_library() -> ctypes.CDLL:
    from editanything_tpu_torch.core.build import load_library
    return bind_resnet(load_library("resnet_fused"))


def build_resnet() -> None:
    """Compile and load kernel E's library (first use does this)."""
    _resnet_library()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def resnet_occupancy(bn: int, dtype) -> Tuple[int, int]:
    """(conv CTAs per SM, dynamic shared memory bytes) of kernel E's conv
    at channel tile bn on the current device."""
    out = (ctypes.c_int * 2)()
    lib = _resnet_library()
    _raise_on(lib.ea_resnet_occupancy(bn, _DTYPE_CODES[dtype], out), lib,
              "resnet_occupancy")
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _resnet_layout(n, cin, cout, h, w, num_groups, shortcut, sms):
    """(plan, scratch sizes, offsets and totals of the two scratch
    buffers) of a block shape: the wrapper's per-call work, done once."""
    plan = resnet_plan(n, cin, cout, h, w, num_groups, shortcut, sms)
    sizes = resnet_scratch(n, cin, cout, h, w, num_groups, shortcut, plan)
    offs_t, total_t = _scratch_offsets(sizes, RESNET_SCRATCH_T)
    offs_f, total_f = _scratch_offsets(sizes, RESNET_SCRATCH_F32)
    return plan, sizes, offs_t, total_t, offs_f, total_f


def _resnet_launch(lib, x, args, num_groups, eps):
    """Plan kernel E's call, pack (cached) its weights, allocate its output
    and scratch (one buffer in x's dtype, one in fp32) and call
    ``ea_resnet_fused`` of ``lib`` on the current stream (checked CUDA
    inputs in x's dtype). Returns (out, plan, scratch), scratch(name) a
    view of one scratch buffer: chip_smoke.py reads GN2's scale and shift
    in scratch("ss2")."""
    (norm1_w, norm1_b, w1, b1, trow, norm2_w, norm2_b, w2, b2, wsc,
     bsc) = args
    n, cin, hgt, wid = x.shape
    cout = w1.shape[0]
    dt, dev = x.dtype, x.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    plan, sizes, offs_t, total_t, offs_f, total_f = _resnet_layout(
        n, cin, cout, hgt, wid, num_groups, wsc is not None, _sm_count(index))
    # held until the launch is queued: the pointers are into these
    vecs = [None if t is None else t.contiguous()
            for t in (norm1_w, norm1_b, w1, b1, trow, norm2_w, norm2_b, w2,
                      b2, wsc, bsc)]
    vecs[2] = packed_conv_weight(w1, plan.cp_in)
    vecs[7] = packed_conv_weight(w2, plan.cp_out)
    if wsc is not None:
        vecs[9] = packed_conv_weight(wsc, plan.cp_in)
    out = torch.empty((n, cout, hgt, wid), dtype=dt, device=dev)
    buf_t = torch.empty(total_t, dtype=dt, device=dev)
    buf_f = torch.empty(total_f, dtype=torch.float32, device=dev)
    base_t, base_f = buf_t.data_ptr(), buf_f.data_ptr()
    item = buf_t.element_size()
    ptr = {name: base_t + item * offs_t[name] for name in RESNET_SCRATCH_T}
    ptr.update((name, base_f + 4 * offs_f[name])
               for name in RESNET_SCRATCH_F32)
    for name, size in sizes.items():
        if size == 0:
            ptr[name] = None
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        return lib.ea_resnet_fused(
            x.data_ptr(), *(None if t is None else t.data_ptr() for t in vecs),
            out.data_ptr(), ptr["xn"], ptr["xs"], ptr["h"], ptr["hn"],
            ptr["part1"], ptr["part2"], ptr["ss2"], ptr["acc"],
            n, cin, cout, hgt, wid, num_groups, plan.cp_in, plan.cp_out,
            plan.bn, plan.split1, plan.split2, plan.slots, plan.segs,
            float(eps), _DTYPE_CODES[dt], stream)
    if index == torch.cuda.current_device():
        err = call()
    else:
        with torch.cuda.device(dev):
            err = call()
    _raise_on(err, lib, "resnet_fused")

    def scratch(name):
        buf, offs = (buf_t, offs_t) if name in offs_t else (buf_f, offs_f)
        return buf[offs[name]:offs[name] + sizes[name]]
    return out, plan, scratch


def resnet_fused(x, norm1_w, norm1_b, w1, b1, trow, norm2_w, norm2_b, w2,
                 b2, wsc=None, bsc=None, *, num_groups: int = 32,
                 eps: float = 1e-5):
    """The SD resnet block in one call (the arguments of
    ``resnet_fused_reference``): x (N, Cin, H, W) -> (N, Cout, H, W) in x's
    dtype, 3x3 convs in the torch layout (Cout, Cin, 3, 3).

    CUDA tensors launch kernel E (six device launches on the current
    stream, two more for each conv split over K; counted once in
    ``resnet_fused.launches``) as ``resnet_plan`` plans it, with the conv
    weights packed tap-major once per weight tensor (``packed_conv_weight``,
    repacked after an in-place change), and take fp32 or bf16 with every
    parameter in x's dtype, through ``TwinVJP`` where autograd records (its
    backward recomputes through the twin); CPU tensors take the plain twin.
    Shapes the block cannot have raise: channels that do not split into the
    groups, kernels other than 3x3, an identity shortcut with Cin != Cout."""
    if x.dim() != 4:
        raise ValueError(f"resnet_fused takes NCHW, got {tuple(x.shape)}")
    n, cin, hgt, wid = x.shape
    cout = w1.shape[0]
    if cin % num_groups or cout % num_groups:
        raise ValueError(f"{cin} or {cout} channels do not split into "
                         f"{num_groups} groups")
    if (w1.shape != (cout, cin, 3, 3) or w2.shape != (cout, cout, 3, 3)
            or (wsc is None and cin != cout)
            or (wsc is not None and wsc.shape != (cout, cin, 1, 1))
            or (trow is not None and trow.shape != (n, cout))):
        raise ValueError(
            f"resnet_fused takes 3x3 convs (Cout, Cin, 3, 3), a 1x1 shortcut "
            f"(or none when Cin == Cout) and trow (N, Cout); got w1 "
            f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}, wsc "
            f"{None if wsc is None else tuple(wsc.shape)}, trow "
            f"{None if trow is None else tuple(trow.shape)} for x "
            f"{tuple(x.shape)}")
    args = (norm1_w, norm1_b, w1, b1, trow, norm2_w, norm2_b, w2, b2, wsc, bsc)
    if x.device.type == "cpu":
        return resnet_fused_reference(x, *args, num_groups=num_groups, eps=eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"resnet_fused: no kernel for {x.device}")
    dt = x.dtype
    if dt not in _DTYPE_CODES:
        raise TypeError(f"resnet_fused takes fp32 or bf16, got {dt}")
    if trow is not None:    # the time-embedding row is rounded to dt
        args = args[:4] + (trow.to(dt),) + args[5:]
    if any(t is not None and (t.dtype != dt or t.device != x.device)
           for t in args):
        raise TypeError("resnet_fused: every parameter must have x's dtype "
                        "and device")
    return twin_vjp(lambda x, *a: _resnet_forward(x, a, num_groups, eps),
                    functools.partial(resnet_fused_reference,
                                      num_groups=num_groups, eps=eps),
                    x, *args)


def _resnet_forward(x, args, num_groups, eps):
    """One call of kernel E on checked CUDA inputs (counted)."""
    out = _resnet_launch(_resnet_library(), x.contiguous(), args, num_groups,
                         eps)[0]
    resnet_fused.launches += 1
    return out


resnet_fused.launches = 0
