"""The port's flash attention and GroupNorm(+SiLU) kernels
(editanything_tpu_torch.core) against the JAX package's Pallas kernels,
which run here in interpret mode (conftest), and kernel A's launch plan at
every GroupNorm call of a full-width edit request.

On the CPU the port's wrappers take their plain PyTorch twins, so these
tests hold the twins' arithmetic against the Pallas kernels and check that
no kernel launch is counted. The kernels themselves need an NVIDIA GPU;
tests/test_torch_kernels_cuda.py compares them with their twins there.

Tolerances (fp32 inputs, matmul precision "highest" on the JAX side):
- attention 1e-4 absolute on outputs of magnitude <~2: both sides compute
  fp32 logits, max, exp and sums, in different orders, and with SAM's
  scale 1.0 over depth 208 the logits reach ~50, whose fp32 rounding
  (~3e-6) exp turns into relative error of the same size;
- GroupNorm 1e-5 absolute on outputs of magnitude <~4 (SiLU of them): the
  fp32 statistics are summed in different orders.
"""

import functools
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.core import flash_attention as jfa
from editanything_tpu.core import kernels as jk
from editanything_tpu_torch.core import flash_attention as tfa
from editanything_tpu_torch.core import kernels as tk
from editanything_tpu_torch.core import layers as tl

ATTN_TOL = 1e-4
GN_TOL = 1e-5


def _qkv(seed, b, h, n, m, dqk, dv):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, n, dqk), dtype=np.float32)
    k = rng.standard_normal((b, h, m, dqk), dtype=np.float32)
    v = rng.standard_normal((b, h, m, dv), dtype=np.float32)
    return q, k, v


# (n, m, dqk, dv, scale): the UNet's head depths with a ragged key tail
# (M = 77, cross-attention), SAM's deep q/k (208 vs 80, scale 1.0) and a
# small VAE-depth (512) case
ATTN_CASES = [
    (128, 128, 40, 40, None),
    (256, 77, 80, 80, None),
    (130, 77, 160, 160, None),
    (96, 64, 208, 80, 1.0),
    (64, 64, 512, 512, None),
]


@pytest.mark.parametrize("n,m,dqk,dv,scale", ATTN_CASES)
def test_flash_attention_plain_matches_pallas(n, m, dqk, dv, scale):
    q, k, v = _qkv(n + m + dqk, 2, 2, n, m, dqk, dv)
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), scale=scale))
    got = tfa.flash_attention_reference(torch.from_numpy(q),
                                        torch.from_numpy(k),
                                        torch.from_numpy(v), scale=scale)
    assert got.shape == (2, 2, n, dv)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=0)


GN_CASES = [(1e-5, True), (1e-5, False), (1e-6, True), (1e-6, False)]


@pytest.mark.parametrize("eps,apply_silu", GN_CASES)
def test_group_norm_silu_plain_matches_pallas(eps, apply_silu):
    rng = np.random.default_rng(int(eps * 1e7) + apply_silu)
    x = rng.standard_normal((2, 8, 8, 64), dtype=np.float32) * 3.0 + 0.5
    scale = rng.standard_normal(64, dtype=np.float32)
    bias = rng.standard_normal(64, dtype=np.float32)
    want = np.asarray(jk.group_norm_silu(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x), num_groups=32, eps=eps, apply_silu=apply_silu))
    got = tk.group_norm_silu_reference(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(scale),
        torch.from_numpy(bias), num_groups=32, eps=eps, apply_silu=apply_silu)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=GN_TOL, rtol=0)


def test_cpu_wrappers_take_plain_twins_and_count_no_launch():
    tfa.flash_attention.launches = 0
    tk.group_norm_silu.launches = 0
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 2, 64, 77, 40, 40))
    torch.testing.assert_close(tfa.flash_attention(q, k, v),
                               tfa.flash_attention_reference(q, k, v),
                               rtol=0, atol=0)
    torch.testing.assert_close(tl.attention(q, k, v),
                               tfa.flash_attention_reference(q, k, v),
                               rtol=0, atol=0)
    x = torch.randn(2, 64, 8, 8, generator=torch.Generator().manual_seed(0))
    w, b = torch.ones(64), torch.zeros(64)
    torch.testing.assert_close(tk.group_norm_silu(x, w, b, num_groups=32),
                               tk.group_norm_silu_reference(x, w, b,
                                                            num_groups=32),
                               rtol=0, atol=0)
    assert tfa.flash_attention.launches == 0
    assert tk.group_norm_silu.launches == 0


def test_masked_dispatch_uses_plain_attention():
    from editanything_tpu.core import layers as jl
    q, k, v = _qkv(3, 1, 2, 8, 8, 16, 16)
    i = np.arange(8)
    mask = (i[None, :] <= i[:, None])[None, None]
    want = np.asarray(jl.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask)))
    got = tl.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL, rtol=0)


# GroupNorm calls of one composed 512^2 edit request (2 samples under CFG,
# 30 steps): per step the UNet and two ControlNets at batch 4, then the VAE
# decoder at batch 2 and the VAE encoder at batch 1 (the masked image)
STEPS = 30
GN_CALLS = {"unet": 61, "controlnet": 27, "vae decoder": 29, "vae encoder": 21}
SMEM_PER_CTA = 232448           # 227 KB, the most a CTA of an H100 may use


@functools.cache
def _traced_group_norms():
    """{model: Counter((shape, groups, eps, silu) -> calls)} of one forward
    of the full-width SD1.5 UNet, a ControlNet and the VAE decoder and
    encoder on the meta device (tools/bench_gn.py, which times kernel A at
    these shapes on the GPU)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "bench_gn.py"
    spec = importlib.util.spec_from_file_location("bench_gn", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    return bench.trace_group_norms()


def test_edit_request_makes_3500_group_norm_calls():
    calls = _traced_group_norms()
    assert {m: sum(c.values()) for m, c in calls.items()} == GN_CALLS
    per_request = (STEPS * (GN_CALLS["unet"] + 2 * GN_CALLS["controlnet"])
                   + GN_CALLS["vae decoder"] + GN_CALLS["vae encoder"])
    assert per_request == 3500
    # the 18 UNet/ControlNet shapes (with and without SiLU)
    denoise = set(calls["unet"]) | set(calls["controlnet"])
    assert len(denoise) == 18


@pytest.mark.parametrize("itemsize", [2, 4])
def test_group_norm_plan_fits_every_traced_shape(itemsize):
    """Every GroupNorm of the request gets a plan whose CTAs hold at most
    227 KB in clusters of at most 16; every UNet/ControlNet shape is held on
    chip, in bf16 by one CTA per slab or a cluster of 2; in bf16 only the VAE
    decoder's 4 MB slabs (2, 256, 512, 512) are streamed, in part, through
    L2."""
    calls = _traced_group_norms()
    streamed = set()
    for model, counter in calls.items():
        for (shape, groups, _eps, _silu) in counter:
            plan = tk.group_norm_plan(*shape, groups, itemsize)
            assert plan.smem_bytes <= SMEM_PER_CTA
            assert plan.k in (1, 2, 4, 8, 16)
            assert plan.ctas % plan.k == 0
            slab = shape[1] // groups * shape[2] * shape[3] * itemsize
            assert plan.share_bytes * plan.k >= slab
            assert plan.ctas == shape[0] * groups * plan.k
            assert plan.smem_bytes <= tk.GN_ONCHIP_MAX
            if plan.path == "stream":
                streamed.add(shape)
                assert plan.k == 16 and plan.held_bytes < plan.share_bytes
            else:
                assert plan.held_bytes == plan.share_bytes <= plan.smem_bytes
                assert (plan.path == "single") == (plan.k == 1)
            if model in ("unet", "controlnet"):
                assert plan.path != "stream", (shape, plan)
                assert plan.k <= 2 or itemsize > 2, (shape, plan)
    if itemsize == 2:
        assert streamed == {(2, 256, 512, 512)}


@pytest.mark.parametrize("shape,itemsize,want", [
    ((4, 1280, 8, 8), 2, ("single", 1, 128, 5120)),
    ((4, 320, 64, 64), 2, ("single", 1, 128, 81920)),
    ((4, 960, 64, 64), 2, ("cluster", 2, 256, 122880)),
    ((1, 512, 64, 64), 2, ("cluster", 4, 128, 32768)),
    ((2, 512, 128, 128), 2, ("cluster", 8, 512, 65536)),
    ((2, 256, 256, 256), 2, ("cluster", 16, 1024, 65536)),
    ((1, 128, 512, 512), 2, ("cluster", 16, 512, 131072)),
    ((2, 256, 512, 512), 2, ("stream", 16, 1024, 262144)),
    ((1, 32, 7, 9), 4, ("single", 1, 32, 252)),
])
def test_group_norm_plan_paths(shape, itemsize, want):
    plan = tk.group_norm_plan(*shape, 32, itemsize)
    assert (plan.path, plan.k, plan.ctas, plan.share_bytes) == want


@pytest.mark.parametrize("itemsize", [2, 4])
def test_group_norm_plan_nhwc_fits_every_traced_shape(itemsize):
    """Every GroupNorm of the request has an NHWC plan on a 132-SM card:
    "grid" with one CTA per SM whose ranges cover each image, each holding
    at most GN_ONCHIP_MAX; else (image, group) slabs in packs that a
    group's run is a whole number of, in clusters of at most 2, held on
    chip by CTAs of at most 227 KB."""
    for model, counter in _traced_group_norms().items():
        for (shape, groups, _eps, _silu) in counter:
            n, c, h, w = shape
            plan = tk.group_norm_plan(*shape, groups, itemsize, nhwc=True,
                                      sms=132)
            assert plan is not None, shape
            if plan.path == "grid":
                assert plan.ctas == n * plan.k <= 132
                assert plan.k * plan.share_bytes >= h * w * c * itemsize
                assert plan.held_bytes == min(plan.share_bytes,
                                              tk.GN_ONCHIP_MAX)
                assert plan.vec_bytes == 16
                assert tk.nhwc_grid_fits(c, groups, itemsize)
            else:
                assert plan.k in (1, 2) and plan.ctas == n * groups * plan.k
                assert (c // groups * itemsize) % plan.vec_bytes == 0
                assert plan.held_bytes == plan.share_bytes <= plan.smem_bytes
                assert plan.smem_bytes <= min(SMEM_PER_CTA, tk.GN_ONCHIP_MAX)
                assert plan.k * plan.share_bytes >= (c // groups * h * w
                                                     * itemsize)


@pytest.mark.parametrize("shape,itemsize,want", [
    ((4, 1280, 8, 8), 2, ("single", 1, 128, 8)),
    ((4, 320, 32, 32), 2, ("single", 1, 128, 4)),
    ((4, 640, 32, 32), 2, ("single", 1, 128, 8)),
    ((4, 320, 64, 64), 2, ("grid", 33, 132, 16)),
    ((4, 640, 64, 64), 2, ("grid", 33, 132, 16)),
    ((1, 512, 64, 64), 2, ("cluster", 2, 64, 8)),
    ((2, 256, 512, 512), 2, ("grid", 66, 132, 16)),
    ((2, 32, 7, 9), 2, ("single", 1, 64, 2)),
    ((2, 32, 7, 9), 4, ("single", 1, 64, 4)),
])
def test_group_norm_plan_nhwc_paths(shape, itemsize, want):
    plan = tk.group_norm_plan(*shape, 32, itemsize, nhwc=True, sms=132)
    assert (plan.path, plan.k, plan.ctas, plan.vec_bytes) == want


@pytest.mark.parametrize("cpg,bf16,fp32,grid", [
    (4, 8, 8, True), (8, 8, 8, True), (10, 4, 8, True), (16, 8, 8, True),
    (20, 8, 8, True), (30, 4, 8, True), (40, 8, 8, True), (60, 8, 8, True),
    (80, 8, 8, True), (1, 2, 4, False)])
def test_nhwc_packs_of_every_group_width(cpg, bf16, fp32, grid):
    """The unit path's pack (the widest of 8 and 4 bytes and one element
    that a group's run is whole packs of) at C / 32 of the SD models; the
    grid path's 16-byte vectors straddle at most two groups down to 4
    channels a group, never at 1."""
    c = 32 * cpg
    assert tk.nhwc_pack(c, 32, 2) == bf16
    assert tk.nhwc_pack(c, 32, 4) == fp32
    assert tk.nhwc_grid_fits(c, 32, 2) is grid


# Every fp32 shape (B, H, N, M, Dqk, Dv) the port hands kernel B on the card:
# tests/test_torch_kernels_cuda.py's cases (ATTN_CASES at batch 2 x 3 heads,
# WIDE_CASES, the safety checker's, BLIP-2's, GroundingDINO's decoder, the
# strided heads, the gradient checks and the full-width training cases) and
# chip_smoke.py's fp32 calls (ATTN_SHAPES in fp32, TRAIN_GRAD_ATTN)
F32_TEST_SHAPES = [
    (2, 3, 128, 128, 40, 40), (2, 3, 256, 77, 80, 80),
    (2, 3, 130, 77, 160, 160), (2, 3, 96, 64, 208, 80),
    (2, 3, 64, 64, 512, 512), (2, 3, 70, 50, 36, 36),
    (2, 3, 80, 77, 176, 176), (2, 3, 196, 196, 108, 80),
    (2, 3, 196, 196, 112, 80), (2, 3, 256, 320, 40, 40),
    (2, 3, 200, 1030, 80, 80), (2, 3, 100, 150, 208, 80),
    (2, 3, 130, 1030, 64, 64),
    (1, 1, 100, 130, 512, 512), (2, 1, 100, 130, 512, 512),
    (1, 1, 64, 64, 512, 512), (2, 1, 64, 64, 512, 512),
    (2, 16, 257, 257, 64, 64),
    (1, 16, 257, 257, 88, 88), (10, 16, 257, 257, 88, 88),
    (1, 12, 32, 32, 64, 64), (10, 12, 32, 257, 64, 64),
    (1, 8, 900, 900, 32, 32), (2, 8, 300, 77, 40, 40),
    (2, 2, 256, 256, 40, 40), (2, 2, 256, 77, 80, 80),
    (2, 2, 64, 77, 160, 160), (2, 2, 64, 64, 512, 512),
    (2, 2, 96, 64, 208, 80),
    (1, 1, 4096, 4001, 512, 512),
    (4, 8, 4096, 4096, 40, 40), (4, 8, 4096, 77, 40, 40),
    (4, 8, 1024, 1024, 80, 80), (4, 8, 1024, 77, 80, 80),
    (4, 8, 256, 256, 160, 160), (4, 8, 256, 77, 160, 160),
    (4, 8, 64, 64, 160, 160), (4, 8, 64, 77, 160, 160),
    (1, 16, 4096, 4096, 208, 80), (2, 8, 1024, 77, 80, 80),
]
# chip_smoke.py TRAIN_ATTN_SHAPES: a ControlNet training step at 512^2 with
# batch 2 (64x64 self also with a tensor-parallel rank's 4 and 2 of its 8
# heads) and its preprocessor's VAE encoder mid attention
F32_TRAIN_SHAPES = [
    (2, 8, 4096, 4096, 40, 40), (2, 4, 4096, 4096, 40, 40),
    (2, 2, 4096, 4096, 40, 40), (2, 8, 4096, 77, 40, 40),
    (2, 8, 1024, 1024, 80, 80), (2, 8, 256, 256, 160, 160),
    (2, 8, 64, 64, 160, 160), (2, 1, 4096, 4096, 512, 512),
]


@pytest.mark.parametrize("shape", F32_TEST_SHAPES + F32_TRAIN_SHAPES)
def test_flash_f32_plan_fits_every_fp32_shape(shape):
    """Kernel B's fp32 plan at every fp32 shape the port launches: each
    block fits 227 KB, the row tiles cover N, the key chunks cover M
    exactly (none empty), narrow exactly where Dv <= 160 and Dqk <= 256,
    and at the training shapes the grid has at least one block per SM."""
    b, h, n, m, dqk, dv = shape
    plan = tfa.flash_f32_plan(*shape)
    assert 0 < plan.smem <= SMEM_PER_CTA
    assert plan.path == ("narrow" if dv <= 160 and dqk <= 256 else "wide")
    if plan.path == "narrow":
        assert plan.warps in (1, 2, 4) and plan.rows == plan.warps * 16 * plan.mt
    else:
        assert plan.warps == 8 and plan.rows == 16 * plan.mt == 64
    assert plan.grid[0] == -(-n // plan.rows) and plan.grid[1] == b * h
    assert plan.grid[2] == plan.splits and 1 <= plan.splits <= 16
    assert (plan.splits - 1) * plan.chunk < m <= plan.splits * plan.chunk
    assert 8 * plan.dvt >= dv
    if shape in F32_TRAIN_SHAPES:
        assert plan.blocks >= 132


def test_flash_f32_plan_refuses_depths_past_512():
    with pytest.raises(ValueError):
        tfa.flash_f32_plan(1, 1, 64, 64, 520, 64)
    with pytest.raises(ValueError):
        tfa.flash_f32_plan(1, 1, 64, 64, 64, 513)
