"""The port's kernels against their plain PyTorch twins, on the GPU.

Marked ``cuda``: they skip without an NVIDIA GPU (the CUDA and Triton
kernels have no CPU mode). This file imports neither jax nor the JAX
package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: tests/conftest.py configures jax.) ``chip_smoke.py``
makes the same comparison at the main path's shapes.

Tolerances: fp32 1e-4 absolute (fp32 products, kernel B's in 3xTF32
within ~2^-21 of them, sums in other orders); bf16 attention 2^-6 of the
twin's largest output, i.e. two bf16 ulps of it (both sides keep fp32
sums and round the output once; P is rounded to bf16 unnormalised in the
kernel and normalised in the twin);
bf16 GroupNorm 6.25e-2, one bf16 ulp at outputs below 16 (fp16 1e-2, one
fp16 ulp there). SAM's decoder
kernels (two-way transformer, upscale + hypernetwork) at SAM's published
decoder widths with small batches: fp32 1e-4 absolute (exact fp32 products
summed in other orders; outputs of magnitude ~1-10); bf16 the bounds of
chip_smoke.py, stated against the twin's largest output. The fused resnet
block: fp32 1e-4 absolute (exact fp32 products summed in other orders);
bf16 the bounds of chip_smoke.py (2^-6 of the twin's largest output and a
relative RMS error of 2e-3).
"""

import warnings

import numpy as np
import pytest
import torch

from editanything_tpu_torch.core import flash_attention as tfa
from editanything_tpu_torch.core import kernels as tk
from editanything_tpu_torch.models.sam import SAMConfig
from editanything_tpu_torch.pipelines.bundle import random_sam

# (n, m, dqk, dv, scale): those of tests/test_torch_kernels.py, plus a
# depth that rules out 16-byte loads (36), an output depth wider than 160
# that takes the wide kernel with a partly used warp (176), key loops longer
# than the ring with a ragged last tile (320 and 1030 keys) and a query count
# that leaves most warps of the 256-row block past N (100), and SD2.1's
# 64-wide heads
ATTN_CASES = [
    (128, 128, 40, 40, None),
    (256, 77, 80, 80, None),
    (130, 77, 160, 160, None),
    (96, 64, 208, 80, 1.0),
    (64, 64, 512, 512, None),
    (70, 50, 36, 36, None),
    (80, 77, 176, 176, None),
    (196, 196, 108, 80, 1.0),     # SAM's windowed encoder layers, unpadded
    (196, 196, 112, 80, 1.0),     # and padded to 16-byte rows, as the model
    (256, 320, 40, 40, None),
    (200, 1030, 80, 80, None),
    (100, 150, 208, 80, 1.0),
    (130, 1030, 64, 64, None),    # SD2.1's 64-wide heads, ragged key tail
]
# (batch, n, m): the VAE's single 512-deep head through the wide kernel, at
# batch 1 (encoder) and 2 (decoder), ragged and whole tiles
WIDE_CASES = [(1, 100, 130), (2, 100, 130), (1, 64, 64), (2, 64, 64)]
GN_CASES = [(1e-5, True), (1e-5, False), (1e-6, True), (1e-6, False)]
SAM_F32_TOL = 1e-4
TWOWAY_BF16_REL = 2.0 ** -5      # chip_smoke.py TWOWAY_BF16_REL_BOUND
TWOWAY_BF16_RMS = 5e-3           # chip_smoke.py TWOWAY_BF16_RMS_BOUND
UPSCALE_BF16_REL = 2.0 ** -6     # chip_smoke.py UPSCALE_BF16_REL_BOUND
# a small SAM whose decoder has the published widths (256, 8 heads, MLP 2048)
SMALL_SAM = SAMConfig(img_size=128, patch_size=16, embed_dim=64, depth=2,
                      num_heads=2, global_attn_indexes=(1,), window_size=4)


def _qkv(seed, b, h, n, m, dqk, dv):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape, dtype=np.float32)
                 for shape in ((b, h, n, dqk), (b, h, m, dqk), (b, h, m, dv)))


def _attention_err_and_bound(got, want):
    err = (got.float() - want.float()).abs().max().item()
    if want.dtype == torch.bfloat16:
        return err, 2.0 ** -6 * want.float().abs().max().item()
    return err, 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,dqk,dv,scale", ATTN_CASES)
def test_flash_attention_kernel_matches_plain(cuda_device, dtype,
                                              n, m, dqk, dv, scale):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(1, 2, 3, n, m, dqk, dv))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, scale=scale)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_reference(q, k, v, scale=scale)
    err, bound = _attention_err_and_bound(got, want)
    assert err <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,n,m", WIDE_CASES)
def test_flash_attention_wide_head_matches_plain(cuda_device, dtype, batch,
                                                 n, m):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(4, batch, 1, n, m, 512, 512))
    got = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = tfa.flash_attention_reference(q, k, v)
    err, bound = _attention_err_and_bound(got, want)
    assert err <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_safety_checker_shape_matches_plain(cuda_device,
                                                            dtype):
    """The safety checker's ViT-L/14 at 224^2 over 2 images: 16 heads of
    64 over the 257 tokens (256 patches + CLS), a ragged last tile."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(6, 2, 16, 257, 257, 64, 64))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_reference(q, k, v)
    err, bound = _attention_err_and_bound(got, want)
    assert err <= bound


# fp32 at full training width (b, h, n, m, dqk, dv), as the trainers run
# it (TF32 off): the UNet's 64x64 self- and cross-attention at batch 2, the
# VAE encoder's 512-deep mid attention at batch 2 (its keys in chunks), and
# at batch 1 with M a multiple of neither the key chunk nor the tile
F32_TRAIN_CASES = [(2, 8, 4096, 4096, 40, 40), (2, 8, 4096, 77, 40, 40),
                   (2, 1, 4096, 4096, 512, 512), (1, 1, 4096, 4001, 512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,m,dqk,dv", F32_TRAIN_CASES)
def test_flash_attention_fp32_training_shapes_match_plain(cuda_device, b, h,
                                                          n, m, dqk, dv):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(9, b, h, n, m, dqk, dv))
    plan = tfa.flash_f32_plan(b, h, n, m, dqk, dv)
    if dv == 512:
        assert plan.splits > 1
    if m == 4001:
        assert m % plan.chunk and m % plan.kb
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_reference(q, k, v)
    err, bound = _attention_err_and_bound(got, want)
    assert err <= bound


# fp32 at a tensor-parallel rank's heads (parallel/sharding.py): the UNet's
# 64x64 self-attention at batch 2 with 4 and with 2 of its 8 heads, as 2
# and 4 model ranks run it; fewer heads, fewer blocks, so the plan may
# split the keys
F32_TP_CASES = [(2, 4, 4096, 4096, 40, 40), (2, 2, 4096, 4096, 40, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,m,dqk,dv", F32_TP_CASES)
def test_flash_attention_fp32_tensor_parallel_heads(cuda_device, b, h, n, m,
                                                    dqk, dv):
    """Within the fp32 bound of the twin, and the bound rejects two planted
    faults made with the twin: the last key tile of the plan dropped and
    the logits scaled by 1.05."""
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(10, b, h, n, m, dqk, dv))
    plan = tfa.flash_f32_plan(b, h, n, m, dqk, dv)
    print(f"flash_f32_plan{(b, h, n, m, dqk, dv)}: {plan}")
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_reference(q, k, v)
    err, bound = _attention_err_and_bound(got, want)
    assert err <= bound
    keep = (m - 1) // plan.kb * plan.kb
    scale = dqk ** -0.5
    for fault in (tfa.flash_attention_reference(q, k[:, :, :keep],
                                                v[:, :, :keep]),
                  tfa.flash_attention_reference(q, k, v, scale=1.05 * scale)):
        assert _attention_err_and_bound(fault, want)[0] > bound


# BLIP-2's attention shapes (b, h, n, m, d): the EVA ViT-g/14 at 224^2, 16
# heads of 88 (padded to 96 inside the kernel) over 257 tokens, for one
# caption and for semantic's 10 crops; the Q-Former's 32 queries, 12 heads
# of 64, over themselves and over the 257 image tokens
BLIP2_ATTN_CASES = [(1, 16, 257, 257, 88), (10, 16, 257, 257, 88),
                    (1, 12, 32, 32, 64), (10, 12, 32, 257, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,n,m,d", BLIP2_ATTN_CASES)
def test_flash_attention_blip2_shapes_match_plain(cuda_device, dtype, b, h,
                                                  n, m, d):
    """Heads carved from the projections' (B, N, H * D) outputs, as the
    model passes them: strided views, the last axis contiguous."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(7, b, 1, n, m, h * d, h * d))
    q, k, v = (x.view(b, -1, h, d).transpose(1, 2) for x in (q, k, v))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_reference(q, k, v)
    err, bound = _attention_err_and_bound(got, want)
    assert err <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_groundingdino_decoder_shape_matches_plain(cuda_device,
                                                                   dtype):
    """GroundingDINO's decoder self-attention: 900 queries, 8 heads of 32
    carved from the (900, 256) projections, as the model passes them."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(8, 1, 1, 900, 900, 256, 256))
    q, k, v = (x.view(1, 900, 8, 32).transpose(1, 2) for x in (q, k, v))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_reference(q, k, v)
    err, bound = _attention_err_and_bound(got, want)
    assert err <= bound


# tiny detectors in fp32, CUDA against the CPU with the same weights:
# logits, scores and normalised boxes of magnitude ~0.1-10 within 1e-4
# (fp32 sums in other orders, TF32 off), boxes in pixels of a 64-96 px
# image within 1e-2 (chip_smoke.py TINY_DETECT_TOL, TINY_DETECT_BOX_PX_TOL)
DETECT_TOL = 1e-4
DETECT_BOX_PX_TOL = 1e-2


def _checker(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1),
                     ((xx // 8 + yy // 8) % 2) * 200], -1).astype(np.uint8)


@pytest.mark.cuda
def test_tiny_groundingdino_on_cuda_matches_cpu(cuda_device):
    import copy
    from editanything_tpu_torch.models import groundingdino as G
    from editanything_tpu_torch.pipelines.bundle import random_groundingdino
    from editanything_tpu_torch.text.tokenizer import tiny_bert_tokenizer
    cfg = G.tiny_dino_config()
    cpu = random_groundingdino(cfg, device="cpu", seed=3)
    image = _checker(70, 96)
    outs = []
    for model in (cpu, copy.deepcopy(cpu).to(cuda_device)):
        det = G.GroundingDINODetector(model, tiny_bert_tokenizer(),
                                      box_threshold=-1.0, short_side=64,
                                      max_side=96)
        inp = det.prepare(image, "a dog head. sofa")
        before = tfa.flash_attention.launches
        out = G.dino_forward(model, inp["pixels"], inp["text_ids"],
                             inp["text_mask"], inp["text_self_mask"],
                             inp["position_ids"])
        launched = tfa.flash_attention.launches - before
        real = inp["text_mask"][0].cpu()
        outs.append((out["logits"].cpu()[:, real], out["boxes"].cpu(),
                     det(image, "a dog head. sofa"), launched))
    (cl, cb, (cbox, cs, cp), c_launched), (gl, gb, (gbox, gs, gp),
                                           g_launched) = outs
    assert c_launched == 0 and g_launched == cfg.dec_layers
    torch.testing.assert_close(gl, cl, atol=DETECT_TOL, rtol=0)
    torch.testing.assert_close(gb, cb, atol=DETECT_TOL, rtol=0)
    np.testing.assert_allclose(gs, cs, atol=DETECT_TOL, rtol=0)
    np.testing.assert_allclose(gbox, cbox, atol=DETECT_BOX_PX_TOL, rtol=0)
    assert gp == cp


@pytest.mark.cuda
def test_tiny_vlpart_on_cuda_matches_cpu(cuda_device):
    import copy
    from editanything_tpu_torch.models import vlpart as V
    from editanything_tpu_torch.pipelines.bundle import random_vlpart
    from editanything_tpu_torch.text.tokenizer import tiny_tokenizer
    cpu = random_vlpart(V.tiny_vlpart_config(), device="cpu", seed=3)
    image = _checker(70, 96)
    outs = []
    for model in (cpu, copy.deepcopy(cpu).to(cuda_device)):
        det = V.VLPartDetector(model, tiny_tokenizer(context_length=16),
                               short_side=72, max_side=120)
        before = tfa.flash_attention.launches
        outs.append(det(image, "dog head.dog nose")
                    + (tfa.flash_attention.launches - before,))
    (cbox, cs, cl, c_launched), (gbox, gs, gl, g_launched) = outs
    assert c_launched == g_launched == 0
    assert len(cs) > 0 and gl == cl
    np.testing.assert_allclose(gs, cs, atol=DETECT_TOL, rtol=0)
    np.testing.assert_allclose(gbox, cbox, atol=DETECT_BOX_PX_TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 6.25e-2)])
@pytest.mark.parametrize("eps,apply_silu", GN_CASES)
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_group_norm_silu_kernel_matches_plain(cuda_device, dtype, tol, eps,
                                              apply_silu, layout):
    """Channels-last x takes the NHWC path (counted in ``launches_nhwc``)
    and gives a channels-last output."""
    g = torch.Generator(cuda_device).manual_seed(0)
    x = (torch.randn(2, 128, 96, 96, generator=g, device=cuda_device) * 3
         + 0.5).to(dtype)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn(128, generator=g, device=cuda_device).to(dtype)
    b = torch.randn(128, generator=g, device=cuda_device).to(dtype)
    before = tk.group_norm_silu.launches
    before_nhwc = tk.group_norm_silu.launches_nhwc
    got = tk.group_norm_silu(x, w, b, eps=eps, apply_silu=apply_silu)
    torch.cuda.synchronize()
    assert tk.group_norm_silu.launches == before + 1
    assert tk.group_norm_silu.launches_nhwc == before_nhwc + (layout == "nhwc")
    assert tk.is_channels_last(got) == (layout == "nhwc")
    want = tk.group_norm_silu_reference(x, w, b, eps=eps,
                                        apply_silu=apply_silu)
    assert (got.float() - want.float()).abs().max().item() <= tol


def _group_norm_inputs(device, dtype, shape, seed):
    """x with per-channel offsets and scales (so that the shares of a slab
    differ), scale ~1 +- 0.3 and bias ~0.3."""
    g = torch.Generator(device).manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g, device=device)
         * (0.5 + 2 * torch.rand(1, c, 1, 1, generator=g, device=device))
         + 2 * torch.randn(1, c, 1, 1, generator=g, device=device)).to(dtype)
    w = (1 + 0.3 * torch.randn(c, generator=g, device=device)).to(dtype)
    b = (0.3 * torch.randn(c, generator=g, device=device)).to(dtype)
    return x, w, b


def _group_norm_check(x, w, b, tol, **kw):
    before = tk.group_norm_silu.launches
    before_nhwc = tk.group_norm_silu.launches_nhwc
    got = tk.group_norm_silu(x, w, b, **kw)
    torch.cuda.synchronize()
    assert tk.group_norm_silu.launches == before + 1
    nhwc = tk.is_channels_last(x)
    assert tk.group_norm_silu.launches_nhwc == before_nhwc + nhwc
    assert tk.is_channels_last(got) == nhwc
    want = tk.group_norm_silu_reference(x, w, b, **kw)
    assert got.shape == x.shape and got.dtype == x.dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


GN_TOLS = {torch.float32: 1e-4, torch.bfloat16: 6.25e-2, torch.float16: 1e-2}
# (shape, dtype, plan path, k, layout): NCHW: one CTA per slab (the UNet's
# 8x8 level and 64x64x320 in fp16), clusters of 2, 4, 8 and 16 (UNet
# 64x64x960, the VAE's 64x64x512 at batch 1 and 128x128x512 at batch 2,
# the VAE encoder's 2 MB slabs), and the slabs held in part and streamed
# through L2 (the VAE decoder's 4 MB slabs in bf16; 4 MB of fp32, also
# with single-element vectors, H*W odd). NHWC: one CTA per slab in 8- and
# 4-byte packs (the UNet's 8x8 and 32x32x320 levels), clusters of 2 (the
# VAE's 64x64x512 at batch 1) and the grid of one CTA per SM (the UNet's
# 64x64x320 and the VAE decoder's 4 MB slabs, read in part twice; in fp16
# and fp32 too); k for the grid is the card's SMs over the batch
GN_PLAN_CASES = [
    ((4, 1280, 8, 8), torch.bfloat16, "single", 1, "nchw"),
    ((4, 320, 64, 64), torch.float16, "single", 1, "nchw"),
    ((4, 960, 64, 64), torch.bfloat16, "cluster", 2, "nchw"),
    ((1, 512, 64, 64), torch.bfloat16, "cluster", 4, "nchw"),
    ((2, 512, 128, 128), torch.bfloat16, "cluster", 8, "nchw"),
    ((1, 128, 512, 512), torch.bfloat16, "cluster", 16, "nchw"),
    ((1, 128, 512, 512), torch.float32, "stream", 16, "nchw"),
    ((2, 256, 512, 512), torch.bfloat16, "stream", 16, "nchw"),
    ((1, 32, 1023, 1025), torch.float32, "stream", 16, "nchw"),
    ((4, 1280, 8, 8), torch.bfloat16, "single", 1, "nhwc"),
    ((4, 320, 32, 32), torch.bfloat16, "single", 1, "nhwc"),
    ((4, 640, 32, 32), torch.float16, "single", 1, "nhwc"),
    ((1, 512, 64, 64), torch.bfloat16, "cluster", 2, "nhwc"),
    ((4, 320, 64, 64), torch.bfloat16, "grid", None, "nhwc"),
    ((4, 960, 64, 64), torch.float16, "grid", None, "nhwc"),
    ((2, 256, 512, 512), torch.bfloat16, "grid", None, "nhwc"),
    ((2, 512, 128, 128), torch.float32, "grid", None, "nhwc"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,path,k,layout", GN_PLAN_CASES)
def test_group_norm_silu_kernel_every_plan_path(cuda_device, shape, dtype,
                                                path, k, layout):
    nhwc = layout == "nhwc"
    sms = tk._sm_count(cuda_device.index or 0)
    plan = tk.group_norm_plan(*shape, 32, torch.finfo(dtype).bits // 8,
                              nhwc=nhwc, sms=sms)
    assert (plan.path, plan.k) == (path, k if k else sms // shape[0])
    x, w, b = _group_norm_inputs(cuda_device, dtype, shape, seed=1)
    if nhwc:
        x = x.contiguous(memory_format=torch.channels_last)
    _group_norm_check(x, w, b, GN_TOLS[dtype], eps=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("eps,apply_silu", GN_CASES)
@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_group_norm_silu_kernel_ragged_one_channel_groups(cuda_device, dtype,
                                                          batch, eps,
                                                          apply_silu, layout):
    """7x9 images (no 16-byte vectors in NCHW) with one channel per group
    (single elements in NHWC too)."""
    x, w, b = _group_norm_inputs(cuda_device, dtype, (batch, 32, 7, 9), seed=2)
    if layout == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    _group_norm_check(x, w, b, GN_TOLS[dtype], num_groups=32, eps=eps,
                      apply_silu=apply_silu)


# NHWC at every channels-per-group of the SD models (C / 32 = 4, 8, 16 in
# the VAE; 10, 20, 30, 40, 60, 80 in the UNet and ControlNets, where a
# 16-byte vector of bf16 straddles two groups), at a ragged 7x9 and at the
# UNet's 8x8 and 32x32 levels
GN_NHWC_WIDTH_CASES = [(c, hw) for c in (128, 256, 320, 512, 640, 960, 1280,
                                         1920, 2560)
                       for hw in ((7, 9), (8, 8), (32, 32))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("apply_silu", [True, False])
@pytest.mark.parametrize("c,hw", GN_NHWC_WIDTH_CASES)
def test_group_norm_silu_kernel_nhwc_every_group_width(cuda_device, dtype,
                                                       apply_silu, c, hw):
    x, w, b = _group_norm_inputs(cuda_device, dtype, (2, c) + hw, seed=3)
    x = x.contiguous(memory_format=torch.channels_last)
    _group_norm_check(x, w, b, GN_TOLS[dtype], eps=1e-6,
                      apply_silu=apply_silu)


@pytest.mark.cuda
def test_flash_attention_kernel_reads_head_strided_views(cuda_device):
    """The models hand the kernel (B, N, H*D) projections viewed as
    (B, H, N, D) without a copy; the output is a view of (B, N, H, D)."""
    g = torch.Generator(cuda_device).manual_seed(2)
    b, n, m, h, d = 2, 300, 77, 8, 40
    x = torch.randn(b, n, h * d, generator=g, device=cuda_device).bfloat16()
    ctx = torch.randn(b, m, 2 * h * d, generator=g, device=cuda_device).bfloat16()
    q = x.view(b, n, h, d).transpose(1, 2)
    k = ctx[..., :h * d].reshape(b, m, h, d).transpose(1, 2)
    v = ctx[..., h * d:].reshape(b, m, h, d).transpose(1, 2)
    assert not q.is_contiguous() and not k.is_contiguous()
    got = tfa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = tfa.flash_attention_reference(q.contiguous(), k.contiguous(),
                                         v.contiguous())
    assert got.transpose(1, 2).is_contiguous()
    err, bound = _attention_err_and_bound(got, want)
    assert err <= bound


def _sam_bound(got, want, rel):
    err = (got.float() - want.float()).abs().max().item()
    if want.dtype == torch.bfloat16:
        return err, rel * want.float().abs().max().item()
    return err, SAM_F32_TOL


# (prompts, image rows, tokens): the AMG's and the click's token counts and
# 12 tokens (each size of the image->token attention: 8, 32 and 16 token
# columns) over two bf16 row tiles of 64 rows; 7 prompts of 6 tokens, which
# leave the token kernel (5 prompts of 6 tokens a block) a last group of
# two, over 4 row tiles of 64 rows, and over 32 of 128 rows (enough blocks
# to fill the card, so the 8-warp row kernel runs); fp32 tiles are 32 rows
TWOWAY_CASES = [(3, 128, 6), (3, 128, 21), (2, 128, 12), (7, 256, 6),
                (7, 4096, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,m,n_tokens", TWOWAY_CASES)
def test_sam_twoway_kernel_matches_plain(cuda_device, dtype, b, m, n_tokens):
    g = torch.Generator(cuda_device).manual_seed(3)
    sam = random_sam(SMALL_SAM, device=cuda_device, dtype=dtype, generator=g)
    # q/k at twice the default range, as chip_smoke.py draws them
    with torch.no_grad():
        for mod in sam.mask_decoder.transformer.modules():
            if hasattr(mod, "q_proj"):
                mod.q_proj.weight.mul_(2.0)
                mod.k_proj.weight.mul_(2.0)
    packed = sam.mask_decoder.pack_twoway()
    src = torch.randn(1, m, 256, generator=g, device=cuda_device).to(dtype)
    pe = torch.randn(m, 256, generator=g, device=cuda_device)
    tokens = torch.randn(b, n_tokens, 256, generator=g, device=cuda_device)
    before = tk.sam_twoway.launches
    q, k = tk.sam_twoway(packed, src, pe, tokens)
    torch.cuda.synchronize()
    assert tk.sam_twoway.launches == before + 1
    want_q, want_k = tk.sam_twoway_reference(packed, src, pe, tokens)
    for got, want in ((q, want_q), (k, want_k)):
        assert got.shape == want.shape and got.dtype == dtype
        err, bound = _sam_bound(got, want, TWOWAY_BF16_REL)
        assert err <= bound
        if dtype == torch.bfloat16:
            rms = ((got.float() - want.float()).norm() / want.float().norm()).item()
            assert rms <= TWOWAY_BF16_RMS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e", [8, 16])
def test_sam_upscale_kernel_matches_plain(cuda_device, dtype, e):
    g = torch.Generator(cuda_device).manual_seed(4)
    sam = random_sam(SMALL_SAM, device=cuda_device, dtype=dtype, generator=g)
    up = sam.mask_decoder.output_upscaling
    b = 3
    src = torch.randn(b, e * e, 256, generator=g, device=cuda_device).to(dtype)
    hyper = torch.randn(b, 4, 32, generator=g, device=cuda_device).to(dtype)
    args = (up[0].weight, up[0].bias, up[1].weight, up[1].bias, up[3].weight,
            up[3].bias)
    before = tk.sam_upscale_hyper.launches
    got = tk.sam_upscale_hyper(src, hyper, *args)
    torch.cuda.synchronize()
    assert tk.sam_upscale_hyper.launches == before + 1
    want = tk.sam_upscale_hyper_reference(src, hyper, *args)
    assert got.shape == (b, 4, 4 * e, 4 * e) and got.dtype == dtype
    err, bound = _sam_bound(got, want, UPSCALE_BF16_REL)
    assert err <= bound


# (prompts, e): the AMG's 64x64 embedding at the click's batch of 1 and at
# 3 prompts (192 work items of 64 pixels, more than one per block of the
# persistent grid of an H100's 132 SMs), 37 prompts of 16x16 (148 items,
# not a multiple of the grid) and an odd e whose one tile is ragged (7x7:
# 8-byte stores)
UPSCALE_CASES = [(1, 64), (3, 64), (37, 16), (5, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,e", UPSCALE_CASES)
def test_sam_upscale_kernel_persistent_grid(cuda_device, dtype, b, e):
    g = torch.Generator(cuda_device).manual_seed(5)
    sam = random_sam(SMALL_SAM, device=cuda_device, dtype=dtype, generator=g)
    up = sam.mask_decoder.output_upscaling
    src = torch.randn(b, e * e, 256, generator=g, device=cuda_device).to(dtype)
    hyper = torch.randn(b, 4, 32, generator=g, device=cuda_device).to(dtype)
    args = (up[0].weight, up[0].bias, up[1].weight, up[1].bias, up[3].weight,
            up[3].bias)
    got = tk.sam_upscale_hyper(src, hyper, *args)
    torch.cuda.synchronize()
    want = tk.sam_upscale_hyper_reference(src, hyper, *args)
    assert got.shape == (b, 4, 4 * e, 4 * e) and got.dtype == dtype
    err, bound = _sam_bound(got, want, UPSCALE_BF16_REL)
    assert err <= bound


@pytest.mark.cuda
def test_sam_kernels_refuse_other_widths(cuda_device):
    src = torch.zeros(1, 64, 128, device=cuda_device)
    with pytest.raises(ValueError):
        tk.sam_upscale_hyper(src, torch.zeros(1, 4, 16, device=cuda_device),
                             torch.zeros(128, 32, 2, 2, device=cuda_device),
                             torch.zeros(32, device=cuda_device),
                             torch.zeros(32, device=cuda_device),
                             torch.zeros(32, device=cuda_device),
                             torch.zeros(32, 16, 2, 2, device=cuda_device),
                             torch.zeros(16, device=cuda_device))


@pytest.mark.cuda
def test_cuda_kernels_launch_on_every_device(cuda_device):
    """Each CUDA kernel that opts in to more than 48 KB of shared memory
    (flash attention, both SAM decoder kernels, the fused resnet block)
    launches and matches its twin on every visible device: the opt-in is
    kept per device, so a second card is opted in too."""
    count = torch.cuda.device_count()
    for i in range(count):
        dev = torch.device("cuda", i)
        q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
                   for a in _qkv(1, 2, 3, 128, 128, 40, 40))
        err, bound = _attention_err_and_bound(
            tfa.flash_attention(q, k, v), tfa.flash_attention_reference(q, k, v))
        assert err <= bound, f"flash attention on {dev}"
        g = torch.Generator(dev).manual_seed(3)
        sam = random_sam(SMALL_SAM, device=dev, dtype=torch.bfloat16, generator=g)
        src = torch.randn(1, 128, 256, generator=g, device=dev).bfloat16()
        pe = torch.randn(128, 256, generator=g, device=dev)
        tokens = torch.randn(2, 6, 256, generator=g, device=dev)
        packed = sam.mask_decoder.pack_twoway()
        for got, want in zip(tk.sam_twoway(packed, src, pe, tokens),
                             tk.sam_twoway_reference(packed, src, pe, tokens)):
            err, bound = _sam_bound(got, want, TWOWAY_BF16_REL)
            assert err <= bound, f"sam_twoway on {dev}"
        up = sam.mask_decoder.output_upscaling
        args = (up[0].weight, up[0].bias, up[1].weight, up[1].bias,
                up[3].weight, up[3].bias)
        keys = torch.randn(2, 64, 256, generator=g, device=dev).bfloat16()
        hyper = torch.randn(2, 4, 32, generator=g, device=dev).bfloat16()
        err, bound = _sam_bound(tk.sam_upscale_hyper(keys, hyper, *args),
                                tk.sam_upscale_hyper_reference(keys, hyper, *args),
                                UPSCALE_BF16_REL)
        assert err <= bound, f"sam_upscale_hyper on {dev}"
        x, rargs = _resnet_inputs(dev, torch.bfloat16, 64, 32, True, 16, 16,
                                  32, seed=6)
        got = tk.resnet_fused(x, *rargs)
        want = tk.resnet_fused_reference(x, *rargs)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= RESNET_BF16_REL * want.float().abs().max().item(), \
            f"resnet_fused on {dev}"
        torch.cuda.synchronize(dev)
    if count < 2:
        warnings.warn(f"{count} CUDA device visible: the kernels ran on device "
                      f"0 only; a second device went untested")


# the fused resnet block (kernel E): (cin, cout, time embedding, eps, H, W,
# groups), with a K that is no multiple of the 32-wide stage (16 x 9), tiles
# cut by the image edge (12 x 20, 9 x 9) and more channels than one tile
RESNET_CASES = [(64, 32, True, 1e-5, 16, 16, 32),
                (32, 32, False, 1e-6, 12, 20, 32),
                (16, 32, True, 1e-5, 9, 9, 8),
                (320, 640, True, 1e-5, 8, 8, 32)]
RESNET_BF16_REL = 2.0 ** -6      # chip_smoke.py RESNET_BF16_REL_BOUND
RESNET_BF16_RMS = 2e-3           # chip_smoke.py RESNET_BF16_RMS_BOUND


def _resnet_inputs(device, dtype, cin, cout, temb, h, w, groups, seed, n=2):
    """x with per-channel offsets and scales, a block's parameters drawn
    away from their init (norm scales ~1 +- 0.2, biases ~0.5) and trow."""
    g = torch.Generator(device).manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=g, device=device) * scale
                + shift).to(dtype)
    x = (torch.randn(n, cin, h, w, generator=g, device=device)
         * (1 + torch.rand(1, cin, 1, 1, generator=g, device=device))
         + torch.randn(1, cin, 1, 1, generator=g, device=device)).to(dtype)
    args = (rnd(cin, scale=0.2, shift=1.0), rnd(cin, scale=0.5),
            rnd(cout, cin, 3, 3, scale=(9 * cin) ** -0.5), rnd(cout, scale=0.5),
            rnd(n, cout) if temb else None,
            rnd(cout, scale=0.2, shift=1.0), rnd(cout, scale=0.5),
            rnd(cout, cout, 3, 3, scale=(9 * cout) ** -0.5), rnd(cout, scale=0.5),
            rnd(cout, cin, 1, 1, scale=cin ** -0.5) if cin != cout else None,
            rnd(cout, scale=0.5) if cin != cout else None)
    return x, args


def _resnet_check(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.bfloat16:
        assert err <= RESNET_BF16_REL * want.float().abs().max().item()
        rms = ((got.float() - want.float()).norm() / want.float().norm()).item()
        assert rms <= RESNET_BF16_RMS
    else:
        assert err <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,temb,eps,h,w,groups", RESNET_CASES)
def test_resnet_fused_kernel_matches_plain(cuda_device, dtype, cin, cout, temb,
                                           eps, h, w, groups):
    x, args = _resnet_inputs(cuda_device, dtype, cin, cout, temb, h, w,
                             groups, seed=6)
    before = tk.resnet_fused.launches
    got = tk.resnet_fused(x, *args, num_groups=groups, eps=eps)
    torch.cuda.synchronize()
    assert tk.resnet_fused.launches == before + 1
    want = tk.resnet_fused_reference(x, *args, num_groups=groups, eps=eps)
    assert got.shape == want.shape == (2, cout, h, w) and got.dtype == dtype
    _resnet_check(got, want, dtype)


# kernel E's plans (core/kernels.py::resnet_plan): (what, n, cin, cout,
# time embedding, eps, h, w, groups, plan check)
RESNET_PLAN_CASES = [
    ("cout no multiple of the tile", 2, 64, 96, True, 1e-5, 10, 10, 32,
     lambda p: p.ntiles * p.bn > 96),
    ("groups straddle a channel tile", 2, 64, 192, True, 1e-5, 12, 12, 32,
     lambda p: p.bn % (192 // 32) != 0),
    ("batch folded into M at 8x8", 4, 128, 128, True, 1e-5, 8, 8, 32,
     lambda p: p.mtiles == 2 and p.slots == 2),
    ("split over K", 4, 256, 128, True, 1e-5, 8, 8, 32,
     lambda p: p.split1 > 1 and p.split2 > 1),
    ("VAE-like, no temb, eps 1e-6", 2, 128, 128, False, 1e-6, 32, 32, 32,
     lambda p: p.segs == 32),
    ("ragged Cin and Cout", 2, 24, 40, True, 1e-5, 9, 7, 8,
     lambda p: p.cp_in == 24 and p.cp_out == 40),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("what,n,cin,cout,temb,eps,h,w,groups,plan_check",
                         RESNET_PLAN_CASES, ids=[c[0] for c in RESNET_PLAN_CASES])
def test_resnet_fused_kernel_plans(cuda_device, dtype, what, n, cin, cout, temb,
                                   eps, h, w, groups, plan_check):
    plan = tk.resnet_plan(n, cin, cout, h, w, groups, cin != cout,
                          tk._sm_count(torch.device(cuda_device).index or 0))
    assert plan_check(plan), f"{what}: {plan}"
    x, args = _resnet_inputs(cuda_device, dtype, cin, cout, temb, h, w,
                             groups, seed=7, n=n)
    got = tk.resnet_fused(x, *args, num_groups=groups, eps=eps)
    want = tk.resnet_fused_reference(x, *args, num_groups=groups, eps=eps)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (n, cout, h, w)
    _resnet_check(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resnet_fused_follows_an_in_place_weight_change(cuda_device, dtype):
    """The packed weights are cached per weight tensor: a second call after
    an in-place change of each conv weight must see it."""
    x, args = _resnet_inputs(cuda_device, dtype, 64, 32, True, 16, 16, 32,
                             seed=8)
    first = tk.resnet_fused(x, *args)
    for i in (2, 7, 9):           # w1, w2, the shortcut
        args[i].mul_(-1.5)
    second = tk.resnet_fused(x, *args)
    want = tk.resnet_fused_reference(x, *args)
    torch.cuda.synchronize()
    _resnet_check(second, want, dtype)
    assert (second.float() - first.float()).abs().max().item() > 0.1


@pytest.mark.cuda
def test_resnet_block_launches_the_kernel_under_the_switch(cuda_device,
                                                           monkeypatch):
    from editanything_tpu_torch.models.blocks import ResnetBlock2D
    blk = ResnetBlock2D(64, 32, 48, num_groups=32).to(cuda_device)
    x = torch.randn(2, 64, 16, 16, device=cuda_device)
    t = torch.randn(2, 48, device=cuda_device)
    with torch.no_grad():
        monkeypatch.setenv("EA_RESNET_FUSED", "0")
        before = tk.resnet_fused.launches
        composed = blk(x, t)
        assert tk.resnet_fused.launches == before
        monkeypatch.setenv("EA_RESNET_FUSED", "1")
        fused = blk(x, t)
        torch.cuda.synchronize()
    assert tk.resnet_fused.launches == before + 1
    assert (fused - composed).abs().max().item() <= 1e-4


# --- training: the kernels' autograd Functions --------------------------------
# The backward of B, A and E recomputes through the plain twin (the JAX
# package's custom_vjp backwards), so on the same inputs the gradients are
# the twin's own autograd ones: fp32 and bf16 both within 1e-5 of the
# largest gradient (the same ops, cuDNN's conv backward made deterministic;
# only the forward differs, and it does not enter the backward).
GRAD_REL = 1e-5


def _grad_pair(fn, twin, inputs, seed=0):
    """(kernel output, its gradients) and the twin's, for one random
    cotangent."""
    outs = []
    for f in (fn, twin):
        leaves = [t.detach().clone().requires_grad_(t.is_floating_point())
                  for t in inputs]
        out = f(*leaves)
        assert out.grad_fn is not None
        g = torch.randn(out.shape, device=out.device,
                        generator=torch.Generator(out.device).manual_seed(seed)
                        ).to(out.dtype)
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=False):
            outs.append((out.detach(), torch.autograd.grad(out, leaves, g)))
    return outs


def _assert_grads(got, want):
    for a, b in zip(got, want):
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= GRAD_REL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,dqk,dv", [(256, 256, 40, 40), (256, 77, 80, 80),
                                        (64, 77, 160, 160), (64, 64, 512, 512),
                                        (96, 64, 208, 80)])
def test_flash_attention_gradients_match_plain(cuda_device, dtype, n, m, dqk,
                                               dv):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(11, 2, 2, n, m, dqk, dv))
    before = tfa.flash_attention.launches
    (out, got), (ref, want) = _grad_pair(tfa.flash_attention,
                                         tfa.flash_attention_reference,
                                         (q, k, v))
    assert tfa.flash_attention.launches == before + 1
    err, bound = _attention_err_and_bound(out, ref)
    assert err <= bound
    _assert_grads(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,eps,silu", [((2, 64, 16, 16), 1e-5, True),
                                            ((2, 128, 8, 8), 1e-6, False),
                                            ((1, 320, 32, 32), 1e-5, True)])
def test_group_norm_silu_gradients_match_plain(cuda_device, dtype, shape, eps,
                                               silu):
    x, w, b = _group_norm_inputs(cuda_device, dtype, shape, seed=12)
    w, b = w.float(), b.float()
    before = tk.group_norm_silu.launches

    def fn(x, w, b):
        return tk.group_norm_silu(x, w, b, eps=eps, apply_silu=silu)

    def twin(x, w, b):
        return tk.group_norm_silu_reference(x, w, b, eps=eps, apply_silu=silu)
    (out, got), (ref, want) = _grad_pair(fn, twin, (x, w, b))
    assert tk.group_norm_silu.launches == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= (
        6.25e-2 if dtype == torch.bfloat16 else 1e-4)
    _assert_grads(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,temb,eps,h,w,groups", RESNET_CASES[:3])
def test_resnet_fused_gradients_match_plain(cuda_device, dtype, cin, cout,
                                            temb, eps, h, w, groups):
    x, args = _resnet_inputs(cuda_device, dtype, cin, cout, temb, h, w,
                             groups, seed=13)
    present = [i for i, a in enumerate(args) if a is not None]

    def spread(rest):
        full = [None] * len(args)
        for i, t in zip(present, rest):
            full[i] = t
        return full

    def fn(x, *rest):
        return tk.resnet_fused(x, *spread(rest), num_groups=groups, eps=eps)

    def twin(x, *rest):
        return tk.resnet_fused_reference(x, *spread(rest), num_groups=groups,
                                         eps=eps)
    before = tk.resnet_fused.launches
    (out, got), (ref, want) = _grad_pair(
        fn, twin, [x] + [args[i] for i in present])
    assert tk.resnet_fused.launches == before + 1
    _resnet_check(out, ref, dtype)
    _assert_grads(got, want)


@pytest.mark.cuda
def test_kernels_relaunch_under_checkpointing(cuda_device):
    """torch.utils.checkpoint recomputes the forward in the backward: each
    Function launches its kernel again, and counts it."""
    q, k, v = (torch.from_numpy(a).to(cuda_device).requires_grad_(True)
               for a in _qkv(3, 1, 2, 64, 64, 40, 40))
    x, w, b = _group_norm_inputs(cuda_device, torch.float32, (2, 64, 8, 8),
                                 seed=3)
    x.requires_grad_(True)

    def block(q, k, v, x):
        return (tfa.flash_attention(q, k, v).sum()
                + tk.group_norm_silu(x, w, b).sum())
    counts = (tfa.flash_attention.launches, tk.group_norm_silu.launches)
    torch.utils.checkpoint.checkpoint(block, q, k, v, x,
                                      use_reentrant=False).backward()
    torch.cuda.synchronize()
    assert (tfa.flash_attention.launches - counts[0],
            tk.group_norm_silu.launches - counts[1]) == (2, 2)
    assert q.grad is not None and x.grad is not None
    with torch.no_grad():         # no autograd: the kernel alone, no Function
        assert tfa.flash_attention(q, k, v).grad_fn is None


@pytest.mark.cuda
def test_resnet_fused_repacks_after_an_optimizer_step(cuda_device):
    x, args = _resnet_inputs(cuda_device, torch.float32, 64, 32, True, 16, 16,
                             32, seed=14)
    params = [a.requires_grad_(True) for a in args if a is not None]
    opt = torch.optim.SGD(params, lr=0.5)
    first = tk.resnet_fused(x, *args)
    first.square().mean().backward()
    opt.step()
    second = tk.resnet_fused(x, *args)
    with torch.no_grad():
        want = tk.resnet_fused_reference(x, *args)
    torch.cuda.synchronize()
    _resnet_check(second.detach(), want, torch.float32)
    assert (second - first).abs().max().item() > 1e-3


@pytest.mark.cuda
def test_tiny_controlnet_step_on_cuda_matches_cpu(cuda_device):
    """One training step of the tiny ControlNet in fp32 on the card (kernels
    B and A forward, their twins backward) against the CPU (twins only):
    loss within 1e-5 relative, every gradient within 1e-4 of its tensor's
    largest, and none of them zero (the zero convs are drawn)."""
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.samplers.schedule import make_schedule
    from editanything_tpu_torch.train import controlnet_train as T
    grads, losses = [], []
    g = torch.Generator().manual_seed(0)
    batch = {"latents": torch.randn(2, 4, 8, 8, generator=g),
             "hint": torch.rand(2, 3, 64, 64, generator=g),
             "context": torch.randn(2, 8, 32, generator=g)}
    t, noise = torch.tensor([17, 640]), torch.randn(2, 4, 8, 8, generator=g)
    for device in ("cpu", cuda_device):
        tb = random_bundle(tiny=True, device="cpu", controlnet_names=("sam",),
                           generator=torch.Generator().manual_seed(3))
        tb.to(device)
        tb.unet.requires_grad_(False)
        cn = tb.controlnets["sam"][1]
        state = T.init_train_state(cn, lambda p: torch.optim.SGD(p, lr=1.0))
        counts = (tfa.flash_attention.launches, tk.group_norm_silu.launches)
        _, m = T.make_train_step(make_schedule(), remat=True)(
            state, tb.unet, {k: v.to(device) for k, v in batch.items()},
            t=t, noise=noise)
        if device != "cpu":
            assert tfa.flash_attention.launches > counts[0]
            assert tk.group_norm_silu.launches > counts[1]
        losses.append(float(m["loss"]))
        grads.append({k: p.grad.cpu() for k, p in
                      state.controlnet.named_parameters()})
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for name, want in grads[0].items():
        got = grads[1][name]
        scale = want.abs().max().item()
        assert got.abs().max().item() > 0, name
        assert (got - want).abs().max().item() <= 1e-4 * scale, name


@pytest.mark.cuda
def test_tiny_ti_step_on_a_bf16_bundle_on_cuda(cuda_device):
    """One textual-inversion step on a bf16 bundle on the card (the dtype
    ``load_bundle`` gives; kernels B and A forward, the twins backward)
    against the CPU's fp32 step on the same weights: the loss within 5e-3
    relative, only the placeholder rows moved, the table still bf16."""
    import functools
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.samplers.schedule import make_schedule
    from editanything_tpu_torch.train import textual_inversion as TTI
    g = torch.Generator().manual_seed(0)
    lat = torch.randn(2, 4, 8, 8, generator=g)
    noise = torch.randn(2, 4, 8, 8, generator=g)
    losses = []
    for device, dtype in (("cpu", torch.float32), (cuda_device, torch.bfloat16)):
        tb = random_bundle(tiny=True, device="cpu", controlnet_names=(),
                           generator=torch.Generator().manual_seed(3))
        tb.to("cpu", torch.bfloat16).to(device, dtype)
        pids = TTI.add_placeholder_tokens(tb.text, tb.tokenizer, num_vectors=2,
                                          initializer_token="cat")
        tb.text.requires_grad_(False)
        tb.unet.requires_grad_(False)
        state = TTI.init_ti_state(tb.text,
                                  functools.partial(torch.optim.Adam, lr=1e-3))
        before = state.embeddings.detach().clone()
        ids = np.asarray([TTI.placeholder_prompt_ids(
            tb.tokenizer, "a photo of a {}", pids, 8)] * 2)
        counts = (tfa.flash_attention.launches, tk.group_norm_silu.launches)
        _, m = TTI.make_ti_train_step(make_schedule(), pids)(
            state, tb.text, tb.unet,
            {"latents": lat.to(device), "input_ids": ids},
            t=torch.tensor([10, 700]), noise=noise)
        if device != "cpu":
            assert tfa.flash_attention.launches > counts[0]
            assert tk.group_norm_silu.launches > counts[1]
        assert state.embeddings.dtype == dtype
        moved = (state.embeddings.detach() != before).any(dim=1)
        assert moved.nonzero().flatten().tolist() == pids
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "dots", "offload"])
def test_tiny_controlnet_step_remat_modes_on_cuda(cuda_device, remat):
    """JAX's remat options on the card (checkpointing that reruns the
    kernels; "offload" keeps the linear layers' outputs in pinned host
    memory): the same
    gradients as without, within 1e-5 of each tensor's largest."""
    from editanything_tpu_torch.pipelines.bundle import random_bundle
    from editanything_tpu_torch.samplers.schedule import make_schedule
    from editanything_tpu_torch.train import controlnet_train as T
    tb = random_bundle(tiny=True, device=cuda_device, controlnet_names=("sam",),
                       generator=torch.Generator(cuda_device).manual_seed(3))
    tb.unet.requires_grad_(False)
    cn = tb.controlnets["sam"][1]
    g = torch.Generator(cuda_device).manual_seed(1)
    batch = {"latents": torch.randn(2, 4, 8, 8, generator=g, device=cuda_device),
             "hint": torch.rand(2, 3, 64, 64, generator=g, device=cuda_device),
             "context": torch.randn(2, 8, 32, generator=g, device=cuda_device)}
    t = torch.tensor([3, 900], device=cuda_device)
    noise = torch.randn(2, 4, 8, 8, generator=g, device=cuda_device)
    grads = []
    for mode in (False, remat):
        state = T.init_train_state(cn, lambda p: torch.optim.SGD(p, lr=1.0))
        with torch.backends.cudnn.flags(enabled=True, deterministic=True,
                                        allow_tf32=False):
            T.make_train_step(make_schedule(), remat=mode)(
                state, tb.unet, batch, t=t, noise=noise)
        grads.append([p.grad for p in state.controlnet.parameters()])
    for a, b in zip(*grads):
        assert (a - b).abs().max().item() <= 1e-5 * a.abs().max().item()
