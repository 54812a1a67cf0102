"""The port's kernels against their plain PyTorch twins, on the GPU.

Marked ``cuda``: they skip without an NVIDIA GPU (the CUDA and Triton
kernels have no CPU mode). This file imports neither jax nor the JAX
package, so it runs on a GPU host that has only PyTorch:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: tests/conftest.py configures jax.) ``chip_smoke.py``
makes the same comparison at the main path's shapes.

Tolerances: fp32 1e-4 absolute (exact fp32 products, sums in other
orders); bf16 attention 2^-6 of the twin's largest output, i.e. two bf16
ulps of it (both sides keep fp32 sums and round the output once; P is
rounded to bf16 unnormalised in the kernel and normalised in the twin);
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
def test_group_norm_silu_kernel_matches_plain(cuda_device, dtype, tol, eps,
                                              apply_silu):
    g = torch.Generator(cuda_device).manual_seed(0)
    x = (torch.randn(2, 128, 96, 96, generator=g, device=cuda_device) * 3
         + 0.5).to(dtype)
    w = torch.randn(128, generator=g, device=cuda_device).to(dtype)
    b = torch.randn(128, generator=g, device=cuda_device).to(dtype)
    before = tk.group_norm_silu.launches
    got = tk.group_norm_silu(x, w, b, eps=eps, apply_silu=apply_silu)
    torch.cuda.synchronize()
    assert tk.group_norm_silu.launches == before + 1
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
    got = tk.group_norm_silu(x, w, b, **kw)
    torch.cuda.synchronize()
    assert tk.group_norm_silu.launches == before + 1
    want = tk.group_norm_silu_reference(x, w, b, **kw)
    assert got.shape == x.shape and got.dtype == x.dtype
    assert (got.float() - want.float()).abs().max().item() <= tol


GN_TOLS = {torch.float32: 1e-4, torch.bfloat16: 6.25e-2, torch.float16: 1e-2}
# (shape, dtype, plan path, k): one CTA per slab (the UNet's 8x8 level and
# 64x64x320 in fp16), clusters of 2, 4, 8 and 16 (UNet 64x64x960, the
# VAE's 64x64x512 at batch 1 and 128x128x512 at batch 2, the VAE encoder's
# 2 MB slabs), and the slabs held in part and streamed through L2 (the VAE
# decoder's 4 MB slabs in bf16; 4 MB of fp32, also with single-element
# vectors, H*W odd)
GN_PLAN_CASES = [
    ((4, 1280, 8, 8), torch.bfloat16, "single", 1),
    ((4, 320, 64, 64), torch.float16, "single", 1),
    ((4, 960, 64, 64), torch.bfloat16, "cluster", 2),
    ((1, 512, 64, 64), torch.bfloat16, "cluster", 4),
    ((2, 512, 128, 128), torch.bfloat16, "cluster", 8),
    ((1, 128, 512, 512), torch.bfloat16, "cluster", 16),
    ((1, 128, 512, 512), torch.float32, "stream", 16),
    ((2, 256, 512, 512), torch.bfloat16, "stream", 16),
    ((1, 32, 1023, 1025), torch.float32, "stream", 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,path,k", GN_PLAN_CASES)
def test_group_norm_silu_kernel_every_plan_path(cuda_device, shape, dtype,
                                                path, k):
    plan = tk.group_norm_plan(*shape, 32, torch.finfo(dtype).bits // 8)
    assert (plan.path, plan.k) == (path, k)
    x, w, b = _group_norm_inputs(cuda_device, dtype, shape, seed=1)
    _group_norm_check(x, w, b, GN_TOLS[dtype], eps=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("eps,apply_silu", GN_CASES)
def test_group_norm_silu_kernel_ragged_one_channel_groups(cuda_device, dtype,
                                                          batch, eps,
                                                          apply_silu):
    """7x9 images (no 16-byte vectors) with one channel per group."""
    x, w, b = _group_norm_inputs(cuda_device, dtype, (batch, 32, 7, 9), seed=2)
    _group_norm_check(x, w, b, GN_TOLS[dtype], num_groups=32, eps=eps,
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
