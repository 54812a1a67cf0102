"""The fused resnet block (kernel E) of the port against the JAX package.

(a) the port's plain twin ``resnet_fused_reference`` against the JAX
    package's fused resnet Pallas kernel (``kernels._resnet_diff``, interpret
    mode), as tests/test_core_layers.py runs it: atol = rtol = 2e-4, that
    test's own bound (fp32 convs summed in other orders);
(b) the port's ``ResnetBlock2D`` under ``EA_RESNET_FUSED=1`` against the
    JAX ``resnet_block``, weights through ``state_dict_from_tree``: 1e-4;
(c) the tiny edit of tests/test_torch_edit.py with the switch on against
    the JAX ``EditPipeline``, and (d) the golden test's ``gen`` case
    (tests/test_golden_regression.py) through the port's txt2img against the
    JAX ``GenerationPipeline``, with the switch off and on, the JAX initial
    latents handed in through ``noise=``: final latents 1e-3 absolute and
    images 2 uint8 levels, the bounds of tests/test_torch_edit.py;
(e) the switch is read per call, a CPU tensor takes the twin, shapes the
    block cannot have raise, and the bundle constructors build on the GPU
    unless asked otherwise;
(f) what kernel E's plan mirrors: its tiles cover every output once with
    no channel tile more than half empty, the tap-major weight pack feeds
    an implicit GEMM to F.conv2d's result (float64, 1e-10: sums in other
    orders) and is repacked after an in-place change, and the twin's tiled
    route for GN2's statistics (per-tile partials merged by Chan's formula,
    as the kernel takes them) matches the direct statistics (1e-5) and the
    JAX Pallas kernel (2e-4) where groups straddle a channel tile and tiles
    straddle images.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from editanything_tpu.core import kernels as JK
from editanything_tpu.engine import DenoiseConfig as JaxDenoiseConfig
from editanything_tpu.models import blocks as JB
from editanything_tpu.pipelines import EditPipeline as JaxEditPipeline
from editanything_tpu.pipelines import GenerationPipeline as JaxGenerationPipeline
from editanything_tpu_torch.checkpoints.convert import state_dict_from_tree
from editanything_tpu_torch.core import kernels as K
from editanything_tpu_torch.models import blocks as TB
from editanything_tpu_torch.models.sam import SAMConfig
from editanything_tpu_torch.pipelines import bundle as TBUNDLE
from editanything_tpu_torch.pipelines.edit import EditPipeline
from editanything_tpu_torch.pipelines.generate import GenerationPipeline

from test_torch_edit import (IMAGE_LEVELS, LATENT_TOL, _checker_image,
                             _edit_args, bundles)
from test_torch_models import BLOCK_TOL, close, nchw, perturb

PALLAS_TOL = 2e-4
TILED_TOL = 1e-5
# (cin, cout, temb width or None, eps)
CASES = [(64, 32, 48, 1e-5), (32, 32, None, 1e-5), (32, 32, None, 1e-6)]
GEN_ARGS = dict(prompt="a house", condition_image=_checker_image(64, 64),
                num_samples=1, image_resolution=64, num_steps=4,
                guidance_scale=7.5, seed=3)


def _block_params(cin, cout, temb, seed=7):
    return perturb(JB.init_resnet_block(jax.random.PRNGKey(seed), cin, cout,
                                        temb), seed)


def _twin_args(params):
    """The twin's parameter arguments from a JAX resnet tree (torch layouts
    through the checkpoint converter)."""
    sd = state_dict_from_tree(params)
    sc = "conv_shortcut.weight" in sd
    return (sd["norm1.weight"], sd["norm1.bias"], sd["conv1.weight"],
            sd["conv1.bias"]), (sd["norm2.weight"], sd["norm2.bias"],
                                sd["conv2.weight"], sd["conv2.bias"],
                                sd["conv_shortcut.weight"] if sc else None,
                                sd["conv_shortcut.bias"] if sc else None)


@pytest.mark.parametrize("cin,cout,temb,eps", CASES)
def test_resnet_twin_matches_pallas_kernel(cin, cout, temb, eps):
    params = _block_params(cin, cout, temb)
    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, 16, 16, cin), dtype=np.float32)
    trow = rng.standard_normal((2, cout), dtype=np.float32) if temb else None
    want = JK._resnet_diff(params, jnp.asarray(x),
                           jnp.zeros((2, cout), jnp.float32) if trow is None
                           else jnp.asarray(trow), 32, eps)
    head, tail = _twin_args(params)
    got = K.resnet_fused_reference(
        nchw(x), *head, None if trow is None else torch.from_numpy(trow),
        *tail, num_groups=32, eps=eps)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=PALLAS_TOL,
                               rtol=PALLAS_TOL)


@pytest.mark.parametrize("cin,cout,temb,eps", CASES)
def test_resnet_block_fused_matches_jax(monkeypatch, cin, cout, temb, eps):
    monkeypatch.setenv("EA_RESNET_FUSED", "1")
    params = _block_params(cin, cout, temb, seed=4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, cin), np.float32)
    t = rng.standard_normal((2, temb), np.float32) if temb else None
    want = JB.resnet_block(params, jnp.asarray(x),
                           None if t is None else jnp.asarray(t),
                           num_groups=8, eps=eps)
    blk = TB.ResnetBlock2D(cin, cout, temb, num_groups=8, eps=eps)
    blk.load_state_dict(state_dict_from_tree(params), strict=True)
    with torch.no_grad():
        got = blk(nchw(x), None if t is None else torch.from_numpy(t))
    close(got, want, BLOCK_TOL)


def _assert_matches(got_lat, want_lat, got_img, want_img, pipe):
    assert np.abs(want_lat).max() > 0.1
    np.testing.assert_allclose(got_lat, want_lat, atol=LATENT_TOL, rtol=0)
    assert got_img.dtype == np.uint8 and got_img.shape == want_img.shape
    diff = np.abs(got_img.astype(np.int32) - want_img.astype(np.int32))
    assert diff.max() <= IMAGE_LEVELS
    assert pipe.last_nonfinite == 0


def test_edit_with_fused_resnets_matches_jax(monkeypatch, bundles):
    jb, tb = bundles
    args = _edit_args()
    jpipe = JaxEditPipeline(jb, controls=("sam", "inpaint"),
                            inpaint_mode="blend")
    want_lat = np.asarray(jpipe(**args, return_latents=True), np.float32)
    want_img = jpipe(**args)
    noise = np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(7))[0], want_lat.shape,
        jnp.float32))
    monkeypatch.setenv("EA_RESNET_FUSED", "1")
    pipe = EditPipeline(tb, controls=("sam", "inpaint"), inpaint_mode="blend")
    _assert_matches(pipe(**args, return_latents=True, noise=noise), want_lat,
                    pipe(**args, noise=noise), want_img, pipe)


@pytest.fixture(scope="module")
def jax_generation(bundles):
    """The JAX txt2img's images, its final latents (the same program
    without the VAE decode) and its initial latents."""
    jb, _ = bundles
    jpipe = JaxGenerationPipeline(jb, controlnet="sam")
    want_img = jpipe(**GEN_ARGS)
    n, res, steps = GEN_ARGS["num_samples"], GEN_ARGS["image_resolution"], \
        GEN_ARGS["num_steps"]
    dcfg = JaxDenoiseConfig(
        unet=jb.unet_cfg, controlnets=jb.controlnet_cfgs(("sam",)),
        num_steps=steps, sampler="unipc",
        prediction_type=jb.noise_schedule().prediction_type)
    program = jpipe.cache.get(jb, dcfg, steps, with_scale_maps=False,
                              decode=False)
    noise = jax.random.normal(jax.random.PRNGKey(GEN_ARGS["seed"]),
                              (n, res // 8, res // 8, 4), jnp.float32)
    inputs = {"controlnet_conds": [jpipe.prepare_condition(
                  GEN_ARGS["condition_image"], res, res, n)],
              "controlnet_scales": [1.0],
              "guidance_scale": GEN_ARGS["guidance_scale"]}
    params = {"unet": jb.unet, "controlnets": jb.controlnet_params(("sam",)),
              "vae": jb.vae}
    want_lat = program(params, noise.astype(jb.dtype),
                       jpipe.embed_prompts(GEN_ARGS["prompt"], "", n), inputs)
    return (np.asarray(want_lat, np.float32), want_img, np.asarray(noise))


@pytest.mark.parametrize("fused", ["0", "1"])
def test_txt2img_matches_jax(monkeypatch, bundles, jax_generation, fused):
    _, tb = bundles
    want_lat, want_img, noise = jax_generation
    monkeypatch.setenv("EA_RESNET_FUSED", fused)
    pipe = GenerationPipeline(tb, controlnet="sam")
    got_lat = pipe(**GEN_ARGS, noise=noise, return_latents=True)
    got_img = pipe(**GEN_ARGS, noise=noise)
    assert got_lat.shape == want_lat.shape == (1, 8, 8, 4)
    assert got_img.shape == (1, 64, 64, 3) and pipe.last_nsfw is None
    _assert_matches(got_lat, want_lat, got_img, want_img, pipe)


def test_txt2img_refuses_unported_options(bundles):
    """Every sampler and encoder caching are ported: what txt2img refuses is
    a sampler the package does not have and caching under guess mode (as
    the JAX package asserts)."""
    pipe = GenerationPipeline(bundles[1], controlnet="sam")
    with pytest.raises(ValueError, match="unknown sampler"):
        pipe(**GEN_ARGS, sampler="euler")
    with pytest.raises(ValueError, match="encoder caching"):
        pipe(**GEN_ARGS, encoder_interval=2, guess_mode=True)


def test_switch_is_read_per_call_and_cpu_takes_the_twin(monkeypatch):
    params = _block_params(32, 16, 24)
    blk = TB.ResnetBlock2D(32, 16, 24, num_groups=8)
    blk.load_state_dict(state_dict_from_tree(params), strict=True)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 32, 6, 6), np.float32))
    t = torch.from_numpy(rng.standard_normal((1, 24), np.float32))
    calls = []
    fused = K.resnet_fused

    def spy(*args, **kwargs):
        calls.append(args[0].device.type)
        return fused(*args, **kwargs)
    monkeypatch.setattr(K, "resnet_fused", spy)
    launches = fused.launches
    with torch.no_grad():
        monkeypatch.delenv("EA_RESNET_FUSED", raising=False)
        composed = blk(x, t)
        monkeypatch.setenv("EA_RESNET_FUSED", "1")
        on = blk(x, t)
        monkeypatch.setenv("EA_RESNET_FUSED", "0")
        off = blk(x, t)
        trow = blk.time_emb_proj(torch.nn.functional.silu(t))
        twin = K.resnet_fused_reference(
            x, blk.norm1.weight, blk.norm1.bias, blk.conv1.weight,
            blk.conv1.bias, trow, blk.norm2.weight, blk.norm2.bias,
            blk.conv2.weight, blk.conv2.bias, blk.conv_shortcut.weight,
            blk.conv_shortcut.bias, num_groups=8)
    assert calls == ["cpu"]
    assert fused.launches == launches      # the twin launches nothing
    torch.testing.assert_close(on, twin, atol=0, rtol=0)
    torch.testing.assert_close(off, composed, atol=0, rtol=0)
    torch.testing.assert_close(on, composed, atol=1e-5, rtol=0)


@pytest.mark.parametrize("what", ["groups", "kernel", "identity", "trow"])
def test_resnet_fused_refuses_other_shapes(what):
    g = torch.Generator().manual_seed(0)
    cin, cout = (24 if what == "groups" else 32), 16
    x = torch.randn(1, cin, 4, 4, generator=g)
    k = 1 if what == "kernel" else 3
    w1 = torch.randn(cout, cin, k, k, generator=g)
    w2 = torch.randn(cout, cout, 3, 3, generator=g)
    wsc = None if what == "identity" else torch.randn(cout, cin, 1, 1,
                                                      generator=g)
    trow = torch.randn(2 if what == "trow" else 1, cout, generator=g)
    ones, zeros = torch.ones(cout), torch.zeros(cout)
    with pytest.raises(ValueError):
        K.resnet_fused(x, torch.ones(cin), torch.zeros(cin), w1, zeros, trow,
                       ones, zeros, w2, zeros, wsc,
                       None if wsc is None else zeros, num_groups=16)


@pytest.mark.parametrize("which", ["bundle", "sam"])
def test_constructors_build_on_the_gpu_by_default(which):
    """With no device named, the port builds on the GPU, and raises where
    there is none: it never falls back to the CPU."""
    tiny_sam = SAMConfig(img_size=64, patch_size=8, embed_dim=32, depth=2,
                         num_heads=2, global_attn_indexes=(1,), window_size=4,
                         out_chans=16, prompt_embed_dim=16, decoder_mlp_dim=32)
    build = ((lambda: TBUNDLE.random_bundle(tiny=True).unet.conv_in.weight)
             if which == "bundle" else
             (lambda: TBUNDLE.random_sam(tiny_sam).mask_decoder.iou_token.weight))
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()


# (n, cin, cout, h, w, groups, shortcut): the main path's UNet and VAE
# blocks, and shapes whose tiles straddle images (12x12, 8x8 at batch 4),
# whose channel tiles are ragged (96) or split groups (192 in 64s)
PLAN_CASES = [(4, 320, 320, 64, 64, 32, False), (4, 640, 320, 64, 64, 32, True),
              (4, 2560, 1280, 8, 8, 32, True), (2, 256, 128, 512, 512, 32, True),
              (4, 1280, 640, 16, 16, 32, True), (3, 64, 96, 12, 12, 32, True),
              (2, 64, 192, 12, 12, 32, True), (2, 16, 32, 9, 9, 8, True)]


@pytest.mark.parametrize("n,cin,cout,h,w,groups,shortcut", PLAN_CASES)
def test_resnet_plan_tiles_cover_every_output_once(n, cin, cout, h, w, groups,
                                                   shortcut):
    plan = K.resnet_plan(n, cin, cout, h, w, groups, shortcut)
    m, bm, bn, hw = n * h * w, K.RESNET_BM, plan.bn, h * w
    cover = torch.zeros(m, cout, dtype=torch.int32)
    slots, segs = set(), set()
    for mt in range(plan.mtiles):
        for nt in range(plan.ntiles):
            rows = slice(mt * bm, min((mt + 1) * bm, m))
            cols = slice(nt * bn, min((nt + 1) * bn, cout))
            cover[rows, cols] += 1
            # GN2's partial slots: images and groups this tile touches
            for img in range(rows.start // hw, (rows.stop - 1) // hw + 1):
                slots.add(img - rows.start // hw)
            cpg = cout // groups
            for gi in range(cols.start // cpg, (cols.stop - 1) // cpg + 1):
                segs.add(gi - cols.start // cpg)
    assert bool((cover == 1).all())
    assert max(slots) + 1 == plan.slots and max(segs) + 1 == plan.segs
    assert cout - (plan.ntiles - 1) * bn >= bn // 2     # last tile half full
    assert plan.cp_in % 8 == 0 and plan.cp_in - cin < 8
    assert plan.cp_out % 8 == 0 and plan.cp_out - cout < 8
    for steps, split in ((plan.steps1, plan.split1), (plan.steps2, plan.split2)):
        per = -(-steps // split)
        assert (split - 1) * per < steps          # no split without work
        if split > 1:                             # only where tiles are few
            assert plan.mtiles * plan.ntiles < 132
            assert per >= K.RESNET_MIN_SPLIT_STEPS
    sizes = K.resnet_scratch(n, cin, cout, h, w, groups, shortcut, plan)
    assert sizes["xs"] == (m * plan.cp_in if shortcut else 0)
    assert sizes["acc"] == (m * cout if plan.split2 > 1 else 0)


@pytest.mark.parametrize("cin", [12, 64])
def test_packed_weight_feeds_an_implicit_gemm(cin):
    """The pack's K order, tap-major over zero-padded channels, as kernel E
    reads it: A rows are each pixel's channel run at the tap's shifted
    pixel (0 outside the image)."""
    g = torch.Generator().manual_seed(cin)
    x = torch.randn(2, cin, 7, 9, generator=g, dtype=torch.float64)
    w = torch.randn(24, cin, 3, 3, generator=g, dtype=torch.float64)
    cp = -(-cin // 8) * 8
    wp = K.pack_conv_weight(w, cp)
    assert wp.shape == (24, 3, 3, cp) and wp.is_contiguous()
    xp = F.pad(F.pad(x.permute(0, 2, 3, 1), (0, cp - cin)), (0, 0, 1, 1, 1, 1))
    a = torch.cat([xp[:, dy:dy + 7, dx:dx + 9, :]
                   for dy in range(3) for dx in range(3)], dim=-1)
    got = a.reshape(-1, 9 * cp) @ wp.reshape(24, -1).t()
    want = F.conv2d(x, w, padding=1).permute(0, 2, 3, 1).reshape(-1, 24)
    torch.testing.assert_close(got, want, atol=1e-10, rtol=0)


def test_packed_weights_follow_an_in_place_change():
    w = torch.randn(8, 16, 3, 3)
    first = K.packed_conv_weight(w, 16)
    assert K.packed_conv_weight(w, 16) is first        # cached, not repacked
    with torch.no_grad():
        w.mul_(2)
    again = K.packed_conv_weight(w, 16)
    assert again is not first
    torch.testing.assert_close(again, K.pack_conv_weight(w, 16), atol=0, rtol=0)


def test_packed_weights_of_inference_tensors():
    """A weight made under torch.inference_mode has no version counter; it
    is packed and cached all the same."""
    with torch.inference_mode():
        w = torch.randn(8, 16, 3, 3)
        first = K.packed_conv_weight(w, 24)
        assert K.packed_conv_weight(w, 24) is first
    torch.testing.assert_close(first, K.pack_conv_weight(w, 24), atol=0,
                               rtol=0)


def test_resnet_twin_tiled_gn2_matches_direct_and_pallas():
    """GN2's statistics by the kernel's route: 192 channels in tiles of 64
    (groups of 6 straddle them) and 2 x 12 x 12 pixels in tiles of 128
    (straddling the images)."""
    cin, cout, temb, eps = 64, 192, 48, 1e-5
    plan = K.resnet_plan(2, cin, cout, 12, 12, 32, True)
    assert plan.bn == 64 and plan.segs > 64 // 6 and plan.slots == 2
    params = _block_params(cin, cout, temb, seed=9)
    rng = np.random.default_rng(33)
    x = rng.standard_normal((2, 12, 12, cin), dtype=np.float32)
    trow = rng.standard_normal((2, cout), dtype=np.float32)
    want = JK._resnet_diff(params, jnp.asarray(x), jnp.asarray(trow), 32, eps)
    head, tail = _twin_args(params)
    args = (nchw(x), *head, torch.from_numpy(trow), *tail)
    tiled = K.resnet_fused_reference(*args, num_groups=32, eps=eps,
                                     gn2_tiles=(K.RESNET_BM, plan.bn))
    direct = K.resnet_fused_reference(*args, num_groups=32, eps=eps)
    torch.testing.assert_close(tiled, direct, atol=TILED_TOL, rtol=TILED_TOL)
    np.testing.assert_allclose(tiled.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=PALLAS_TOL,
                               rtol=PALLAS_TOL)
    # the fault leaves tile (0, 0)'s partials out: GN2's affine moves
    affine = K.resnet_gn2_affine_reference(*args[:8], num_groups=32, eps=eps)
    dropped = K.resnet_gn2_affine_reference(*args[:8], num_groups=32, eps=eps,
                                            fault="gn2_tile_dropped")
    assert (dropped - affine).abs().max().item() > 1e-3
