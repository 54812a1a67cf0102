"""The port's reference-only control (engine/refctrl.py), its PLMS and
DPM-Solver loops and its encoder caching against the JAX package.

Unit level: the FFT magnitude mix, the masked statistics and AdaIN (with
and without CFG, style fidelity 0 and 0.5), the mask resize at odd ratios,
the gating weights, and the read attention over the compacted bank (only
the reference tokens inside the mask) against the JAX package's masked
attention over the whole bank, at a ragged mask and an empty one. End to
end, through ``EditPipeline``: the golden ``refctrl`` case's inputs
(tests/test_golden_regression.py::_run_refctrl), attention-only and
AdaIN-only variants, PLMS, DPM-Solver++ multistep order 3 and singlestep
order 2 edits, UniPC and DDIM with encoder_interval 2, txt2img with
encoder_interval 3, and one reference-mode request through
``EditAnythingEditor.process``.

The bundle is tests/test_torch_edit_modes.py's tiny SD1.5 bundle (the
port's ``random_bundle`` carried to the JAX package's trees), the draws are
the JAX pipeline's own, handed to the port, and the JAX side runs through
its plain references (its Pallas kernels switched off for this module, as
there). Tolerances: unit functions 1e-5 (fp32 sums and FFTs in other
orders); final latents 1e-3 absolute and images 2 uint8 levels, those of
tests/test_torch_edit.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.engine import refctrl as JR
from editanything_tpu.models import blocks as JB
from editanything_tpu.models import config as JC
from editanything_tpu.pipelines import EditPipeline as JaxEditPipeline
from editanything_tpu.pipelines import GenerationPipeline as JaxGeneration
from editanything_tpu.pipelines.editor import EditAnythingEditor as JaxEditor
from editanything_tpu_torch.engine import refctrl as TR
from editanything_tpu_torch.models import blocks as TB
from editanything_tpu_torch.models import config as TC
from editanything_tpu_torch.pipelines.bundle import random_bundle
from editanything_tpu_torch.pipelines.edit import EditPipeline
from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
from editanything_tpu_torch.pipelines.generate import GenerationPipeline

from test_torch_edit_modes import (_assert_close, _checker_image, _decode,
                                   _jax_config, _mask, _tree, jax_draws,
                                   jax_twin)

TOL = 1e-5
LATENT_TOL = 1e-3
IMAGE_LEVELS = 2
SEED = 5


@pytest.fixture(scope="module", autouse=True)
def jax_plain_references():
    saved = JFA._DISABLED, JK._DISABLED
    JFA._DISABLED = JK._DISABLED = True
    yield
    JFA._DISABLED, JK._DISABLED = saved


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny edits on one thread: beside the other test workers
    on a shared CPU, a thread pool per process oversubscribes the cores and
    these milliseconds-long ops slow down a hundredfold."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def sd15():
    tb = random_bundle(tiny=True, device="cpu", family="sd15",
                       generator=torch.Generator().manual_seed(3))
    return tb, jax_twin(tb)


def _nchw(x):
    return torch.from_numpy(np.array(x).transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _ragged_mask(h, w, seed=0):
    """A {0, 1} mask (1, h, w, 1) of a blob whose area is no multiple of a
    tile, as an irregular reference region is."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    blob = ((yy - 0.4 * h) ** 2 / (0.3 * h) ** 2
            + (xx - 0.55 * w) ** 2 / (0.35 * w) ** 2) <= 1.0
    return blob.astype(np.float32)[None, :, :, None]


# --- the math ------------------------------------------------------------

@pytest.mark.parametrize("ratio", [0.0, 0.4, 1.0])
def test_add_freq_feature_matches_jax(ratio):
    rng = np.random.default_rng(1)
    ref, tgt = (rng.standard_normal((2, 6, 10, 5), np.float32)
                for _ in range(2))
    want = JR.add_freq_feature(jnp.asarray(ref), jnp.asarray(tgt), ratio)
    got = TR.add_freq_feature(_nchw(ref), _nchw(tgt), ratio)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL, rtol=0)
    # the token-grid layout of the attention hook: spatial axes (1, 2)
    got = TR.add_freq_feature(torch.from_numpy(ref), torch.from_numpy(tgt),
                              ratio, dims=(1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_masked_mean_var_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 7, 9, 6), np.float32) * 3 + 1
    m = _ragged_mask(7, 9)
    want = JR.masked_mean_var(jnp.asarray(x), jnp.asarray(m))
    got = TR.masked_mean_var(_nchw(x), _nchw(m))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=TOL, rtol=0)
    # an empty mask counts 1, as there
    want = JR.masked_mean_var(jnp.asarray(x), jnp.zeros_like(jnp.asarray(m)))
    got = TR.masked_mean_var(_nchw(x), torch.zeros(1, 1, 7, 9))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("do_cfg", [True, False])
@pytest.mark.parametrize("style_fidelity", [0.0, 0.5])
def test_mix_norm_feature_matches_jax(do_cfg, style_fidelity):
    """The inpaint mask at another size than the feature (resized inside),
    the reference statistics of the write pass's batch (tiled under CFG)."""
    rng = np.random.default_rng(3)
    b = 4 if do_cfg else 2
    x = rng.standard_normal((b, 4, 4, 6), np.float32) * 2 + 0.5
    mask = _ragged_mask(8, 8, 1)
    ref_x = rng.standard_normal((2, 4, 4, 6), np.float32) * 0.7 - 1
    rmean, rvar = JR.masked_mean_var(jnp.asarray(ref_x), jnp.ones((1, 4, 4, 1)))
    cfg = dict(style_fidelity=style_fidelity, do_cfg=do_cfg)
    want = JR.mix_norm_feature(jnp.asarray(x), jnp.asarray(mask), rmean, rvar,
                               JR.RefConfig(**cfg))
    got = TR.mix_norm_feature(_nchw(x), _nchw(mask),
                              _nchw(np.asarray(rmean)), _nchw(np.asarray(rvar)),
                              TR.RefConfig(**cfg))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("src,dst", [((13, 17), (8, 8)), ((8, 8), (5, 7)),
                                     ((10, 10), (4, 3)), ((5, 7), (13, 21)),
                                     ((80, 80), (8, 8))])
def test_resize_mask_matches_jax(src, dst):
    m = (np.random.default_rng(4).uniform(0, 1, (1,) + src + (1,))
         > 0.5).astype(np.float32)
    want = JR._resize_mask(jnp.asarray(m), *dst)
    got = TR._resize_mask(_nchw(m), *dst)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("family", ["sd15", "tiny"])
def test_gating_weights_match_jax(family):
    if family == "sd15":
        tcfg, jcfg = TC.sd15_unet(), JC.sd15_unet()
    else:
        tcfg = random_bundle(tiny=True, device="cpu").unet_cfg
        jcfg = _jax_config(tcfg)
    assert TR.unet_attn_weights(tcfg) == JR.unet_attn_weights(jcfg)
    assert (TR.controlnet_attn_weights(TC.ControlNetConfig(unet=tcfg))
            == JR.controlnet_attn_weights(JC.ControlNetConfig(unet=jcfg)))
    n = len(tcfg.block_out_channels)
    for bi in range(n):
        assert TR.gn_weight_down(bi, n) == JR.gn_weight_down(bi, n)
        assert TR.gn_weight_up(bi, n) == JR.gn_weight_up(bi, n)


# --- the read attention --------------------------------------------------

@pytest.mark.parametrize("mask", ["ragged", "empty", "full"])
def test_read_attention_matches_jax_masked(mask):
    """Write the bank, then read it: the port attends over the compacted
    bank unmasked, the JAX package over the whole bank with the tokens
    outside the mask masked out."""
    h, w, c, heads = 8, 6, 32, 2
    torch.manual_seed(5)
    attn = TB.Attention(c, None, heads=heads)
    params = _tree(attn)
    m = {"ragged": _ragged_mask(h, w), "empty": np.zeros((1, h, w, 1), np.float32),
         "full": np.ones((1, h, w, 1), np.float32)}[mask]
    rng = np.random.default_rng(6)
    written = rng.standard_normal((2, h * w, c), np.float32)
    read = rng.standard_normal((4, h * w, c), np.float32)
    cfg = dict(style_fidelity=0.5, ref_scale=0.4, do_cfg=True)

    jw = JR.RefState(JR.RefConfig(**cfg), "write", ref_mask=jnp.asarray(m),
                     inpaint_mask=jnp.ones((2, h, w, 1)))
    jw.write_attn(jnp.asarray(written), (h, w))
    want = jw.reader().read_attn(params, jnp.asarray(read), (h, w), heads,
                                 JB.attention_layer)

    masks = TR.RefMasks(_nchw(m), torch.ones(2, 1, h, w))
    tw = TR.RefState(TR.RefConfig(**cfg), "write", masks)
    with torch.no_grad():
        tw.write_attn(torch.from_numpy(written), (h, w))
        n_valid = tw.banks["attn_bank"][0].shape[1]
        got = tw.reader().read_attn(attn, torch.from_numpy(read), (h, w))
    assert n_valid == int(m.sum())
    if mask == "ragged":
        assert 0 < n_valid < h * w and n_valid % 8
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


# --- end to end ----------------------------------------------------------

def _golden_refctrl_args(**overrides):
    """tests/test_golden_regression.py::_run_refctrl's inputs."""
    mask = np.zeros((96, 96), np.uint8)
    mask[24:72, 24:72] = 255
    ref_mask = np.zeros((80, 80), np.uint8)
    ref_mask[10:70, 10:70] = 255
    args = dict(image=_checker_image(96, 96), mask=mask, prompt="a red cat",
                condition_image=_checker_image(64, 64), num_samples=1,
                image_resolution=64, num_steps=3, guidance_scale=7.0,
                alignment_ratio=0.7, seed=11,
                ref_image=_checker_image(80, 80)[:, ::-1], ref_mask=ref_mask,
                ref_prompt="a blue cat", reference_attn=True,
                reference_adain=True, style_fidelity=0.5, ref_scale=0.4)
    args.update(overrides)
    return args


def _ragged_ref_mask():
    m = np.zeros((64, 64), np.uint8)
    m[5:38, 9:50] = 255
    m[20:38, 30:50] = 0
    return m


REF_CASES = {
    "golden": {},
    # two samples (the JAX AdaIN broadcasts one mask per sample, so only the
    # attention hook runs at two), a ragged mask, the write pass's own scales
    "attn_only": dict(num_samples=2, reference_adain=False,
                      image=_checker_image(64, 64), mask=_mask(),
                      ref_image=_checker_image(64, 64)[::-1],
                      ref_mask=_ragged_ref_mask(), style_fidelity=0.3,
                      ref_scale=0.0, ref_sam_scale=0.3, ref_inpaint_scale=0.8),
    "adain_only": dict(reference_attn=False, style_fidelity=0.0,
                       gn_auto_weight=0.5, ref_prompt=None),
}


def _edit_pair(tb, jb, args, steps):
    """(port latents, JAX latents, port images, JAX images, port pipeline)
    of one blend edit with the JAX pipeline's draws."""
    want_lat = np.asarray(JaxEditPipeline(jb)(**args, return_latents=True),
                          np.float32)
    draws = jax_draws(want_lat.shape, steps, args["seed"])
    pipe = EditPipeline(tb)
    got_lat = pipe(**args, **draws, return_latents=True)
    got_img = pipe(**args, **draws)
    return got_lat, want_lat, got_img, _decode(jb, want_lat), pipe


@pytest.mark.parametrize("case", list(REF_CASES))
def test_reference_edit_matches_jax(sd15, case):
    tb, jb = sd15
    args = _golden_refctrl_args(**REF_CASES[case])
    _assert_close(*_edit_pair(tb, jb, args, args["num_steps"]))


def _edit_args(steps, **kw):
    return dict(image=_checker_image(64, 64), mask=_mask(), prompt="a red cat",
                condition_image=_checker_image(64, 64)[::-1],
                negative_prompt="blurry", num_samples=2, image_resolution=64,
                num_steps=steps, guidance_scale=7.5, control_scale=0.7,
                alignment_ratio=0.7, seed=SEED, **kw)


# 5 steps: PLMS reaches its 4th order, DPM++ order 3 its 3rd at step 2,
# singlestep order 2 runs blocks [2, 2, 1]; 4 steps cache 2 and reuse 2
SAMPLER_CASES = {
    "plms": (5, dict(sampler="plms")),
    "dpm3": (5, dict(sampler="dpm3")),
    "dpms2": (5, dict(sampler="dpms2")),
    "unipc_encoder_interval_2": (4, dict(encoder_interval=2)),
    "ddim_encoder_interval_2": (4, dict(sampler="ddim", encoder_interval=2)),
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sampler_edit_matches_jax(sd15, case):
    tb, jb = sd15
    steps, kw = SAMPLER_CASES[case]
    _assert_close(*_edit_pair(tb, jb, _edit_args(steps, **kw), steps))


def test_txt2img_encoder_interval_matches_jax(sd15):
    tb, jb = sd15
    args = dict(prompt="a house", condition_image=_checker_image(64, 64),
                num_samples=2, image_resolution=64, num_steps=5,
                guidance_scale=7.5, seed=SEED, encoder_interval=3)
    want = JaxGeneration(jb, controlnet="sam")(**args)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED),
                                         (2, 8, 8, 4), jnp.float32))
    pipe = GenerationPipeline(tb, controlnet="sam")
    got = pipe(**args, noise=noise)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert diff.max() <= IMAGE_LEVELS and pipe.last_nonfinite == 0
    # caching has changed the images
    full = pipe(**dict(args, encoder_interval=1), noise=noise)
    assert np.abs(full.astype(np.int32) - got.astype(np.int32)).max() > 3


def test_editor_reference_request_matches_jax(sd15):
    tb, jb = sd15
    args = dict(image=_checker_image(64, 64), mask=_mask(), prompt="a red cat",
                a_prompt="best", condition_image=_checker_image(64, 64)[::-1],
                num_samples=2, image_resolution=64, ddim_steps=3, scale=7.5,
                seed=SEED, alignment_ratio=0.7,
                ref_image=_checker_image(64, 64)[:, ::-1],
                ref_mask=_ragged_ref_mask(), ref_prompt="a blue cat",
                style_fidelity=0.5, ref_scale=0.4, ref_sam_scale=0.6)
    _, want, _, _ = JaxEditor(jb).process(**args)
    editor = EditAnythingEditor(tb)
    _, got, _, _ = editor.process(**args, **jax_draws((2, 8, 8, 4), 3, SEED))
    diff = np.abs(np.stack(got).astype(np.int32)
                  - np.stack(want).astype(np.int32))
    assert diff.max() <= IMAGE_LEVELS and editor.last_nonfinite == 0


def test_adain_runs_each_sample_as_alone(sd15):
    """The AdaIN hook at two samples, where the JAX package's broadcast of
    the per-sample inpaint mask over the CFG batch fails: two samples with
    the same initial noise each give the one-sample edit's latents, within
    the latent bound of the JAX comparisons (the batch size changes the
    order of the convs' and products' fp32 sums; ~7e-5 here)."""
    tb, _ = sd15
    pipe = EditPipeline(tb)
    args = _golden_refctrl_args(image=_checker_image(64, 64), mask=_mask())
    noise = np.random.default_rng(9).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    one = pipe(**args, noise=noise, return_latents=True)
    two = pipe(**dict(args, num_samples=2), noise=np.concatenate([noise] * 2),
               return_latents=True)
    np.testing.assert_allclose(two, np.concatenate([one] * 2),
                               atol=LATENT_TOL, rtol=0)


def test_reference_refusals(sd15):
    """Reference control rejects guess mode (as the JAX package asserts),
    the 9-channel UNet (its write pass feeds 4 channels) and a reference
    image without its mask."""
    from editanything_tpu_torch.engine.denoise import (DenoiseConfig,
                                                       build_denoiser)
    from editanything_tpu_torch.samplers.schedule import make_schedule
    tb, _ = sd15
    ref = TR.RefConfig()
    for kw, match in ((dict(guess_mode=True), "guess_mode"),
                      (dict(inpaint_mode="unet9"), "4-channel UNet")):
        with pytest.raises(ValueError, match=match):
            build_denoiser(DenoiseConfig(unet=tb.unet_cfg, num_steps=2,
                                         ref=ref, **kw),
                           make_schedule(), [999, 499])
    with pytest.raises(ValueError, match="ref_mask"):
        EditPipeline(tb)(**_golden_refctrl_args(ref_mask=None))
