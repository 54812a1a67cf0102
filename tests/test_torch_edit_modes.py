"""The port's edit surface beyond the main path against the JAX package:
the ControlNet's per-pixel scale maps and guess mode, the edit in the
inpaint modes "mix" and "unet9", DDIM with eta, the scale map and guess
mode, SD2.1 (v-prediction, the OpenCLIP-style gelu tower and linear
transformer projections) edit and txt2img, and the editor's eta, scale
map and alpha-mixing arguments.

Two module-scoped tiny bundles: SD1.5 at the widths of the JAX package's
``random_bundle(tiny=True)``, and SD2.1 shaped like tests/test_sd21.py's
``tiny_sd21_bundle`` (linear projections, 2/4 heads of width 16, context
48, a 2-layer gelu text tower, a v-prediction schedule on the bundle).
Both are drawn by the port's ``random_bundle`` (every conv drawn, the
ControlNet zero convs included) and carried to the JAX package's trees by
its ``state_dict_to_tree``; the 9-channel case swaps in a 9-channel UNet.
JAX and torch draw different numbers, so every draw is the JAX pipeline's
own (its initial latents, the "mix" noises folded from PRNGKey(seed + 1),
the eta noises from PRNGKey(seed + 2)), computed here and handed to the
port. The JAX side decodes its final latents with the VAE of its program.
It runs through its plain references, with its Pallas kernels switched
off for this module (as tests/test_core_layers.py does for one test): each
JAX program compiles in ~6 s instead of ~10, and the Pallas forms of the
kernels this slice runs are held to the port in tests/test_torch_edit.py.

Tolerances, those of tests/test_torch_edit.py: final latents 1e-3
absolute, images 2 uint8 levels; the ControlNet's residuals 2e-4, the
deep-stack bound of tests/test_torch_models.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.checkpoints.convert import state_dict_to_tree
from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.models import config as JC
from editanything_tpu.models import controlnet as JCN
from editanything_tpu.models import vae as JV
from editanything_tpu.pipelines import EditPipeline as JaxEditPipeline
from editanything_tpu.pipelines import GenerationPipeline as JaxGeneration
from editanything_tpu.pipelines.bundle import ModelBundle as JaxBundle
from editanything_tpu.pipelines.editor import EditAnythingEditor as JaxEditor
from editanything_tpu.pipelines.generate import to_uint8
from editanything_tpu.samplers import make_schedule as jax_make_schedule
from editanything_tpu.text.tokenizer import tiny_tokenizer as jax_tokenizer
from editanything_tpu_torch.models import controlnet as TCN
from editanything_tpu_torch.pipelines.bundle import random_bundle
from editanything_tpu_torch.pipelines.edit import EditPipeline
from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
from editanything_tpu_torch.pipelines.generate import GenerationPipeline

import test_torch_models as TM

LATENT_TOL = 1e-3
IMAGE_LEVELS = 2
DEEP_TOL = 2e-4
STEPS = 3
SEED = 5


def _jax_config(cfg):
    """A port config as the JAX package's config of the same name."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if "unet" in kw:
        kw["unet"] = _jax_config(kw["unet"])
    return getattr(JC, type(cfg).__name__)(**kw)


def _tree(module, **kw):
    return state_dict_to_tree(
        {k: v.numpy() for k, v in module.state_dict().items()}, **kw)


def jax_twin(tb):
    """The port's bundle as a JAX ModelBundle with the same weights."""
    schedule = (None if tb.schedule is None else jax_make_schedule(
        prediction_type=tb.schedule.prediction_type))
    return JaxBundle(
        unet_cfg=_jax_config(tb.unet_cfg), vae_cfg=_jax_config(tb.vae_cfg),
        text_cfg=_jax_config(tb.text_cfg), unet=_tree(tb.unet),
        vae=_tree(tb.vae),
        text=_tree(tb.text, embedding_modules=("token_embedding",
                                               "position_embedding")),
        tokenizer=jax_tokenizer(
            context_length=tb.text_cfg.max_position_embeddings),
        controlnets={n: (_jax_config(c), _tree(m))
                     for n, (c, m) in tb.controlnets.items()},
        dtype=jnp.float32, schedule=schedule)


@pytest.fixture(scope="module", autouse=True)
def jax_plain_references():
    saved = JFA._DISABLED, JK._DISABLED
    JFA._DISABLED = JK._DISABLED = True
    yield
    JFA._DISABLED, JK._DISABLED = saved


def _bundles(family):
    tb = random_bundle(tiny=True, device="cpu", family=family,
                       generator=torch.Generator().manual_seed(3))
    return tb, jax_twin(tb)


@pytest.fixture(scope="module")
def sd15():
    tb, jb = _bundles("sd15")
    # the same bundle with a 9-channel inpainting UNet
    unet9 = random_bundle(tiny=True, device="cpu", family="sd15_inpaint",
                          generator=torch.Generator().manual_seed(4))
    tb9 = dataclasses.replace(tb, unet_cfg=unet9.unet_cfg, unet=unet9.unet)
    jb9 = dataclasses.replace(jb, unet_cfg=_jax_config(unet9.unet_cfg),
                              unet=_tree(unet9.unet))
    return {"blend": (tb, jb), "unet9": (tb9, jb9)}


@pytest.fixture(scope="module")
def sd21():
    return _bundles("sd21")


def _checker_image(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // max(w - 1, 1)),
                    (yy * 255 // max(h - 1, 1)),
                    ((xx // 8 + yy // 8) % 2) * 200], axis=-1)
    return img.astype(np.uint8)


def _mask():
    m = np.zeros((64, 64), np.uint8)
    m[16:48, 24:56] = 255
    return m


def _scale_map(h=64, w=64):
    """A smooth map with a zero region, resized to the edit's size and then
    to each residual's."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / (h - 1), xx / (w - 1)
    return np.where(xx > 0.75, 0.0, 0.3 + 0.7 * yy).astype(np.float32)


def jax_draws(shape, steps, seed):
    """The JAX edit pipeline's draws in the port's layouts: the initial
    latents and the "mix" start noise ((B, h, w, 4), edit.py:176-183), and
    the per-step "mix" and eta noises ((steps, B, 4, h, w),
    denoise.py:360-364 and :443-450; _shard_fold is the identity here)."""
    k_noise, k_mix = jax.random.split(jax.random.PRNGKey(seed))
    mix_key = jax.random.wrap_key_data(jax.random.PRNGKey(seed + 1))
    eta_key = jax.random.PRNGKey(seed + 2)

    def per_step(fold):
        return np.stack([np.asarray(jax.random.normal(
            fold(i), shape, jnp.float32)).transpose(0, 3, 1, 2)
            for i in range(steps)])
    return dict(
        noise=np.asarray(jax.random.normal(k_noise, shape, jnp.float32)),
        mix_noise=np.asarray(jax.random.normal(k_mix, shape, jnp.float32)),
        step_noise=per_step(lambda i: jax.random.fold_in(mix_key, i)),
        eta_noise=per_step(lambda i: jax.random.fold_in(eta_key, i)))


def _decode(jb, latents):
    return to_uint8(np.asarray(JV.decode_from_latents(
        jb.vae, jb.vae_cfg, jnp.asarray(latents))))


def _assert_close(got_lat, want_lat, got_img, want_img, pipe):
    assert got_lat.shape == want_lat.shape
    assert np.abs(want_lat).max() > 0.1
    np.testing.assert_allclose(got_lat, want_lat, atol=LATENT_TOL, rtol=0)
    diff = np.abs(got_img.astype(np.int32) - want_img.astype(np.int32))
    assert got_img.dtype == np.uint8 and diff.max() <= IMAGE_LEVELS, diff.max()
    assert pipe.last_nonfinite == 0


def _edit_case(tb, jb, mode, **kw):
    """One edit through both packages: (port latents, JAX latents, port
    images, JAX images, port pipeline)."""
    args = dict(image=_checker_image(64, 64), mask=_mask(),
                prompt="a red cat", condition_image=_checker_image(64, 64)[::-1],
                negative_prompt="blurry", num_samples=2, image_resolution=64,
                num_steps=STEPS, guidance_scale=7.5, control_scale=0.7,
                seed=SEED, **kw)
    want_lat = np.asarray(JaxEditPipeline(jb, inpaint_mode=mode)(
        **args, return_latents=True), np.float32)
    draws = jax_draws(want_lat.shape, STEPS, SEED)
    pipe = EditPipeline(tb, inpaint_mode=mode)
    got_lat = pipe(**args, **draws, return_latents=True)
    got_img = pipe(**args, **draws)
    return got_lat, want_lat, got_img, _decode(jb, want_lat), pipe


# --- the ControlNet alone ------------------------------------------------------

@pytest.mark.parametrize("scale_map,guess_mode", [(True, False),
                                                  (False, True), (True, True)])
def test_controlnet_scale_map_and_guess_mode_match_jax(sd15, scale_map,
                                                       guess_mode):
    tb, jb = sd15["blend"]
    rng = np.random.default_rng(0)
    sample = rng.standard_normal((2, 8, 8, 4), np.float32)
    t = np.array([999, 400], np.int32)
    ctx = rng.standard_normal((2, 8, 32), np.float32)
    cond = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    smap = np.stack([_scale_map(), _scale_map()[::-1]]) if scale_map else None
    names = ("sam", "inpaint")
    jdown, jmid = JCN.multi_controlnet_apply(
        [jb.controlnets[n][1] for n in names],
        [jb.controlnets[n][0] for n in names], jnp.asarray(sample),
        jnp.asarray(t), jnp.asarray(ctx), [jnp.asarray(cond)] * 2, [0.6, 1.0],
        [None if smap is None else jnp.asarray(smap), None],
        guess_mode=guess_mode)
    down, mid = TCN.multi_controlnet_apply(
        tb.controlnet_modules(names), TM.nchw(sample), torch.from_numpy(t),
        torch.from_numpy(ctx), [TM.nchw(cond)] * 2, [0.6, 1.0],
        [None if smap is None else torch.from_numpy(smap), None],
        guess_mode=guess_mode)
    assert len(down) == len(jdown)
    for got, want in zip(down + (mid,), tuple(jdown) + (jmid,)):
        TM.close(got, want, DEEP_TOL)
    assert float(np.abs(np.asarray(jmid)).max()) > 1e-2


@pytest.mark.parametrize("size", [(4, 6), (13, 21), (26, 40), (64, 64)])
def test_resize_corners_matches_jax(size):
    """Down, same size, up: within 1e-5 on values in [0, 1] (fp32
    interpolation weights formed in other orders, a few ulps)."""
    x = np.random.default_rng(1).uniform(0, 1, (2, 13, 21)).astype(np.float32)
    want = JCN._resize_corners(jnp.asarray(x), *size)
    got = TCN._resize_corners(torch.from_numpy(x), *size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# --- the edit --------------------------------------------------------------------

# each JAX program compiles for ~10 s on the CPU, so the modes share cases
EDIT_CASES = {
    "mix": ("mix", dict(alignment_ratio=0.7, alpha_weight=0.4)),
    "unet9_ddim_eta": ("unet9", dict(sampler="ddim", eta=0.5)),
    "scale_map_guess_mode": ("blend", dict(scale_map=_scale_map(),
                                           guess_mode=True,
                                           alignment_ratio=0.7)),
    # a map of another size than the edit's: resized as jax.image.resize
    "scale_map_resized": ("blend", dict(scale_map=_scale_map(48, 80),
                                        alignment_ratio=0.7)),
}


@pytest.mark.parametrize("case", list(EDIT_CASES))
def test_edit_mode_matches_jax(sd15, case):
    mode, kw = EDIT_CASES[case]
    tb, jb = sd15["unet9" if mode == "unet9" else "blend"]
    _assert_close(*_edit_case(tb, jb, mode, **kw))


@pytest.mark.parametrize("case", ["unipc_blend", "ddim_eta_mix"])
def test_sd21_edit_matches_jax(sd21, case):
    tb, jb = sd21
    assert tb.noise_schedule().prediction_type == "v_prediction"
    if case == "unipc_blend":
        out = _edit_case(tb, jb, "blend", alignment_ratio=0.7)
    else:
        out = _edit_case(tb, jb, "mix", sampler="ddim", eta=0.5,
                         alpha_weight=0.5)
    _assert_close(*out)


def test_sd21_txt2img_matches_jax(sd21):
    tb, jb = sd21
    args = dict(prompt="a house", condition_image=_checker_image(64, 64),
                num_samples=2, image_resolution=64, num_steps=STEPS,
                guidance_scale=7.5, scale_map=_scale_map(80, 48),
                guess_mode=True,
                seed=SEED)
    jpipe = JaxGeneration(jb, controlnet="sam")
    want_img = jpipe(**args)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED),
                                         (2, 8, 8, 4), jnp.float32))
    pipe = GenerationPipeline(tb, controlnet="sam")
    got_img = pipe(**args, noise=noise)
    diff = np.abs(got_img.astype(np.int32) - want_img.astype(np.int32))
    assert got_img.shape == want_img.shape == (2, 64, 64, 3)
    assert diff.max() <= IMAGE_LEVELS and pipe.last_nonfinite == 0
    # the v-prediction loop has run: the images are not the eps bundle's
    eps = dataclasses.replace(tb, schedule=None)
    assert np.abs(GenerationPipeline(eps)(**args, noise=noise).astype(int)
                  - got_img.astype(int)).max() > 3


# --- the editor's newly accepted arguments ---------------------------------------

def test_editor_eta_scale_map_and_alpha_mixing_match_jax(sd15):
    tb, jb = sd15["blend"]
    args = dict(image=_checker_image(64, 64), mask=_mask(), prompt="a red cat",
                condition_image=_checker_image(64, 64)[::-1], num_samples=2,
                image_resolution=64, ddim_steps=STEPS, scale=7.5, seed=SEED,
                sampler="ddim", eta=0.4, use_scale_map=True,
                use_alpha_mixing=True, alpha_weight=0.3, alignment_ratio=0.7)
    _, want, _, _ = JaxEditor(jb).process(**args)
    draws = jax_draws((2, 8, 8, 4), STEPS, SEED)
    editor = EditAnythingEditor(tb)
    _, got, _, _ = editor.process(**args, **draws)
    diff = np.abs(np.stack(got).astype(np.int32)
                  - np.stack(want).astype(np.int32))
    assert diff.max() <= IMAGE_LEVELS and editor.last_nonfinite == 0
    # an explicit map equal to the derived one gives the same edit, and
    # the map counts only with use_scale_map
    derived = 1.0 - (_mask() >= 128).astype(np.float32)
    _, same, _, _ = editor.process(**args, **draws, scale_map=derived)
    np.testing.assert_array_equal(np.stack(same), np.stack(got))
    _, off, _, _ = editor.process(**dict(args, use_scale_map=False), **draws,
                                  scale_map=derived)
    assert not np.array_equal(np.stack(off), np.stack(got))


def test_sampler_and_mode_refusals_name_their_items(sd15):
    """What is still refused names its ROADMAP item: the reference image's
    caption (item 7); an unknown mode is an error. (The tiled VAE and tile
    refinement, item 5, are ported: tests/test_torch_hires.py,
    tests/test_torch_pipelines_extra.py; textual inversion, item 6:
    tests/test_torch_load_e2e.py.)"""
    tb, _ = sd15["blend"]
    args = dict(image=_checker_image(64, 64), mask=_mask(), prompt="x",
                condition_image=_checker_image(64, 64), image_resolution=64,
                num_steps=2)
    editor = EditAnythingEditor(tb)
    request = dict(image=_checker_image(64, 64), mask=_mask(),
                   condition_image=_checker_image(64, 64))
    for name in ("ref_auto_prompt",):
        with pytest.raises(NotImplementedError, match="item 7"):
            editor.process(**request, ref_image=_checker_image(64, 64),
                           ref_mask=_mask(), **{name: True})
    with pytest.raises(ValueError, match="inpaint_mode"):
        EditPipeline(tb, inpaint_mode="paint")(**args)
