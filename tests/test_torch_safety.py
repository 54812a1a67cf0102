"""The port's safety checker (models/safety.py) against the JAX package's
and HF's CLIPVisionModel, at the JAX package's tiny test widths.

PIL's BICUBIC resampling in numpy equals PIL's to the level; ``preprocess``
equals the JAX package's within 1e-6 (the same uint8 pixels normalised in
fp32); the tower's pooled embedding and the concept scores equal JAX's
within 1e-5 (fp32 sums in other orders), with concept and special-care
embeddings placed on some images' embeddings so that flags fire and the
special-care adjustment applies; the HF-layout state dict (the doubled
``vision_model.`` prefix, the ``position_ids`` buffer) loads strictly and
the tower equals HF's within 2e-5 (the bound of tests/test_safety.py); and
a pipeline over a bundle with a checker blacks out what it flags and
reports the flags.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from editanything_tpu.checkpoints.convert import safety_checker_to_tree
from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.models import safety as JS
from editanything_tpu_torch.checkpoints.convert import safety_checker_state_dict
from editanything_tpu_torch.models import safety as TS
from editanything_tpu_torch.pipelines.bundle import (module_from_state_dict,
                                                     random_bundle)
from editanything_tpu_torch.pipelines.generate import GenerationPipeline
from editanything_tpu_torch.utils.image import resize_pil

from test_safety import _full_sd, _hf_tiny

TINY = TS.tiny_vision_config()
JTINY = JS.tiny_vision_config()
TOL = 1e-5
HF_TOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def jax_plain_references():
    saved = JFA._DISABLED, JK._DISABLED
    JFA._DISABLED = JK._DISABLED = True
    yield
    JFA._DISABLED, JK._DISABLED = saved


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def hf_checker():
    hf = _hf_tiny()
    return hf, _full_sd(hf)


def _port(sd):
    return module_from_state_dict(
        TS.SafetyCheckerModel, TINY,
        safety_checker_state_dict({k: torch.from_numpy(np.array(v))
                                   for k, v in sd.items()}),
        device="cpu", dtype=torch.float32)


def _images(n, h, w, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("src,dst", [((64, 48), (224, 298)),
                                     ((300, 500), (224, 373)),
                                     ((40, 48), (32, 38)),
                                     ((512, 512), (224, 224))])
def test_bicubic_matches_pil(src, dst):
    img = _images(1, *src, seed=sum(src))[0]
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BICUBIC))
    np.testing.assert_array_equal(resize_pil(img, dst, "bicubic"), want)


@pytest.mark.parametrize("h,w", [(48, 64), (70, 40), (32, 32)])
def test_preprocess_matches_jax(h, w):
    imgs = _images(2, h, w, seed=h + w)
    want = JS.preprocess(imgs, JTINY)
    got = TS.preprocess(imgs, TINY)
    assert got.shape == (2, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_state_dict_converter_and_tower_match_hf(hf_checker):
    hf, sd = hf_checker
    assert any(k.startswith("vision_model.vision_model.") for k in sd)
    model = _port(sd)     # strict: every parameter, nothing left over
    px = np.random.default_rng(1).standard_normal(
        (2, 3, TINY.image_size, TINY.image_size)).astype(np.float32)
    with torch.no_grad():
        want = hf(pixel_values=torch.from_numpy(px)).pooler_output
        got = model.vision_pooled(torch.from_numpy(px))
    torch.testing.assert_close(got, want, atol=HF_TOL, rtol=HF_TOL)


def test_check_and_flags_match_jax(hf_checker):
    _, sd = hf_checker
    sd = dict(sd)
    px = TS.preprocess(_images(4, 40, 48, seed=7), TINY)
    tree = safety_checker_to_tree(sd)
    # concept 0 on image 0's embedding and special-care concept 0 on image
    # 2's, each threshold halfway between that image's similarity (1) and
    # the next image's, the other concepts' above 1: image 0 alone is
    # flagged, and image 2's thresholds drop by 0.01
    pooled = np.asarray(JS.vision_pooled(tree, JTINY, jnp.asarray(px)))
    emb = pooled @ sd["visual_projection.weight"].T
    unit = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    cos = unit @ unit.T

    def place(embeds, weights, image):
        e, w = sd[embeds].copy(), np.full_like(sd[weights], 1.5)
        e[0] = emb[image]
        w[0] = (1.0 + np.delete(cos[image], image).max()) / 2
        sd[embeds], sd[weights] = e, w
    place("concept_embeds", "concept_embeds_weights", 0)
    place("special_care_embeds", "special_care_embeds_weights", 2)
    tree = safety_checker_to_tree(sd)
    want_pooled = JS.vision_pooled(tree, JTINY, jnp.asarray(px))
    want_nsfw, want_scores = JS.check(tree, JTINY, jnp.asarray(px))
    model = _port(sd)
    x = torch.from_numpy(px).permute(0, 3, 1, 2)
    with torch.no_grad():
        pooled_t = model.vision_pooled(x)
        nsfw, scores = model.check(x)
    np.testing.assert_allclose(pooled_t.numpy(), np.asarray(want_pooled),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(nsfw.numpy(), np.asarray(want_nsfw))
    assert nsfw.tolist() == [True, False, False, False]
    # the wrapper over uint8 images: flagged ones black, the others as given
    imgs = _images(4, 40, 48, seed=7)
    out, flags = TS.SafetyChecker(model)(imgs)
    _, want_flags = JS.SafetyChecker(tree, JTINY)(imgs)
    np.testing.assert_array_equal(flags, np.asarray(want_flags))
    for i in range(4):
        np.testing.assert_array_equal(out[i], 0 if flags[i] else imgs[i])


def test_pipeline_reports_flags(hf_checker):
    """A bundle with a checker: images flagged (every threshold at -1)
    are black and the flags are ``last_nsfw``; without one it is None."""
    _, sd = hf_checker
    sd = dict(sd, concept_embeds_weights=np.full(TINY.num_concepts, -1.0,
                                                 np.float32))
    tb = random_bundle(tiny=True, device="cpu", controlnet_names=("sam",))
    args = dict(prompt="a cat", condition_image=np.zeros((64, 64, 3), np.uint8),
                num_samples=2, image_resolution=64, num_steps=1, seed=0)
    plain = GenerationPipeline(tb, controlnet="sam")
    out = plain(**args)
    assert plain.last_nsfw is None and out.any()
    tb.safety = TS.SafetyChecker(_port(sd))
    pipe = GenerationPipeline(tb, controlnet="sam")
    out = pipe(**args)
    assert pipe.last_nsfw.tolist() == [True, True] and not out.any()
