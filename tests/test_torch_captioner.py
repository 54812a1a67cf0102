"""The port's captioner pipeline (pipelines/captioner.py) and semantic
overlay (apps/demos.py) against the JAX package's, at the tiny BLIP-2 of
tests/test_torch_blip2.py (every parameter nonzero, numpy from a seed) with
the tiny GPT-2 tokenizer, in fp32.

Tolerances: ``preprocess``'s resize within 1e-5 of ``jax.image.resize``'s
"bicubic" (pixels in [0, 1]; 4e-5 after the division by CLIP's std), one
way downscaling 512^2 to 224^2, the other upscaling a 100 x 60 crop. A
crop's "bilinear" resize (values up to 255) within 1e-4 of the fp64 sum
over JAX's own weight matrices (``compute_weight_mat``), and within 4e-3
of ``jax.image.resize`` itself, whose fp32 contraction lies up to 6.5e-4
(upscaling) and 3.5e-3 (downscaling) from that fp64 sum; the uint8
truncation equal except where JAX's value lies within 4e-3 of an integer
(counted). The ranking, the crops, the captions and the labels equal; the
overlay equal for the same masks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.apps import demos as JD
from editanything_tpu.checkpoints.convert import blip2_to_tree
from editanything_tpu.models import blip2 as JB
from editanything_tpu.pipelines import captioner as JC
from editanything_tpu.text.tokenizer import tiny_gpt2_tokenizer as jax_gpt2
from editanything_tpu_torch.apps import demos as TD
from editanything_tpu_torch.pipelines import captioner as TC
from editanything_tpu_torch.text.tokenizer import tiny_gpt2_tokenizer

from test_torch_blip2 import port_model, random_state_dict

RESIZE_TOL = 1e-5
CROP_EXACT_TOL = 1e-4
CROP_TOL = 4e-3
NEW_TOKENS = 4
STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def captioners():
    sd = random_state_dict(1)
    return (JC.Captioner(blip2_to_tree(sd), JB.tiny_blip2_config(), jax_gpt2(),
                         prompt="Q:", max_new_tokens=NEW_TOKENS),
            TC.Captioner(port_model(sd), tiny_gpt2_tokenizer(),
                         prompt="Q:", max_new_tokens=NEW_TOKENS))


def _uint8(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("shape", [(2, 512, 512, 3), (1, 100, 60, 3)])
def test_preprocess_matches_jax(shape):
    img = _uint8(0, shape)
    want = np.asarray(JC.preprocess(img, 224))
    got = TC.preprocess(img, 224)
    assert got.shape == (shape[0], 3, 224, 224) and got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    resize_err = np.abs((got - want) * STD).max()
    print(f"{shape}: resize error {resize_err:.2e}, normalised "
          f"{np.abs(got - want).max():.2e}")
    assert resize_err <= RESIZE_TOL
    assert np.abs(got - want).max() <= RESIZE_TOL / STD.min()


@pytest.mark.parametrize("hw", [(100, 60), (23, 41), (300, 250)])
def test_crop_resize_matches_jax(hw):
    """A crop to the 224^2 input, as semantic_labels resizes it: floats
    close, and the uint8 truncation equal away from integers."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat
    crop = _uint8(1, hw + (3,))
    crop[: hw[0] // 2] = 77     # a flat region: many values land on 77
    want = np.asarray(jax.image.resize(
        jnp.asarray(crop, jnp.float32), (224, 224, 3), method="bilinear"))
    wh, ww = (np.asarray(compute_weight_mat(n, 224, 224 / n, 0.0,
                                            _fill_triangle_kernel, True),
                         np.float64) for n in hw)
    exact = np.einsum("hwc,hH->Hwc", crop.astype(np.float64), wh)
    exact = np.einsum("Hwc,wW->HWc", exact, ww)
    got = TC.resize_crop(crop, 224)
    assert got.shape == (224, 224, 3) and got.dtype == np.float32
    print(f"{hw}: port {np.abs(got - exact).max():.2e} and JAX "
          f"{np.abs(want - exact).max():.2e} from the fp64 sum")
    assert np.abs(got - exact).max() <= CROP_EXACT_TOL
    assert np.abs(got - want).max() <= CROP_TOL
    near = np.abs(want - np.round(want)) <= CROP_TOL
    differ = got.astype(np.uint8) != want.astype(np.uint8)
    print(f"{hw}: {near.mean():.3f} of values within {CROP_TOL} of an "
          f"integer, {differ.sum()} truncations differ")
    assert not (differ & ~near).any()


def _masks(h=40, w=40):
    masks = np.zeros((5, h, w), bool)
    masks[0, 5:30, 5:30] = True
    masks[1, 0:10, 30:40] = True
    masks[2, 20:38, 2:12] = True
    masks[3, 2:4, 2:4] = True
    masks[4, 10:35, 12:36] = True
    valid = np.array([True, True, False, True, True])
    return masks, valid, masks.reshape(5, -1).sum(-1)


def test_rank_and_crop_regions_equal_jax():
    img = _uint8(2, (40, 40, 3))
    masks, valid, areas = _masks()
    masks[4] = False                 # valid but empty: skipped
    for top_k in (1, 3, 10):
        want_idx, want = JC.rank_and_crop_regions(img, masks, valid, areas,
                                                  top_k=top_k)
        got_idx, got = TC.rank_and_crop_regions(img, masks, valid, areas,
                                                top_k=top_k)
        np.testing.assert_array_equal(got_idx, want_idx)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_captioner_strings_equal_jax(captioners):
    jcap, tcap = captioners
    assert tcap.prompt_ids == jcap.prompt_ids
    imgs = _uint8(3, (3, 48, 40, 3))
    want = np.asarray(jcap.fn(jcap.params, JC.preprocess(imgs, 28),
                              jnp.broadcast_to(jnp.asarray(jcap.prompt_ids)[None],
                                               (3, len(jcap.prompt_ids)))))
    np.testing.assert_array_equal(tcap.tokens(imgs), want)
    got = tcap(imgs)
    print(got)
    assert got == jcap(imgs) and all(isinstance(s, str) for s in got)


def test_semantic_labels_equal_jax(captioners):
    jcap, tcap = captioners
    img = _uint8(4, (40, 40, 3))
    masks, valid, areas = _masks()
    want = JC.semantic_labels(img, masks, valid, areas, jcap, top_k=3)
    got = TC.semantic_labels(img, masks, valid, areas, tcap, top_k=3)
    print(got)
    assert [i for i, _ in got] == [0, 4, 1]
    assert got == want
    assert TC.semantic_labels(img, masks, np.zeros(5, bool), areas, tcap) == []


def test_semantic_overlay_equal_jax():
    img = _uint8(5, (64, 48, 3))
    rng = np.random.RandomState(6)
    logits = rng.randn(4, 16, 12).astype(np.float32)
    valid = np.array([True, False, True, True])
    labels = [(0, "a dog"), (1, "hidden"), (3, "a sofa by the window at noon")]
    want = JD.semantic_overlay(img, logits, valid, labels, mask_threshold=0.1)
    got = TD.semantic_overlay(img, logits, valid, labels, mask_threshold=0.1)
    assert got.dtype == np.uint8 and got.shape == (64, 48, 3)
    np.testing.assert_array_equal(got, want)
    m = np.zeros((64, 64), bool)
    m[8:30, 8:30] = True
    regions = [(m, "a dog"), (~m, "")]
    np.testing.assert_array_equal(TD.show_semantic_image_label((64, 64), regions),
                                  JD.show_semantic_image_label((64, 64), regions))


def test_semantic_overlay_names_pil_when_missing(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        TD.show_semantic_image_label((8, 8), [(np.ones((8, 8), bool), "x")])
