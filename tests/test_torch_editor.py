"""The port's editor entry points against the JAX package's
``EditAnythingEditor``, with the same weights, inputs and noise.

The fixture is tests/test_editor.py's (tiny bundle from PRNGKey(0), tiny
SAM, 4x4 AMG points with the quality filters open, 16 slots) without the
captioner, with the ControlNet zero convs filled (as tests/test_torch_edit.py)
and the SAM weights drawn by the port's ``random_sam`` (every parameter
nonzero) and carried to the JAX tree by ``sam_to_tree``. Images are 64^2, so
neither side resizes (PIL on the JAX side, torch on the port's).

Tolerances: the ID condition maps and click masks equal except at pixels
whose upscaled logit lies within 1e-5 of the threshold (counted; fp32 SAM
as tests/test_torch_amg.py); the edited images within 2 uint8 levels, the
bound of tests/test_torch_edit.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.perception import amg as JA
from editanything_tpu.pipelines.bundle import random_bundle as jax_random_bundle
from editanything_tpu.pipelines.editor import EditAnythingEditor as JaxEditor
from editanything_tpu_torch.models.clip_text import CLIPTextModel
from editanything_tpu_torch.models.controlnet import ControlNetModel
from editanything_tpu_torch.models.unet import UNet2DConditionModel
from editanything_tpu_torch.models.vae import AutoencoderKL
from editanything_tpu_torch.perception import amg as TA
from editanything_tpu_torch.pipelines.bundle import (ModelBundle,
                                                     module_from_tree,
                                                     random_sam)
from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
from editanything_tpu_torch.text.tokenizer import tiny_tokenizer

from test_torch_models import fill_zero_convs, port_cfg
from test_torch_sam import JAX_TINY, TINY, to_tree

IMAGE_LEVELS = 2
LOGIT_TOL = 1e-5
NEAR_SHARE = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AMG = dict(points_per_side=4, points_per_batch=16, pred_iou_thresh=-10.0,
           stability_score_thresh=-1.0, max_masks=16)


@pytest.fixture(scope="module")
def editors():
    jb = jax_random_bundle(jax.random.PRNGKey(0), tiny=True,
                           controlnet_names=("sam", "inpaint"))
    jb.controlnets = {name: (cfg, fill_zero_convs(tree, 30 + i))
                      for i, (name, (cfg, tree)) in
                      enumerate(jb.controlnets.items())}
    ucfg, vcfg, tcfg = (port_cfg(jb.unet_cfg), port_cfg(jb.vae_cfg),
                        port_cfg(jb.text_cfg))
    tb = ModelBundle(
        unet_cfg=ucfg, vae_cfg=vcfg, text_cfg=tcfg,
        unet=module_from_tree(UNet2DConditionModel, ucfg, jb.unet),
        vae=module_from_tree(AutoencoderKL, vcfg, jb.vae),
        text=module_from_tree(CLIPTextModel, tcfg, jb.text),
        tokenizer=tiny_tokenizer(context_length=tcfg.max_position_embeddings),
        dtype=torch.float32,
        controlnets={n: (port_cfg(c), module_from_tree(ControlNetModel,
                                                       port_cfg(c), t))
                     for n, (c, t) in jb.controlnets.items()})
    sam = random_sam(TINY, device="cpu",
                     generator=torch.Generator().manual_seed(21)).eval()
    jed = JaxEditor(jb, sam=(JAX_TINY, to_tree(sam)), extra_inpaint=True,
                    amg_config=JA.AMGConfig(**AMG))
    ted = EditAnythingEditor(tb, sam=(TINY, sam), extra_inpaint=True,
                             amg_config=TA.AMGConfig(**AMG))
    return jed, ted


def _image(seed, h=64, w=64):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)).astype(np.uint8)


def _near_threshold(jed, image):
    """Pixels where some kept AMG mask's upscaled logit (JAX side) lies
    within LOGIT_TOL of the threshold."""
    sam_cfg, params = jed.sam
    from editanything_tpu.models import sam as JS
    emb = jed._amg_encode(params, JS.preprocess(jnp.asarray(image), sam_cfg))
    out = jed._amg_generate(params, emb, jnp.asarray(
        JA._grid_points(jed.amg_cfg, *image.shape[:2])))
    up = np.asarray(JA.upscale_masks(out["logits"], image.shape[:2]))
    near = (np.abs(up) <= LOGIT_TOL) & np.asarray(out["valid"])[:, None, None]
    return near.any(axis=0)


def test_get_sam_control_matches_jax(editors):
    jed, ted = editors
    img = _image(1)
    want = jed.get_sam_control(img)
    got = ted.get_sam_control(img)
    assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
    assert len(np.unique(want[..., 0])) >= 2
    near = _near_threshold(jed, img)
    print(f"ID map pixels within {LOGIT_TOL} of the threshold: {near.sum()}")
    assert near.mean() < NEAR_SHARE
    np.testing.assert_array_equal(got[~near], want[~near])


def test_process_image_click_matches_jax(editors):
    jed, ted = editors
    img = _image(3)
    for ed in (jed, ted):
        ed.clear_clicks()
    for x, y, fg in ((40, 40, True), (10, 50, False)):
        want_overlay, want_mask = jed.process_image_click(
            img, x, y, fg, detect_resolution=64)
        got_overlay, got_mask = ted.process_image_click(
            img, x, y, fg, detect_resolution=64)
        assert got_mask.dtype == np.uint8 and set(np.unique(got_mask)) <= {0, 255}
        np.testing.assert_array_equal(got_mask, want_mask)
        np.testing.assert_array_equal(got_overlay, want_overlay)
    assert ted.click_points == jed.click_points


def test_process_with_sam_condition_matches_jax(editors):
    jed, ted = editors
    img = _image(5)
    mask = np.zeros((64, 64), np.uint8)
    mask[16:48, 16:48] = 255
    args = dict(image=img, mask=mask, prompt="a red cat", a_prompt="best",
                n_prompt="blurry", num_samples=2, image_resolution=64,
                detect_resolution=64, ddim_steps=4, scale=9.0,
                control_scale=0.5, seed=7, alignment_ratio=0.75)
    _, want, (want_cond, _), want_prompt = jed.process(**args)
    # the JAX pipeline's initial latents (edit.py:176-183)
    noise = jax.random.normal(jax.random.split(jax.random.PRNGKey(7))[0],
                              (2, 8, 8, 4), jnp.float32)
    tiles, got, (got_cond, got_mask), got_prompt = ted.process(
        **args, noise=np.asarray(noise))
    assert tiles == [] and got_prompt == want_prompt == "a red cat, best"
    near = _near_threshold(jed, img)
    np.testing.assert_array_equal(got_cond[~near], want_cond[~near])
    np.testing.assert_array_equal(got_mask, mask)
    assert len(got) == 2 and got[0].shape == (64, 64, 3)
    diff = np.abs(np.stack(got).astype(np.int32)
                  - np.stack(want).astype(np.int32))
    print(f"images max diff {diff.max()} levels")
    assert diff.max() <= IMAGE_LEVELS


@pytest.mark.parametrize("arg,value", [("enable_auto_prompt", True),
                                       ("ref_auto_prompt", True)])
def test_process_refuses_arguments_not_ported(editors, arg, value):
    _, ted = editors
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ted.process(image=_image(7), mask=None, condition_image=_image(8),
                    **{arg: value})


def test_editor_path_imports_neither_jax_nor_pil():
    """A tiny SAM-conditioned edit at 64^2 (nothing for PIL to resize) in a
    fresh interpreter loads no module of jax, PIL or the JAX package."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from editanything_tpu_torch.models.sam import SAMConfig\n"
        "from editanything_tpu_torch.perception import AMGConfig\n"
        "from editanything_tpu_torch.pipelines.bundle import random_bundle, random_sam\n"
        "from editanything_tpu_torch.pipelines.editor import EditAnythingEditor\n"
        "cfg = SAMConfig(img_size=64, patch_size=8, embed_dim=32, depth=2,\n"
        "                num_heads=2, global_attn_indexes=(1,), window_size=4,\n"
        "                out_chans=16, prompt_embed_dim=16, decoder_mlp_dim=32)\n"
        "ed = EditAnythingEditor(random_bundle(tiny=True, device='cpu'),\n"
        "                        sam=(cfg, random_sam(cfg, device='cpu')),\n"
        "                        amg_config=AMGConfig(points_per_side=4,\n"
        "                                             points_per_batch=16))\n"
        "img = np.zeros((64, 64, 3), np.uint8)\n"
        "_, out, (cond, _), _ = ed.process(image=img, mask=None, prompt='a cat',\n"
        "    image_resolution=64, detect_resolution=64, ddim_steps=1)\n"
        "ed.process_image_click(img, 10, 10, detect_resolution=64)\n"
        "assert out[0].shape == (64, 64, 3) and cond.shape == (64, 64, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'PIL', 'editanything_tpu'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
