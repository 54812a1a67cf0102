"""The port's editor entry points against the JAX package's
``EditAnythingEditor``, with the same weights, inputs and noise.

The fixture is tests/test_editor.py's (tiny bundle from PRNGKey(0), tiny
SAM, 4x4 AMG points with the quality filters open, 16 slots, a tiny BLIP-2
captioner of 3 new tokens), with the ControlNet zero convs filled (as
tests/test_torch_edit.py), the SAM weights drawn by the port's
``random_sam`` (every parameter nonzero) and carried to the JAX tree by
``sam_to_tree``, and the captioner's weights those of
tests/test_torch_blip2.py (every parameter nonzero, numpy from a seed).
Images are 64^2, so neither side resizes (PIL on the JAX side, torch on
the port's).

Tolerances: the ID condition maps and click masks equal except at pixels
whose upscaled logit lies within 1e-5 of the threshold (counted; fp32 SAM
as tests/test_torch_amg.py); the edited images within 2 uint8 levels, the
bound of tests/test_torch_edit.py; captions, prompts and region labels
equal; the semantic overlay equal wherever no labelled mask's upscaled
logit lies within 1e-5 of the threshold.
"""

import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.checkpoints.convert import blip2_to_tree
from editanything_tpu.models import blip2 as JB
from editanything_tpu.perception import amg as JA
from editanything_tpu.pipelines.bundle import random_bundle as jax_random_bundle
from editanything_tpu.pipelines.captioner import Captioner as JaxCaptioner
from editanything_tpu.pipelines.editor import EditAnythingEditor as JaxEditor
from editanything_tpu.text.tokenizer import tiny_gpt2_tokenizer as jax_gpt2
from editanything_tpu_torch.models.clip_text import CLIPTextModel
from editanything_tpu_torch.models.controlnet import ControlNetModel
from editanything_tpu_torch.models.unet import UNet2DConditionModel
from editanything_tpu_torch.models.vae import AutoencoderKL
from editanything_tpu_torch.perception import amg as TA
from editanything_tpu_torch.pipelines.bundle import (ModelBundle,
                                                     module_from_tree,
                                                     random_sam)
from editanything_tpu_torch.pipelines.captioner import Captioner
from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
from editanything_tpu_torch.text.tokenizer import (tiny_gpt2_tokenizer,
                                                   tiny_tokenizer)

from test_torch_blip2 import port_model, random_state_dict
from test_torch_models import fill_zero_convs, port_cfg
from test_torch_sam import JAX_TINY, TINY, to_tree

IMAGE_LEVELS = 2
LOGIT_TOL = 1e-5
NEAR_SHARE = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AMG = dict(points_per_side=4, points_per_batch=16, pred_iou_thresh=-10.0,
           stability_score_thresh=-1.0, max_masks=16)
CAPTION_TOKENS = 3


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
    blip2 = random_state_dict(5)
    jcap = JaxCaptioner(blip2_to_tree(blip2), JB.tiny_blip2_config(),
                        jax_gpt2(), max_new_tokens=CAPTION_TOKENS)
    tcap = Captioner(port_model(blip2), tiny_gpt2_tokenizer(),
                     max_new_tokens=CAPTION_TOKENS)
    jed = JaxEditor(jb, sam=(JAX_TINY, to_tree(sam)), captioner=jcap,
                    extra_inpaint=True, amg_config=JA.AMGConfig(**AMG))
    ted = EditAnythingEditor(tb, sam=(TINY, sam), captioner=tcap,
                             extra_inpaint=True, amg_config=TA.AMGConfig(**AMG))
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


def _process_args(img):
    mask = np.zeros((64, 64), np.uint8)
    mask[16:48, 16:48] = 255
    return dict(image=img, mask=mask, prompt="a red cat", a_prompt="best",
                n_prompt="blurry", num_samples=2, image_resolution=64,
                detect_resolution=64, ddim_steps=4, scale=9.0,
                control_scale=0.5, seed=7, alignment_ratio=0.75)


def _jax_noise():
    """The JAX pipeline's initial latents for seed 7 (edit.py:176-183)."""
    return np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(7))[0], (2, 8, 8, 4), jnp.float32))


def test_process_with_sam_condition_matches_jax(editors):
    jed, ted = editors
    img = _image(5)
    args = _process_args(img)
    _, want, (want_cond, _), want_prompt = jed.process(**args)
    tiles, got, (got_cond, got_mask), got_prompt = ted.process(
        **args, noise=_jax_noise())
    assert tiles == [] and got_prompt == want_prompt == "a red cat, best"
    near = _near_threshold(jed, img)
    np.testing.assert_array_equal(got_cond[~near], want_cond[~near])
    np.testing.assert_array_equal(got_mask, args["mask"])
    assert len(got) == 2 and got[0].shape == (64, 64, 3)
    diff = np.abs(np.stack(got).astype(np.int32)
                  - np.stack(want).astype(np.int32))
    print(f"images max diff {diff.max()} levels")
    assert diff.max() <= IMAGE_LEVELS


class _RecordingPipe:
    """Stands in for an editor's edit pipeline: records its arguments and
    returns black images, so a test reads what ``process`` hands the edit
    without running it."""

    def __init__(self):
        self.kwargs = None
        self.last_nonfinite = 0

    def __call__(self, **kwargs):
        self.kwargs = kwargs
        return np.zeros((kwargs["num_samples"], 64, 64, 3), np.uint8)


@pytest.mark.parametrize("arg", ["enable_auto_prompt", "ref_auto_prompt"])
def test_process_auto_prompt_arguments_match_jax(editors, arg):
    """enable_auto_prompt: the image's caption goes before the prompt, and
    the whole request (the SAM map, the edit) matches JAX's.
    ref_auto_prompt: the masked reference crop's caption is appended to
    ref_prompt and a_prompt, as JAX's, which both editors hand their edit
    pipeline (recorded here; the reference-mode edit itself is held in
    tests/test_torch_refctrl.py)."""
    jed, ted = editors
    img = _image(5)
    args = _process_args(img)
    if arg == "enable_auto_prompt":
        _, want, (want_cond, _), want_prompt = jed.process(
            **args, enable_auto_prompt=True)
        _, got, (got_cond, _), got_prompt = ted.process(
            **args, enable_auto_prompt=True, noise=_jax_noise())
        caption = ted.get_blip2_text(img)
        assert caption == jed.get_blip2_text(img) and caption
        assert got_prompt == want_prompt == f"{caption}, a red cat, best"
        near = _near_threshold(jed, img)
        np.testing.assert_array_equal(got_cond[~near], want_cond[~near])
        diff = np.abs(np.stack(got).astype(np.int32)
                      - np.stack(want).astype(np.int32))
        print(f"caption {caption!r}; images max diff {diff.max()} levels")
        assert diff.max() <= IMAGE_LEVELS
        return
    ref = _image(11)
    ref_mask = np.zeros((64, 64), np.uint8)
    ref_mask[8:40, 20:60] = 255
    recorded = []
    for ed in (jed, ted):
        saved = ed.pipe
        ed.pipe = _RecordingPipe()
        try:
            _, _, _, positive = ed.process(
                **args, condition_image=_image(8), ref_image=ref,
                ref_mask=ref_mask, ref_prompt="a dog: ", ref_auto_prompt=True)
            recorded.append((positive, ed.pipe.kwargs))
        finally:
            ed.pipe = saved
    (want_pos, want_kw), (got_pos, got_kw) = recorded
    caption = ted.get_blip2_text(ted._crop_masked_region(ref, ref_mask))
    assert caption
    assert got_kw["ref_prompt"] == want_kw["ref_prompt"] == "a dog: " + caption
    assert got_pos == want_pos == f"a red cat, best{caption}"
    assert got_kw["prompt"] == want_kw["prompt"] == got_pos


def test_process_takes_every_jax_argument(editors):
    """The port's process takes every argument of the JAX editor's, with
    the same defaults; what it adds (encoder_interval, the generator and
    the noises) is keyword-only, and anything else is a TypeError."""
    jax_params = inspect.signature(JaxEditor.process).parameters
    port_params = inspect.signature(EditAnythingEditor.process).parameters
    for name, p in jax_params.items():
        assert name in port_params, name
        assert port_params[name].default == p.default, name
    extra = set(port_params) - set(jax_params)
    assert extra == {"encoder_interval", "generator", "noise", "mix_noise",
                     "step_noise", "eta_noise", "tile_noise"}, extra
    assert not any(p.kind == p.VAR_KEYWORD for p in port_params.values())
    with pytest.raises(TypeError, match="enable_auto_prompts"):
        editors[1].process(image=_image(7), mask=None,
                           condition_image=_image(8), enable_auto_prompts=True)


def test_semantic_matches_jax(editors):
    """Region labels equal JAX's (mapped to the same AMG slots), and the
    overlay equal wherever no labelled mask's upscaled logit is within
    LOGIT_TOL of the threshold (counted). Box NMS is off for this test (IoU
    threshold 1), so that the random SAM's overlapping masks fill the top 4
    and the labels take one captioner call of 4 crops."""
    jed, ted = editors
    img = _image(9)
    amg = dict(AMG, box_nms_thresh=1.0)
    saved = [(ed.amg_cfg, ed._amg_encode, ed._amg_generate) for ed in editors]
    jed.amg_cfg = JA.AMGConfig(**amg)
    jed._amg_encode, jed._amg_generate = JA.build_amg(JAX_TINY, jed.amg_cfg)
    ted.amg_cfg = TA.AMGConfig(**amg)
    ted._amg_encode, ted._amg_generate = TA.build_amg(TINY, ted.amg_cfg)
    try:
        want_labels, want = jed.semantic(img, top_k=4, detect_resolution=64)
        got_labels, got = ted.semantic(img, top_k=4, detect_resolution=64)
    finally:
        for ed, (cfg, enc, gen) in zip(editors, saved):
            ed.amg_cfg, ed._amg_encode, ed._amg_generate = cfg, enc, gen
    print(f"labels {got_labels}")
    assert len(got_labels) == 4 and all(lab for _, lab in got_labels)
    assert got_labels == want_labels
    assert got.dtype == np.uint8 and got.shape == want.shape == (64, 64, 3)
    sam_cfg, params = jed.sam
    from editanything_tpu.models import sam as JS
    encode, generate = JA.build_amg(JAX_TINY, JA.AMGConfig(**amg))
    out = generate(params, encode(params, JS.preprocess(jnp.asarray(img),
                                                        sam_cfg)),
                   jnp.asarray(JA._grid_points(jed.amg_cfg, 64, 64)))
    slots = [i for i, _ in want_labels]
    up = np.asarray(jax.image.resize(np.asarray(out["logits"])[slots],
                                     (len(slots), 64, 64), "bilinear"))
    near = (np.abs(up) <= LOGIT_TOL).any(axis=0)
    print(f"overlay pixels within {LOGIT_TOL} of the threshold: {near.sum()}")
    assert near.mean() < NEAR_SHARE
    if near.any():
        np.testing.assert_array_equal(got[~near], want[~near])
    else:
        np.testing.assert_array_equal(got, want)


def test_editor_path_imports_neither_jax_nor_pil():
    """A tiny SAM-conditioned edit at 64^2 (nothing for PIL to resize) with
    the auto prompt of a tiny captioner, in a fresh interpreter, loads no
    module of jax, PIL or the JAX package."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from editanything_tpu_torch.models.blip2 import tiny_blip2_config\n"
        "from editanything_tpu_torch.models.sam import SAMConfig\n"
        "from editanything_tpu_torch.perception import AMGConfig\n"
        "from editanything_tpu_torch.pipelines.bundle import (random_blip2,\n"
        "    random_bundle, random_sam)\n"
        "from editanything_tpu_torch.pipelines.captioner import Captioner\n"
        "from editanything_tpu_torch.pipelines.editor import EditAnythingEditor\n"
        "from editanything_tpu_torch.text.tokenizer import tiny_gpt2_tokenizer\n"
        "cfg = SAMConfig(img_size=64, patch_size=8, embed_dim=32, depth=2,\n"
        "                num_heads=2, global_attn_indexes=(1,), window_size=4,\n"
        "                out_chans=16, prompt_embed_dim=16, decoder_mlp_dim=32)\n"
        "cap = Captioner(random_blip2(tiny_blip2_config(), device='cpu'),\n"
        "                tiny_gpt2_tokenizer(), max_new_tokens=3)\n"
        "ed = EditAnythingEditor(random_bundle(tiny=True, device='cpu'),\n"
        "                        sam=(cfg, random_sam(cfg, device='cpu')),\n"
        "                        captioner=cap,\n"
        "                        amg_config=AMGConfig(points_per_side=4,\n"
        "                                             points_per_batch=16))\n"
        "img = np.zeros((64, 64, 3), np.uint8)\n"
        "_, out, (cond, _), prompt = ed.process(image=img, mask=None,\n"
        "    prompt='a cat', image_resolution=64, detect_resolution=64,\n"
        "    ddim_steps=1, enable_auto_prompt=True)\n"
        "assert prompt.endswith(', a cat'), prompt\n"
        "ed.process_image_click(img, 10, 10, detect_resolution=64)\n"
        "assert out[0].shape == (64, 64, 3) and cond.shape == (64, 64, 3)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'PIL', 'editanything_tpu'))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
