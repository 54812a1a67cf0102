"""The port's whole edit slice against the JAX package's EditPipeline.

The case is the golden test's ``_run_edit`` (tests/test_golden_regression.py:
tiny bundle from PRNGKey(42), fp32, 96^2 image and mask, 64^2 condition
map, 2 samples, 4 UniPC steps, CFG 9, alignment_ratio 0.75, seed 7), with
the ControlNet zero convs filled with seeded values on both sides so the
residuals reach the UNet. The port gets the JAX weights and, through
``noise=``, the JAX pipeline's own initial draw.

Tolerances: final latents 1e-3 absolute (fp32 through ~100 network
evaluations' worth of convs, norms and attentions summed in other orders,
amplified by CFG 9 and UniPC's x0 extrapolation); images 2 uint8 levels,
the golden test's own bound. Resize helpers: nearest exact, bilinear 1e-5
(fp32 filter weights summed in another order).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.pipelines import EditPipeline as JaxEditPipeline
from editanything_tpu.pipelines.bundle import random_bundle as jax_random_bundle
from editanything_tpu_torch.models.clip_text import CLIPTextModel
from editanything_tpu_torch.models.controlnet import ControlNetModel
from editanything_tpu_torch.models.unet import UNet2DConditionModel
from editanything_tpu_torch.models.vae import AutoencoderKL
from editanything_tpu_torch.pipelines.bundle import (ModelBundle,
                                                     module_from_tree,
                                                     random_bundle)
from editanything_tpu_torch.pipelines.edit import EditPipeline
from editanything_tpu_torch.text.tokenizer import tiny_tokenizer
from editanything_tpu_torch.utils.image import resize_bilinear, resize_nearest

from test_torch_models import fill_zero_convs, port_cfg

LATENT_TOL = 1e-3
IMAGE_LEVELS = 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _checker_image(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 255 // max(w - 1, 1)),
                    (yy * 255 // max(h - 1, 1)),
                    ((xx // 8 + yy // 8) % 2) * 200], axis=-1)
    return img.astype(np.uint8)


def _edit_args():
    mask = np.zeros((96, 96), np.uint8)
    mask[24:72, 24:72] = 255
    return dict(image=_checker_image(96, 96), mask=mask, prompt="a red cat",
                condition_image=_checker_image(64, 64),
                negative_prompt="blurry", num_samples=2,
                image_resolution=64, num_steps=4, guidance_scale=9.0,
                control_scale=0.5, alignment_ratio=0.75, seed=7)


@pytest.fixture(scope="module")
def bundles():
    jb = jax_random_bundle(jax.random.PRNGKey(42), tiny=True,
                           dtype=jnp.float32)
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
    return jb, tb


def test_edit_slice_matches_jax(bundles):
    jb, tb = bundles
    args = _edit_args()
    jpipe = JaxEditPipeline(jb, controls=("sam", "inpaint"),
                            inpaint_mode="blend")
    want_lat = np.asarray(jpipe(**args, return_latents=True), np.float32)
    want_img = jpipe(**args)
    # the JAX pipeline's initial latents (edit.py:176-183)
    noise = jax.random.normal(jax.random.split(jax.random.PRNGKey(7))[0],
                              want_lat.shape, jnp.float32)

    pipe = EditPipeline(tb, controls=("sam", "inpaint"), inpaint_mode="blend")
    got_lat = pipe(**args, return_latents=True, noise=np.asarray(noise))
    got_img = pipe(**args, noise=np.asarray(noise))

    assert got_lat.shape == want_lat.shape == (2, 8, 8, 4)
    assert np.abs(want_lat).max() > 0.1
    np.testing.assert_allclose(got_lat, want_lat, atol=LATENT_TOL, rtol=0)
    assert got_img.dtype == np.uint8 and got_img.shape == (2, 64, 64, 3)
    diff = np.abs(got_img.astype(np.int32) - want_img.astype(np.int32))
    assert diff.max() <= IMAGE_LEVELS
    assert pipe.last_nonfinite == 0


def test_random_bundle_edit_draws_from_explicit_generator():
    args = _edit_args()
    pipe = EditPipeline(random_bundle(tiny=True, device="cpu",
                                      generator=torch.Generator().manual_seed(0)))
    a = pipe(**args, generator=torch.Generator().manual_seed(3))
    b = pipe(**args, generator=torch.Generator().manual_seed(3))
    c = pipe(**args, generator=torch.Generator().manual_seed(4))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("size", [(40, 60), (8, 12), (13, 17), (20, 30)])
def test_resize_helpers_match_jax_image_resize(size):
    x = np.random.default_rng(0).uniform(0, 1, (1, 3, 20, 30)).astype(np.float32)
    want_near = jax.image.resize(jnp.asarray(x), (1, 3) + size, method="nearest")
    want_bil = jax.image.resize(jnp.asarray(x), (1, 3) + size, method="bilinear")
    got_near = resize_nearest(torch.from_numpy(x), size)
    got_bil = resize_bilinear(torch.from_numpy(x), size)
    np.testing.assert_array_equal(got_near.numpy(), np.asarray(want_near))
    np.testing.assert_allclose(got_bil.numpy(), np.asarray(want_bil),
                               atol=1e-5, rtol=0)


def test_port_imports_no_jax():
    """Importing every module of the port, and running a one-step tiny edit
    and a tiny caption (which make the lazy imports too), loads neither
    jax, nor triton, nor any module of the JAX package."""
    code = ("import importlib, pkgutil, sys\n"
            "import numpy as np, torch\n"
            "import editanything_tpu_torch as pkg\n"
            "from editanything_tpu_torch.pipelines.bundle import random_bundle\n"
            "from editanything_tpu_torch.pipelines.edit import EditPipeline\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "img = np.zeros((64, 64, 3), np.uint8)\n"
            "pipe = EditPipeline(random_bundle(tiny=True, device='cpu'))\n"
            "args = dict(image=img, mask=img[..., 0], prompt='a cat',\n"
            "            condition_image=img, image_resolution=64, num_steps=1)\n"
            "out = pipe(**args)\n"
            "assert out.shape == (1, 64, 64, 3), out.shape\n"
            "import os\n"
            "os.environ['EA_RESNET_FUSED'] = '1'\n"
            "fused = pipe(**args)\n"
            "assert np.abs(fused.astype(int) - out.astype(int)).max() <= 2\n"
            "from editanything_tpu_torch.models.blip2 import tiny_blip2_config\n"
            "from editanything_tpu_torch.pipelines.bundle import random_blip2\n"
            "from editanything_tpu_torch.pipelines.captioner import Captioner\n"
            "from editanything_tpu_torch.text.tokenizer import tiny_gpt2_tokenizer\n"
            "cap = Captioner(random_blip2(tiny_blip2_config(), device='cpu'),\n"
            "                tiny_gpt2_tokenizer(), max_new_tokens=2)\n"
            "assert len(cap(img[None])) == 1\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'triton', 'editanything_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
