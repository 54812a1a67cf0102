"""The port's high-resolution pieces against the JAX package and PIL: the
tile helpers, the tiled VAE, txt2img and an edit whose encode and decode
run tiled, and ``resize_image`` without PIL.

The tile helpers (``_tile_starts``, ``_ramp``, ``_tile_plan``,
``_blend_weight``) must equal JAX's exactly. ``decode_tiled`` and
``encode_tiled`` run a tiny VAE (tests/test_vae_tiled.py's widths) drawn by
the port and carried to the JAX package's tree by its
``state_dict_to_tree``, at non-square sizes where one side fits a tile and
the other ends on a clamped tile; fp32, within 1e-4 (fp32 convs summed in
other orders; outputs of magnitude ~1). The pipelines lower
``vae_oneshot_max_px`` as tests/test_vae_tiled.py does, so 64^2 images
encode and decode in 2 x 2 tiles; their bounds are those of
tests/test_torch_edit_modes.py: final latents 1e-3, images 2 uint8
levels. The JAX pipeline's draws are handed to the port, and the JAX side
runs through its plain references (its Pallas kernels switched off for
this module). ``resize_image`` must equal PIL's
``Image.resize`` (LANCZOS up, BOX down) to the level.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.models import vae as JV
from editanything_tpu.pipelines import EditPipeline as JaxEditPipeline
from editanything_tpu.pipelines import GenerationPipeline as JaxGeneration
from editanything_tpu_torch.models import config as TC
from editanything_tpu_torch.models import vae as TV
from editanything_tpu_torch.pipelines.bundle import (_empty, init_weights_,
                                                     random_bundle)
from editanything_tpu_torch.pipelines.edit import EditPipeline
from editanything_tpu_torch.pipelines.generate import GenerationPipeline
from editanything_tpu_torch.utils.image import resize_image

from test_torch_edit_modes import (_checker_image, _jax_config, _mask, _tree,
                                   jax_draws, jax_twin)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VAE_TOL = 1e-4
LATENT_TOL = 1e-3
IMAGE_LEVELS = 2
STEPS = 3
SEED = 5
# a 64^2 image in 2 x 2 tiles of 4^2 latents overlapping by 2
TILED = dict(vae_oneshot_max_px=32, vae_tile_latent=4, vae_tile_overlap=2)
VAE_CFG = TC.VAEConfig(block_out_channels=(8, 16, 16, 32), latent_channels=4,
                       layers_per_block=1, norm_num_groups=4)


@pytest.fixture(scope="module", autouse=True)
def jax_plain_references():
    saved = JFA._DISABLED, JK._DISABLED
    JFA._DISABLED = JK._DISABLED = True
    yield
    JFA._DISABLED, JK._DISABLED = saved


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny models on one thread: beside the other test workers
    on a shared CPU, a thread pool per process oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def vae():
    tv = init_weights_(_empty(TV.AutoencoderKL, VAE_CFG, torch.device("cpu"),
                              torch.float32),
                       torch.Generator().manual_seed(2))
    return tv, _tree(tv), _jax_config(VAE_CFG)


@pytest.fixture(scope="module")
def sd15():
    tb = random_bundle(tiny=True, device="cpu", family="sd15",
                       generator=torch.Generator().manual_seed(3))
    return tb, jax_twin(tb)


def _tiled(pipe):
    for name, value in TILED.items():
        setattr(pipe, name, value)
    return pipe


def _levels(got, want):
    return int(np.abs(np.asarray(got).astype(np.int32)
                      - np.asarray(want).astype(np.int32)).max())


# --- the tile helpers ----------------------------------------------------------

@pytest.mark.parametrize("size,tile,stride", [
    (64, 128, 96), (512, 128, 96), (40, 16, 8), (288, 128, 96),
    (2304, 1024, 768), (100, 30, 7)])
def test_tile_starts_equal_jax(size, tile, stride):
    assert TV._tile_starts(size, tile, stride) == JV._tile_starts(size, tile,
                                                                  stride)


@pytest.mark.parametrize("tile_px,ov_px", [(16, 4), (1024, 256), (7, 0),
                                           (128, 32)])
def test_ramp_equals_jax(tile_px, ov_px):
    np.testing.assert_array_equal(TV._ramp(tile_px, ov_px),
                                  JV._ramp(tile_px, ov_px))


@pytest.mark.parametrize("h,w,tile,overlap", [
    (12, 40, 16, 8), (40, 12, 16, 8), (288, 288, 128, 32),
    (2304, 2304, 1024, 256), (128, 128, 128, 32), (100, 250, 64, 16)])
def test_tile_plan_and_blend_weight_equal_jax(h, w, tile, overlap):
    got = TV._tile_plan(h, w, tile, overlap)
    want = JV._tile_plan(h, w, tile, overlap)
    assert got[:4] == tuple(want[:4])
    np.testing.assert_array_equal(np.asarray(got[4], np.int32).reshape(-1, 2),
                                  want[4])
    th, tw, ov_h, ov_w = got[:4]
    np.testing.assert_array_equal(
        TV._blend_weight(th, tw, ov_h, ov_w).numpy(),
        np.asarray(JV._blend_weight(th, tw, ov_h, ov_w))[..., 0])


# --- the tiled VAE ---------------------------------------------------------

@pytest.mark.parametrize("hw", [(12, 40), (40, 12)])
def test_decode_tiled_matches_jax(vae, hw):
    """One side fits the 16-latent tile, the other ends on a clamped tile;
    the tiled decode differs from the one-shot one (per-tile GroupNorm)."""
    tv, tree, cfg = vae
    z = np.random.default_rng(7).standard_normal((2, *hw, 4)).astype(
        np.float32) * 0.5
    want = np.asarray(JV.decode_tiled(tree, cfg, jnp.asarray(z), tile=16,
                                      overlap=8))
    with torch.no_grad():
        zt = torch.from_numpy(z).permute(0, 3, 1, 2)
        got = TV.decode_tiled(tv, zt, tile=16, overlap=8)
        oneshot = tv.decode(zt)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 8 * hw[0], 8 * hw[1], 3)
    np.testing.assert_allclose(got, want, atol=VAE_TOL, rtol=0)
    assert np.abs(got - oneshot.permute(0, 2, 3, 1).numpy()).max() > 10 * VAE_TOL


def test_encode_tiled_matches_jax(vae):
    tv, tree, cfg = vae
    x = np.random.default_rng(8).uniform(-1, 1, (1, 96, 320, 3)).astype(
        np.float32)
    want = JV.encode_tiled(tree, cfg, jnp.asarray(x), tile=128, overlap=64)
    with torch.no_grad():
        got = TV.encode_tiled(tv, torch.from_numpy(x).permute(0, 3, 1, 2),
                              tile=128, overlap=64)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (1, 4, 12, 40)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=VAE_TOL, rtol=0)
    with pytest.raises(ValueError, match="multiples of 8"):
        TV.encode_tiled(tv, torch.zeros(1, 3, 200, 200), tile=100, overlap=50)


def test_latent_entry_points_switch_on_tile(vae):
    """encode_to_latents / decode_from_latents: one-shot without `tile`,
    tiled with it, one-shot again where one tile covers the input."""
    tv, _, _ = vae
    g = torch.Generator().manual_seed(9)
    x = torch.rand(1, 3, 64, 128, generator=g) * 2 - 1
    z = torch.randn(1, 4, 8, 16, generator=g)
    with torch.no_grad():
        lat = tv.encode_to_latents(x)
        torch.testing.assert_close(
            lat, tv.encode(x).mean * VAE_CFG.scaling_factor, rtol=0, atol=0)
        torch.testing.assert_close(tv.encode_to_latents(x, tile=128), lat,
                                   rtol=0, atol=0)
        tiled = tv.encode_to_latents(x, tile=64, overlap=32)
        torch.testing.assert_close(
            tiled, TV.encode_tiled(tv, x, 64, 32).mean * VAE_CFG.scaling_factor,
            rtol=0, atol=0)
        img = tv.decode_from_latents(z)
        torch.testing.assert_close(tv.decode_from_latents(z, tile=16), img,
                                   rtol=0, atol=0)
        torch.testing.assert_close(
            tv.decode_from_latents(z, tile=8, overlap=4),
            TV.decode_tiled(tv, z / VAE_CFG.scaling_factor, 8, 4),
            rtol=0, atol=0)


# --- the pipelines through the tiled VAE -----------------------------------

def test_decode_tile_spec_switches_above_the_bound(sd15):
    tb, _ = sd15
    pipe = GenerationPipeline(tb)
    assert pipe._decode_tile_spec(2048, 1024) is None
    assert pipe._decode_tile_spec(2048, 2112) == (128, 32)
    assert _tiled(pipe)._decode_tile_spec(64, 64) == (4, 2)
    assert pipe._decode_tile_spec(32, 32) is None


def test_txt2img_through_tiled_vae_matches_jax(sd15):
    """The port's txt2img decodes tiled above ``vae_oneshot_max_px``, as
    JAX's (ROADMAP Queue 3's fault): the images, and the port's tiled
    decode of its final latents against JAX's of the same latents."""
    tb, jb = sd15
    args = dict(prompt="a house", condition_image=_checker_image(64, 64),
                num_samples=2, image_resolution=64, num_steps=STEPS,
                guidance_scale=7.5, seed=SEED)
    want = _tiled(JaxGeneration(jb, controlnet="sam"))(**args)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(SEED),
                                         (2, 8, 8, 4), jnp.float32))
    pipe = _tiled(GenerationPipeline(tb, controlnet="sam"))
    got = pipe(**args, noise=noise)
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert _levels(got, want) <= IMAGE_LEVELS and pipe.last_nonfinite == 0
    lat = pipe(**args, noise=noise, return_latents=True)
    want_img = np.asarray(JV.decode_from_latents(
        jb.vae, jb.vae_cfg, jnp.asarray(lat), tile=4, overlap=2))
    with torch.no_grad():
        got_img = tb.vae.decode_from_latents(
            torch.from_numpy(lat).permute(0, 3, 1, 2), tile=4, overlap=2)
    np.testing.assert_allclose(got_img.permute(0, 2, 3, 1).numpy(), want_img,
                               atol=VAE_TOL, rtol=0)
    oneshot = GenerationPipeline(tb, controlnet="sam")(**args, noise=noise)
    assert _levels(oneshot, got) > IMAGE_LEVELS


def test_edit_through_tiled_vae_matches_jax(sd15):
    """The edit's tiled encode (latents) and tiled decode (images)."""
    tb, jb = sd15
    args = dict(image=_checker_image(64, 64), mask=_mask(), prompt="a red cat",
                condition_image=_checker_image(64, 64)[::-1],
                negative_prompt="blurry", num_samples=2, image_resolution=64,
                num_steps=STEPS, guidance_scale=7.5, control_scale=0.7,
                alignment_ratio=0.75, seed=SEED)
    jpipe = _tiled(JaxEditPipeline(jb))
    want_lat = np.asarray(jpipe(**args, return_latents=True), np.float32)
    want = jpipe(**args)
    draws = jax_draws(want_lat.shape, STEPS, SEED)
    pipe = _tiled(EditPipeline(tb))
    got_lat = pipe(**args, **draws, return_latents=True)
    got = pipe(**args, **draws)
    np.testing.assert_allclose(got_lat, want_lat, atol=LATENT_TOL, rtol=0)
    assert np.abs(want_lat).max() > 0.1
    assert _levels(got, want) <= IMAGE_LEVELS and pipe.last_nonfinite == 0


# --- resize_image without PIL ------------------------------------------------

@pytest.mark.parametrize("h,w,resolution", [
    (64, 96, 128), (96, 64, 200), (100, 160, 512), (512, 384, 1024),
    (300, 200, 100), (200, 331, 64), (97, 131, 77)])
def test_resize_image_equals_pil(h, w, resolution):
    """LANCZOS when upscaling, BOX when downscaling, non-square, on a smooth
    image with noise (overshoots that clip) and on pure noise."""
    rng = np.random.default_rng(h * w + resolution)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1),
                       ((xx // 5 + yy // 7) % 2) * 255], -1)
    for img in (np.clip(smooth + rng.integers(-20, 21, (h, w, 3)), 0, 255),
                rng.integers(0, 256, (h, w, 3))):
        img = img.astype(np.uint8)
        got = resize_image(img, resolution)
        k = resolution / min(h, w)
        size = (int(np.round(w * k / 64.0)) * 64, int(np.round(h * k / 64.0)) * 64)
        want = np.asarray(Image.fromarray(img).resize(
            size, Image.LANCZOS if k > 1 else Image.BOX))
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    gray = img[..., 0]
    np.testing.assert_array_equal(resize_image(gray, resolution), np.asarray(
        Image.fromarray(gray).resize(size, Image.LANCZOS if k > 1
                                     else Image.BOX)))
    same = rng.integers(0, 256, (64, 128, 3), dtype=np.uint8)
    assert resize_image(same, 64) is same


def test_port_high_resolution_paths_import_no_pil_or_jax():
    """Tile refinement with an upscale, img2img and a sketch in a fresh
    process load neither PIL, nor jax, nor the JAX package."""
    code = ("import sys\n"
            "import numpy as np\n"
            "from editanything_tpu_torch.pipelines.bundle import random_bundle\n"
            "from editanything_tpu_torch.pipelines.edit import EditPipeline\n"
            "from editanything_tpu_torch.pipelines.img2img import Img2ImgPipeline\n"
            "from editanything_tpu_torch.pipelines.sketch import SketchPipeline\n"
            "b = random_bundle(tiny=True, device='cpu',\n"
            "                  controlnet_names=('sam', 'inpaint', 'tile'))\n"
            "img = np.random.default_rng(0).integers(0, 256, (48, 48, 3), np.uint8)\n"
            "out = EditPipeline(b).tile_refine(img[None], img[..., 0], 'x',\n"
            "    refine_image_resolution=128, num_steps=1)\n"
            "assert out[0].shape == (128, 128, 3), out[0].shape\n"
            "out = Img2ImgPipeline(b)(image=img, prompt='x', image_resolution=64,\n"
            "                         num_steps=2)\n"
            "assert out.shape == (1, 64, 64, 3), out.shape\n"
            "out = SketchPipeline(b)(sketch=img, prompt='x', image_resolution=64,\n"
            "                        num_steps=1)\n"
            "assert out.shape == (1, 64, 64, 3), out.shape\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('PIL', 'jax', 'jaxlib', 'editanything_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
