"""The port's tile refinement, img2img and sketch pipelines against the
JAX package.

``EditPipeline.tile_refine`` in the set-up of the golden ``tile`` case
(tests/test_golden_regression.py::_run_tile) and with 2 samples, a partial
mask and its encode and decode tiled (``vae_oneshot_max_px`` lowered);
``EditAnythingEditor.process(enable_tile=True)``; ``Img2ImgPipeline`` in
the golden ``img2img`` case's set-up, with the VAE tiled, at a strength
whose step count Python's ``round`` takes to the even side, and without a
ControlNet; the sketch helpers on seeded sketches; ``SketchPipeline``.

The bundle is tests/test_torch_edit_modes.py's tiny SD1.5 bundle with a
third ControlNet, "tile", drawn after the other two by the port's
``random_bundle`` and carried to the JAX package's trees. The JAX
pipelines draw their noise inside; the same arrays are drawn here with
``jax.random`` and handed to the port. The JAX side runs through its plain
references (its Pallas kernels switched off for this module). Bounds,
those of tests/test_torch_edit_modes.py: images 2 uint8 levels (these JAX
entry points return images only); the sketch helpers exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.pipelines import EditPipeline as JaxEditPipeline
from editanything_tpu.pipelines import sketch as JS
from editanything_tpu.pipelines.editor import EditAnythingEditor as JaxEditor
from editanything_tpu.pipelines.img2img import Img2ImgPipeline as JaxImg2Img
from editanything_tpu_torch.pipelines import sketch as TS
from editanything_tpu_torch.pipelines.bundle import random_bundle
from editanything_tpu_torch.pipelines.edit import EditPipeline
from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
from editanything_tpu_torch.pipelines.img2img import Img2ImgPipeline

from test_torch_edit_modes import _checker_image, _mask, jax_draws, jax_twin

IMAGE_LEVELS = 2
STEPS = 3
SEED = 5
# a 128^2 image in 3 x 3 tiles of 8^2 latents overlapping by 4; a 64^2 one
# in 2 x 2 tiles of 4^2 latents overlapping by 2
TILED_128 = dict(vae_oneshot_max_px=64, vae_tile_latent=8, vae_tile_overlap=4)
TILED_64 = dict(vae_oneshot_max_px=32, vae_tile_latent=4, vae_tile_overlap=2)


@pytest.fixture(scope="module", autouse=True)
def jax_plain_references():
    saved = JFA._DISABLED, JK._DISABLED
    JFA._DISABLED = JK._DISABLED = True
    yield
    JFA._DISABLED, JK._DISABLED = saved


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tiny edits on one thread: beside the other test workers
    on a shared CPU, a thread pool per process oversubscribes the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def sd15_tile():
    tb = random_bundle(tiny=True, device="cpu", family="sd15",
                       generator=torch.Generator().manual_seed(3),
                       controlnet_names=("sam", "inpaint", "tile"))
    return tb, jax_twin(tb)


def _normal(seed, shape, key=None):
    key = jax.random.PRNGKey(seed) if key is None else key
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _levels(got, want):
    return int(np.abs(np.asarray(got).astype(np.int32)
                      - np.asarray(want).astype(np.int32)).max())


def _with(pipe, attrs):
    for name, value in attrs.items():
        setattr(pipe, name, value)
    return pipe


def test_random_bundle_appends_the_tile_controlnet(sd15_tile):
    """"tile" is drawn after "sam" and "inpaint", whose weights stay those
    of the default bundle from the same seed."""
    tb, _ = sd15_tile
    base = random_bundle(tiny=True, device="cpu", family="sd15",
                         generator=torch.Generator().manual_seed(3))
    assert list(tb.controlnets) == ["sam", "inpaint", "tile"]
    assert tb.controlnets["tile"][0] == tb.controlnets["sam"][0]
    for name in ("sam", "inpaint"):
        for (k, a), b in zip(tb.controlnets[name][1].state_dict().items(),
                             base.controlnets[name][1].state_dict().values()):
            assert torch.equal(a, b), (name, k)
    assert not torch.equal(tb.controlnets["tile"][1].conv_in.weight,
                           tb.controlnets["sam"][1].conv_in.weight)


# --- tile refinement ---------------------------------------------------------

@pytest.mark.parametrize("case", ["golden", "tiled vae, 2 samples"])
def test_tile_refine_matches_jax(sd15_tile, case):
    tb, jb = sd15_tile
    if case == "golden":
        imgs = np.stack([_checker_image(64, 64)])
        mask = np.full((64, 64), 255, np.uint8)
        tiled, seed = {}, 19
    else:
        imgs = np.stack([_checker_image(64, 64), _checker_image(64, 64)[::-1]])
        mask = _mask()
        tiled, seed = TILED_128, SEED
    args = dict(tile_control="tile", negative_prompt="blurry",
                refine_image_resolution=128, num_steps=STEPS,
                guidance_scale=7.0, alignment_ratio=0.9, seed=seed)
    want = _with(JaxEditPipeline(jb), tiled).tile_refine(
        imgs, mask, "sharp detail", **args)
    pipe = _with(EditPipeline(tb), tiled)
    got = pipe.tile_refine(imgs, mask, "sharp detail", **args,
                           noise=_normal(seed, (len(imgs), 16, 16, 4)))
    assert len(got) == len(want) == len(imgs)
    assert got[0].shape == (128, 128, 3) and got[0].dtype == np.uint8
    assert _levels(np.stack(got), np.stack(want)) <= IMAGE_LEVELS
    assert pipe.last_nonfinite == 0


def test_process_enable_tile_matches_jax(sd15_tile):
    """``process`` returns the tile pass's images first; the tile pass
    runs UniPC at the edit's steps and CFG, from its own noise."""
    tb, jb = sd15_tile
    args = dict(image=_checker_image(64, 64), mask=_mask(), prompt="a red cat",
                a_prompt="best quality", n_prompt="blurry",
                condition_image=_checker_image(64, 64)[::-1], num_samples=2,
                image_resolution=64, ddim_steps=STEPS, scale=7.5, seed=SEED,
                alignment_ratio=0.7, enable_tile=True,
                refine_image_resolution=128, refine_alignment_ratio=0.9)
    want_tile, want, _, _ = JaxEditor(jb).process(**args)
    editor = EditAnythingEditor(tb)
    assert editor.tile_control == "tile"
    draws = jax_draws((2, 8, 8, 4), STEPS, SEED)
    got_tile, got, (cond, mask), positive = editor.process(
        **args, **draws, tile_noise=_normal(SEED, (2, 16, 16, 4)))
    assert positive == "a red cat, best quality"
    assert len(got_tile) == 2 and got_tile[0].shape == (128, 128, 3)
    assert _levels(np.stack(got), np.stack(want)) <= IMAGE_LEVELS
    assert _levels(np.stack(got_tile), np.stack(want_tile)) <= IMAGE_LEVELS
    assert editor.last_nonfinite == 0
    # without a tile ControlNet, or without enable_tile, there is no pass
    no_tile = EditAnythingEditor(tb, tile_control="none")
    assert no_tile.tile_control is None
    assert no_tile.process(**args, **draws)[0] == []
    assert editor.process(**dict(args, enable_tile=False), **draws)[0] == []


# --- img2img -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["golden", "tiled vae, strength 0.5",
                                  "no controlnet"])
def test_img2img_matches_jax(sd15_tile, case):
    """The golden case runs round(0.6 x 5) = 3 steps; strength 0.5 runs
    round(2.5) = 2 (Python rounds halves to even), with the encode and
    decode tiled; the last case has no condition image."""
    tb, jb = sd15_tile
    args = dict(image=_checker_image(96, 96), prompt="a boat", strength=0.6,
                condition_image=_checker_image(64, 64), image_resolution=64,
                num_steps=5, guidance_scale=7.5, seed=23)
    tiled = {}
    if case == "tiled vae, strength 0.5":
        args.update(strength=0.5, num_samples=2)
        tiled = TILED_64
    elif case == "no controlnet":
        args.update(condition_image=None, strength=1.0, num_steps=2)
    want = _with(JaxImg2Img(jb, controlnet="sam"), tiled)(**args)
    n = args.get("num_samples", 1)
    noise = _normal(0, (n, 8, 8, 4),
                    key=jax.random.split(jax.random.PRNGKey(23))[1])
    pipe = _with(Img2ImgPipeline(tb, controlnet="sam"), tiled)
    got = pipe(**args, noise=noise)
    assert got.shape == want.shape == (n, 64, 64, 3)
    assert _levels(got, want) <= IMAGE_LEVELS and pipe.last_nonfinite == 0


def test_img2img_rejects_strength_out_of_range(sd15_tile):
    tb, _ = sd15_tile
    with pytest.raises(ValueError, match="strength"):
        Img2ImgPipeline(tb)(image=_checker_image(64, 64), prompt="x",
                            strength=0.0, image_resolution=64)


# --- sketch ----------------------------------------------------------------

def _sketch(seed, size=64):
    """A palette sketch on white: rectangles and discs of a few colours,
    some touched up with a near-duplicate or a half-alpha shade, and a few
    stray pixels of rare colours."""
    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 255, np.uint8)
    palette = rng.integers(0, 200, (4, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    for i, c in enumerate(palette):
        y0, x0 = rng.integers(0, size - 16, 2)
        if i % 2:
            img[(yy - y0 - 8) ** 2 + (xx - x0 - 8) ** 2 < 64] = c
        else:
            img[y0:y0 + 16, x0:x0 + 20] = c
    near = np.clip(palette[0].astype(int) + 6, 0, 255).astype(np.uint8)
    img[:4, :6] = near
    img[-3:, -5:] = np.array(JS.opaque_color_on_white(palette[1], 0.5), np.uint8)
    img[rng.integers(0, size, 3), rng.integers(0, size, 3)] = (1, 2, 3)
    return img


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sketch_helpers_equal_jax(seed):
    img = _sketch(seed)
    assert TS.high_freq_colors(img) == JS.high_freq_colors(img)
    assert TS.high_freq_colors(img, 5.0) == JS.high_freq_colors(img, 5.0)
    for colors in (None, [(255, 255, 255)] + JS.high_freq_colors(img)[::-1]):
        for got, want in zip(TS.sketch_condition(img, colors),
                             JS.sketch_condition(img, colors)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    palette = JS.high_freq_colors(img)
    np.testing.assert_array_equal(TS.quantize_to_palette(img, palette),
                                  JS.quantize_to_palette(img, palette))
    c1, c2 = tuple(int(v) for v in img[5, 5]), (10, 200, 30)
    assert TS.color_distance(c1, c2) == JS.color_distance(c1, c2)
    assert TS.opaque_color_on_white(c2, 0.3) == JS.opaque_color_on_white(c2, 0.3)


def test_sketch_pipeline_matches_jax(sd15_tile):
    tb, jb = sd15_tile
    sketch = _sketch(4)
    args = dict(sketch=sketch, prompt="a garden", image_resolution=64,
                num_steps=STEPS, guidance_scale=7.5, seed=SEED)
    want = JS.SketchPipeline(jb)(**args)
    pipe = TS.SketchPipeline(tb)
    got = pipe(**args, noise=_normal(SEED, (1, 8, 8, 4)))
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert _levels(got, want) <= IMAGE_LEVELS and pipe.gen.last_nonfinite == 0
    # the scale map counts: without it the image changes
    off = pipe(**args, noise=_normal(SEED, (1, 8, 8, 4)), use_scale_map=False)
    assert _levels(off, got) > 0
