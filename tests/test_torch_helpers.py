"""Two small helpers of the port against the JAX package's.

- ``utils/image.py::get_bounding_box``: the reference's swapped axes kept,
  on masks of several shapes (2-D, 3-channel, one pixel, full) equal to
  JAX's; an empty mask raises IndexError on both sides.
- ``engine/prompts.py::encode_windows``: a (2, 77) window batch through a
  tiny CLIP text tower (fp32, its 77 positions), with and without a layer
  skip, within 1e-5 of JAX's (fp32 sums in other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.engine import prompts as JP
from editanything_tpu.utils import image as JI
from editanything_tpu_torch.engine import prompts as P
from editanything_tpu_torch.models import config as C
from editanything_tpu_torch.models.clip_text import CLIPTextModel
from editanything_tpu_torch.pipelines.bundle import _empty, init_weights_
from editanything_tpu_torch.utils import image as I

from test_torch_edit_modes import _jax_config, _tree

WINDOW_TOL = 1e-5


def _masks():
    rng = np.random.default_rng(0)
    box = np.zeros((40, 60), np.uint8)
    box[5:17, 20:51] = 1
    dot = np.zeros((30, 30), bool)
    dot[29, 3] = True
    three = np.zeros((24, 32, 3), np.uint8)
    three[2:9, 4:30, 0] = 255
    three[:, :, 1] = 255           # only channel 0 is read
    return {"box": box, "dot": dot, "three_channels": three,
            "full": np.ones((8, 12), np.float32),
            "scattered": (rng.uniform(size=(50, 40)) > 0.97).astype(np.uint8)}


@pytest.mark.parametrize("name", sorted(_masks()))
def test_get_bounding_box_matches_jax(name):
    mask = _masks()[name]
    got = I.get_bounding_box(mask)
    assert got == JI.get_bounding_box(mask)
    assert all(type(v) is int for v in got)


def test_get_bounding_box_of_an_empty_mask_raises_as_jax():
    empty = np.zeros((16, 16), np.uint8)
    with pytest.raises(IndexError):
        JI.get_bounding_box(empty)
    with pytest.raises(IndexError):
        I.get_bounding_box(empty)


@pytest.mark.parametrize("layer_skip", [None, 1])
def test_encode_windows_matches_jax(layer_skip):
    cfg = C.CLIPTextConfig(vocab_size=2000, hidden_size=32,
                           intermediate_size=64, num_layers=2, num_heads=4,
                           max_position_embeddings=77)
    text = init_weights_(_empty(CLIPTextModel, cfg, "cpu", torch.float32),
                         torch.Generator().manual_seed(2))
    params = _tree(text, embedding_modules=("token_embedding",
                                            "position_embedding"))
    ids = np.random.default_rng(1).integers(0, 2000, (2, 77), np.int32)
    want = JP.encode_windows(params, _jax_config(cfg), jnp.asarray(ids),
                             layer_skip=layer_skip)
    with torch.no_grad():
        got = P.encode_windows(text, torch.from_numpy(ids).long(),
                               layer_skip=layer_skip)
    assert got.shape == want.shape == (1, 2 * 77, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=WINDOW_TOL)
