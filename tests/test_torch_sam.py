"""The port's SAM (editanything_tpu_torch.models.sam and the two SAM kernel
twins) against the JAX package's, with the same weights.

Weights: the port's ``random_sam`` (every parameter drawn nonzero, rel-pos
tables and biases included) at the tiny config of tests/test_sam.py, carried
to the JAX tree by the JAX package's own checkpoint converter (``sam_to_tree``
of the state dict, official SAM names). The JAX side runs its Pallas
kernels in interpret mode (conftest).

Tolerances (fp32):
- config fields, state-dict names and the converter round trip: exact;
- image encoder 1e-4 absolute on outputs of magnitude ~1-4 (LayerNorm2d
  outputs; two fp32 ViT blocks and a neck summed in other orders);
- prompt encoder 1e-5 (sin/cos of fp32 products of the same inputs);
- mask decoder 1e-5 absolute on logits and IoUs of magnitude ~0.2-0.5 (the
  tiny random decoder's; fp32 sums in other orders);
- kernel twins: two-way transformer 1e-4 on outputs of magnitude ~1-4
  (LayerNorm outputs), upscale + hypernetwork 1e-4 on logits of magnitude
  ~1-10: fp32 products of the same values summed in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.checkpoints.convert import sam_to_tree
from editanything_tpu.core import kernels as JK
from editanything_tpu.models import sam as JS
from editanything_tpu_torch.checkpoints.convert import sam_state_dict_from_tree
from editanything_tpu_torch.core import kernels as TK
from editanything_tpu_torch.models import sam as TS
from editanything_tpu_torch.pipelines.bundle import random_sam

from sam_replica import Sam as ReplicaSam

ENC_TOL = 1e-4
PROMPT_TOL = 1e-5
DEC_TOL = 1e-5
TWIN_TOL = 1e-4

JAX_TINY = JS.SAMConfig(
    img_size=64, patch_size=8, embed_dim=32, depth=2, num_heads=2,
    global_attn_indexes=(1,), window_size=4, out_chans=16,
    prompt_embed_dim=16, decoder_mlp_dim=32,
)


def port_sam_cfg(jcfg):
    return TS.SAMConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(jcfg)})


TINY = port_sam_cfg(JAX_TINY)


def to_tree(module):
    return sam_to_tree({k: v.detach().numpy()
                        for k, v in module.state_dict().items()})


@pytest.fixture(scope="module")
def pair():
    sam = random_sam(TINY, device="cpu",
                     generator=torch.Generator().manual_seed(3)).eval()
    return sam, to_tree(sam)


def _np(x):
    return x.detach().float().numpy()


# --- config and weights ----------------------------------------------------

@pytest.mark.parametrize("make", ["SAMConfig", "sam_vit_b", "sam_vit_l",
                                  "sam_vit_h"])
def test_config_mirrors_jax(make):
    jf = [(f.name, f.type) for f in dataclasses.fields(JS.SAMConfig)]
    tf = [(f.name, f.type) for f in dataclasses.fields(TS.SAMConfig)]
    assert jf == tf
    j, t = getattr(JS, make)(), getattr(TS, make)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.embedding_size == t.embedding_size


def test_jax_tree_loads_strictly_and_round_trips():
    tree = JS.init_sam(jax.random.PRNGKey(0), JAX_TINY)
    rng = np.random.default_rng(0)
    for blk in tree["image_encoder"]["blocks"].values():
        for k in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][k] = jnp.asarray(
                rng.normal(0, 0.5, blk["attn"][k].shape).astype(np.float32))
    sam = TS.Sam(TINY)
    sam.load_state_dict(sam_state_dict_from_tree(tree), strict=True)
    back = to_tree(sam)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    want, got = flat(tree), flat(back)
    assert set(want) == set(got)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))


def test_official_replica_state_dict_loads_strictly():
    replica = ReplicaSam(img_size=64, patch_size=8, embed_dim=32, depth=2,
                         num_heads=2, global_attn_indexes=(1,), window_size=4,
                         out_chans=16, decoder_heads=8, decoder_mlp_dim=32)
    sam = TS.Sam(TINY)
    result = sam.load_state_dict(replica.state_dict(), strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_random_sam_draws_every_parameter_nonzero(pair):
    sam, _ = pair
    for name, t in list(sam.named_parameters()) + list(sam.named_buffers()):
        assert (t != 0).all(), name


# --- modules ---------------------------------------------------------------

def test_image_encoder_matches_jax(pair):
    sam, tree = pair
    x = np.random.default_rng(1).normal(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(JS.image_encoder(tree["image_encoder"], JAX_TINY,
                                       jnp.asarray(x)))
    got = _np(sam.image_encoder(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want,
                               atol=ENC_TOL, rtol=0)


def test_preprocess_matches_jax():
    img = np.random.default_rng(2).integers(0, 256, (48, 64, 3), np.uint8)
    want = np.asarray(JS.preprocess(jnp.asarray(img), JAX_TINY))
    got = _np(TS.preprocess(torch.from_numpy(img), TINY))
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, atol=1e-6,
                               rtol=0)


def test_prompt_encoder_matches_jax_for_every_label(pair):
    sam, tree = pair
    coords = np.array([[[10.0, 20.0], [40.0, 5.0], [0.0, 0.0], [63.0, 1.0],
                        [31.5, 31.5]]], np.float32)
    labels = np.array([[1, 0, -1, 2, 3]], np.int64)
    want = np.asarray(JS.encode_points(tree["prompt_encoder"], JAX_TINY,
                                       jnp.asarray(coords),
                                       jnp.asarray(labels)))
    got = _np(sam.prompt_encoder.encode_points(torch.from_numpy(coords),
                                               torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, atol=PROMPT_TOL, rtol=0)
    want_pe = np.asarray(JS.dense_positional_encoding(tree["prompt_encoder"],
                                                      JAX_TINY))
    got_pe = _np(sam.prompt_encoder.dense_positional_encoding())
    np.testing.assert_allclose(got_pe.transpose(0, 2, 3, 1), want_pe,
                               atol=PROMPT_TOL, rtol=0)


@pytest.mark.parametrize("shared", [True, False])
@torch.no_grad()
def test_mask_decoder_matches_jax(pair, shared):
    """shared: the dense prompt of batch 1, which takes the two-way kernel
    path on both sides; otherwise the plain per-prompt blocks."""
    sam, tree = pair
    rng = np.random.default_rng(4)
    b = 3
    emb = rng.normal(0, 1, (1, 8, 8, 16)).astype(np.float32)
    coords = rng.uniform(0, 64, (b, 2, 2)).astype(np.float32)
    labels = np.array([[1, -1], [0, 1], [2, 3]], np.int64)
    jpe = tree["prompt_encoder"]
    dense_b = 1 if shared else b
    want_m, want_i = JS.mask_decoder(
        tree["mask_decoder"], JAX_TINY, jnp.asarray(emb),
        JS.dense_positional_encoding(jpe, JAX_TINY),
        JS.encode_points(jpe, JAX_TINY, jnp.asarray(coords),
                         jnp.asarray(labels)),
        JS.no_mask_dense_embedding(jpe, JAX_TINY, dense_b))
    pe = sam.prompt_encoder
    got_m, got_i = sam.mask_decoder(
        torch.from_numpy(emb).permute(0, 3, 1, 2),
        pe.dense_positional_encoding(),
        pe.encode_points(torch.from_numpy(coords), torch.from_numpy(labels)),
        pe.no_mask_dense_embedding(dense_b))
    assert got_m.shape == (b, 4, 32, 32) and got_i.shape == (b, 4)
    assert np.abs(np.asarray(want_m)).max() > 0.1
    np.testing.assert_allclose(_np(got_m), np.asarray(want_m), atol=DEC_TOL,
                               rtol=0)
    np.testing.assert_allclose(_np(got_i), np.asarray(want_i), atol=DEC_TOL,
                               rtol=0)


# --- the kernel twins --------------------------------------------------------

@pytest.mark.parametrize("m", [64, 2 * TK.TWOWAY_ROW_TILE])
@pytest.mark.parametrize("n_tokens", [6, 21])
def test_twoway_twin_matches_pallas(pair, n_tokens, m):
    """T = 6 is the AMG's (5 output tokens + 1 point), T = 21 the click
    predictor's (5 + 16 padded point slots): padded to 8 and 24 inside the
    Pallas kernel, with the pad tokens masked. M = 64 and 2 x
    TWOWAY_ROW_TILE image rows hold the twin's merge of its token->image
    partials over 2 and 8 row tiles (32 rows each in fp32) to the Pallas
    kernel's softmax."""
    sam, tree = pair
    rng = np.random.default_rng(5)
    b, d = 3, 16
    src = rng.normal(0, 1, (1, m, d)).astype(np.float32)
    pe = rng.normal(0, 1, (1, m, d)).astype(np.float32)
    tokens = rng.normal(0, 1, (b, n_tokens, d)).astype(np.float32)
    want_q, want_k = JK.sam_twoway(tree["mask_decoder"]["transformer"],
                                   jnp.asarray(src), jnp.asarray(pe),
                                   jnp.asarray(tokens), heads=8)
    packed = sam.mask_decoder.pack_twoway()
    got_q, got_k = TK.sam_twoway(packed, torch.from_numpy(src),
                                 torch.from_numpy(pe[0]),
                                 torch.from_numpy(tokens))
    assert got_q.shape == (b, n_tokens, d) and got_k.shape == (b, m, d)
    np.testing.assert_allclose(_np(got_q), np.asarray(want_q), atol=TWIN_TOL,
                               rtol=0)
    np.testing.assert_allclose(_np(got_k), np.asarray(want_k), atol=TWIN_TOL,
                               rtol=0)
    # the residual fault of the first layer is visible at this size
    bad_q, _ = TK.sam_twoway_reference(
        packed, torch.from_numpy(src), torch.from_numpy(pe[0]),
        torch.from_numpy(tokens), first_layer_replaces=False)
    assert np.abs(_np(bad_q) - np.asarray(want_q)).max() > 100 * TWIN_TOL


def _upscale_inputs(rng, b, e, c):
    src = rng.normal(0, 1, (b, e * e, c)).astype(np.float32)
    hyper = rng.normal(0, 1, (b, 4, c // 8)).astype(np.float32)
    k1 = rng.normal(0, c ** -0.5, (2, 2, c, c // 4)).astype(np.float32)
    k2 = rng.normal(0, (c // 4) ** -0.5, (2, 2, c // 4, c // 8)).astype(np.float32)
    vec = lambda n, s, o=0.0: (o + rng.normal(0, s, (n,))).astype(np.float32)
    up = {"0": {"kernel": k1, "bias": vec(c // 4, 0.1)},
          "1": {"weight": vec(c // 4, 0.1, 1.0), "bias": vec(c // 4, 0.1)},
          "3": {"kernel": k2, "bias": vec(c // 8, 0.1)}}
    return src, hyper, up


@pytest.mark.parametrize("c,e", [(256, 16), (16, 8)])
def test_upscale_twin_matches_jax(c, e):
    """c = 256 takes the JAX Pallas kernel (its only width), c = 16 the JAX
    XLA path with its flipped taps; both must equal torch ConvTranspose2d
    semantics."""
    src, hyper, up = _upscale_inputs(np.random.default_rng(6), 2, e, c)
    want = np.asarray(JK.sam_upscale_hyper(
        jnp.asarray(src), jax.tree.map(jnp.asarray, up), jnp.asarray(hyper)))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = TK.sam_upscale_hyper(
        t(src), t(hyper), t(up["0"]["kernel"].transpose(2, 3, 0, 1)),
        t(up["0"]["bias"]), t(up["1"]["weight"]), t(up["1"]["bias"]),
        t(up["3"]["kernel"].transpose(2, 3, 0, 1)), t(up["3"]["bias"]))
    assert got.shape == (2, 4, 4 * e, 4 * e)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(_np(got), want, atol=TWIN_TOL, rtol=0)


@torch.no_grad()
def test_cpu_wrappers_count_no_launch(pair):
    sam, _ = pair
    before = (TK.sam_twoway.launches, TK.sam_upscale_hyper.launches)
    pe = sam.prompt_encoder
    sam.mask_decoder(torch.zeros(1, 16, 8, 8), pe.dense_positional_encoding(),
                     torch.zeros(2, 1, 16), pe.no_mask_dense_embedding(1))
    assert (TK.sam_twoway.launches, TK.sam_upscale_hyper.launches) == before


def test_twoway_packing_follows_the_kernel_order(pair):
    sam, _ = pair
    packed = sam.mask_decoder.pack_twoway()
    mats, vecs = TK._twoway_names(2)
    assert list(packed.mats) == mats and len(mats) == 2 * 14 + 4
    assert list(packed.vecs) == vecs and len(vecs) == 2 * 22 + 6
    lin1 = sam.mask_decoder.transformer.layers[1].mlp.lin1
    np.testing.assert_array_equal(_np(packed.mat("layers.1.mlp.lin1")),
                                  _np(lin1.weight))
    np.testing.assert_array_equal(_np(packed.vec("layers.1.mlp.lin1.bias")),
                                  _np(lin1.bias))
