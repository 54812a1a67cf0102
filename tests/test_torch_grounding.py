"""The port's text-grounded edit path against the JAX package's: BERT's
tokenizer, Swin, GroundingDINO (BERT with phrase masks, deformable
attention, the fusion block, the forward, the detector), PIL's BILINEAR
resize, ``remove_small_regions``, ``prompt2mask`` and
``TextGuidedEditPipeline``, at tiny widths in fp32.

Weights: one state dict in the official GroundingDINO layout, from
tests/dino_replica.py's module tree with every parameter drawn nonzero with
numpy from a seed, loads strictly into the port (``load_groundingdino``)
and goes through the JAX package's ``dino_to_tree``. The editors are the
port's tiny random bundle carried to JAX by tests/test_torch_edit_modes.py's
``jax_twin`` and a tiny SAM drawn by ``random_sam`` (tests/test_torch_sam.py).

Tolerances: tokens, phrase masks, the resize, ``remove_small_regions`` and
the selected query set exact; BERT, Swin, deformable attention and the
fusion block within 1e-5 of JAX's (fp32 sums in other orders, outputs of
magnitude 1-10); the forward's logits and boxes within 1e-4 (a 12-query
decoder over the encoder's outputs; the 12th and 13th selection scores
apart by more than 1e-3, so no tie decides the set); detector boxes within
1e-3 pixels, scores within 1e-5, phrases equal; masks equal except at
pixels whose upscaled SAM logit lies within 1e-5 of the threshold
(counted); edited images within 2 uint8 levels (tests/test_torch_editor.py's
bound).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from editanything_tpu.checkpoints.detectors import dino_to_tree
from editanything_tpu.core import flash_attention as JFA
from editanything_tpu.core import kernels as JK
from editanything_tpu.models import groundingdino as JG
from editanything_tpu.models import swin as JS
from editanything_tpu.perception import amg as JA
from editanything_tpu.perception import grounding as JGR
from editanything_tpu.pipelines.editor import EditAnythingEditor as JaxEditor
from editanything_tpu.text import tokenizer as JT
from editanything_tpu_torch.checkpoints.convert import (dino_state_dict,
                                                        swin_state_dict)
from editanything_tpu_torch.models import groundingdino as TG
from editanything_tpu_torch.models import swin as TS
from editanything_tpu_torch.perception import amg as TA
from editanything_tpu_torch.perception import grounding as TGR
from editanything_tpu_torch.pipelines.bundle import (load_groundingdino,
                                                     random_bundle,
                                                     random_groundingdino,
                                                     random_sam)
from editanything_tpu_torch.pipelines.editor import EditAnythingEditor
from editanything_tpu_torch.text import tokenizer as TT
from editanything_tpu_torch.utils.image import resize_pil

from dino_replica import TinyDINOReplica
from test_torch_edit_modes import jax_twin
from test_torch_editor import AMG, IMAGE_LEVELS, _near_threshold
from test_torch_sam import JAX_TINY, TINY, to_tree

TOL = 1e-5
FWD_TOL = 1e-4
BOX_PX_TOL = 1e-3
LOGIT_TOL = 1e-5
JTINY = JG.tiny_dino_config()
PTINY = TG.tiny_dino_config()
CAPTIONS = ["a dog", "A dog head. a cat.", "sofa?", "dogs, heads and a caT!"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def jax_plain_references():
    saved = JFA._DISABLED, JK._DISABLED
    JFA._DISABLED = JK._DISABLED = True
    yield
    JFA._DISABLED, JK._DISABLED = saved


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype=dtype)


def official_state_dict(seed: int) -> dict:
    """tests/dino_replica.py's official key layout at the tiny config, every
    parameter drawn with numpy: weights N(0, 1/fan_in), biases N(0, 0.1),
    norm scales 1 + N(0, 0.1), embeddings, the level embedding and the
    relative-position tables N(0, 0.5), the fusion gammas 0.3 + N(0, 0.1),
    the sampling-offset biases N(0, 1) (samples reach past the maps)."""
    cfg = JTINY
    torch.manual_seed(0)
    m = TinyDINOReplica(
        swin_dim=cfg.swin.embed_dim, swin_depths=cfg.swin.depths,
        swin_heads=cfg.swin.num_heads, swin_window=cfg.swin.window_size,
        d=cfg.hidden_dim, heads=cfg.nheads, ffn=cfg.dim_feedforward,
        levels=cfg.num_feature_levels, points=cfg.n_points,
        enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
        num_queries=cfg.num_queries, gn_groups=cfg.input_proj_groups,
        pe_temperature=cfg.pe_temperature).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in m.named_parameters():
            shape = tuple(p.shape)
            if ("embeddings." in name or "tgt_embed" in name
                    or name.endswith(("level_embed",
                                      "relative_position_bias_table"))):
                a = 0.5 * rng.standard_normal(shape)
            elif name.endswith(("gamma_v", "gamma_l")):
                a = 0.3 + 0.1 * rng.standard_normal(shape)
            elif name.endswith("sampling_offsets.bias"):
                a = rng.standard_normal(shape)
            elif len(shape) >= 2:
                a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
            elif name.endswith("bias"):
                a = 0.1 * rng.standard_normal(shape)
            else:
                a = 1.0 + 0.1 * rng.standard_normal(shape)
            p.copy_(torch.from_numpy(a.astype(np.float32)))
    return {k: v.detach().clone() for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def dino():
    sd = official_state_dict(11)
    tree = dino_to_tree({k: v.numpy() for k, v in sd.items()})
    model = load_groundingdino(sd, PTINY, device="cpu", dtype=torch.float32)
    return sd, tree, model


def _text(caption="a dog head. a cat."):
    tok = TT.tiny_bert_tokenizer()
    ids, mask, tokens = tok.encode_padded(caption, PTINY.max_text_len)
    self_mask, pos = TG.generate_text_masks(ids, (2, 3, 4))
    return ids, mask, self_mask, pos, tokens


# --- configs, tokenizer, resize -----------------------------------------------

def test_configs_mirror_jax():
    for jc, tc in ((JG.DINOConfig(), TG.DINOConfig()), (JTINY, PTINY),
                   (JS.swin_base(), TS.swin_base()),
                   (JS.swin_tiny(), TS.swin_tiny())):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (TG.BERT_SPECIAL_IDS, TG.IMAGENET_MEAN.tolist()) == (
        JG.BERT_SPECIAL_IDS, JG.IMAGENET_MEAN.tolist())


@pytest.mark.parametrize("caption", CAPTIONS + ["a " * 40])
def test_bert_tokenizer_matches_jax(caption, tmp_path):
    jt, tt = JT.tiny_bert_tokenizer(), TT.tiny_bert_tokenizer()
    assert tt.vocab == jt.vocab
    assert tt.tokenize(caption) == jt.tokenize(caption)
    for got, want in zip(tt.encode_padded(caption, 16),
                         jt.encode_padded(caption, 16)):
        np.testing.assert_array_equal(got, want)
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(sorted(jt.vocab, key=jt.vocab.get)) + "\n")
    assert TT.BertTokenizer.from_file(str(path)).vocab == \
        JT.BertTokenizer.from_file(str(path)).vocab == jt.vocab


@pytest.mark.parametrize("src,dst", [((80, 100), (64, 96)), ((480, 640),
                                                             (800, 1056)),
                                     ((37, 53), (11, 200)), ((64, 64),
                                                             (64, 32))])
def test_resize_bilinear_equals_pil(src, dst):
    img = np.random.RandomState(src[0]).randint(0, 256, src + (3,)) \
        .astype(np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR))
    np.testing.assert_array_equal(resize_pil(img, dst, "bilinear"), want)


def test_generate_text_masks_matches_jax():
    for caption in CAPTIONS:
        ids = _text(caption)[0]
        for got, want in zip(TG.generate_text_masks(ids, (2, 3, 4)),
                             JG.generate_text_masks(ids, (2, 3, 4))):
            np.testing.assert_array_equal(got, want)


# --- weights ------------------------------------------------------------------

def test_official_layout_loads_strictly_with_its_aliases(dino):
    """The official file's extra aliases (module. prefix, the five tied box
    MLPs, the decoder's view of them, BERT's pooler) load to the same
    parameters; the port's own names pass through."""
    sd, _, model = dino
    extra = {"module." + k: v for k, v in sd.items()}
    for k, v in sd.items():
        if k.startswith("bbox_embed.0."):
            extra["module.bbox_embed.3." + k[len("bbox_embed.0."):]] = v
            extra["module.transformer.decoder." + k] = v
    extra["module.bert.pooler.dense.weight"] = torch.zeros(16, 16)
    for alt in (extra, model.state_dict()):
        again = load_groundingdino(alt, PTINY, device="cpu",
                                   dtype=torch.float32)
        for k, v in model.state_dict().items():
            torch.testing.assert_close(again.state_dict()[k], v, rtol=0,
                                       atol=0)
    assert set(dino_state_dict(model.state_dict())) == set(model.state_dict())


def test_random_groundingdino_draws_every_parameter():
    model = random_groundingdino(PTINY, device="cpu", seed=3)
    again = random_groundingdino(PTINY, device="cpu", seed=3)
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k
    sd = model.state_dict()
    assert float(sd["transformer.encoder.fusion_layers.0.gamma_v"][0]) == \
        pytest.approx(1e-4)
    assert sd["transformer.encoder.layers.0.self_attn.sampling_offsets.bias"
              ].abs().max() > 0
    assert sd["backbone.layers.0.blocks.0.attn.relative_position_bias_table"
              ].abs().max() > 0


# --- modules ------------------------------------------------------------------

def test_bert_with_phrase_masks_matches_jax(dino):
    _, tree, model = dino
    ids, _, self_mask, pos, _ = _text()
    want = np.asarray(JG.bert_apply(tree["bert"], JTINY.bert,
                                    jnp.asarray(ids)[None],
                                    jnp.asarray(self_mask)[None],
                                    position_ids=jnp.asarray(pos)[None]))
    got = TG.bert_forward(model.bert, PTINY.bert, _t(ids, torch.long)[None],
                          _t(self_mask)[None],
                          position_ids=_t(pos, torch.long)[None])
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("hw", [(52, 76), (64, 64)])
def test_swin_matches_jax_at_padded_sizes(dino, hw):
    """52 x 76 -> 13 x 19 patches: stage 0 pads to 16 x 20 for window 4 and
    shifts; the later stages merge odd sides and stop shifting where the
    padded side is a single window."""
    _, tree, model = dino
    x = np.random.RandomState(1).randn(1, *hw, 3).astype(np.float32)
    want = jax.jit(lambda p, x: JS.apply(p, JTINY.swin, x))(
        tree["backbone"], jnp.asarray(x))
    with torch.no_grad():
        got = TS.swin_forward(model.backbone, _t(x).permute(0, 3, 1, 2))
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), w,
                                   atol=TOL, rtol=0)


def test_swin_state_dict_drops_buffers_and_prefix(dino):
    sd = dino[0]
    bb = {"backbone.bottom_up." + k[len("backbone.0."):]: v
          for k, v in sd.items() if k.startswith("backbone.0.")}
    bb["head.weight"] = torch.zeros(2, 2)
    out = swin_state_dict(bb)
    assert set(out) == set(TS.Swin(PTINY.swin).state_dict())


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_deform_attn_matches_jax_past_the_borders(dino, ref_dim):
    _, tree, model = dino
    p = model.transformer.encoder.layers[0].self_attn
    jp = tree["transformer"]["encoder"]["layers"]["0"]["self_attn"]
    shapes = [(6, 8), (3, 4), (2, 2), (1, 1)]
    rng = np.random.RandomState(5)
    q = rng.randn(9, 16).astype(np.float32)
    val = rng.randn(sum(h * w for h, w in shapes), 16).astype(np.float32)
    refs = rng.uniform(-0.2, 1.2, (9, 4, ref_dim)).astype(np.float32)
    if ref_dim == 4:
        refs[..., 2:] = np.abs(refs[..., 2:]) + 0.05
    want = np.asarray(JG.deform_attn(jp, jnp.asarray(q), jnp.asarray(refs),
                                     jnp.asarray(val), shapes, heads=2,
                                     points=2))
    with torch.no_grad():
        got = TG.deform_attn(p, _t(q), _t(refs), _t(val), shapes, heads=2,
                             points=2)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_bi_attention_matches_jax(dino):
    _, tree, model = dino
    rng = np.random.RandomState(2)
    v = rng.randn(20, 16).astype(np.float32)
    l = rng.randn(16, 16).astype(np.float32)
    pad = np.zeros(16, bool)
    pad[6:] = True
    wv, wl = JG._bi_attention(
        tree["transformer"]["encoder"]["fusion_layers"]["0"], jnp.asarray(v),
        jnp.asarray(l), JTINY.fusion_heads, jnp.asarray(pad))
    with torch.no_grad():
        gv, gl = TG._bi_attention(model.transformer.encoder.fusion_layers[0],
                                  _t(v), _t(l), PTINY.fusion_heads, _t(pad))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=TOL, rtol=0)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), atol=TOL, rtol=0)


def test_dino_forward_matches_jax(dino):
    _, tree, model = dino
    ids, mask, self_mask, pos, _ = _text()
    px = np.random.RandomState(3).randn(1, 64, 96, 3).astype(np.float32)
    want = jax.jit(lambda p, *a: JG.dino_forward(p, JTINY, *a))(
        tree, jnp.asarray(px), jnp.asarray(ids)[None],
        jnp.asarray(mask)[None], jnp.asarray(self_mask)[None],
        jnp.asarray(pos)[None])
    targs = (_t(ids, torch.long)[None], _t(mask)[None], _t(self_mask)[None],
             _t(pos, torch.long)[None])
    got = TG.dino_forward(model, _t(px).permute(0, 3, 1, 2), *targs)
    # the selection: the 12th and 13th best scores are well apart
    with torch.no_grad():
        txt = TG.text_features(model, targs[0], targs[2], targs[3])
        img, txt, shapes = TG.encoder_forward(
            model, TG.image_features(model, _t(px).permute(0, 3, 1, 2)), txt,
            targs[1], targs[2], targs[3])
        mem = model.transformer.enc_output_norm(
            model.transformer.enc_output(img))
        scores = (mem @ txt.T)[:, torch.from_numpy(mask)].amax(-1)
    top = scores.sort(descending=True)[0]
    q = PTINY.num_queries
    assert float(top[q - 1] - top[q]) > 1e-3
    wl, wb = np.asarray(want["logits"]), np.asarray(want["boxes"])
    gl, gb = got["logits"].numpy(), got["boxes"].numpy()
    assert np.isneginf(gl[:, ~mask]).all() and np.isneginf(wl[:, ~mask]).all()
    assert np.abs(wl[:, mask]).max() > 1.0
    np.testing.assert_allclose(gl[:, mask], wl[:, mask], atol=FWD_TOL, rtol=0)
    np.testing.assert_allclose(gb, wb, atol=FWD_TOL, rtol=0)


@pytest.mark.parametrize("caption,threshold", [("a dog head", -1.0),
                                               ("A dog. head.", 0.5)])
def test_detector_matches_jax(detectors, caption, threshold):
    """A non-square image resized to 64 x 96 (PIL's BILINEAR on the JAX
    side, numpy's on the port's), boxes back in the original frame."""
    jdet, tdet = (_with(d, box_threshold=threshold, text_threshold=0.5)
                  for d in detectors)
    img = np.random.RandomState(4).randint(0, 256, (70, 110, 3)) \
        .astype(np.uint8)
    wb, ws, wp = jdet(img, caption)
    gb, gs, gp = tdet(img, caption)
    assert 0 < len(ws) and (threshold < 0) == (len(ws) == PTINY.num_queries)
    np.testing.assert_allclose(gs, ws, atol=TOL, rtol=0)
    np.testing.assert_allclose(gb, wb, atol=BOX_PX_TOL, rtol=0)
    assert gp == wp and any(gp)


@pytest.fixture(scope="module")
def detectors(dino):
    """Both packages' detectors (64 on the short side, at most 96, every box
    kept), built once: the JAX one jits its forward once per image size."""
    _, tree, model = dino
    kw = dict(box_threshold=0.0, short_side=64, max_side=96)
    return (JG.GroundingDINODetector(tree, JTINY, JT.tiny_bert_tokenizer(),
                                     **kw),
            TG.GroundingDINODetector(model, TT.tiny_bert_tokenizer(), **kw))


def _with(detector, **thresholds):
    """`detector` with other thresholds (host-side attributes)."""
    out = copy.copy(detector)
    for name, value in thresholds.items():
        setattr(out, name, value)
    return out


# --- the grounding seam ----------------------------------------------------------

@pytest.mark.parametrize("mode", ["holes", "islands"])
def test_remove_small_regions_matches_jax(mode):
    rng = np.random.RandomState(6)
    mask = rng.rand(64, 64) > 0.55
    for area in (3, 30, 10 ** 4):
        got = TGR.remove_small_regions(mask, area, mode)
        want = JGR.remove_small_regions(mask, area, mode)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0], want[0])


@pytest.fixture(scope="module")
def editors():
    tb = random_bundle(tiny=True, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    sam = random_sam(TINY, device="cpu",
                     generator=torch.Generator().manual_seed(21)).eval()
    jed = JaxEditor(jax_twin(tb), sam=(JAX_TINY, to_tree(sam)),
                    extra_inpaint=True, amg_config=JA.AMGConfig(**AMG))
    ted = EditAnythingEditor(tb, sam=(TINY, sam), extra_inpaint=True,
                             amg_config=TA.AMGConfig(**AMG))
    return jed, ted


def _image(seed):
    return np.random.RandomState(seed).randint(0, 255, (64, 64, 3)) \
        .astype(np.uint8)


# the reference UI's GroundingDINO flow (top 2 boxes), thresholds opened so
# that the random detector's boxes reach SAM, holes filled below 20 pixels
# (400 of the reference's 512^2 and up is a tenth of a 64^2 image)
P2M = dict(score_thresh=0.0, union_score_thresh=0.0, max_boxes=2,
           small_region_area=20.0)


def _near_box_threshold(jed, image, boxes):
    """Pixels where some box's upscaled SAM logit (JAX side) lies within
    LOGIT_TOL of the threshold."""
    jed.sam_predictor.set_image(image)
    near = np.zeros(image.shape[:2], bool)
    for box in boxes:
        logits = jed.sam_predictor.predict(box=box,
                                           multimask_output=False)[2][0]
        near |= np.abs(np.asarray(logits)) <= LOGIT_TOL
    return near


def test_prompt2mask_matches_jax(detectors, editors):
    jed, ted = editors
    jdet, tdet = detectors
    img = _image(8)
    want = JGR.prompt2mask(jdet, jed.sam_predictor, img, "a dog", **P2M)
    got = TGR.prompt2mask(tdet, ted.sam_predictor, img, "a dog", **P2M)
    boxes, scores, _ = jdet(img, "a dog")
    top = boxes[np.argsort(-scores)[:2]]
    near = _near_box_threshold(jed, img, top)
    print(f"mask pixels within {LOGIT_TOL} of the threshold: {near.sum()}")
    assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
    assert 0 < (want[..., 0] > 0).sum() < 64 * 64
    np.testing.assert_array_equal(got[~near], want[~near])


def test_prompt2mask_without_boxes_skips_sam(detectors, editors):
    _, ted = editors
    tdet = _with(detectors[1], box_threshold=2.0)
    ted.sam_predictor._embedding = None
    out = TGR.prompt2mask(tdet, ted.sam_predictor, _image(9), "a dog",
                          score_thresh=0.25, max_boxes=2)
    assert not out.any() and ted.sam_predictor._embedding is None


def test_text_guided_edit_matches_jax(detectors, editors):
    jed, ted = editors
    jdet, tdet = detectors
    img = _image(10)
    args = dict(image=img, mask_prompt="a dog head", prompt="a red cat",
                num_samples=1, image_resolution=64, detect_resolution=64,
                ddim_steps=3, seed=7)
    _, want, (want_cond, want_mask), want_prompt = \
        JGR.TextGuidedEditPipeline(jed, jdet, **P2M)(**args)
    noise = np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(7))[0], (1, 8, 8, 4),
        jnp.float32))
    _, got, (got_cond, got_mask), got_prompt = \
        TGR.TextGuidedEditPipeline(ted, tdet, **P2M)(**args, noise=noise)
    assert got_prompt == want_prompt == "a red cat"
    assert 0 < (np.asarray(want_mask) > 0).sum() < 64 * 64
    np.testing.assert_array_equal(got_mask, np.asarray(want_mask))
    near = _near_threshold(jed, img)
    np.testing.assert_array_equal(got_cond[~near], want_cond[~near])
    diff = np.abs(np.stack(got).astype(np.int32)
                  - np.stack(want).astype(np.int32))
    print(f"images max diff {diff.max()} levels")
    assert diff.max() <= IMAGE_LEVELS
