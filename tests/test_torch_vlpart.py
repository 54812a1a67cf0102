"""The port's VLPart (models/vlpart.py), its detection ops
(models/detection.py) and its loader against the JAX package's, at the
JAX package's tiny widths in fp32.

Weights: every parameter of the port's VLPart drawn nonzero with numpy from
a seed, written in the detectron2 / open_clip layout of
``swinbase_part_0a0000.pth`` (the text tower's q/k/v fused into
``in_proj``, the pixel mean/std and Swin's ``relative_position_index``
beside them); that one state dict goes through the JAX package's
``vlpart_to_tree`` and the port's ``load_vlpart``.

Tolerances: anchors, FPN level assignments, NMS keep flags, proposal
validity, classes and labels exact; ROIAlign, box transforms, the FPN,
the text embeddings within 1e-5 of JAX's (outputs of magnitude 1-10), a
cascade stage's logits and deltas within 1e-5 of their largest magnitude
(up to ~70); proposals and detected boxes within 1e-3 pixels, scores
within 1e-5.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editanything_tpu.checkpoints.detectors import vlpart_to_tree
from editanything_tpu.models import detection as JD
from editanything_tpu.models import swin as JS
from editanything_tpu.models import vlpart as JV
from editanything_tpu.perception.amg import greedy_nms as jax_nms
from editanything_tpu.text.tokenizer import tiny_tokenizer as jax_tokenizer
from editanything_tpu_torch.checkpoints.convert import vlpart_state_dict
from editanything_tpu_torch.models import detection as TD
from editanything_tpu_torch.models import swin as TS
from editanything_tpu_torch.models import vlpart as TV
from editanything_tpu_torch.pipelines.bundle import load_vlpart, random_vlpart
from editanything_tpu_torch.text.tokenizer import tiny_tokenizer

TOL = 1e-5
BOX_PX_TOL = 1e-3
JTINY = JV.tiny_vlpart_config()
PTINY = TV.tiny_vlpart_config()
VOCAB = "dog head.dog nose:tip.cat"
WORDS = ("a", "dog", "head", "nose", "tip", "cat", "background")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype=dtype)


def port_state_dict(seed: int) -> dict:
    """Every parameter of the port's tiny VLPart drawn with numpy: weights
    N(0, 1/fan_in), biases N(0, 0.1), norm scales 1 + N(0, 0.1), the
    embeddings and relative-position tables N(0, 0.5), the text projection
    N(0, 1/width)."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in TV.VLPart(PTINY).state_dict().items()}
    out = {}
    for k, shape in shapes.items():
        if "embedding" in k or k.endswith("relative_position_bias_table"):
            a = 0.5 * rng.standard_normal(shape)
        elif k.endswith("text_projection") or len(shape) >= 2:
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif k.endswith("bias"):
            a = 0.1 * rng.standard_normal(shape)
        else:
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        out[k] = torch.from_numpy(a.astype(np.float32))
    return out


_TO_D2 = [
    (r"^backbone\.", "backbone.bottom_up."),
    (r"^fpn\.(lateral|output)\.(\d)\.", None),
    (r"^rpn\.", "proposal_generator.rpn_head."),
    (r"^roi_heads\.(\d)\.(fc1|fc2)\.", r"roi_heads.box_head.\1.\2."),
    (r"^roi_heads\.(\d)\.bbox_pred\.", r"roi_heads.box_predictor.\1.bbox_pred."),
    (r"^roi_heads\.(\d)\.cls_score\.", r"roi_heads.box_predictor.\1.cls_score.linear."),
]
_TEXT_TO_OPEN_CLIP = {
    "clip.embeddings.token_embedding.weight": "token_embedding.weight",
    "clip.embeddings.position_embedding.weight": "positional_embedding",
    "clip.final_layer_norm.weight": "ln_final.weight",
    "clip.final_layer_norm.bias": "ln_final.bias",
    "text_projection": "text_projection",
}


def detectron2_layout(sd: dict) -> dict:
    """The port's names -> VLPart's published checkpoint layout."""
    out = {"pixel_mean": torch.zeros(3, 1, 1), "pixel_std": torch.ones(3, 1, 1),
           "backbone.bottom_up.layers.0.blocks.0.attn.relative_position_index":
               torch.zeros(16, 16, dtype=torch.long)}
    fused = {}
    for k, v in sd.items():
        if k.startswith("text_encoder."):
            k = k[len("text_encoder."):]
            if k in _TEXT_TO_OPEN_CLIP:
                out["text_encoder." + _TEXT_TO_OPEN_CLIP[k]] = v
                continue
            n, rest = re.match(r"clip\.encoder\.layers\.(\d+)\.(.*)", k).groups()
            pre = f"text_encoder.transformer.resblocks.{n}."
            m = re.match(r"self_attn\.([qkv])_proj\.(weight|bias)", rest)
            if m:
                fused.setdefault((pre, m.group(2)), {})[m.group(1)] = v
                continue
            for a, b in (("self_attn.out_proj", "attn.out_proj"),
                         ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                         ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
                rest = rest.replace(a, b)
            out[pre + rest] = v
            continue
        for pat, rep in _TO_D2:
            m = re.match(pat, k)
            if m and rep is None:
                kind, lvl = m.groups()
                k = f"backbone.fpn_{kind}{int(lvl) + 2}." + k[m.end():]
                break
            if m:
                k = re.sub(pat, rep, k)
                break
        out[k] = v
    for (pre, leaf), qkv in fused.items():
        out[f"{pre}attn.in_proj_{leaf}"] = torch.cat([qkv[c] for c in "qkv"])
    return out


@pytest.fixture(scope="module")
def vlpart():
    sd = port_state_dict(17)
    d2 = detectron2_layout(sd)
    tree = vlpart_to_tree({k: v.numpy() for k, v in d2.items()})
    model = load_vlpart(d2, PTINY, device="cpu", dtype=torch.float32)
    return sd, tree, model


def _pixels(h=60, w=90, seed=3):
    return np.random.RandomState(seed).randn(1, h, w, 3).astype(np.float32)


# --- configs, weights ---------------------------------------------------------

def test_configs_mirror_jax():
    for jc, tc in ((JV.VLPartConfig(), TV.VLPartConfig()), (JTINY, PTINY)):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert (TV.PIXEL_MEAN.tolist(), TV.PIXEL_STD.tolist()) == (
        JV.PIXEL_MEAN.tolist(), JV.PIXEL_STD.tolist())


def test_detectron2_layout_loads_strictly(vlpart):
    sd, _, model = vlpart
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    assert set(vlpart_state_dict(model.state_dict())) == set(sd)


def test_random_vlpart_is_seeded():
    a = random_vlpart(PTINY, device="cpu", seed=2).state_dict()
    b = random_vlpart(PTINY, device="cpu", seed=2).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["text_encoder.text_projection"].abs().max() > 0


# --- detection ops ------------------------------------------------------------

def test_level_anchors_equal_jax():
    for args in ((2, 3, 4, 32.0), (5, 7, 16, 128.0, (0.5, 1.0, 2.0))):
        np.testing.assert_array_equal(TD.level_anchors(*args),
                                      JD.level_anchors(*args))


def _boxes(n=40, seed=0, size=64.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-8, size, (n, 2))
    wh = rng.uniform(0.5, size / 2, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_transforms_match_jax():
    boxes = _boxes()
    deltas = np.random.RandomState(1).randn(40, 4).astype(np.float32) * 2
    deltas[0, 2:] = 10.0                           # past the scale clamp
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        want = np.asarray(JD.apply_deltas(jnp.asarray(deltas),
                                          jnp.asarray(boxes), weights=w))
        got = TD.apply_deltas(_t(deltas), _t(boxes), weights=w).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(
        TD.clip_boxes(_t(boxes), (50, 60)).numpy(),
        np.asarray(JD.clip_boxes(jnp.asarray(boxes), (50, 60))))
    big = np.concatenate([boxes, boxes * 8], 0)
    np.testing.assert_array_equal(
        TD.assign_fpn_level(_t(big)).numpy(),
        np.asarray(JD.assign_fpn_level(jnp.asarray(big))))


def test_roi_align_matches_jax():
    feat = np.random.RandomState(2).randn(13, 17, 5).astype(np.float32)
    boxes = _boxes(size=60.0)
    for stride in (1, 4):
        want = np.asarray(JD.roi_align(jnp.asarray(feat), jnp.asarray(boxes),
                                       out_size=3, stride=stride))
        got = TD.roi_align(_t(feat), _t(boxes), out_size=3,
                           stride=stride).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    feats = {f"p{i}": np.random.RandomState(i).randn(1, 64 >> i, 96 >> i, 5)
             .astype(np.float32) for i in range(2, 6)}
    big = np.concatenate([boxes, boxes * 6], 0)
    want = np.asarray(JD.multilevel_roi_align(
        {k: jnp.asarray(v) for k, v in feats.items()}, jnp.asarray(big),
        out_size=3))
    got = TD.multilevel_roi_align(
        {k: _t(v).permute(0, 3, 1, 2) for k, v in feats.items()}, _t(big),
        out_size=3).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_batched_nms_matches_jax():
    boxes = np.repeat(_boxes(60, seed=4), 2, axis=0)
    boxes += np.random.RandomState(5).uniform(-3, 3, boxes.shape) \
        .astype(np.float32)
    scores = np.random.RandomState(6).rand(120).astype(np.float32)
    classes = np.tile(np.arange(2), 60)
    valid = scores > 0.2
    offsets = classes.astype(np.float32)[:, None] * (64 + 2.0)
    want = np.asarray(jax_nms(jnp.asarray(boxes + offsets),
                              jnp.asarray(scores), jnp.asarray(valid), 0.5))
    got = TD.batched_nms(_t(boxes), _t(scores), _t(classes), _t(valid), 0.5,
                         (64, 48)).numpy()
    assert 0 < want.sum() < valid.sum()
    np.testing.assert_array_equal(got, want)


# --- the model ----------------------------------------------------------------

def _fpn(tree, model, px):
    def fwd(backbone, fpn, x):
        f = JS.apply(backbone, JTINY.swin, x)
        return JS.fpn_apply(fpn, [f[f"swin{i}"] for i in range(4)])
    jfpn = jax.jit(fwd)(tree["backbone"], tree["fpn"], jnp.asarray(px))
    with torch.no_grad():
        tf = TS.swin_forward(model.backbone, _t(px).permute(0, 3, 1, 2))
        tfpn = TS.fpn_forward(model.fpn, [tf[f"swin{i}"] for i in range(4)])
    return jfpn, tfpn


def test_fpn_matches_jax_at_odd_sizes(vlpart):
    """60 x 90 -> 15 x 23 at p2: the top-down path upsamples 8 x 12 to
    15 x 23 with jax.image.resize's nearest rows."""
    _, tree, model = vlpart
    jfpn, tfpn = _fpn(tree, model, _pixels())
    assert set(jfpn) == set(tfpn) == {"p2", "p3", "p4", "p5", "p6"}
    for k in jfpn:
        np.testing.assert_allclose(tfpn[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(jfpn[k]), atol=TOL, rtol=0)


def test_rpn_and_a_cascade_stage_match_jax(vlpart):
    _, tree, model = vlpart
    px = _pixels()
    jfpn, tfpn = _fpn(tree, model, px)
    wb, wv = jax.jit(lambda p, f: JV.rpn_proposals(p, JTINY, f, (60, 90)))(
        tree, jfpn)
    with torch.no_grad():
        gb, gv = TV.rpn_proposals(model, tfpn, (60, 90))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert 0 < int(gv.sum())
    np.testing.assert_allclose(gb.numpy()[gv.numpy()],
                               np.asarray(wb)[np.asarray(wv)],
                               atol=BOX_PX_TOL, rtol=0)
    emb = np.random.RandomState(7).randn(32, 4).astype(np.float32)
    wl, wd = jax.jit(lambda p, f, b, e: JV._run_stage(p, JTINY, f, b, e, 1))(
        tree, jfpn, wb, jnp.asarray(emb))
    with torch.no_grad():
        gl, gd = TV._run_stage(model, tfpn, _t(np.array(wb)), _t(emb), 1)
    for got, want in ((gl, wl), (gd, wd)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=TOL * np.abs(want).max(), rtol=0)


def test_encode_vocabulary_matches_jax(vlpart):
    _, tree, model = vlpart
    ctx = PTINY.text.max_position_embeddings
    want = np.asarray(JV.encode_vocabulary(
        tree, JTINY, jax_tokenizer(WORDS, context_length=ctx), VOCAB))
    got = TV.encode_vocabulary(model, tiny_tokenizer(WORDS,
                                                     context_length=ctx),
                               VOCAB).numpy()
    assert got.shape == (32, 4)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_detect_matches_jax(vlpart):
    _, tree, model = vlpart
    px = _pixels(64, 80, seed=8)
    emb = np.asarray(JV.encode_vocabulary(
        tree, JTINY, jax_tokenizer(WORDS, context_length=16), VOCAB))
    want = jax.jit(lambda p, x, e: JV.detect(p, JTINY, x, e))(
        tree, jnp.asarray(px), jnp.asarray(emb))
    got = TV.detect(model, _t(px).permute(0, 3, 1, 2), _t(emb))
    wv = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), wv)
    assert wv.sum() > 3
    np.testing.assert_array_equal(got["classes"].numpy()[wv],
                                  np.asarray(want["classes"])[wv])
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=TOL, rtol=0)
    np.testing.assert_allclose(got["boxes"].numpy()[wv],
                               np.asarray(want["boxes"])[wv],
                               atol=BOX_PX_TOL, rtol=0)


def test_detector_matches_jax(vlpart):
    """A non-square image, short side resized to 72 (PIL's BILINEAR on the
    JAX side, numpy's on the port's), boxes back in the original frame."""
    _, tree, model = vlpart
    kw = dict(short_side=72, max_side=120)
    jdet = JV.VLPartDetector(tree, JTINY, jax_tokenizer(
        WORDS, context_length=16), **kw)
    tdet = TV.VLPartDetector(model, tiny_tokenizer(WORDS, context_length=16),
                             **kw)
    img = np.random.RandomState(9).randint(0, 256, (50, 70, 3)) \
        .astype(np.uint8)
    wb, ws, wl = jdet(img, VOCAB)
    gb, gs, gl = tdet(img, VOCAB)
    assert len(ws) > 3 and gl == wl
    np.testing.assert_allclose(gs, ws, atol=TOL, rtol=0)
    np.testing.assert_allclose(gb, wb, atol=BOX_PX_TOL, rtol=0)
