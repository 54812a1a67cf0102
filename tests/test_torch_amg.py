"""The port's automatic mask generation (editanything_tpu_torch.perception
.amg) against the JAX package's, and its uint8 resize against PIL.

Tolerances:
- resize matrices and mask upscales 1e-5 absolute (the same bilinear
  weights, fp32 sums in other orders) on values of magnitude ~1-16;
- greedy NMS, select_candidates on the same logits, encode_id_map: exact;
- the whole tiny AMG: candidate logits and IoUs 1e-5 absolute (fp32
  encoder and decoder, as tests/test_torch_sam.py) on values of magnitude
  ~0.3-1; keep flags exact; the ID maps equal except at pixels where a kept
  mask's upscaled logit lies within that bound of the threshold, which are
  counted and must stay under 0.1% of the map;
- ``resize_uint8_bilinear`` at most 1 level from PIL's BILINEAR (PIL rounds
  its fixed-point filter differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from editanything_tpu.models import sam as JS
from editanything_tpu.perception import amg as JA
from editanything_tpu_torch.models import sam as TS
from editanything_tpu_torch.perception import amg as TA
from editanything_tpu_torch.pipelines.bundle import random_sam
from editanything_tpu_torch.utils.image import resize_uint8_bilinear

from test_torch_sam import JAX_TINY, TINY, to_tree

RESIZE_TOL = 1e-5
CAND_TOL = 1e-5
NEAR_SHARE = 1e-3


def _nms_oracle(boxes, scores, valid, thresh):
    """Greedy NMS in plain Python (tests/test_sam.py:86-103)."""
    def iou(a, b):
        x0, y0 = max(a[0], b[0]), max(a[1], b[1])
        x1, y1 = min(a[2], b[2]), min(a[3], b[3])
        inter = max(x1 - x0, 0) * max(y1 - y0, 0)
        union = ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1])
                 - inter)
        return inter / max(union, 1e-6)
    n = len(boxes)
    order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
    alive, keep = np.ones(n, bool), np.zeros(n, bool)
    for i in order:
        if not valid[i] or not alive[i]:
            continue
        keep[i] = True
        for j in range(n):
            if j != i and alive[j] and iou(boxes[i], boxes[j]) > thresh:
                alive[j] = False
    return keep


@pytest.mark.parametrize("out_hw", [(32, 48), (64, 24), (8, 12), (17, 33)])
def test_resize_matrix_and_upscale_match_jax(out_hw):
    for n_in, n_out in ((16, out_hw[0]), (24, out_hw[1])):
        np.testing.assert_allclose(TA._resize_matrix(n_in, n_out).numpy(),
                                   np.asarray(JA._resize_matrix(n_in, n_out)),
                                   atol=RESIZE_TOL, rtol=0)
    logits = np.random.default_rng(0).normal(0, 4, (5, 16, 24)).astype(np.float32)
    want = np.asarray(JA.upscale_masks(jnp.asarray(logits), out_hw))
    got = TA.upscale_masks(torch.from_numpy(logits), out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=RESIZE_TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_nms_matches_jax_and_oracle_with_ties(seed):
    rng = np.random.default_rng(seed)
    n = 60
    xy = rng.uniform(0, 100, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 40, (n, 2))],
                           axis=1).astype(np.float32)
    # scores from a few levels, so many tie; some candidates invalid
    scores = rng.choice([0.5, 0.7, 0.9], n).astype(np.float32)
    valid = rng.uniform(0, 1, n) > 0.2
    want = np.asarray(JA.greedy_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    jnp.asarray(valid), 0.5))
    got = TA.greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                        torch.from_numpy(valid), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _nms_oracle(boxes, scores, valid, 0.5))


def _blobby_logits(seed, c=48, h=16, w=16):
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 1, (c, 1, 1))
    logits = (rng.normal(0, 1, (c, h, w)) * 2 + base).astype(np.float32)
    return logits, rng.uniform(0.5, 1.0, c).astype(np.float32)


def _assert_same_selection(got, want):
    for key in ("logits", "valid", "scores", "boxes", "areas"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


def _select_both(seed, max_masks):
    logits, iou = _blobby_logits(seed)
    cfg = dict(pred_iou_thresh=0.7, stability_score_thresh=0.5,
               stability_score_offset=1.0, box_nms_thresh=0.6,
               max_masks=max_masks)
    want = JA.select_candidates(jnp.asarray(logits), jnp.asarray(iou),
                                JA.AMGConfig(**cfg))
    got = TA.select_candidates(torch.from_numpy(logits), torch.from_numpy(iou),
                               TA.AMGConfig(**cfg))
    return got, want


@pytest.mark.parametrize("seed,max_masks", [(7, 8), (8, 16), (9, 40)])
def test_select_candidates_matches_jax_exactly(seed, max_masks):
    got, want = _select_both(seed, max_masks)
    assert got["valid"].any()
    _assert_same_selection(got, want)


def test_select_candidates_with_fewer_candidates_than_slots():
    """48 candidates, 64 slots: the JAX package's overflow bin is slot C
    (amg.py:146), which then lies inside the output and marks a candidate
    that NMS did not keep as valid (a fault of the reference, ROADMAP Queue
    3; the AMG's 3072 candidates never have fewer than its 256 slots). The
    port leaves that slot empty and agrees everywhere else."""
    got, want = _select_both(8, 64)
    assert bool(np.asarray(want["valid"])[48]) and not got["valid"][48]
    rest = np.arange(64) != 48
    for key in ("logits", "valid", "scores", "boxes", "areas"):
        np.testing.assert_array_equal(got[key].numpy()[rest],
                                      np.asarray(want[key])[rest], err_msg=key)


def test_select_candidates_overflow_and_empty():
    cfg = dict(pred_iou_thresh=0.5, stability_score_thresh=-1.0,
               box_nms_thresh=0.99, max_masks=2)
    logits = np.full((5, 8, 8), -10.0, np.float32)
    for i in range(5):
        logits[i, i:i + 1, :] = 10.0
    for iou in (np.full((5,), 0.9, np.float32), np.zeros((5,), np.float32)):
        want = JA.select_candidates(jnp.asarray(logits), jnp.asarray(iou),
                                    JA.AMGConfig(**cfg))
        got = TA.select_candidates(torch.from_numpy(logits),
                                   torch.from_numpy(iou), TA.AMGConfig(**cfg))
        _assert_same_selection(got, want)
    assert got["valid"].tolist() == [False, False]


@pytest.mark.parametrize("c,out_hw", [(3, (8, 8)), (300, (4, 4)), (70, (24, 40))])
def test_encode_id_map_matches_jax(c, out_hw):
    """300 slots: ids past 255 carry into G; 70 slots span several of the
    port's chunks."""
    rng = np.random.default_rng(c)
    logits = rng.normal(0, 5, (c, 8, 8)).astype(np.float32)
    valid = rng.uniform(0, 1, c) > 0.3
    valid[-1] = True
    logits[-1] = 10.0
    want = np.asarray(JA.encode_id_map(jnp.asarray(logits), jnp.asarray(valid),
                                       out_hw=out_hw))
    got = TA.encode_id_map(torch.from_numpy(logits), torch.from_numpy(valid),
                           out_hw=out_hw).numpy()
    assert got.dtype == np.uint8 and got.shape == out_hw + (3,)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0] == c % 256 and got[0, 0, 1] == c // 256


@torch.no_grad()
def test_whole_amg_matches_jax_tiny():
    """4x4 points with the quality filters open (every candidate valid):
    encoder, batched decode, NMS, slot compaction and the ID map."""
    sam = random_sam(TINY, device="cpu",
                     generator=torch.Generator().manual_seed(11)).eval()
    tree = to_tree(sam)
    cfg = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=-10.0,
               stability_score_thresh=-1.0, max_masks=16)
    jcfg, tcfg = JA.AMGConfig(**cfg), TA.AMGConfig(**cfg)
    img = np.random.default_rng(12).integers(0, 256, (64, 64, 3), np.uint8)
    pts = JA._grid_points(jcfg, 64, 64)
    np.testing.assert_array_equal(TA._grid_points(tcfg, 64, 64), pts)

    j_encode, j_generate = JA.build_amg(JAX_TINY, jcfg)
    j_emb = j_encode(tree, JS.preprocess(jnp.asarray(img), JAX_TINY))
    t_encode, t_generate = TA.build_amg(TINY, tcfg)
    t_emb = t_encode(sam, TS.preprocess(torch.from_numpy(img), TINY))

    # candidates: the JAX decode of amg.py:176-192, batch by batch
    jpe = tree["prompt_encoder"]
    j_logits, j_iou = [], []
    for batch in pts.reshape(-1, 8, 2):
        sparse = JS.encode_points(jpe, JAX_TINY, jnp.asarray(batch[:, None]),
                                  jnp.ones((8, 1), jnp.int32))
        m, i = JS.mask_decoder(tree["mask_decoder"], JAX_TINY, j_emb,
                               JS.dense_positional_encoding(jpe, JAX_TINY),
                               sparse, JS.no_mask_dense_embedding(jpe, JAX_TINY, 1))
        j_logits.append(np.asarray(m[:, 1:4]).reshape(-1, 32, 32))
        j_iou.append(np.asarray(i[:, 1:4]).reshape(-1))
    t_logits, t_iou = TA.decode_candidates(sam, tcfg, t_emb, torch.from_numpy(pts))
    assert t_logits.shape == (48, 32, 32)
    assert np.abs(np.concatenate(j_logits)).max() > 0.1
    np.testing.assert_allclose(t_logits.numpy(), np.concatenate(j_logits),
                               atol=CAND_TOL, rtol=0)
    np.testing.assert_allclose(t_iou.numpy(), np.concatenate(j_iou),
                               atol=CAND_TOL, rtol=0)

    want = j_generate(tree, j_emb, jnp.asarray(pts))
    got = t_generate(sam, t_emb, torch.from_numpy(pts))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].any()
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               atol=CAND_TOL, rtol=0)

    want_map = np.asarray(JA.encode_id_map(want["logits"], want["valid"],
                                           out_hw=(64, 64)))
    got_map = TA.encode_id_map(got["logits"], got["valid"], out_hw=(64, 64)).numpy()
    up = np.asarray(JA.upscale_masks(want["logits"], (64, 64)))
    near = (np.abs(up) <= CAND_TOL) & np.asarray(want["valid"])[:, None, None]
    near = near.any(axis=0)
    print(f"ID map pixels within {CAND_TOL} of the threshold: {near.sum()} "
          f"of {near.size}")
    assert near.mean() < NEAR_SHARE
    np.testing.assert_array_equal(got_map[~near], want_map[~near])


@pytest.mark.parametrize("src,dst", [((512, 512), (1024, 1024)),
                                     ((480, 640), (768, 1024)),
                                     ((2048, 1536), (1024, 768)),
                                     ((64, 48), (64, 48))])
def test_resize_uint8_bilinear_within_one_level_of_pil(src, dst):
    img = np.random.default_rng(sum(src)).integers(0, 256, src + (3,), np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR))
    got = resize_uint8_bilinear(img, dst)
    assert got.dtype == np.uint8 and got.shape == dst + (3,)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    back = resize_uint8_bilinear(torch.from_numpy(img), dst)
    np.testing.assert_array_equal(back.numpy(), got)
