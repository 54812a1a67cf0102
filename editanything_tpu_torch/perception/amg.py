"""SAM automatic mask generation (AMG) and the ID condition map.

Counterpart of ``editanything_tpu/perception/amg.py``: the point grid is
decoded in fixed batches (a Python loop here, ``lax.scan`` there), the
quality filters are dense masks, NMS is exact greedy box NMS over the
score-sorted candidates, and the kept masks fill a fixed ``max_masks`` slab
in candidate order, from which ``encode_id_map`` paints the uint16 ID map
(R = id % 256, G = id // 256) that the SAM ControlNet takes.

Greedy NMS is a sequential chain: each kept box suppresses later ones. The
IoU > threshold matrix of the score-sorted valid candidates is computed on
the device and copied to the host once (at most 3072^2 booleans, 9 MiB);
the chain then runs over it in numpy, stopping at the last valid candidate
as the JAX package's while loop does. A loop of small device kernels per
candidate would cost thousands of launches when the filters pass many
candidates. This is a design choice, not a fallback: the same code runs on
every device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from editanything_tpu_torch.models import sam as SAM
from editanything_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class AMGConfig:
    points_per_side: int = 32
    points_per_batch: int = 256
    pred_iou_thresh: float = 0.88
    stability_score_thresh: float = 0.95
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    mask_threshold: float = 0.0
    max_masks: int = 256          # fixed output slots after NMS

    @property
    def num_points(self) -> int:
        return self.points_per_side ** 2

    @property
    def num_candidates(self) -> int:
        return self.num_points * 3   # multimask outputs per point


def _grid_points(cfg: AMGConfig, h: int, w: int) -> np.ndarray:
    """Evenly spaced point grid over the (unpadded) image, pixel coords."""
    n = cfg.points_per_side
    offset = 1.0 / (2 * n)
    ticks = np.linspace(offset, 1.0 - offset, n)
    gx, gy = np.meshgrid(ticks * w, ticks * h)
    return np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)


def _mask_stats(logits, threshold: float, offset: float):
    """Per-candidate stability score, area and xyxy box from (N, H, W)
    logits; an empty mask's box is (1e6, 1e6, 0, 0), as in the JAX package."""
    hi = (logits > threshold + offset).sum(dim=(1, 2))
    lo = (logits > threshold - offset).sum(dim=(1, 2))
    stability = hi.float() / lo.clamp(min=1).float()
    mask = logits > threshold
    area = mask.sum(dim=(1, 2))
    h, w = logits.shape[1:]
    rows, cols = mask.any(dim=2), mask.any(dim=1)
    ridx = torch.arange(h, device=logits.device)
    cidx = torch.arange(w, device=logits.device)
    big = 10 ** 6
    y0 = torch.where(rows, ridx, big).amin(dim=1)
    y1 = torch.where(rows, ridx, -1).amax(dim=1)
    x0 = torch.where(cols, cidx, big).amin(dim=1)
    x1 = torch.where(cols, cidx, -1).amax(dim=1)
    boxes = torch.stack([x0, y0, x1 + 1, y1 + 1], dim=-1).float()
    return stability, area, boxes


def _box_iou(boxes):
    """(N, 4) xyxy -> (N, N) IoU matrix."""
    area = ((boxes[:, 2] - boxes[:, 0]).clamp(min=0)
            * (boxes[:, 3] - boxes[:, 1]).clamp(min=0))
    x0 = torch.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y0 = torch.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x1 = torch.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y1 = torch.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = (x1 - x0).clamp(min=0) * (y1 - y0).clamp(min=0)
    union = area[:, None] + area[None, :] - inter
    return inter / union.clamp(min=1e-6)


def greedy_nms(boxes, scores, valid, iou_thresh: float):
    """Exact greedy NMS; returns keep flags (N,) bool on the input's device.

    Candidates are sorted by score with a stable sort (invalid ones last,
    as -inf), exactly as ``jnp.argsort`` orders them, so ties keep candidate
    order and the kept set is the JAX package's."""
    n = boxes.shape[0]
    order = torch.argsort(-torch.where(valid, scores.float(), -torch.inf),
                          stable=True)
    n_valid = trace.host_read(valid.sum(), "amg.valid_count", int)
    trace.count("amg.candidates_valid", n_valid)
    top = order[:n_valid]
    over = trace.host_read(_box_iou(boxes[top]) > iou_thresh,
                           "amg.iou_matrix").numpy()
    alive = np.ones(n_valid, bool)
    kept = np.zeros(n_valid, bool)
    for i in range(n_valid):
        if alive[i]:
            kept[i] = True
            alive &= ~over[i]
    trace.count("amg.kept", int(kept.sum()))
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    if n_valid:
        # a copy from host memory waits on the device; an empty one does not
        trace.count("sync.amg.keep")
    keep[top] = torch.from_numpy(kept).to(boxes.device)
    return keep


def select_candidates(logits, iou, amg_cfg: AMGConfig):
    """The post-decode chain on (C, H, W) candidate logits and (C,)
    predicted IoUs: quality filters, greedy box NMS, then the first
    ``max_masks`` kept candidates, in candidate order, into fixed slots
    (the reference paints masks in generation order)."""
    c = logits.shape[0]
    stability, areas, boxes = _mask_stats(
        logits, amg_cfg.mask_threshold, amg_cfg.stability_score_offset)
    valid = ((iou > amg_cfg.pred_iou_thresh)
             & (stability > amg_cfg.stability_score_thresh) & (areas > 0))
    keep = greedy_nms(boxes, iou, valid, amg_cfg.box_nms_thresh)
    # slot of a kept candidate = its rank among the kept ones; ranks past
    # the last slot are dropped, as the JAX scatter's mode="drop"
    k = amg_cfg.max_masks
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    into = keep & (rank < k)
    sel = torch.full((k,), -1, dtype=torch.int64, device=logits.device)
    # each boolean-mask index reads its count to the host
    trace.count("sync.amg.slots", 2)
    sel[rank[into]] = torch.arange(c, device=logits.device)[into]
    slot_valid = sel >= 0
    sel_safe = sel.clamp(min=0)
    return {
        "logits": logits[sel_safe],
        "valid": slot_valid,
        "scores": torch.where(slot_valid, iou[sel_safe], 0.0),
        "boxes": torch.where(slot_valid[:, None], boxes[sel_safe], 0.0),
        "areas": torch.where(slot_valid, areas[sel_safe], 0),
    }


def decode_candidates(sam: SAM.Sam, amg_cfg: AMGConfig, embedding, points):
    """All grid points, in batches of ``points_per_batch``, through the
    prompt encoder and the mask decoder -> the three multimask candidates
    of each point: (3P, 4e, 4e) logits and (3P,) predicted IoUs.
    `embedding` (1, d, e, e); `points` (P, 2) pixel coords in the 1024 space."""
    n = points.shape[0]
    bs = amg_cfg.points_per_batch
    if n % bs:
        raise ValueError(f"{n} points do not split into batches of {bs}")
    pe_mod, dec = sam.prompt_encoder, sam.mask_decoder
    image_pe = pe_mod.dense_positional_encoding()
    dense = pe_mod.no_mask_dense_embedding(1).to(embedding.dtype)
    packed = dec.pack_twoway()
    logits, ious = [], []
    for i in range(0, n, bs):
        pts = points[i:i + bs]
        sparse = pe_mod.encode_points(
            pts[:, None, :], torch.ones((pts.shape[0], 1), dtype=torch.int64,
                                        device=pts.device))
        masks, iou = dec(embedding, image_pe, sparse, dense,
                         twoway_packed=packed)
        # multimask outputs: tokens 1..3 (token 0 is the single-mask head)
        logits.append(masks[:, 1:4].flatten(0, 1))
        ious.append(iou[:, 1:4].flatten())
    return torch.cat(logits), torch.cat(ious)


def build_amg(sam_cfg: SAM.SAMConfig, amg_cfg: AMGConfig):
    """Returns (encode_fn, generate_fn), as the JAX package's:

    encode_fn(sam, image (1, 3, S, S)) -> (1, 256, e, e) embedding
    generate_fn(sam, embedding, points (P, 2)) -> dict(logits
        (max_masks, 4e, 4e), valid, scores, boxes (max_masks, 4), areas)
    """
    @torch.inference_mode()
    def encode_fn(sam, image):
        with trace.span("sam.encode"):
            return sam.image_encoder(image)

    @torch.inference_mode()
    def generate_fn(sam, embedding, points):
        with trace.span("amg.decode"):
            logits, iou = decode_candidates(sam, amg_cfg, embedding, points)
        with trace.span("amg.select"):
            return select_candidates(logits, iou, amg_cfg)

    return encode_fn, generate_fn


def _resize_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) weights of ``jax.image.resize``'s bilinear resize
    along one axis (antialiased when shrinking): the resize of the identity,
    as the JAX package builds it (amg.py:220-225)."""
    eye = torch.eye(n_in, dtype=torch.float32, device=device)
    return F.interpolate(eye[None, None], size=(n_out, n_in), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


def upscale_masks(logits, out_hw: Tuple[int, int]):
    """Bilinear upscale of a (C, h, w) logit slab to (C, H, W) fp32 as two
    products with the separable resize matrices; the column matrix is cast
    to the logits' dtype, as the JAX package does (amg.py:228-243)."""
    c, mh, mw = logits.shape
    ah = _resize_matrix(mh, out_hw[0], logits.device)
    aw = _resize_matrix(mw, out_hw[1], logits.device)
    up = torch.matmul(logits.float(), aw.to(logits.dtype).float().t())
    return torch.matmul(ah, up)


ID_MAP_CHUNK = 32   # masks upscaled at a time: 32 x 1024^2 x 4 B = 128 MiB


@torch.inference_mode()
def encode_id_map(logits, valid, *, out_hw: Tuple[int, int],
                  mask_threshold: float = 0.0):
    """Masks -> the ControlNet condition map (show_anns semantics,
    editany_lora.py:426-449): ids 1.. painted in slot order, later masks
    over earlier ones (the largest covering id), encoded R = id % 256,
    G = id // 256, B = 0. logits (C, h, w) -> uint8 (H, W, 3) tensor.

    The max over ids is taken in int32 (CUDA has little uint16 support),
    ``ID_MAP_CHUNK`` masks at a time, so the upscaled slab (1 GiB for 256
    masks at 1024^2) is never held whole."""
    c = logits.shape[0]
    id_map = torch.zeros(out_hw, dtype=torch.int32, device=logits.device)
    for i in range(0, c, ID_MAP_CHUNK):
        up = upscale_masks(logits[i:i + ID_MAP_CHUNK], out_hw)
        hit = (up > mask_threshold) & valid[i:i + ID_MAP_CHUNK, None, None]
        ids = torch.arange(i + 1, i + 1 + up.shape[0], dtype=torch.int32,
                           device=logits.device)[:, None, None]
        id_map = torch.maximum(id_map, torch.where(hit, ids, 0).amax(dim=0))
    r = (id_map % 256).to(torch.uint8)
    g = (id_map // 256).to(torch.uint8)
    return torch.stack([r, g, torch.zeros_like(r)], dim=-1)
