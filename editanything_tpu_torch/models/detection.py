"""Detection ops for VLPart: anchors, box transforms, ROIAlign, the FPN level
assignment and class-local NMS.

Counterpart of ``editanything_tpu/models/detection.py`` (detectron2's ops
as the reference's VLPart uses them). No torchvision: ``roi_align`` is a
gather of the four bilinear corners (ROIAlignV2, aligned=True, 2 x 2
samples a bin, averaged), and NMS is ``perception/amg.py::greedy_nms``, the
exact greedy scan the AMG uses, as the JAX package reuses its own.
Features are channel-last per image, (H, W, C), where the pooling is.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from editanything_tpu_torch.perception.amg import greedy_nms


def level_anchors(h: int, w: int, stride: int, size: float,
                  ratios: Sequence[float] = (0.5, 1.0, 2.0)) -> np.ndarray:
    """(H*W*A, 4) xyxy anchors of one level (DefaultAnchorGenerator: cell
    centres at (x + 0.5) * stride, area size^2 at each height/width
    ratio)."""
    ws = np.array([np.sqrt(size * size / r) for r in ratios])
    hs = ws * np.asarray(ratios)
    cx, cy = np.meshgrid((np.arange(w) + 0.5) * stride,
                         (np.arange(h) + 0.5) * stride)
    cx, cy = cx.reshape(-1, 1), cy.reshape(-1, 1)
    boxes = np.stack([cx - ws / 2, cy - hs / 2, cx + ws / 2, cy + hs / 2],
                     axis=-1)
    return boxes.reshape(-1, 4).astype(np.float32)


def apply_deltas(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0),
                 scale_clamp: float = math.log(1000.0 / 16)):
    """Box2BoxTransform.apply_deltas: (N, 4) deltas on (N, 4) xyxy boxes."""
    widths = boxes[:, 2] - boxes[:, 0]
    heights = boxes[:, 3] - boxes[:, 1]
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    wx, wy, ww, wh = weights
    pcx = deltas[:, 0] / wx * widths + ctr_x
    pcy = deltas[:, 1] / wy * heights + ctr_y
    pw = torch.exp(torch.clamp(deltas[:, 2] / ww, max=scale_clamp)) * widths
    ph = torch.exp(torch.clamp(deltas[:, 3] / wh, max=scale_clamp)) * heights
    return torch.stack([pcx - pw / 2, pcy - ph / 2, pcx + pw / 2,
                        pcy + ph / 2], dim=-1)


def clip_boxes(boxes, hw: Tuple[int, int]):
    h, w = hw
    return torch.stack([boxes[:, 0].clamp(0, w), boxes[:, 1].clamp(0, h),
                        boxes[:, 2].clamp(0, w), boxes[:, 3].clamp(0, h)],
                       dim=-1)


def roi_align(feat, boxes, *, out_size: int = 7, stride: int = 1,
              samples: int = 2):
    """feat (H, W, C); boxes (N, 4) xyxy pixels -> (N, out, out, C):
    ROIAlignV2 (the -0.5 pixel offset), `samples` points a bin axis at the
    sub-bin centres, each read bilinearly with its corners clamped to the
    map, then averaged."""
    h, w, c = feat.shape
    n = boxes.shape[0]
    b = boxes / stride
    bw = torch.clamp(b[:, 2] - b[:, 0], min=1e-4)
    bh = torch.clamp(b[:, 3] - b[:, 1], min=1e-4)
    g = out_size * samples
    steps = (torch.arange(g, dtype=torch.float32, device=feat.device)
             + 0.5) / g
    xs = b[:, 0, None] + steps[None] * bw[:, None] - 0.5       # (N, G)
    ys = b[:, 1, None] + steps[None] * bh[:, None] - 0.5

    def corners(coords, size):
        c0 = torch.clamp(torch.floor(coords), 0, size - 1)
        c1 = torch.clamp(c0 + 1, 0, size - 1)
        return c0.long(), c1.long(), torch.clamp(coords - c0, 0.0, 1.0)

    xi0, xi1, tx = corners(xs, w)
    yi0, yi1, ty = corners(ys, h)
    tx = tx[:, None, :, None]
    ty = ty[:, :, None, None]

    def gather(yi, xi):
        return feat[yi[:, :, None], xi[:, None, :]]            # (N, G, G, C)

    fx0 = gather(yi0, xi0) * (1 - tx) + gather(yi0, xi1) * tx
    fx1 = gather(yi1, xi0) * (1 - tx) + gather(yi1, xi1) * tx
    vals = fx0 * (1 - ty) + fx1 * ty
    return vals.view(n, out_size, samples, out_size, samples, c).mean((2, 4))


def assign_fpn_level(boxes, *, min_level: int = 2, max_level: int = 5,
                     canonical_size: float = 224.0,
                     canonical_level: int = 4):
    """detectron2's assign_boxes_to_levels: floor(4 + log2(sqrt(area) /
    224)), clipped to [2, 5]."""
    area = torch.clamp((boxes[:, 2] - boxes[:, 0])
                       * (boxes[:, 3] - boxes[:, 1]), min=1e-6)
    lvl = torch.floor(canonical_level
                      + torch.log2(torch.sqrt(area) / canonical_size + 1e-8))
    return torch.clamp(lvl, min_level, max_level).long()


def multilevel_roi_align(feats: Dict[str, torch.Tensor], boxes, *,
                         out_size: int = 7,
                         levels: Sequence[str] = ("p2", "p3", "p4", "p5")):
    """ROIPooler over the FPN levels (NCHW, batch 1): each box pooled at its
    assigned level -> (N, out, out, C) fp32."""
    lvl = assign_fpn_level(boxes)
    c = feats[levels[0]].shape[1]
    pooled = boxes.new_zeros((boxes.shape[0], out_size, out_size, c),
                             dtype=torch.float32)
    for i, name in enumerate(levels):
        sel = lvl == i + 2
        if bool(sel.any()):
            pooled[sel] = roi_align(feats[name][0].permute(1, 2, 0),
                                    boxes[sel], out_size=out_size,
                                    stride=2 ** (i + 2))
    return pooled


def batched_nms(boxes, scores, classes, valid, iou_thresh: float,
                image_hw: Tuple[int, int]):
    """Class-local greedy NMS (detectron2's batched_nms): every class's
    boxes shifted by class * (max side + 2), so boxes of two classes never
    overlap -> keep flags (N,)."""
    offsets = classes.float()[:, None] * (max(image_hw) + 2.0)
    return greedy_nms(boxes + offsets, scores, valid, iou_thresh)
