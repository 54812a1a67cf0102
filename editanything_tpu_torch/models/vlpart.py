"""VLPart: the open-vocabulary part detector (Swin-B with an FPN, an RPN, a
three-stage cascade R-CNN and a CLIP-RN50 text classifier).

Counterpart of ``editanything_tpu/models/vlpart.py`` (the reference's
vlpart/: "a {part}" prompts and "background" L2-normalised through CLIP's
text tower; anchors 32-512 on p2-p6; cascade IoUs 0.5/0.6/0.7 with
class-agnostic boxes and scores averaged over the stages; the classifier a
linear to 1024, L2-normalised, x 50, against the text embeddings, sigmoid).
The modules are named after the JAX package's tree (``backbone``,
``fpn.lateral.I``, ``rpn.conv``, ``roi_heads.K.bbox_pred.0``,
``text_encoder.clip``), the detectron2 checkpoint's names mapped by
``checkpoints/convert.py::vlpart_state_dict``.

Proposals and detections keep the JAX package's fixed slabs (512
proposals, the top 100 detections) with validity flags, and every top-k is
a stable descending sort (ties to the lower index, as ``jax.lax.top_k``);
NMS is the exact greedy scan. The pooled ROI features are flattened
channel-last, (y, x, c), as the JAX package flattens them. No attention of
VLPart is unmasked (Swin's windows compute their own products, the CLIP
tower is causal), so it launches no kernel B.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from editanything_tpu_torch.models import detection as D
from editanything_tpu_torch.models import swin as SW
from editanything_tpu_torch.models.clip_text import CLIPTextModel
from editanything_tpu_torch.models.config import CLIPTextConfig
from editanything_tpu_torch.perception.amg import greedy_nms
from editanything_tpu_torch.utils.image import resize_pil


@dataclasses.dataclass(frozen=True)
class VLPartConfig:
    swin: SW.SwinConfig = dataclasses.field(default_factory=SW.swin_base)
    fpn_channels: int = 256
    anchor_sizes: Tuple[int, ...] = (32, 64, 128, 256, 512)   # p2..p6
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    pre_nms_topk: int = 1000          # per level (test)
    post_nms_topk: int = 512          # the proposal slab
    rpn_nms_thresh: float = 0.7
    pooler_resolution: int = 7
    box_head_fc_dim: int = 1024
    num_cascade_stages: int = 3
    cascade_weights: Tuple[Tuple[float, ...], ...] = (
        (10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0),
        (30.0, 30.0, 15.0, 15.0))
    zs_weight_dim: int = 1024
    norm_temperature: float = 50.0
    test_score_thresh: float = 0.0
    test_nms_thresh: float = 0.5
    test_topk: int = 100
    # CLIP-RN50's text tower: width 512, projected to 1024
    text: CLIPTextConfig = dataclasses.field(
        default_factory=lambda: CLIPTextConfig(
            hidden_size=512, intermediate_size=2048, num_layers=12,
            num_heads=8))

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_ratios)


def tiny_vlpart_config() -> VLPartConfig:
    return VLPartConfig(
        swin=SW.SwinConfig(embed_dim=16, depths=(1, 1, 1, 1),
                           num_heads=(1, 2, 2, 2), window_size=4),
        fpn_channels=16, pre_nms_topk=64, post_nms_topk=32,
        pooler_resolution=3, box_head_fc_dim=32, zs_weight_dim=32,
        test_topk=16,
        text=CLIPTextConfig(vocab_size=2000, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=4,
                            max_position_embeddings=16))


class CascadeStage(nn.Module):
    def __init__(self, cfg: VLPartConfig):
        super().__init__()
        fc = cfg.box_head_fc_dim
        self.fc1 = nn.Linear(cfg.fpn_channels * cfg.pooler_resolution ** 2,
                             fc)
        self.fc2 = nn.Linear(fc, fc)
        self.bbox_pred = nn.ModuleDict({"0": nn.Linear(fc, fc),
                                        "2": nn.Linear(fc, 4)})
        self.cls_score = nn.Linear(fc, cfg.zs_weight_dim)


class VLPart(nn.Module):
    def __init__(self, cfg: VLPartConfig):
        super().__init__()
        self.cfg = cfg
        c, a = cfg.fpn_channels, cfg.num_anchors
        self.backbone = SW.Swin(cfg.swin)
        self.fpn = SW.FPN([cfg.swin.stage_dim(i)
                           for i in range(len(cfg.swin.depths))], c)
        self.rpn = nn.Module()
        self.rpn.conv = nn.Conv2d(c, c, 3, padding=1)
        self.rpn.objectness_logits = nn.Conv2d(c, a, 1)
        self.rpn.anchor_deltas = nn.Conv2d(c, 4 * a, 1)
        self.roi_heads = nn.ModuleList(CascadeStage(cfg)
                                       for _ in range(cfg.num_cascade_stages))
        self.text_encoder = nn.Module()
        self.text_encoder.clip = CLIPTextModel(cfg.text)
        self.text_encoder.text_projection = nn.Parameter(
            torch.empty(cfg.text.hidden_size, cfg.zs_weight_dim))


# --------------------------------------------------------------------------
# text embeddings (vlpart.py:78-84)
# --------------------------------------------------------------------------

def _clip_ids(tokenizer, texts: List[str], length: int) -> np.ndarray:
    """BOS, the tokens cut to length - 2, EOS, EOS padding: (B, length)."""
    out = np.full((len(texts), length), tokenizer.eos_id, np.int64)
    for r, text in enumerate(texts):
        row = ([tokenizer.bos_id] + tokenizer.encode(text)[:length - 2]
               + [tokenizer.eos_id])
        out[r, :len(row)] = row
    return out


@torch.inference_mode()
def encode_vocabulary(model: VLPart, tokenizer, vocabulary: str,
                      prefix: str = "a ") -> torch.Tensor:
    """'dog head.dog nose' -> (zs_dim, K + 1) L2-normalised embeddings of
    "a dog head", "a dog nose" and a trailing "background": CLIP's hidden
    state at each prompt's first EOS, projected."""
    names = [v for v in vocabulary.split(".") if v.strip()]
    texts = [prefix + x.lower().replace(":", " ") for x in names]
    texts.append("background")
    te = model.text_encoder
    ids = torch.from_numpy(_clip_ids(
        tokenizer, texts, model.cfg.text.max_position_embeddings)).to(
            te.text_projection.device)
    hidden = te.clip(ids)
    eos = (ids == tokenizer.eos_id).int().argmax(dim=1)
    pooled = hidden[torch.arange(len(texts), device=ids.device), eos]
    emb = pooled @ te.text_projection
    return (emb / emb.norm(dim=-1, keepdim=True)).T


# --------------------------------------------------------------------------
# RPN and the cascade
# --------------------------------------------------------------------------

def _top(scores, k: int):
    """The k largest, ties to the lower index (``jax.lax.top_k``)."""
    idx = torch.sort(scores, descending=True, stable=True)[1][:k]
    return scores[idx], idx


def rpn_proposals(model: VLPart, feats: Dict[str, torch.Tensor],
                  image_hw: Tuple[int, int]):
    """-> (post_nms_topk, 4) fp32 boxes and their validity: per level the
    pre_nms_topk best anchors after their deltas, clipped; degenerate
    boxes dropped, exact NMS over all levels, the best post_nms_topk
    kept."""
    cfg, rpn = model.cfg, model.rpn
    all_boxes, all_scores = [], []
    for i, name in enumerate(("p2", "p3", "p4", "p5", "p6")):
        f = feats[name]
        _, _, h, w = f.shape
        t = F.relu(rpn.conv(f))
        obj = rpn.objectness_logits(t)[0].permute(1, 2, 0).reshape(-1)
        dlt = rpn.anchor_deltas(t)[0].permute(1, 2, 0).reshape(-1, 4)
        anchors = torch.from_numpy(D.level_anchors(
            h, w, 2 ** (i + 2), cfg.anchor_sizes[i], cfg.anchor_ratios)
        ).to(f.device)
        boxes = D.clip_boxes(D.apply_deltas(dlt.float(), anchors), image_hw)
        scores, idx = _top(obj.float(), min(cfg.pre_nms_topk, obj.shape[0]))
        all_boxes.append(boxes[idx])
        all_scores.append(scores)
    boxes = torch.cat(all_boxes)
    scores = torch.cat(all_scores)
    wh_ok = ((boxes[:, 2] - boxes[:, 0]) > 1e-3) & \
        ((boxes[:, 3] - boxes[:, 1]) > 1e-3)
    keep = greedy_nms(boxes, scores, wh_ok, cfg.rpn_nms_thresh)
    top, idx = _top(scores.masked_fill(~keep, -torch.inf), cfg.post_nms_topk)
    return boxes[idx], top > -torch.inf


def _run_stage(model: VLPart, feats, boxes, text_embed, stage: int):
    """One cascade stage -> (class logits (N, K + 1), box deltas (N, 4))."""
    cfg = model.cfg
    p = model.roi_heads[stage]
    pooled = D.multilevel_roi_align(feats, boxes,
                                    out_size=cfg.pooler_resolution)
    x = pooled.reshape(pooled.shape[0], -1).to(p.fc1.weight.dtype)
    x = F.relu(p.fc2(F.relu(p.fc1(x))))
    deltas = p.bbox_pred["2"](F.relu(p.bbox_pred["0"](x)))
    e = p.cls_score(x)
    e = e / torch.clamp(e.norm(dim=-1, keepdim=True), min=1e-6)
    logits = cfg.norm_temperature * (e @ text_embed.to(e.dtype))
    return logits, deltas


def backbone_forward(model: VLPart, pixels) -> Dict[str, torch.Tensor]:
    """(1, 3, H, W) normalised pixels -> the FPN's {"p2".."p6"}."""
    feats = SW.swin_forward(model.backbone, pixels)
    return SW.fpn_forward(model.fpn, [feats[f"swin{i}"] for i in
                                      range(len(model.cfg.swin.depths))])


def cascade_forward(model: VLPart, fpn, boxes, valid, text_embed,
                    hw: Tuple[int, int]):
    """The three stages from the proposals, scores averaged over them, the
    background column dropped, class-local NMS -> the test_topk slab."""
    cfg = model.cfg
    scores = 0.0
    for s in range(cfg.num_cascade_stages):
        logits, deltas = _run_stage(model, fpn, boxes, text_embed, s)
        scores = scores + torch.sigmoid(logits.float())
        boxes = D.clip_boxes(D.apply_deltas(
            deltas.float(), boxes, weights=cfg.cascade_weights[s]), hw)
    fg = (scores / cfg.num_cascade_stages)[:, :-1]      # background dropped
    n, k = fg.shape
    flat_scores = fg.reshape(-1)
    flat_boxes = boxes.repeat_interleave(k, dim=0)
    flat_classes = torch.arange(k, device=fg.device).repeat(n)
    flat_valid = valid.repeat_interleave(k) & \
        (flat_scores > cfg.test_score_thresh)
    keep = D.batched_nms(flat_boxes, flat_scores, flat_classes, flat_valid,
                         cfg.test_nms_thresh, hw)
    top, idx = _top(flat_scores.masked_fill(~keep, -torch.inf),
                    min(cfg.test_topk, flat_scores.shape[0]))
    found = top > -torch.inf
    return {"boxes": flat_boxes[idx], "scores": torch.where(found, top, 0.0),
            "classes": flat_classes[idx], "valid": found}


@torch.inference_mode()
def detect(model: VLPart, pixels, text_embed):
    """pixels (1, 3, H, W) normalised, text_embed (zs_dim, K + 1) -> dict of
    the test_topk slab: boxes (T, 4) xyxy pixels, scores (T,), classes
    (T,), valid (T,)."""
    hw = tuple(pixels.shape[-2:])
    fpn = backbone_forward(model, pixels)
    boxes, valid = rpn_proposals(model, fpn, hw)
    return cascade_forward(model, fpn, boxes, valid, text_embed, hw)


# --------------------------------------------------------------------------
# the detector
# --------------------------------------------------------------------------

PIXEL_MEAN = np.array([123.675, 116.280, 103.530], np.float32)
PIXEL_STD = np.array([58.395, 57.120, 57.375], np.float32)


class VLPartDetector:
    """``detector(image, "dog head.dog nose") -> (boxes (N, 4) xyxy pixels of
    the original image, scores (N,), part names)``; the short side resized
    to `short_side`, the long side at most `max_side` (ResizeShortestEdge
    ([800], 1333), sam2vlpart_edit.py:121), PIL's BILINEAR in numpy."""

    def __init__(self, model: VLPart, tokenizer, *, short_side: int = 800,
                 max_side: int = 1333):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.short_side = short_side
        self.max_side = max_side

    def prepare(self, image: np.ndarray) -> Tuple[torch.Tensor, float]:
        """Host side: the resized, normalised image on the model's device
        and the scale."""
        h, w = image.shape[:2]
        scale = min(self.short_side / min(h, w), self.max_side / max(h, w))
        nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
        px = (resize_pil(np.ascontiguousarray(image, np.uint8), (nh, nw),
                         "bilinear").astype(np.float32) - PIXEL_MEAN) / PIXEL_STD
        dev = self.model.text_encoder.text_projection.device
        return torch.from_numpy(px.transpose(2, 0, 1).copy())[None].to(dev), \
            scale

    def __call__(self, image: np.ndarray, text: str):
        px, scale = self.prepare(image)
        text_embed = encode_vocabulary(self.model, self.tokenizer, text)
        out = {k: v.cpu().numpy() for k, v in
               detect(self.model, px, text_embed).items()}
        valid = out["valid"]
        names = [v for v in text.split(".") if v.strip()]
        return (out["boxes"][valid] / scale, out["scores"][valid],
                [names[int(c)] for c in out["classes"][valid]])
