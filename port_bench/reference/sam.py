"""Plain fp32 SAM (ViT image encoder, prompt encoder, mask decoder) and the
automatic mask generator's outputs before and after its filters, with
the official checkpoint's parameter names.

Written from facebookresearch/segment-anything (``image_encoder.py``,
``prompt_encoder.py``, ``mask_decoder.py``, ``transformer.py``,
``automatic_mask_generator.py``) at ``sam_vit_h``'s sizes. Departures from
it, each the port's specification (the JAX package's) and noted in
PERF.md:

- a grid point is prompted alone, without the padding point (label -1)
  that the official prompt encoder appends when no box is given;
- the quality filters (predicted IoU, stability) and the box NMS read the
  256^2 low-resolution logits, not masks upscaled to the image;
- the ID map upscales the whole 256^2 logit frame (the padding included)
  to the image, without first cropping the padding.

Every product goes through ``reference/nn.py``. Imports nothing of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from port_bench.reference import nn as P
from port_bench.reference.image import resize_pil_bilinear


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    mlp_ratio: float = 4.0
    out_chans: int = 256
    prompt_embed_dim: int = 256
    num_multimask_outputs: int = 3
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048

    @property
    def embedding_size(self) -> int:
        return self.img_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class AMGConfig:
    points_per_side: int = 32
    points_per_batch: int = 256
    pred_iou_thresh: float = 0.88
    stability_score_thresh: float = 0.95
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    mask_threshold: float = 0.0
    max_masks: int = 256


def lin(m, x):
    return P.linear(x, m.weight, m.bias)


class LayerNorm2d(nn.Module):
    def __init__(self, c, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        return P.layer_norm_2d(x.float(), self.weight, self.bias, self.eps)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return P.layer_norm(x, self.weight, self.bias, self.eps)


def rel_pos(table, size):
    """(2 size - 1, d) -> (size, size, d): entry (i, j) is table[i - j +
    size - 1] (official ``get_rel_pos`` where q and k sizes agree)."""
    i = torch.arange(size, device=table.device)
    return table.float()[i[:, None] - i[None, :] + size - 1]


class EncoderAttention(nn.Module):
    def __init__(self, dim, heads, size):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))

    def forward(self, x):
        """Official ``Attention`` with decomposed relative positions:
        softmax(q k^T / sqrt(d) + rel_h + rel_w) v, the biases from the
        unscaled q; query rows in blocks so the logits stay bounded."""
        b, h, w, c = x.shape
        nh, hd, n = self.heads, c // self.heads, h * w
        qkv = lin(self.qkv, x.reshape(b, n, c)).reshape(b, n, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2).reshape(b * nh, n, hd)
                   for i in range(3))
        rh, rw = rel_pos(self.rel_pos_h, h), rel_pos(self.rel_pos_w, w)
        rows = max(w, (P.ATTENTION_BLOCK // (b * nh * n)) // w * w)
        out = []
        for r in range(0, n, rows):
            qb = q[:, r:r + rows]
            m = qb.shape[1]
            logits = P.matmul(qb, k.transpose(1, 2)) / math.sqrt(hd)
            qr = qb.reshape(b * nh, m // w, w, hd)
            y0 = r // w
            bias_h = torch.einsum("bhwc,hkc->bhwk", P._q(qr),
                                  P._q(rh[y0:y0 + m // w]))
            bias_w = torch.einsum("bhwc,wkc->bhwk", P._q(qr), P._q(rw))
            logits = (logits.view(b * nh, m // w, w, h, w)
                      + bias_h[..., :, None] + bias_w[..., None, :])
            probs = torch.softmax(logits.reshape(b * nh, m, n), dim=-1)
            out.append(P.matmul(probs, v))
        o = torch.cat(out, dim=1).reshape(b, nh, h, w, hd)
        return lin(self.proj, o.permute(0, 2, 3, 1, 4).reshape(b, h, w, c))


class EncoderBlock(nn.Module):
    def __init__(self, cfg: SAMConfig, window: int):
        super().__init__()
        d = cfg.embed_dim
        self.window = window
        self.norm1 = LayerNorm(d)
        self.attn = EncoderAttention(d, cfg.num_heads,
                                     window or cfg.embedding_size)
        self.norm2 = LayerNorm(d)
        self.mlp = nn.Module()
        self.mlp.lin1 = nn.Linear(d, int(d * cfg.mlp_ratio))
        self.mlp.lin2 = nn.Linear(int(d * cfg.mlp_ratio), d)

    def forward(self, x):
        y = self.norm1(x)
        if self.window:
            b, h, w, c = y.shape
            s = self.window
            ph, pw = -h % s, -w % s
            y = F.pad(y, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            y = y.reshape(b, hp // s, s, wp // s, s, c).permute(
                0, 1, 3, 2, 4, 5).reshape(-1, s, s, c)
            y = self.attn(y).reshape(b, hp // s, wp // s, s, s, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)[:, :h, :w]
        else:
            y = self.attn(y)
        x = x + y
        return x + lin(self.mlp.lin2, F.gelu(lin(self.mlp.lin1,
                                                  self.norm2(x))))


class ImageEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d, e = cfg.embed_dim, cfg.embedding_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, d, cfg.patch_size, cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, e, e, d))
        self.blocks = nn.ModuleList(
            [EncoderBlock(cfg, 0 if i in cfg.global_attn_indexes
                          else cfg.window_size) for i in range(cfg.depth)])
        self.neck = nn.Sequential(
            nn.Conv2d(d, cfg.out_chans, 1, bias=False), LayerNorm2d(cfg.out_chans),
            nn.Conv2d(cfg.out_chans, cfg.out_chans, 3, padding=1, bias=False),
            LayerNorm2d(cfg.out_chans))

    def forward(self, x):
        pe = self.patch_embed.proj
        h = P.conv2d(x, pe.weight, pe.bias, stride=pe.stride).permute(0, 2, 3, 1)
        h = h + self.pos_embed.float()
        for blk in self.blocks:
            h = blk(h)
        n = self.neck
        h = n[1](P.conv2d(h.permute(0, 3, 1, 2), n[0].weight))
        return n[3](P.conv2d(h, n[2].weight, padding=1))


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.cfg = cfg
        self.pe_layer = nn.Module()
        self.pe_layer.register_buffer("positional_encoding_gaussian_matrix",
                                      torch.zeros(2, d // 2))
        self.point_embeddings = nn.ModuleList([nn.Embedding(1, d)
                                               for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, 4, 2, 2), LayerNorm2d(4), nn.GELU(),
            nn.Conv2d(4, 16, 2, 2), LayerNorm2d(16), nn.GELU(),
            nn.Conv2d(16, d, 1))

    def pe(self, coords):
        """coords in [0, 1], (..., 2) -> random Fourier features (..., d)."""
        g = self.pe_layer.positional_encoding_gaussian_matrix.float()
        proj = 2.0 * np.pi * ((2.0 * coords.float() - 1.0) @ g)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def dense_pe(self):
        e = self.cfg.embedding_size
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        t = (torch.arange(e, dtype=torch.float32, device=dev) + 0.5) / e
        ys, xs = torch.meshgrid(t, t, indexing="ij")
        return self.pe(torch.stack([xs, ys], dim=-1)).permute(2, 0, 1)[None]

    def points(self, coords):
        """(B, 2) positive points in the 1024 frame -> (B, 1, d)."""
        pe = self.pe((coords.float()[:, None] + 0.5) / self.cfg.img_size)
        return pe + self.point_embeddings[1].weight.float()


class Attention(nn.Module):
    def __init__(self, dim, heads, downsample=1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        b = q.shape[0]
        qh, kh, vh = lin(self.q_proj, q), lin(self.k_proj, k), lin(self.v_proj, v)
        inner = qh.shape[-1]

        def heads(x):
            return x.reshape(b, -1, self.heads, inner // self.heads).transpose(1, 2)
        out = P.attention(heads(qh), heads(kh), heads(vh))
        return lin(self.out_proj, out.transpose(1, 2).reshape(b, -1, inner))


class TwoWayBlock(nn.Module):
    def __init__(self, d, heads, mlp, skip_pe):
        super().__init__()
        self.skip_pe = skip_pe
        self.self_attn = Attention(d, heads)
        self.norm1 = LayerNorm(d)
        self.cross_attn_token_to_image = Attention(d, heads, 2)
        self.norm2 = LayerNorm(d)
        self.mlp = nn.Module()
        self.mlp.lin1 = nn.Linear(d, mlp)
        self.mlp.lin2 = nn.Linear(mlp, d)
        self.norm3 = LayerNorm(d)
        self.cross_attn_image_to_token = Attention(d, heads, 2)
        self.norm4 = LayerNorm(d)

    def forward(self, queries, keys, qpe, kpe):
        if self.skip_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + qpe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        k = keys + kpe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            queries + qpe, k, keys))
        h = F.relu(lin(self.mlp.lin1, queries))
        queries = self.norm3(queries + lin(self.mlp.lin2, h))
        keys = self.norm4(keys + self.cross_attn_image_to_token(
            k, queries + qpe, queries))
        return queries, keys


class MLP(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = lin(layer, x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d, nm = cfg.prompt_embed_dim, cfg.num_multimask_outputs + 1
        self.transformer = nn.Module()
        self.transformer.layers = nn.ModuleList(
            [TwoWayBlock(d, cfg.decoder_heads, cfg.decoder_mlp_dim, i == 0)
             for i in range(cfg.decoder_depth)])
        self.transformer.final_attn_token_to_image = Attention(
            d, cfg.decoder_heads, 2)
        self.transformer.norm_final_attn = LayerNorm(d)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(nm, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, 2), LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            [MLP([d, d, d, d // 8]) for _ in range(nm)])
        self.iou_prediction_head = MLP([d, d, d, nm])

    def forward(self, emb, image_pe, sparse, dense):
        """emb (1, d, e, e), image_pe (1, d, e, e), sparse (B, P, d), dense
        (d,) the no-mask embedding -> (logits (B, 4, 4e, 4e), iou (B, 4))."""
        b, e = sparse.shape[0], emb.shape[-1]
        out = torch.cat([self.iou_token.weight, self.mask_tokens.weight]).float()
        tokens = torch.cat([out[None].expand(b, -1, -1), sparse.float()], 1)
        src = (emb.float() + dense.float()[None, :, None, None])
        src = src.flatten(2).transpose(1, 2).expand(b, -1, -1)
        pos = image_pe.float().flatten(2).transpose(1, 2).expand(b, -1, -1)
        t = self.transformer
        queries, keys = tokens, src
        for layer in t.layers:
            queries, keys = layer(queries, keys, tokens, pos)
        queries = t.norm_final_attn(queries + t.final_attn_token_to_image(
            queries + tokens, keys + pos, keys))
        nm = self.mask_tokens.weight.shape[0]
        hyper = torch.stack([mlp(queries[:, 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        up = self.output_upscaling
        x = keys.transpose(1, 2).reshape(b, -1, e, e)
        x = P.conv_transpose2d(x, up[0].weight, up[0].bias, stride=2)
        x = F.gelu(up[1](x))
        x = F.gelu(P.conv_transpose2d(x, up[3].weight, up[3].bias, stride=2))
        logits = P.matmul(hyper, x.flatten(2)).reshape(b, nm, 4 * e, 4 * e)
        return logits, self.iou_prediction_head(queries[:, 0])


class Sam(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoder(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)


PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def preprocess(image: np.ndarray, cfg: SAMConfig, device):
    """uint8 (h, w, 3) -> (normalised (1, 3, S, S) fp32 padded at the bottom
    and right, (nh, nw)): the long side resized to S with PIL's BILINEAR
    (official ``ResizeLongestSide``)."""
    h, w = image.shape[:2]
    scale = cfg.img_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    img = resize_pil_bilinear(image, (nh, nw))
    x = torch.from_numpy(img.astype(np.float32)).to(device)
    x = (x - torch.tensor(PIXEL_MEAN, device=device)) / torch.tensor(
        PIXEL_STD, device=device)
    x = F.pad(x.permute(2, 0, 1), (0, cfg.img_size - nw, 0, cfg.img_size - nh))
    return x[None], (nh, nw)


def grid_points(amg: AMGConfig, nh: int, nw: int) -> np.ndarray:
    """The official 32 x 32 point grid over the resized image, (P, 2) x, y."""
    n = amg.points_per_side
    off = 1.0 / (2 * n)
    t = np.linspace(off, 1.0 - off, n)
    gx, gy = np.meshgrid(t * nw, t * nh)
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


@torch.no_grad()
def candidates(sam: Sam, amg: AMGConfig, emb, points, rows=None):
    """The AMG's candidates before its filters: point p's multimask
    outputs are candidates 3p..3p+2. `rows` (optional) picks candidates;
    only their points are decoded. Returns (logits (C, 4e, 4e), iou (C,))."""
    pe_mod, dec = sam.prompt_encoder, sam.mask_decoder
    idx = (torch.arange(3 * points.shape[0], device=points.device)
           if rows is None else torch.as_tensor(rows, device=points.device))
    pts = torch.unique(idx // 3)
    image_pe = pe_mod.dense_pe()
    logits, ious = [], []
    for i in range(0, pts.shape[0], amg.points_per_batch):
        p = pts[i:i + amg.points_per_batch]
        masks, iou = dec(emb, image_pe, pe_mod.points(points[p]),
                          pe_mod.no_mask_embed.weight[0])
        logits.append(masks[:, 1:4].flatten(0, 1))
        ious.append(iou[:, 1:4].flatten())
    logits, ious = torch.cat(logits), torch.cat(ious)
    where = {int(v): j for j, v in enumerate(pts.tolist())}
    sel = torch.tensor([3 * where[int(c) // 3] + int(c) % 3
                        for c in idx.tolist()], device=points.device)
    return logits[sel], ious[sel]


def select(logits, iou, amg: AMGConfig):
    """Filters, greedy box NMS and the first ``max_masks`` kept candidates
    in candidate order -> (their logits, valid flags)."""
    t, off = amg.mask_threshold, amg.stability_score_offset
    hi = (logits > t + off).sum(dim=(1, 2)).float()
    lo = (logits > t - off).sum(dim=(1, 2)).clamp(min=1).float()
    mask = logits > t
    area = mask.sum(dim=(1, 2))
    valid = (iou > amg.pred_iou_thresh) & (hi / lo > amg.stability_score_thresh) \
        & (area > 0)
    keep = np.zeros(logits.shape[0], bool)
    idx = np.nonzero(valid.cpu().numpy())[0]
    if len(idx):
        m = mask[torch.from_numpy(idx).to(logits.device)]
        rows, cols = m.any(2).cpu().numpy(), m.any(1).cpu().numpy()
        boxes = np.array([[c.argmax(), r.argmax(), len(c) - c[::-1].argmax(),
                           len(r) - r[::-1].argmax()]
                          for r, c in zip(rows, cols)], np.float64)
        order = np.argsort(-iou[torch.from_numpy(idx).to(iou.device)]
                           .cpu().numpy(), kind="stable")
        kept = []
        for j in order:
            ok = True
            for k in kept:
                a, b = boxes[j], boxes[k]
                inter = max(0.0, min(a[2], b[2]) - max(a[0], b[0])) * max(
                    0.0, min(a[3], b[3]) - max(a[1], b[1]))
                union = ((a[2] - a[0]) * (a[3] - a[1])
                         + (b[2] - b[0]) * (b[3] - b[1]) - inter)
                if inter / max(union, 1e-6) > amg.box_nms_thresh:
                    ok = False
                    break
            if ok:
                kept.append(j)
        keep[idx[kept]] = True
    chosen = np.nonzero(keep)[0][:amg.max_masks]
    return chosen


def id_map(logits, chosen, out_hw, threshold=0.0):
    """Kept masks, ids 1.. in slot order, the later over the earlier ->
    uint8 (H, W, 3) R = id % 256, G = id // 256. The logits are upscaled
    with an antialiased bilinear resize of the whole frame."""
    ids = np.zeros(out_hw, np.int64)
    for slot, c in enumerate(chosen):
        up = F.interpolate(logits[int(c)][None, None].float(), size=out_hw,
                           mode="bilinear", align_corners=False,
                           antialias=True)[0, 0]
        ids[(up > threshold).cpu().numpy()] = slot + 1
    out = np.zeros(out_hw + (3,), np.uint8)
    out[..., 0] = ids % 256
    out[..., 1] = ids // 256
    return out
