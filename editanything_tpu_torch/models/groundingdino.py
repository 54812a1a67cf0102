"""GroundingDINO: the open-vocabulary detector behind text-grounded edits.

Counterpart of ``editanything_tpu/models/groundingdino.py`` (the official
``groundingdino_swint_ogc`` architecture: Swin-T, BERT-base, a deformable
DETR of 6 + 6 layers with 900 queries, 4 levels, 8 heads, 4 points,
image<->text fusion and contrastive token scores). The modules carry the
official checkpoint's names (``bert.encoder.layer.N.attention.self.query``,
``transformer.encoder.fusion_layers.N.attn.v_proj``, packed
``self_attn.in_proj_weight`` as ``nn.MultiheadAttention`` stores it,
``input_proj.I.0``/``.1``), so the official state dict loads strictly once
``checkpoints/convert.py::dino_state_dict`` has dropped its aliases.

What runs where:
- the decoder's query self-attention is unmasked and goes through
  ``layers.attention``, kernel B on CUDA at (1, 8, 900, 900, 32), 6 launches
  a detection; BERT's, the text enhancer's and the decoder's text
  cross-attention are masked, so they take the plain masked attention, as
  XLA runs them in the JAX package; the fusion block computes its own
  products;
- ``deform_attn`` (multi-scale deformable attention) is a gather of the
  four bilinear corners of every sample and a weighted sum, with
  ``grid_sample``'s zero padding (align_corners=False), as the JAX package
  computes it; no kernel runs it;
- ``input_proj``'s GroupNorm(32) is the plain ``layers.group_norm`` (XLA's
  in the JAX package), not kernel A;
- the two-stage query selection sorts the scores with a stable descending
  sort, so ties keep the lower index, as ``jax.lax.top_k`` does;
- the reference boxes and their inverse sigmoid are fp32 whatever the
  weights' dtype, so the clamps (1e-3) and the ``inf`` of invalid
  proposals hold in a bf16 run.

BERT's LayerNorms use eps 1e-5, as the JAX package's (the published
bert-base has 1e-12). Host work (resize, tokens, phrase masks, the
thresholds) is numpy; the image resize is PIL's BILINEAR in numpy
(``utils/image.py::resize_pil``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from editanything_tpu_torch.core import layers as L
from editanything_tpu_torch.models import swin as SW
from editanything_tpu_torch.utils.image import resize_pil


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 512
    type_vocab: int = 2


@dataclasses.dataclass(frozen=True)
class DINOConfig:
    swin: SW.SwinConfig = dataclasses.field(
        default_factory=lambda: dataclasses.replace(
            SW.swin_tiny(), out_indices=(1, 2, 3)))
    return_interm_indices: Tuple[int, ...] = (1, 2, 3)
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    num_queries: int = 900
    num_feature_levels: int = 4
    n_points: int = 4
    max_text_len: int = 256
    pe_temperature: float = 20.0
    input_proj_groups: int = 32

    # the official model derives these as nheads // 2, dim_feedforward // 2
    @property
    def text_heads(self) -> int:
        return max(self.nheads // 2, 1)

    @property
    def fusion_dim(self) -> int:
        return self.dim_feedforward // 2

    @property
    def fusion_heads(self) -> int:
        return max(self.nheads // 2, 1)


def tiny_dino_config() -> DINOConfig:
    return DINOConfig(
        swin=SW.SwinConfig(embed_dim=8, depths=(2, 1, 1, 1),
                           num_heads=(1, 2, 2, 2), window_size=4,
                           out_indices=(1, 2, 3)),
        bert=BertConfig(vocab_size=200, hidden=16, layers=1, heads=2,
                        intermediate=32, max_positions=32),
        hidden_dim=16, nheads=2, enc_layers=1, dec_layers=1,
        dim_feedforward=32, num_queries=12, n_points=2, max_text_len=16,
        input_proj_groups=4)


# --------------------------------------------------------------------------
# modules (parameters only, named as the official checkpoint)
# --------------------------------------------------------------------------

def _module(**children) -> nn.Module:
    m = nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden
        self.attention = _module(
            self=_module(query=nn.Linear(d, d), key=nn.Linear(d, d),
                         value=nn.Linear(d, d)),
            output=_module(dense=nn.Linear(d, d), LayerNorm=L.LayerNorm(d)))
        self.intermediate = _module(dense=nn.Linear(d, cfg.intermediate))
        self.output = _module(dense=nn.Linear(cfg.intermediate, d),
                              LayerNorm=L.LayerNorm(d))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden
        self.embeddings = _module(
            word_embeddings=nn.Embedding(cfg.vocab_size, d),
            position_embeddings=nn.Embedding(cfg.max_positions, d),
            token_type_embeddings=nn.Embedding(cfg.type_vocab, d),
            LayerNorm=L.LayerNorm(d))
        self.encoder = _module(layer=nn.ModuleList(
            BertLayer(cfg) for _ in range(cfg.layers)))


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters: packed q/k/v projections and
    ``out_proj``."""

    def __init__(self, d: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)


class MSDeformAttn(nn.Module):
    def __init__(self, d: int, heads: int, levels: int, points: int):
        super().__init__()
        self.sampling_offsets = nn.Linear(d, heads * levels * points * 2)
        self.attention_weights = nn.Linear(d, heads * levels * points)
        self.value_proj = nn.Linear(d, d)
        self.output_proj = nn.Linear(d, d)


def _mlp(dims: Sequence[int]) -> nn.Module:
    return _module(layers=nn.ModuleList(
        nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])))


def _ffn_layer(m: nn.Module, d: int, ffn: int) -> None:
    m.linear1 = nn.Linear(d, ffn)
    m.linear2 = nn.Linear(ffn, d)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: DINOConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.self_attn = MSDeformAttn(d, cfg.nheads, cfg.num_feature_levels,
                                      cfg.n_points)
        self.norm1 = L.LayerNorm(d)
        _ffn_layer(self, d, cfg.dim_feedforward)
        self.norm2 = L.LayerNorm(d)


class TextEnhancerLayer(nn.Module):
    def __init__(self, cfg: DINOConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.self_attn = MultiheadAttention(d)
        self.norm1 = L.LayerNorm(d)
        _ffn_layer(self, d, cfg.dim_feedforward // 2)
        self.norm2 = L.LayerNorm(d)


class BiAttentionBlock(nn.Module):
    def __init__(self, cfg: DINOConfig):
        super().__init__()
        d, e = cfg.hidden_dim, cfg.fusion_dim
        self.layer_norm_v = L.LayerNorm(d)
        self.layer_norm_l = L.LayerNorm(d)
        self.gamma_v = nn.Parameter(torch.empty(d))
        self.gamma_l = nn.Parameter(torch.empty(d))
        self.attn = _module(
            v_proj=nn.Linear(d, e), l_proj=nn.Linear(d, e),
            values_v_proj=nn.Linear(d, e), values_l_proj=nn.Linear(d, e),
            out_v_proj=nn.Linear(e, d), out_l_proj=nn.Linear(e, d))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DINOConfig):
        super().__init__()
        d = cfg.hidden_dim
        self.cross_attn = MSDeformAttn(d, cfg.nheads, cfg.num_feature_levels,
                                       cfg.n_points)
        self.norm1 = L.LayerNorm(d)
        self.ca_text = MultiheadAttention(d)
        self.catext_norm = L.LayerNorm(d)
        self.self_attn = MultiheadAttention(d)
        self.norm2 = L.LayerNorm(d)
        _ffn_layer(self, d, cfg.dim_feedforward)
        self.norm3 = L.LayerNorm(d)


class GroundingDINO(nn.Module):
    def __init__(self, cfg: DINOConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_dim
        self.backbone = SW.Swin(cfg.swin)
        self.bert = BertModel(cfg.bert)
        self.feat_map = nn.Linear(cfg.bert.hidden, d)
        dims = [cfg.swin.stage_dim(i) for i in cfg.return_interm_indices]
        projs = [nn.Sequential(nn.Conv2d(c, d, 1),
                               nn.GroupNorm(cfg.input_proj_groups, d))
                 for c in dims]
        projs.append(nn.Sequential(nn.Conv2d(dims[-1], d, 3, 2, 1),
                                   nn.GroupNorm(cfg.input_proj_groups, d)))
        self.input_proj = nn.ModuleList(projs)
        self.transformer = _module(
            encoder=_module(
                layers=nn.ModuleList(EncoderLayer(cfg)
                                     for _ in range(cfg.enc_layers)),
                text_layers=nn.ModuleList(TextEnhancerLayer(cfg)
                                          for _ in range(cfg.enc_layers)),
                fusion_layers=nn.ModuleList(BiAttentionBlock(cfg)
                                            for _ in range(cfg.enc_layers))),
            decoder=_module(
                layers=nn.ModuleList(DecoderLayer(cfg)
                                     for _ in range(cfg.dec_layers)),
                norm=L.LayerNorm(d),
                ref_point_head=_mlp((2 * d, d, d))),
            tgt_embed=nn.Embedding(cfg.num_queries, d),
            enc_output=nn.Linear(d, d),
            enc_output_norm=L.LayerNorm(d),
            enc_out_bbox_embed=_mlp((d, d, d, 4)))
        self.transformer.level_embed = nn.Parameter(
            torch.empty(cfg.num_feature_levels, d))
        # one MLP shared by every decoder layer (the official model's six
        # tied copies)
        self.bbox_embed = _mlp((d, d, d, 4))


# --------------------------------------------------------------------------
# BERT
# --------------------------------------------------------------------------

def _heads(x, heads: int):
    b, n, _ = x.shape
    return x.view(b, n, heads, -1).transpose(1, 2)


def bert_forward(bert: BertModel, cfg: BertConfig, ids, attn_mask,
                 position_ids=None):
    """ids (B, T); attn_mask (B, T) key mask or (B, T, T) full mask (bool,
    True = attend); position_ids (B, T) or None -> (B, T, D), post-LN BERT
    as GroundingDINO's BertModelWarper drives it."""
    b, t = ids.shape
    emb = bert.embeddings
    if position_ids is None:
        position_ids = torch.arange(t, device=ids.device)[None]
    x = (emb.word_embeddings.weight[ids]
         + emb.position_embeddings.weight[position_ids]
         + emb.token_type_embeddings.weight[0])
    x = emb.LayerNorm(x)
    mask = attn_mask[:, None, None, :] if attn_mask.dim() == 2 \
        else attn_mask[:, None]
    for layer in bert.encoder.layer:
        sa = layer.attention.self
        q, k, v = (_heads(proj(x), cfg.heads)
                   for proj in (sa.query, sa.key, sa.value))
        att = L.attention(q, k, v, mask=mask).transpose(1, 2).reshape(b, t, -1)
        out = layer.attention.output
        x = out.LayerNorm(x + out.dense(att))
        y = F.gelu(layer.intermediate.dense(x))
        x = layer.output.LayerNorm(x + layer.output.dense(y))
    return x


def generate_text_masks(ids: np.ndarray, special_ids: Sequence[int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-phrase block-diagonal self-attention mask and position ids
    (groundingdino's generate_masks_with_special_tokens_and_transfer_map):
    special tokens ([CLS]/[SEP]/./?) close phrases, each token attends
    within its phrase (the closing special token included) and positions
    restart at every phrase. The last special token, the final [SEP] wherever
    padding put it, and padding tokens attend only to themselves. ids (T,)
    -> ((T, T) bool, (T,) int32)."""
    ids = np.asarray(ids)
    t = ids.shape[0]
    attn = np.eye(t, dtype=bool)
    pos = np.zeros((t,), np.int32)
    prev = 0
    cols = np.nonzero(np.isin(ids, list(special_ids)))[0]
    for k, col in enumerate(cols):
        if col == 0 or k == len(cols) - 1:
            pos[col] = 0
        else:
            attn[prev + 1:col + 1, prev + 1:col + 1] = True
            pos[prev + 1:col + 1] = np.arange(0, col - prev)
        prev = int(col)
    return attn, pos


# --------------------------------------------------------------------------
# multi-scale deformable attention
# --------------------------------------------------------------------------

def deform_attn(p: MSDeformAttn, query, reference_points, value_flat,
                shapes: Sequence[Tuple[int, int]], *, heads: int,
                points: int):
    """query (N, D); reference_points (N, L, 2) normalised centres or (N, L,
    4) normalised cxcywh boxes; value_flat (sum H*W, D) over the levels of
    `shapes` -> (N, D).

    Sample points: ref + offsets / (W, H) (2-d), or ref_xy + offsets /
    points * ref_wh / 2 (4-d); each is read bilinearly at loc * size - 0.5,
    corners outside the map contributing zero (grid_sample, zero padding,
    align_corners=False); the samples are weighted by the softmax over
    levels x points of each head. Sample coordinates and weights are fp32."""
    n, d = query.shape
    levels = len(shapes)
    dh = d // heads
    dev = query.device
    value = p.value_proj(value_flat).reshape(-1, dh)      # (S * H, dh)
    offs = p.sampling_offsets(query).view(n, heads, levels, points, 2).float()
    attw = torch.softmax(p.attention_weights(query).view(
        n, heads, levels * points).float(), dim=-1).view(
            n, heads, levels, points)
    ref = reference_points.float()[:, None, :, None]      # (N, 1, L, 1, *)
    sizes = torch.tensor(shapes, dtype=torch.float32, device=dev)  # (L, 2)
    lvl_h = sizes[:, 0][None, None, :, None]
    lvl_w = sizes[:, 1][None, None, :, None]
    if reference_points.shape[-1] == 4:
        locs = ref[..., :2] + offs / points * ref[..., 2:] * 0.5
    else:
        locs = ref + offs / sizes.flip(-1)[None, None, :, None]
    x = locs[..., 0] * lvl_w - 0.5                        # (N, H, L, P)
    y = locs[..., 1] * lvl_h - 0.5
    starts = np.concatenate([[0], np.cumsum([h * w for h, w in shapes])[:-1]])
    lvl_start = torch.tensor(starts, device=dev)[None, None, :, None]
    ih, iw = lvl_h.long(), lvl_w.long()
    x0, y0 = torch.floor(x), torch.floor(y)
    tx, ty = x - x0, y - y0
    xi0, yi0 = x0.long(), y0.long()
    head = torch.arange(heads, device=dev)[None, :, None, None]
    out = torch.zeros((n, heads, dh), dtype=torch.float32, device=dev)
    for dx, dy, wgt in ((0, 0, (1 - tx) * (1 - ty)), (1, 0, tx * (1 - ty)),
                        (0, 1, (1 - tx) * ty), (1, 1, tx * ty)):
        xi, yi = xi0 + dx, yi0 + dy
        valid = (xi >= 0) & (xi < iw) & (yi >= 0) & (yi < ih)
        idx = (lvl_start + yi.clamp(min=0).minimum(ih - 1) * iw
               + xi.clamp(min=0).minimum(iw - 1))
        g = value[(idx * heads + head).reshape(-1)].view(
            n, heads, levels, points, dh)
        w = wgt * valid * attw
        out += torch.einsum("nhlpc,nhlp->nhc", g.float(), w)
    return p.output_proj(out.reshape(n, d).to(query.dtype))


# --------------------------------------------------------------------------
# attention blocks
# --------------------------------------------------------------------------

def _mha(p: MultiheadAttention, q_in, k_in, v_in, heads: int, mask=None):
    """nn.MultiheadAttention over single sequences: q_in (N, D), k_in and
    v_in (M, D); mask broadcastable to (1, H, N, M), True = attend. Unmasked
    calls reach kernel B on CUDA tensors."""
    n, d = q_in.shape
    wq, wk, wv = p.in_proj_weight.chunk(3)
    bq, bk, bv = p.in_proj_bias.chunk(3)
    q = _heads(F.linear(q_in, wq, bq)[None], heads)
    k = _heads(F.linear(k_in, wk, bk)[None], heads)
    v = _heads(F.linear(v_in, wv, bv)[None], heads)
    out = L.attention(q, k, v, mask=mask)
    return p.out_proj(out.transpose(1, 2).reshape(n, d))


def _bi_attention(blk: BiAttentionBlock, v, l, heads: int, text_pad_mask):
    """The fusion block: both inputs LayerNormed (the norm rebases the
    residual), image->text attention with padded text keys masked,
    text->image attention unmasked, layer-scale gammas. text_pad_mask (Tl,)
    True = pad."""
    vn, ln = blk.layer_norm_v(v), blk.layer_norm_l(l)
    a = blk.attn
    e = a.v_proj.out_features
    dh = e // heads
    q = (a.v_proj(vn) * dh ** -0.5).view(-1, heads, dh)
    k = a.l_proj(ln).view(-1, heads, dh)
    vv = a.values_v_proj(vn).view(-1, heads, dh)
    vl = a.values_l_proj(ln).view(-1, heads, dh)
    logits = torch.einsum("nhd,mhd->hnm", q.float(), k.float())
    attn_v = torch.softmax(logits.masked_fill(text_pad_mask[None, None],
                                              -1e30), dim=-1)
    attn_l = torch.softmax(logits.transpose(1, 2), dim=-1)
    dv = torch.einsum("hnm,mhd->nhd", attn_v.to(vl.dtype), vl).reshape(-1, e)
    dl = torch.einsum("hmn,nhd->mhd", attn_l.to(vv.dtype), vv).reshape(-1, e)
    return (vn + blk.gamma_v * a.out_v_proj(dv),
            ln + blk.gamma_l * a.out_l_proj(dl))


def _text_enhancer(p: TextEnhancerLayer, txt, pos_text, heads: int,
                   block_mask):
    q = txt + pos_text
    a = _mha(p.self_attn, q, q, txt, heads, mask=block_mask[None, None])
    txt = p.norm1(txt + a)
    return p.norm2(txt + p.linear2(F.relu(p.linear1(txt))))


def _enc_image_layer(p: EncoderLayer, img, pos, ref_pts, shapes, heads,
                     points):
    sa = deform_attn(p.self_attn, img + pos, ref_pts, img, shapes,
                     heads=heads, points=points)
    img = p.norm1(img + sa)
    return p.norm2(img + p.linear2(F.relu(p.linear1(img))))


def _bbox_mlp(m: nn.Module, x):
    layers = m.layers
    for lin in layers[:-1]:
        x = F.relu(lin(x))
    return layers[-1](x)


# --------------------------------------------------------------------------
# positions and proposals
# --------------------------------------------------------------------------

def _centres(shapes) -> np.ndarray:
    """(sum H*W, 2) normalised (x, y) pixel centres of every level."""
    out = []
    for h, w in shapes:
        gy, gx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w,
                             indexing="ij")
        out.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    return np.concatenate(out, 0)


def _sine_pos_hw(shapes, d: int, temperature: float) -> np.ndarray:
    """PositionEmbeddingSineHW over unpadded maps, (sum H*W, D) float64:
    1-based positions normalised to 2 pi, channels (y, x), sin/cos
    interleaved."""
    npf = d // 2
    dim_t = temperature ** (2 * (np.arange(npf) // 2) / npf)

    def emb(n):
        e = (np.arange(1, n + 1, dtype=np.float64) / (n + 1e-6)
             * 2 * np.pi)[:, None] / dim_t
        return np.stack([np.sin(e[:, 0::2]), np.cos(e[:, 1::2])],
                        axis=2).reshape(n, npf)
    outs = []
    for h, w in shapes:
        pe = np.concatenate([np.broadcast_to(emb(h)[:, None], (h, w, npf)),
                             np.broadcast_to(emb(w)[None], (h, w, npf))], -1)
        outs.append(pe.reshape(h * w, d))
    return np.concatenate(outs, 0)


def _sine_embed(coord, num_pos_feats: int, temperature: float = 10000.0):
    """(N,) positions -> (N, num_pos_feats), sin/cos interleaved, fp32."""
    dim_t = temperature ** (2 * (torch.arange(num_pos_feats,
                                              device=coord.device) // 2)
                            / num_pos_feats)
    e = coord.float()[:, None] * 2 * math.pi / dim_t
    return torch.stack([torch.sin(e[:, 0::2]), torch.cos(e[:, 1::2])],
                       dim=2).reshape(coord.shape[0], num_pos_feats)


def _box_sine_embed(boxes, d: int):
    """(N, 4) cxcywh -> (N, 2D) in channel order (y, x, w, h)."""
    return torch.cat([_sine_embed(boxes[:, i], d // 2) for i in (1, 0, 2, 3)],
                     dim=-1)


def _inverse_sigmoid(x, eps: float = 1e-3):
    x = x.clamp(0, 1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def _proposals(shapes, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """gen_encoder_output_proposals: per-level centre grids with a
    0.05 * 2^level size prior -> (valid (S,), inverse-sigmoid proposals
    (S, 4) fp32, inf where invalid)."""
    props = [np.concatenate([_centres([(h, w)]), np.full((h * w, 2),
                                                         0.05 * 2.0 ** lvl)], -1)
             for lvl, (h, w) in enumerate(shapes)]
    props = torch.from_numpy(np.concatenate(props, 0).astype(np.float32)
                             ).to(device)
    valid = ((props > 0.01) & (props < 0.99)).all(dim=-1)
    unsig = torch.log(props / (1 - props)).masked_fill(~valid[:, None],
                                                       math.inf)
    return valid, unsig


# --------------------------------------------------------------------------
# forward, in the parts a detection times
# --------------------------------------------------------------------------

def text_features(model: GroundingDINO, text_ids, text_self_mask,
                  position_ids):
    """(1, T) ids, (1, T, T) phrase mask, (1, T) positions -> (T, D) text
    features: BERT with the phrase masks, then ``feat_map``."""
    txt = bert_forward(model.bert, model.cfg.bert, text_ids, text_self_mask,
                       position_ids=position_ids)[0]
    return model.feat_map(txt)


def image_features(model: GroundingDINO, pixels) -> List[torch.Tensor]:
    """(1, 3, H, W) normalised pixels -> the 4 projected levels (NCHW):
    Swin's stages 1-3 and a stride-2 conv of the last, each conv +
    GroupNorm."""
    cfg = model.cfg
    feats = SW.swin_forward(model.backbone, pixels)
    feats = [feats[f"swin{i}"] for i in cfg.return_interm_indices]
    srcs = []
    for proj, f in zip(model.input_proj, feats + feats[-1:]):
        conv, gn = proj
        srcs.append(L.group_norm(conv(f), gn.weight, gn.bias,
                                 num_groups=cfg.input_proj_groups))
    return srcs


def encoder_forward(model: GroundingDINO, srcs, txt, text_mask,
                    text_self_mask, position_ids):
    """The fusion encoder: per layer the image<->text fusion, the text
    enhancer and the deformable image layer -> (image tokens (S, D), text
    (T, D), level shapes)."""
    cfg = model.cfg
    d = cfg.hidden_dim
    tp = model.transformer
    dev = txt.device
    shapes = [tuple(s.shape[-2:]) for s in srcs]
    img = torch.cat([s[0].flatten(1).T for s in srcs], dim=0)
    level = torch.cat([tp.level_embed[i].float().expand(h * w, d)
                       for i, (h, w) in enumerate(shapes)], dim=0)
    pos = (torch.from_numpy(_sine_pos_hw(shapes, d, cfg.pe_temperature)
                            .astype(np.float32)).to(dev) + level
           ).to(img.dtype)
    ref_pts = torch.from_numpy(_centres(shapes).astype(np.float32)).to(dev)
    ref_pts = ref_pts[:, None].expand(-1, len(shapes), 2)
    pos_text = _sine_embed(position_ids[0], d).to(txt.dtype)
    block_mask, pad_mask = text_self_mask[0], ~text_mask[0]
    enc = tp.encoder
    for i in range(cfg.enc_layers):
        img, txt = _bi_attention(enc.fusion_layers[i], img, txt,
                                 cfg.fusion_heads, pad_mask)
        txt = _text_enhancer(enc.text_layers[i], txt, pos_text,
                             cfg.text_heads, block_mask)
        img = _enc_image_layer(enc.layers[i], img, pos, ref_pts, shapes,
                               cfg.nheads, cfg.n_points)
    return img, txt, shapes


def select_queries(model: GroundingDINO, img, txt, text_mask, shapes):
    """Two-stage query selection: the top num_queries image tokens by their
    best text score (stable sort: ties keep the lower index, as
    ``jax.lax.top_k``) -> (indices (Q,), reference boxes (Q, 4) fp32 in
    sigmoid space)."""
    tp = model.transformer
    valid, unsig = _proposals(shapes, img.device)
    mem = img.masked_fill(~valid[:, None], 0)
    mem = tp.enc_output_norm(tp.enc_output(mem))
    scores = (mem @ txt.T).float().masked_fill(~text_mask[0][None],
                                               -math.inf).amax(dim=-1)
    top = torch.sort(scores, descending=True, stable=True)[1][
        :model.cfg.num_queries]
    ref = _bbox_mlp(tp.enc_out_bbox_embed, mem[top]).float() + unsig[top]
    return top, torch.sigmoid(ref)


def decoder_forward(model: GroundingDINO, img, txt, text_mask, shapes,
                    boxes):
    """The decoder from the selected reference boxes -> dict(logits (Q, T)
    fp32, -inf at padded text, boxes (Q, 4) fp32 cxcywh). Each layer: query
    self-attention (kernel B), text cross-attention, deformable image
    cross-attention, FFN, then the shared box MLP refines the reference on
    the raw state; the final heads read the LayerNormed state with the last
    layer's input reference, as GroundingDINO recomputes its outputs."""
    cfg = model.cfg
    d, q = cfg.hidden_dim, cfg.num_queries
    dec = model.transformer.decoder
    x = model.transformer.tgt_embed.weight
    tmask = text_mask[0]
    key_mask = tmask[None, None, None, :]
    rph = dec.ref_point_head.layers
    boxes_in = boxes
    for lp in dec.layers:
        qpos = rph[1](F.relu(rph[0](_box_sine_embed(boxes, d).to(x.dtype))))
        sa = _mha(lp.self_attn, x + qpos, x + qpos, x, cfg.nheads)
        x = lp.norm2(x + sa)
        tc = _mha(lp.ca_text, x + qpos, txt, txt, cfg.nheads, mask=key_mask)
        x = lp.catext_norm(x + tc)
        refs = boxes[:, None].expand(q, len(shapes), 4)
        ca = deform_attn(lp.cross_attn, x + qpos, refs, img, shapes,
                         heads=cfg.nheads, points=cfg.n_points)
        x = lp.norm1(x + ca)
        x = lp.norm3(x + lp.linear2(F.relu(lp.linear1(x))))
        boxes_in = boxes
        boxes = torch.sigmoid(_bbox_mlp(model.bbox_embed, x).float()
                              + _inverse_sigmoid(boxes))
    hs = dec.norm(x)
    out_boxes = torch.sigmoid(_bbox_mlp(model.bbox_embed, hs).float()
                              + _inverse_sigmoid(boxes_in))
    logits = (hs @ txt.T).float().masked_fill(~tmask[None], -math.inf)
    return {"logits": logits, "boxes": out_boxes}


@torch.inference_mode()
def dino_forward(model: GroundingDINO, pixels, text_ids, text_mask,
                 text_self_mask=None, position_ids=None):
    """pixels (1, 3, H, W) ImageNet-normalised; text_ids / text_mask (1, T);
    text_self_mask (1, T, T) phrase mask and position_ids (1, T) per-phrase
    positions (``generate_text_masks``; default: one phrase) -> dict(logits
    (Q, T) pre-sigmoid token scores, boxes (Q, 4) normalised cxcywh)."""
    if text_self_mask is None:
        text_self_mask = text_mask[:, None, :] & text_mask[:, :, None]
    if position_ids is None:
        position_ids = torch.arange(text_ids.shape[1],
                                    device=text_ids.device)[None]
    txt = text_features(model, text_ids, text_self_mask, position_ids)
    srcs = image_features(model, pixels)
    img, txt, shapes = encoder_forward(model, srcs, txt, text_mask,
                                       text_self_mask, position_ids)
    _, boxes = select_queries(model, img, txt, text_mask, shapes)
    return decoder_forward(model, img, txt, text_mask, shapes, boxes)


# --------------------------------------------------------------------------
# the detector (groundingdino.util.inference.predict semantics)
# --------------------------------------------------------------------------

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# bert-base-uncased ids of [CLS], [SEP], "." and "?" (bertwarper's list)
BERT_SPECIAL_IDS = (101, 102, 1012, 1029)


class GroundingDINODetector:
    """``detector(image, caption) -> (boxes (N, 4) xyxy pixels of the
    original image, scores (N,), phrases)``, the thresholds of
    sam2groundingdino_edit.py:130 (0.25 / 0.25). ``prepare``, ``model`` and
    ``postprocess`` are its host, device and host parts."""

    def __init__(self, model: GroundingDINO, tokenizer, *,
                 box_threshold: float = 0.25, text_threshold: float = 0.25,
                 short_side: int = 800, max_side: int = 1333,
                 special_ids: Optional[Sequence[int]] = None):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.box_threshold = box_threshold
        self.text_threshold = text_threshold
        self.short_side = short_side
        self.max_side = max_side
        if special_ids is None:
            vocab = getattr(tokenizer, "vocab", {})
            special_ids = [vocab[t] for t in ("[CLS]", "[SEP]", ".", "?")
                           if t in vocab] or list(BERT_SPECIAL_IDS)
        self.special_ids = tuple(special_ids)

    @property
    def device(self) -> torch.device:
        return self.model.feat_map.weight.device

    def prepare(self, image: np.ndarray, caption: str) -> Dict:
        """Host side: the caption lowercased and closed with ".", the image
        resized (both sides rounded to multiples of 32) and normalised, the
        tokens, phrase mask and positions -> the forward's tensors on the
        model's device and the tokens."""
        caption = caption.lower().strip()
        if not caption.endswith("."):
            caption = caption + "."
        h, w = image.shape[:2]
        scale = min(self.short_side / min(h, w), self.max_side / max(h, w))
        nh = max(32, int(round(h * scale / 32)) * 32)
        nw = max(32, int(round(w * scale / 32)) * 32)
        px = resize_pil(np.ascontiguousarray(image, np.uint8), (nh, nw),
                        "bilinear").astype(np.float32) / 255.0
        px = (px - IMAGENET_MEAN) / IMAGENET_STD
        ids, mask, tokens = self.tokenizer.encode_padded(
            caption, self.cfg.max_text_len)
        self_mask, pos_ids = generate_text_masks(ids, self.special_ids)
        dev = self.device

        def put(a, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                dev, dtype)[None]
        return {"pixels": put(px.transpose(2, 0, 1)),
                "text_ids": put(ids, torch.long), "text_mask": put(mask),
                "text_self_mask": put(self_mask),
                "position_ids": put(pos_ids, torch.long),
                "tokens": tokens, "hw": (h, w)}

    def postprocess(self, out: Dict, tokens: List[str], hw):
        """Host side: logits clipped to +-80 (nan_to_num first), sigmoid,
        a box kept where its best token scores above box_threshold, its
        phrase the tokens above text_threshold with WordPiece continuations
        merged; boxes to xyxy pixels of the original image."""
        h, w = hw
        logits = np.clip(np.nan_to_num(out["logits"].cpu().numpy(),
                                       neginf=-80.0, posinf=80.0), -80.0, 80.0)
        probs = 1.0 / (1.0 + np.exp(-logits))
        scores = probs.max(axis=1)
        keep = scores > self.box_threshold
        boxes_n = out["boxes"].cpu().numpy()[keep]
        cx, cy, bw, bh = (boxes_n[:, i] for i in range(4))
        boxes = np.stack([(cx - bw / 2) * w, (cy - bh / 2) * h,
                          (cx + bw / 2) * w, (cy + bh / 2) * h], axis=-1)
        phrases = []
        for row in probs[keep]:
            words: List[str] = []
            for i in np.nonzero(row > self.text_threshold)[0]:
                tok = tokens[i] if i < len(tokens) else None
                if tok is None or tok in ("[CLS]", "[SEP]", "."):
                    continue
                if tok.startswith("##") and words:
                    words[-1] += tok[2:]
                else:
                    words.append(tok[2:] if tok.startswith("##") else tok)
            phrases.append(" ".join(words))
        return boxes, scores[keep], phrases

    def __call__(self, image: np.ndarray, caption: str):
        inp = self.prepare(image, caption)
        out = dino_forward(self.model, inp["pixels"], inp["text_ids"],
                           inp["text_mask"], inp["text_self_mask"],
                           inp["position_ids"])
        return self.postprocess(out, inp["tokens"], inp["hw"])
