"""Segment Anything (ViT image encoder, prompt encoder, mask decoder).

Counterpart of ``editanything_tpu/models/sam.py``. Attribute paths are the
official SAM checkpoint's names (``image_encoder.blocks.N.attn.qkv``,
``prompt_encoder.point_embeddings.K``, ``mask_decoder.transformer...``), so a
``sam_vit_*.pth`` state dict, or ``tests/sam_replica.py``'s, loads with
strict=True. Layouts: the ViT blocks run on (B, H, W, C) tokens as the
official encoder does; image maps around them are NCHW.

Kernels on this path: every encoder attention goes through
``layers.attention`` with the relative-position bias folded into deeper q/k
(scale 1.0), which is the flash-attention kernel on CUDA tensors for the
windowed layers too (the JAX package runs those in XLA, sam.py:189-200).
When every prompt of a batch shares the dense prompt (the AMG and the click
predictor), the decoder's two-way transformer is kernel D
(``kernels.sam_twoway``), and its output path is kernel C
(``kernels.sam_upscale_hyper``) in every case.

The encoder's LayerNorms use eps 1e-5, as the JAX package's
``layers.layer_norm`` does; official SAM uses 1e-6 there (ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from editanything_tpu_torch.core import kernels as K
from editanything_tpu_torch.core import layers as L
from editanything_tpu_torch.utils.image import resize_uint8_bilinear


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768                  # ViT-B; H: 1280
    depth: int = 12                       # ViT-B; H: 32
    num_heads: int = 12                   # ViT-B; H: 16
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    window_size: int = 14
    mlp_ratio: float = 4.0
    out_chans: int = 256
    # prompt/decoder
    prompt_embed_dim: int = 256
    num_multimask_outputs: int = 3
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048

    @property
    def embedding_size(self) -> int:
        return self.img_size // self.patch_size     # 64


def sam_vit_b() -> SAMConfig:
    return SAMConfig()


def sam_vit_l() -> SAMConfig:
    return SAMConfig(embed_dim=1024, depth=24, num_heads=16,
                     global_attn_indexes=(5, 11, 17, 23))


def sam_vit_h() -> SAMConfig:
    return SAMConfig(embed_dim=1280, depth=32, num_heads=16,
                     global_attn_indexes=(7, 15, 23, 31))


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over NCHW maps (SAM's LayerNorm2d), fp32 stats."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        return K.layer_norm_2d(x, self.weight, self.bias, self.eps)


def _linear(layer: nn.Linear, x):
    """``layers.linear`` of the JAX package: weights cast to x's dtype."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


# ---------------------------------------------------------------------------
# Image encoder
# ---------------------------------------------------------------------------

def _rel_pos_bias(rel_pos, q_size: int, k_size: int):
    """(2*size-1, hd) table -> (q, k, hd) gathered relative embeddings."""
    coords_q = torch.arange(q_size, device=rel_pos.device)[:, None]
    coords_k = torch.arange(k_size, device=rel_pos.device)[None, :]
    return rel_pos[coords_q - coords_k + (k_size - 1)]


class EncoderAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, input_size: int):
        super().__init__()
        self.num_heads = num_heads
        hd = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd))

    def augmented_qkv(self, x):
        """Fold the decomposed rel-pos bias into the q.k contraction
        (sam.py:143-186): q' = [q/sqrt(d), q.rel_h, q.rel_w], k' = [k,
        onehot(row), onehot(col)], so q'.k' is the biased logit. q' is cast
        back to x's dtype. Both end in zero columns up to a multiple of 8
        (108 -> 112 in the 14x14 windows), which add nothing to q'.k' and
        let the attention kernel read their rows as 16-byte vectors.
        Returns q', k' (B, nh, N, d+h+w rounded up to 8) and v (B, nh, N, d).
        """
        b, h, w, c = x.shape
        nh, hd, n = self.num_heads, c // self.num_heads, h * w
        pad = -(hd + h + w) % 8
        qkv = self.qkv(x.reshape(b, n, c)).reshape(b, n, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        rh = _rel_pos_bias(self.rel_pos_h, h, h).float()
        rw = _rel_pos_bias(self.rel_pos_w, w, w).float()
        qf = q.float().reshape(b, nh, h, w, hd)
        bias_h = torch.einsum("bxhwd,hkd->bxhwk", qf, rh).reshape(b, nh, n, h)
        bias_w = torch.einsum("bxhwd,wkd->bxhwk", qf, rw).reshape(b, nh, n, w)
        q_aug = torch.cat([q.float() * (1.0 / math.sqrt(hd)), bias_h, bias_w,
                           bias_w.new_zeros(b, nh, n, pad)], -1).to(x.dtype)
        idx = torch.arange(n, device=x.device)
        onehot = torch.cat(
            [(idx[:, None] // w == torch.arange(h, device=x.device)),
             (idx[:, None] % w == torch.arange(w, device=x.device)),
             idx.new_zeros(n, pad, dtype=torch.bool)],
            -1).to(x.dtype)
        k_aug = torch.cat([k, onehot.expand(b, nh, n, h + w + pad)], -1)
        return q_aug, k_aug, v

    def forward(self, x):
        b, h, w, c = x.shape
        q_aug, k_aug, v = self.augmented_qkv(x)
        out = L.attention(q_aug, k_aug, v, scale=1.0)
        return self.proj(out.transpose(1, 2).reshape(b, h, w, c))


class MLPBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


def window_partition(x, win: int):
    b, h, w, c = x.shape
    pad_h, pad_w = (win - h % win) % win, (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // win, win, wp // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c), (hp, wp)


def window_unpartition(x, win: int, hw_pad, hw):
    (hp, wp), (h, w) = hw_pad, hw
    b = x.shape[0] // (hp // win * (wp // win))
    x = x.reshape(b, hp // win, wp // win, win, win, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)[:, :h, :w]


class EncoderBlock(nn.Module):
    def __init__(self, cfg: SAMConfig, window: int):
        super().__init__()
        d = cfg.embed_dim
        self.window = window
        self.norm1 = L.LayerNorm(d)
        self.attn = EncoderAttention(d, cfg.num_heads,
                                     window or cfg.embedding_size)
        self.norm2 = L.LayerNorm(d)
        self.mlp = MLPBlock(d, int(d * cfg.mlp_ratio))

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window > 0:
            hw = x.shape[1:3]
            xw, hw_pad = window_partition(x, self.window)
            x = window_unpartition(self.attn(xw), self.window, hw_pad, hw)
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d, e = cfg.embed_dim, cfg.embedding_size
        self.patch_embed = nn.Module()
        # a stride-16 conv: the same map as the JAX package's
        # space-to-depth einsum (sam.py:267-279, a TPU layout choice)
        self.patch_embed.proj = nn.Conv2d(3, d, cfg.patch_size, cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, e, e, d))
        self.blocks = nn.ModuleList([
            EncoderBlock(cfg, 0 if i in cfg.global_attn_indexes
                         else cfg.window_size) for i in range(cfg.depth)])
        self.neck = nn.Sequential(
            nn.Conv2d(d, cfg.out_chans, 1, bias=False),
            LayerNorm2d(cfg.out_chans),
            nn.Conv2d(cfg.out_chans, cfg.out_chans, 3, padding=1, bias=False),
            LayerNorm2d(cfg.out_chans))

    def forward(self, x):
        """(B, 3, S, S) normalised pixels -> (B, out_chans, S/16, S/16)."""
        h = self.patch_embed.proj(x).permute(0, 2, 3, 1)
        h = h + self.pos_embed.to(h.dtype)
        for blk in self.blocks:
            h = blk(h)
        return self.neck(h.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# Prompt encoder
# ---------------------------------------------------------------------------

class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.cfg = cfg
        self.pe_layer = nn.Module()
        self.pe_layer.register_buffer("positional_encoding_gaussian_matrix",
                                      torch.zeros(2, d // 2))
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, d) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)
        # mask prompts: built so the official state dict loads strictly;
        # no forward runs them, as no function of the JAX package does
        # (editanything_tpu/models/sam.py:314-323)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, 4, 2, 2), LayerNorm2d(4), nn.GELU(),
            nn.Conv2d(4, 16, 2, 2), LayerNorm2d(16), nn.GELU(),
            nn.Conv2d(16, d, 1))

    def _pe_encode(self, coords):
        """coords in [0, 1]^2, (..., 2) -> (..., D) random-Fourier PE."""
        gauss = self.pe_layer.positional_encoding_gaussian_matrix.float()
        proj = (2.0 * np.pi) * ((2.0 * coords.float() - 1.0) @ gauss)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def dense_positional_encoding(self):
        """(1, D, e, e) fp32 image-grid PE; channel 0 of the grid is x."""
        e = self.cfg.embedding_size
        dev = self.pe_layer.positional_encoding_gaussian_matrix.device
        ticks = (torch.arange(e, dtype=torch.float32, device=dev) + 0.5) / e
        ys, xs = torch.meshgrid(ticks, ticks, indexing="ij")
        grid = torch.stack([xs, ys], dim=-1)
        return self._pe_encode(grid).permute(2, 0, 1)[None]

    def encode_points(self, coords, labels):
        """coords (B, P, 2) pixel coords in [0, img_size), labels (B, P):
        1 positive, 0 negative, -1 pad, 2/3 box corners -> (B, P, D) fp32."""
        pe = self._pe_encode((coords.float() + 0.5) / self.cfg.img_size)
        lab = labels[..., None]
        add = torch.zeros_like(pe)
        for i, emb in enumerate(self.point_embeddings):
            add = add + torch.where(lab == i, emb.weight[0].float(), 0.0)
        return torch.where(lab == -1, self.not_a_point_embed.weight[0].float(),
                           pe + add)

    def no_mask_dense_embedding(self, batch: int):
        """(batch, D, e, e) view of the no-mask embedding."""
        e = self.cfg.embedding_size
        return self.no_mask_embed.weight[0][None, :, None, None].expand(
            batch, -1, e, e)


# ---------------------------------------------------------------------------
# Mask decoder
# ---------------------------------------------------------------------------

class DecoderAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        b, nq, _ = q.shape
        qh, kh, vh = (_linear(self.q_proj, q), _linear(self.k_proj, k),
                      _linear(self.v_proj, v))
        inner = qh.shape[-1]
        hd = inner // self.num_heads

        def heads(x):
            return x.reshape(b, -1, self.num_heads, hd).transpose(1, 2)
        out = L.attention_reference(heads(qh), heads(kh), heads(vh))
        return _linear(self.out_proj, out.transpose(1, 2).reshape(b, nq, inner))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int,
                 skip_first_layer_pe: bool):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(dim, num_heads)
        self.norm1 = L.LayerNorm(dim)
        self.cross_attn_token_to_image = DecoderAttention(dim, num_heads, 2)
        self.norm2 = L.LayerNorm(dim)
        self.mlp = nn.Module()
        self.mlp.lin1 = nn.Linear(dim, mlp_dim)
        self.mlp.lin2 = nn.Linear(mlp_dim, dim)
        self.norm3 = L.LayerNorm(dim)
        self.cross_attn_image_to_token = DecoderAttention(dim, num_heads, 2)
        self.norm4 = L.LayerNorm(dim)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            # official SAM REPLACES the queries here (no residual)
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            queries + query_pe, k, keys))
        h = F.relu(_linear(self.mlp.lin1, queries))
        queries = self.norm3(queries + _linear(self.mlp.lin2, h))
        keys = self.norm4(keys + self.cross_attn_image_to_token(
            k, queries + query_pe, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        self.layers = nn.ModuleList([
            TwoWayAttentionBlock(d, cfg.decoder_heads, cfg.decoder_mlp_dim,
                                 skip_first_layer_pe=(i == 0))
            for i in range(cfg.decoder_depth)])
        self.final_attn_token_to_image = DecoderAttention(d, cfg.decoder_heads, 2)
        self.norm_final_attn = L.LayerNorm(d)

    def forward(self, src, pos, tokens):
        """The plain per-prompt path: src, pos (B, M, d), tokens (B, T, d)."""
        queries, keys = tokens, src
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, pos)
        queries = queries + self.final_attn_token_to_image(
            queries + tokens, keys + pos, keys)
        return self.norm_final_attn(queries), keys


class MLP(nn.Module):
    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = _linear(layer, x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.prompt_embed_dim
        nm = cfg.num_multimask_outputs + 1
        self.cfg = cfg
        self.transformer = TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(nm, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, 2), LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            [MLP([d, d, d, d // 8]) for _ in range(nm)])
        # official: iou_head_depth 3, hidden 256 == d in every SAM variant
        self.iou_prediction_head = MLP([d, d, d, nm])

    def pack_twoway(self) -> K.TwoWayPacked:
        return K.pack_twoway(self.transformer, heads=self.cfg.decoder_heads)

    def forward(self, image_embedding, image_pe, sparse_prompts, dense_prompts,
                *, twoway_packed: Optional[K.TwoWayPacked] = None):
        """image_embedding (1, d, e, e); image_pe (1, d, e, e) fp32;
        sparse_prompts (B, P, d) fp32; dense_prompts (B, d, e, e), or
        (1, d, e, e) when every prompt shares it, which routes the two-way
        transformer through kernel D (sam.py:521-532). `twoway_packed`:
        ``pack_twoway()`` hoisted by a caller that decodes many batches.
        Returns (mask logits (B, 4, 4e, 4e), iou (B, 4))."""
        d = self.cfg.prompt_embed_dim
        b = sparse_prompts.shape[0]
        nm = self.cfg.num_multimask_outputs + 1
        out_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight])
        tokens = torch.cat([out_tokens.float()[None].expand(b, -1, -1),
                            sparse_prompts.float()], dim=1)
        src = (image_embedding + dense_prompts).flatten(2).transpose(1, 2)
        pos = image_pe.flatten(2).transpose(1, 2)[0].float()
        if dense_prompts.shape[0] == 1:
            packed = twoway_packed or self.pack_twoway()
            queries, keys = K.sam_twoway(packed, src.contiguous(), pos, tokens)
        else:
            queries, keys = self.transformer(src, pos[None].expand(b, -1, -1),
                                             tokens)
        mask_tokens_out = queries[:, 1:1 + nm]
        hyper = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        up = self.output_upscaling
        masks = K.sam_upscale_hyper(keys, hyper, up[0].weight, up[0].bias,
                                    up[1].weight, up[1].bias, up[3].weight,
                                    up[3].bias, eps=up[1].eps)
        return masks, self.iou_prediction_head(queries[:, 0])


class Sam(nn.Module):
    """The three SAM modules under the official checkpoint's top-level names."""

    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)


# SAM's pixel normalisation
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def preprocess(image, cfg: SAMConfig):
    """uint8 (h, w, 3) tensor, long side already img_size -> normalised
    fp32 (1, 3, S, S), zero-padded at the bottom and right (sam.py:578-584)."""
    mean = torch.tensor(PIXEL_MEAN, device=image.device)
    std = torch.tensor(PIXEL_STD, device=image.device)
    x = (image.float() - mean) / std
    h, w = x.shape[:2]
    x = F.pad(x.permute(2, 0, 1), (0, cfg.img_size - w, 0, cfg.img_size - h))
    return x[None]


def prepare_image(image: np.ndarray, cfg: SAMConfig, device):
    """uint8 (h, w, 3) numpy image -> (``preprocess``ed (1, 3, S, S) fp32 on
    `device`, (nh, nw)): the long side resized to img_size on the device
    with ``resize_uint8_bilinear``, where the JAX package uses PIL's
    BILINEAR (editor.py:131-136, predictor.py:64-71)."""
    h, w = image.shape[:2]
    scale = cfg.img_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    img = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    return preprocess(resize_uint8_bilinear(img, (nh, nw)), cfg), (nh, nw)
