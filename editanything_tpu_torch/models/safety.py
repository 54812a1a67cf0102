"""Stable Diffusion safety checker: CLIP ViT-L/14 vision tower + NSFW head.

Counterpart of ``editanything_tpu/models/safety.py``. The module's names are
HF's CLIPVisionModel tower (``vision_model.embeddings``, the misspelled
``pre_layrnorm``, ``encoder.layers``, ``post_layernorm``) and diffusers'
StableDiffusionSafetyChecker head (``visual_projection``, the 17 concept and
3 special-care embeddings and their thresholds), so its state dict is the
published one with one ``vision_model.`` level stripped
(checkpoints/convert.py::safety_checker_state_dict). The tower's attention
goes through ``layers.attention``: kernel B on CUDA tensors, at (S, 16, 257,
257, 64) for ViT-L/14 at 224^2. ``preprocess`` is CLIPImageProcessor's
(shortest-edge BICUBIC resize as PIL computes it, centre crop, normalise)
in numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from editanything_tpu_torch.core import layers as L
from editanything_tpu_torch.utils.image import resize_pil


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    num_concepts: int = 17
    num_special: int = 3

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def tiny_vision_config() -> CLIPVisionConfig:
    """The JAX package's test widths."""
    return CLIPVisionConfig(image_size=32, patch_size=8, hidden_size=32,
                            num_layers=2, num_heads=2, intermediate_size=64,
                            projection_dim=16, num_concepts=4, num_special=2)


class VisionLayer(nn.Module):
    """One pre-norm CLIP encoder layer with quick-GELU (JAX _vision_layer)."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.layer_norm1 = L.LayerNorm(d)
        self.self_attn = nn.Module()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self.self_attn, name, nn.Linear(d, d))
        self.layer_norm2 = L.LayerNorm(d)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(d, cfg.intermediate_size)
        self.mlp.fc2 = nn.Linear(cfg.intermediate_size, d)

    def forward(self, x):
        b, n, d = x.shape
        h = self.layer_norm1(x)
        att = self.self_attn
        q, k, v = (proj(h).view(b, n, self.heads, -1).transpose(1, 2)
                   for proj in (att.q_proj, att.k_proj, att.v_proj))
        o = L.attention(q, k, v).transpose(1, 2).reshape(b, n, d)
        x = x + att.out_proj(o)
        return x + self.mlp.fc2(L.quick_gelu(self.mlp.fc1(self.layer_norm2(x))))


class SafetyCheckerModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        vm = self.vision_model = nn.Module()
        vm.embeddings = nn.Module()
        vm.embeddings.class_embedding = nn.Parameter(torch.zeros(d))
        vm.embeddings.patch_embedding = nn.Conv2d(
            3, d, cfg.patch_size, stride=cfg.patch_size, bias=False)
        vm.embeddings.position_embedding = nn.Embedding(cfg.num_patches + 1, d)
        vm.pre_layrnorm = L.LayerNorm(d)
        vm.encoder = nn.Module()
        vm.encoder.layers = nn.ModuleList(
            [VisionLayer(cfg) for _ in range(cfg.num_layers)])
        vm.post_layernorm = L.LayerNorm(d)
        self.visual_projection = nn.Linear(d, cfg.projection_dim, bias=False)
        p = cfg.projection_dim
        self.concept_embeds = nn.Parameter(torch.zeros(cfg.num_concepts, p))
        self.special_care_embeds = nn.Parameter(torch.zeros(cfg.num_special, p))
        self.concept_embeds_weights = nn.Parameter(torch.zeros(cfg.num_concepts))
        self.special_care_embeds_weights = nn.Parameter(
            torch.zeros(cfg.num_special))

    def vision_pooled(self, pixels):
        """(B, 3, S, S) normalised pixels -> (B, D) pooled CLS embedding
        (HF CLIPVisionModel's pooler_output)."""
        vm = self.vision_model
        emb = vm.embeddings
        h = emb.patch_embedding(pixels).flatten(2).transpose(1, 2)
        cls = emb.class_embedding.to(h.dtype).expand(h.shape[0], 1, -1)
        h = torch.cat([cls, h], dim=1) + emb.position_embedding.weight[None]
        h = vm.pre_layrnorm(h)
        for layer in vm.encoder.layers:
            h = layer(h)
        return vm.post_layernorm(h[:, 0])

    def check(self, pixels):
        """(has_nsfw (B,) bool, concept_scores (B, K) fp32), diffusers'
        StableDiffusionSafetyChecker.forward: cosine similarities against
        the concepts minus their thresholds, every threshold lowered by 0.01
        for an image where a special-care concept fires."""
        emb = self.vision_pooled(pixels).float() @ \
            self.visual_projection.weight.float().T

        def cosine(a, b):
            return F.normalize(a, dim=-1) @ F.normalize(b.float(), dim=-1).T
        special = (cosine(emb, self.special_care_embeds)
                   - self.special_care_embeds_weights.float()[None])
        adjust = (special > 0).any(dim=1, keepdim=True).float() * 0.01
        scores = (cosine(emb, self.concept_embeds)
                  - self.concept_embeds_weights.float()[None] + adjust)
        return (scores > 0).any(dim=1), scores


# CLIPImageProcessor normalisation constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess(images_uint8: np.ndarray, cfg: CLIPVisionConfig) -> np.ndarray:
    """uint8 (B, H, W, 3) -> normalised (B, S, S, 3) fp32 (CLIPImageProcessor:
    shortest edge to S by BICUBIC, the long side truncated as HF's
    get_resize_output_image_size does, centre crop, rescale, normalise)."""
    s = cfg.image_size
    out = np.empty((images_uint8.shape[0], s, s, 3), np.float32)
    for i, img in enumerate(images_uint8):
        h, w = img.shape[:2]
        if h <= w:
            nh, nw = s, max(int(s * w / h), s)
        else:
            nh, nw = max(int(s * h / w), s), s
        r = resize_pil(np.asarray(img, np.uint8), (nh, nw), "bicubic")
        y0, x0 = (nh - s) // 2, (nw - s) // 2
        out[i] = r[y0:y0 + s, x0:x0 + s].astype(np.float32) / 255.0
    return (out - CLIP_MEAN) / CLIP_STD


class SafetyChecker:
    """Pipeline-facing wrapper: uint8 images in, the images with every
    flagged one blacked out and the flags out (diffusers' semantics)."""

    def __init__(self, model: SafetyCheckerModel):
        self.model = model
        self.cfg = model.cfg

    @torch.inference_mode()
    def __call__(self, images_uint8: np.ndarray):
        w = self.model.visual_projection.weight
        px = torch.from_numpy(preprocess(images_uint8, self.cfg))
        px = px.permute(0, 3, 1, 2).to(w.device, w.dtype)
        nsfw = self.model.check(px)[0].cpu().numpy()
        out = np.array(images_uint8, copy=True)
        out[nsfw] = 0
        return out, nsfw
