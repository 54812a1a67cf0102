"""BLIP-2 captioner: EVA ViT-g/14 image encoder, Q-Former, OPT-2.7B decoder.

Counterpart of ``editanything_tpu/models/blip2.py`` (the architecture of
Salesforce/blip2-opt-2.7b), which serves the reference's auto prompts
(editany_lora.py:98-107,512-520: ``generate(max_new_tokens=50)``) and region
labels (sam2semantic.py:60-71). The modules are named after the JAX
package's parameter tree (``vision_model.layers.N.attn.q``,
``qformer.layers.N.crossattention``, ``language_model.layers.N.fc1``), so
``checkpoints/convert.py::state_dict_from_tree`` carries a JAX tree across
as it is, and ``blip2_state_dict`` maps the published HF layout.

- vision: 1408 wide, 39 pre-LN blocks, 16 heads of 88, exact-erf GELU, 224^2
  input, 256 patches and the CLS token first; the Q-Former reads all 257
  tokens after ``post_layernorm``;
- Q-Former: 12 post-LN BERT blocks over 32 learned queries, cross-attention
  to the image tokens in layers 0, 2, ..., 10, 12 heads of 64;
- ``language_projection`` 768 -> 2560;
- OPT: 32 pre-LN blocks, 2560 wide, 32 heads, ReLU FFN, learned positions
  offset by 2, the LM head tied (``x @ embed_tokens.T``).

Every LayerNorm uses eps 1e-5, as the JAX package does everywhere (the
published config has 1e-6 in the vision tower and 1e-12 in the Q-Former).
The vision tower's and the Q-Former's attention is unmasked and goes
through ``layers.attention``: kernel B on CUDA tensors, at (B, 16, 257, 257,
88), (B, 12, 32, 32, 64) and (B, 12, 32, 257, 64). OPT's attention is
causally masked (prefill) or masked to the filled part of the KV cache
(decode), so it is the plain masked attention, as XLA runs it in the JAX
package. ``caption`` is the JAX ``make_caption_fn``: prefill into a cache
preallocated to n0 + max_new_tokens, then greedy decode with every token
after the first eos an eos; its loop stops once every row is done, which
leaves its output as the fixed-length one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from editanything_tpu_torch.core import layers as L


@dataclasses.dataclass(frozen=True)
class BLIP2Config:
    # vision (EVA ViT-g/14)
    image_size: int = 224
    patch_size: int = 14
    vision_hidden: int = 1408
    vision_layers: int = 39
    vision_heads: int = 16
    vision_mlp: int = 6144
    # Q-Former
    num_query_tokens: int = 32
    qformer_hidden: int = 768
    qformer_layers: int = 12
    qformer_heads: int = 12
    qformer_mlp: int = 3072
    cross_attention_frequency: int = 2
    # OPT
    opt_hidden: int = 2560
    opt_layers: int = 32
    opt_heads: int = 32
    opt_ffn: int = 10240
    vocab_size: int = 50272
    max_positions: int = 2048
    bos_token_id: int = 2
    eos_token_id: int = 2
    pad_token_id: int = 1

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


def tiny_blip2_config() -> BLIP2Config:
    """Test-sized architecture (the JAX package's test widths)."""
    return BLIP2Config(
        image_size=28, patch_size=14, vision_hidden=16, vision_layers=2,
        vision_heads=2, vision_mlp=32,
        num_query_tokens=4, qformer_hidden=16, qformer_layers=2,
        qformer_heads=2, qformer_mlp=32, cross_attention_frequency=2,
        opt_hidden=16, opt_layers=2, opt_heads=2, opt_ffn=32,
        vocab_size=128, max_positions=64)


# --------------------------------------------------------------------------
# modules (parameters only; the forward functions follow)
# --------------------------------------------------------------------------

class Attention(nn.Module):
    """q/k/v/o projections; k and v read `kv_dim`-wide inputs."""

    def __init__(self, d: int, kv_dim: Optional[int] = None):
        super().__init__()
        kv = kv_dim or d
        self.q = nn.Linear(d, d)
        self.k = nn.Linear(kv, d)
        self.v = nn.Linear(kv, d)
        self.o = nn.Linear(d, d)


def _mlp(d: int, hidden: int) -> nn.Module:
    m = nn.Module()
    m.fc1 = nn.Linear(d, hidden)
    m.fc2 = nn.Linear(hidden, d)
    return m


class VisionLayer(nn.Module):
    def __init__(self, cfg: BLIP2Config):
        super().__init__()
        d = cfg.vision_hidden
        self.norm1 = L.LayerNorm(d)
        self.attn = Attention(d)
        self.norm2 = L.LayerNorm(d)
        self.mlp = _mlp(d, cfg.vision_mlp)


class VisionModel(nn.Module):
    def __init__(self, cfg: BLIP2Config):
        super().__init__()
        d = cfg.vision_hidden
        self.patch_embed = nn.Conv2d(3, d, cfg.patch_size,
                                     stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_patches + 1, d))
        self.layers = nn.ModuleList(VisionLayer(cfg)
                                    for _ in range(cfg.vision_layers))
        self.post_layernorm = L.LayerNorm(d)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: BLIP2Config, cross: bool):
        super().__init__()
        d = cfg.qformer_hidden
        self.attention = Attention(d)
        self.attention_norm = L.LayerNorm(d)
        if cross:
            self.crossattention = Attention(d, kv_dim=cfg.vision_hidden)
            self.crossattention_norm = L.LayerNorm(d)
        self.ffn = _mlp(d, cfg.qformer_mlp)
        self.ffn_norm = L.LayerNorm(d)


class QFormer(nn.Module):
    def __init__(self, cfg: BLIP2Config):
        super().__init__()
        d = cfg.qformer_hidden
        self.query_tokens = nn.Parameter(
            torch.zeros(1, cfg.num_query_tokens, d))
        self.layernorm = L.LayerNorm(d)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_attention_frequency == 0)
            for i in range(cfg.qformer_layers))


class OPTLayer(nn.Module):
    def __init__(self, cfg: BLIP2Config):
        super().__init__()
        d = cfg.opt_hidden
        self.self_attn_layer_norm = L.LayerNorm(d)
        self.self_attn = Attention(d)
        self.final_layer_norm = L.LayerNorm(d)
        self.fc1 = nn.Linear(d, cfg.opt_ffn)
        self.fc2 = nn.Linear(cfg.opt_ffn, d)


class OPTDecoder(nn.Module):
    def __init__(self, cfg: BLIP2Config):
        super().__init__()
        d = cfg.opt_hidden
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.embed_positions = nn.Embedding(cfg.max_positions + 2, d)
        self.final_layer_norm = L.LayerNorm(d)
        self.layers = nn.ModuleList(OPTLayer(cfg)
                                    for _ in range(cfg.opt_layers))


class BLIP2(nn.Module):
    """The whole captioner's parameters, named as the JAX tree."""

    def __init__(self, cfg: BLIP2Config):
        super().__init__()
        self.cfg = cfg
        self.vision_model = VisionModel(cfg)
        self.qformer = QFormer(cfg)
        self.language_projection = nn.Linear(cfg.qformer_hidden,
                                             cfg.opt_hidden)
        self.language_model = OPTDecoder(cfg)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _heads(x, heads: int):
    b, n, _ = x.shape
    return x.view(b, n, heads, -1).transpose(1, 2)


def _mha(p: Attention, q_in, kv_in, heads: int, mask=None):
    b, n, d = q_in.shape
    q = _heads(p.q(q_in), heads)
    k = _heads(p.k(kv_in), heads)
    v = _heads(p.v(kv_in), heads)
    out = L.attention(q, k, v, mask=mask)
    return p.o(out.transpose(1, 2).reshape(b, n, d))


def vision_encoder(model: BLIP2, pixels):
    """(B, 3, S, S) normalised pixels -> (B, 1 + P, D) image tokens."""
    cfg, p = model.cfg, model.vision_model
    x = p.patch_embed(pixels.to(p.patch_embed.weight.dtype))
    x = x.flatten(2).transpose(1, 2)
    b, _, d = x.shape
    x = torch.cat([p.cls_token.to(x.dtype).expand(b, 1, d), x], dim=1)
    x = x + p.pos_embed[:, :x.shape[1]]
    for lp in p.layers:
        h = lp.norm1(x)
        x = x + _mha(lp.attn, h, h, cfg.vision_heads)
        x = x + lp.mlp.fc2(F.gelu(lp.mlp.fc1(lp.norm2(x))))
    return p.post_layernorm(x)


def qformer(model: BLIP2, image_tokens):
    """(B, 1 + P, Dv) -> (B, Q, Dq) query outputs (post-LN BERT blocks)."""
    cfg, p = model.cfg, model.qformer
    b = image_tokens.shape[0]
    x = p.query_tokens.to(image_tokens.dtype).expand(
        b, *p.query_tokens.shape[1:])
    x = p.layernorm(x)
    for lp in p.layers:
        x = lp.attention_norm(x + _mha(lp.attention, x, x, cfg.qformer_heads))
        if hasattr(lp, "crossattention"):
            x = lp.crossattention_norm(x + _mha(
                lp.crossattention, x, image_tokens, cfg.qformer_heads))
        h = F.gelu(lp.ffn.fc1(x))
        x = lp.ffn_norm(x + lp.ffn.fc2(h))
    return x


def _causal_mask(n: int, device):
    i = torch.arange(n, device=device)
    return (i[None, :] <= i[:, None])[None, None]


def _opt_layer(lp: OPTLayer, cfg: BLIP2Config, x, mask,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               pos: Optional[int] = None):
    """Pre-LN OPT block. `cache`: dict(k, v) of (B, H, T, Dh) preallocated;
    x's K/V are written into it in place at `pos`, and the attention reads
    its first mask.shape[-1] entries (the prefill's own n keys, or the
    decode's whole cache)."""
    b, n, d = x.shape
    h = lp.self_attn_layer_norm(x)
    q = _heads(lp.self_attn.q(h), cfg.opt_heads)
    k = _heads(lp.self_attn.k(h), cfg.opt_heads)
    v = _heads(lp.self_attn.v(h), cfg.opt_heads)
    if cache is not None:
        cache["k"][:, :, pos:pos + n] = k.to(cache["k"].dtype)
        cache["v"][:, :, pos:pos + n] = v.to(cache["v"].dtype)
        t = mask.shape[-1]
        k, v = cache["k"][:, :, :t], cache["v"][:, :, :t]
    att = L.attention(q, k, v, mask=mask).transpose(1, 2).reshape(b, n, d)
    x = x + lp.self_attn.o(att)
    h = F.relu(lp.fc1(lp.final_layer_norm(x)))
    return x + lp.fc2(h), cache


def _lm_logits(lm: OPTDecoder, x):
    return lm.final_layer_norm(x) @ lm.embed_tokens.weight.T


def opt_forward(model: BLIP2, inputs_embeds, *, caches=None,
                pos: Optional[int] = None, total_len: Optional[int] = None):
    """OPT over embeddings -> (logits (B, N, V), caches). Prefill: no
    caches, causal mask. Decode: inputs_embeds (B, 1, D), `caches` the
    per-layer KV (written in place at `pos`), the mask over the first
    pos + 1 of `total_len` (default the caches' length) entries."""
    cfg, lm = model.cfg, model.language_model
    n = inputs_embeds.shape[1]
    dev = inputs_embeds.device
    if caches is None:
        positions = torch.arange(n, device=dev)
        mask = _causal_mask(n, dev)
    else:
        positions = torch.tensor([pos], device=dev)
        t = caches[0]["k"].shape[2] if total_len is None else total_len
        mask = (torch.arange(t, device=dev) <= pos)[None, None, None, :]
    x = inputs_embeds + lm.embed_positions.weight[positions + 2]
    new_caches = []
    for i, lp in enumerate(lm.layers):
        x, nc = _opt_layer(lp, cfg, x, mask,
                           cache=None if caches is None else caches[i],
                           pos=pos)
        new_caches.append(nc)
    return _lm_logits(lm, x), new_caches


def _prefill_caches(model: BLIP2, inputs_embeds, max_len: int):
    """The prompt through OPT once, its K/V written into (B, H, max_len, Dh)
    caches -> (last-token logits (B, V), caches)."""
    cfg, lm = model.cfg, model.language_model
    b, n, d = inputs_embeds.shape
    dh = d // cfg.opt_heads
    caches = [{name: inputs_embeds.new_zeros(b, cfg.opt_heads, max_len, dh)
               for name in ("k", "v")} for _ in range(cfg.opt_layers)]
    mask = _causal_mask(n, inputs_embeds.device)
    x = inputs_embeds + lm.embed_positions.weight[
        torch.arange(n, device=inputs_embeds.device) + 2]
    for lp, cache in zip(lm.layers, caches):
        x, _ = _opt_layer(lp, cfg, x, mask, cache=cache, pos=0)
    return _lm_logits(lm, x[:, -1]), caches


def caption(model: BLIP2, pixels, prompt_ids, *, max_new_tokens: int = 50):
    """Greedy captions: (B, 3, S, S) normalised pixels and (B, L) prompt ids
    (the text after the image: OPT reads [query embeds; prompt]) -> (B,
    max_new_tokens) token ids, every token after the first eos an eos."""
    cfg, lm = model.cfg, model.language_model
    queries = qformer(model, vision_encoder(model, pixels))
    qemb = model.language_projection(queries)
    temb = lm.embed_tokens(prompt_ids.to(qemb.device)).to(qemb.dtype)
    emb = torch.cat([qemb, temb], dim=1)
    b, n0, _ = emb.shape
    max_len = n0 + max_new_tokens
    logits, caches = _prefill_caches(model, emb, max_len)
    tok = logits.argmax(-1)
    done = torch.zeros(b, dtype=torch.bool, device=tok.device)
    out = torch.full((b, max_new_tokens), cfg.eos_token_id, dtype=torch.long,
                     device=tok.device)
    for step in range(max_new_tokens):
        out[:, step] = tok
        done = done | (tok == cfg.eos_token_id)
        if step == max_new_tokens - 1 or bool(done.all()):
            break   # every later token is eos, as out already holds
        lg, caches = opt_forward(model, lm.embed_tokens(tok)[:, None],
                                 caches=caches, pos=n0 + step,
                                 total_len=max_len)
        tok = torch.where(done, cfg.eos_token_id, lg[:, -1].argmax(-1))
    return out
