"""Checkpoint files -> state dicts of the port's modules, and parameter
trees of the JAX package -> the same state dicts.

Counterpart of ``editanything_tpu/checkpoints/convert.py``. Loading
(``load_torch_state_dict``, its :35-50): ``.safetensors`` through the
port's own reader (checkpoints/safetensors_io.py), ``.pt/.pth/.ckpt/.bin``
through ``torch.load(..., weights_only=True)``, which refuses a file that
needs arbitrary unpickling (the JAX package loads with
``weights_only=False``). Published state dicts and the port's modules:

    diffusers UNet, ControlNet, VAE   the port's names; load as they are
    official SAM (``sam_vit_*.pth``)  the port's names; load as they are
    HF CLIPTextModel                  ``clip_text_state_dict`` (:143-155)
    StableDiffusionSafetyChecker      ``safety_checker_state_dict`` (:157-174)
    HF Blip2ForConditionalGeneration  ``blip2_state_dict`` (:232-301)
    Swin backbones (timm/detectron2)  ``swin_state_dict`` (:214-229)
    ``groundingdino_swint_ogc.pth``   ``dino_state_dict``
                                      (checkpoints/detectors.py:146-195)
    VLPart (detectron2, open_clip)    ``vlpart_state_dict``
                                      (checkpoints/detectors.py:49-143)

The trees of the JAX package map per leaf (the inverse of its
``state_dict_to_tree``, :84-127):

    conv ``kernel`` (H, W, I, O) -> ``weight`` (O, I, H, W)
    transposed-conv ``kernel`` (H, W, I, O) -> ``weight`` (I, O, H, W)
    linear ``kernel`` (in, out)  -> ``weight`` (out, in)
    norm ``scale``               -> ``weight``
    ``bias`` and embedding ``weight`` unchanged

Tree leaves may be numpy or JAX arrays (read with ``np.asarray``; nothing
here imports jax). Each port module loads the result with ``strict=True``.
"""

from __future__ import annotations

import pickle
import re
import zipfile
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from editanything_tpu_torch.checkpoints import safetensors_io


def load_torch_state_dict(path: str, *, device=None,
                          dtype: Optional[torch.dtype] = None
                          ) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` / ``.pt`` / ``.pth`` / ``.ckpt`` / ``.bin`` file ->
    name -> tensor, each on `device` (default the CPU) and, where floating
    point and `dtype` is given, in `dtype`, converted one tensor at a time.
    Lightning's ``{"state_dict": ...}`` (cldm/model.py:12-21) and
    detectron2/DETR's ``{"model": ...}`` are unwrapped; entries that are
    neither tensors, arrays nor numbers are dropped, as in the JAX
    package."""
    path = str(path)
    if path.endswith(".safetensors"):
        return safetensors_io.load_file(path, device=device, dtype=dtype)
    try:
        # a zip-format file (every torch.save since 1.6) is mapped, not read
        obj = torch.load(path, map_location="cpu", weights_only=True,
                         mmap=zipfile.is_zipfile(path))
    except pickle.UnpicklingError as e:
        raise ValueError(f"{path}: loading it needs arbitrary unpickling, "
                         f"which the port refuses (torch.load with "
                         f"weights_only=True): {e}") from None
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    elif isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    out: Dict[str, torch.Tensor] = {}
    for k, v in obj.items():
        if isinstance(v, (np.ndarray, int, float)):
            v = torch.as_tensor(v)
        if not isinstance(v, torch.Tensor):
            continue
        cast = dtype if dtype is not None and v.is_floating_point() else None
        out[k] = v.to(device=device, dtype=cast)
    return out


def clip_text_state_dict(sd: Mapping) -> Dict:
    """HF CLIPTextModel state dict -> ``models/clip_text.py``'s: the
    ``text_model.`` prefix stripped, the ``position_ids`` buffer dropped."""
    return {k.replace("text_model.", ""): v for k, v in sd.items()
            if not k.replace("text_model.", "").startswith(
                "embeddings.position_ids")}


def safety_checker_state_dict(sd: Mapping) -> Dict:
    """StableDiffusionSafetyChecker state dict
    (CompVis/stable-diffusion-safety-checker) -> ``models/safety.py``'s. The
    HF class nests a CLIPVisionModel under an attribute also named
    ``vision_model``, so its tower keys are doubled
    (``vision_model.vision_model.embeddings...``); one level is stripped,
    and the ``position_ids`` buffer dropped."""
    return {k.replace("vision_model.vision_model.", "vision_model.", 1): v
            for k, v in sd.items() if not k.endswith("position_ids")}


# HF Blip2ForConditionalGeneration names -> models/blip2.py's, the JAX
# package's _BLIP2_MAP (checkpoints/convert.py:232-270) with torch's leaves
_BLIP2_MAP = [
    (r"^vision_model\.embeddings\.patch_embedding\.", "vision_model.patch_embed."),
    (r"^vision_model\.embeddings\.class_embedding$", "vision_model.cls_token"),
    (r"^vision_model\.embeddings\.position_embedding$", "vision_model.pos_embed"),
    (r"^vision_model\.encoder\.layers\.(\d+)\.layer_norm1\.", r"vision_model.layers.\1.norm1."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.layer_norm2\.", r"vision_model.layers.\1.norm2."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.self_attn\.projection\.", r"vision_model.layers.\1.attn.o."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.mlp\.fc1\.", r"vision_model.layers.\1.mlp.fc1."),
    (r"^vision_model\.encoder\.layers\.(\d+)\.mlp\.fc2\.", r"vision_model.layers.\1.mlp.fc2."),
    (r"^query_tokens$", "qformer.query_tokens"),
    (r"^qformer\.encoder\.layer\.(\d+)\.(attention|crossattention)\.attention\.query\.", r"qformer.layers.\1.\2.q."),
    (r"^qformer\.encoder\.layer\.(\d+)\.(attention|crossattention)\.attention\.key\.", r"qformer.layers.\1.\2.k."),
    (r"^qformer\.encoder\.layer\.(\d+)\.(attention|crossattention)\.attention\.value\.", r"qformer.layers.\1.\2.v."),
    (r"^qformer\.encoder\.layer\.(\d+)\.(attention|crossattention)\.output\.dense\.", r"qformer.layers.\1.\2.o."),
    (r"^qformer\.encoder\.layer\.(\d+)\.(attention|crossattention)\.output\.LayerNorm\.", r"qformer.layers.\1.\2_norm."),
    (r"^qformer\.encoder\.layer\.(\d+)\.intermediate_query\.dense\.", r"qformer.layers.\1.ffn.fc1."),
    (r"^qformer\.encoder\.layer\.(\d+)\.output_query\.dense\.", r"qformer.layers.\1.ffn.fc2."),
    (r"^qformer\.encoder\.layer\.(\d+)\.output_query\.LayerNorm\.", r"qformer.layers.\1.ffn_norm."),
    (r"^language_model\.model\.decoder\.layers\.(\d+)\.self_attn\.(q|k|v)_proj\.", r"language_model.layers.\1.self_attn.\2."),
    (r"^language_model\.model\.decoder\.layers\.(\d+)\.self_attn\.out_proj\.", r"language_model.layers.\1.self_attn.o."),
    (r"^language_model\.model\.decoder\.", "language_model."),
]
_BLIP2_TIED_HEAD = "language_model.lm_head.weight"


def blip2_state_dict(sd: Mapping) -> Dict:
    """HF Blip2ForConditionalGeneration state dict -> ``models/blip2.py``'s.

    The vision tower's fused ``qkv`` weight and bias are split into q/k/v
    (the JAX package's ``blip2_to_tree``); files of the older layout, with
    ``q_bias`` and ``v_bias`` beside a bias-free ``qkv``, give q and v those
    biases and k a zero one, as HF computes them. OPT's ``lm_head`` is tied
    to ``embed_tokens`` and dropped (an untied one raises: the port's head
    is ``x @ embed_tokens.T``). Names already the port's pass through."""
    out: Dict = {}
    for k, v in sd.items():
        if k == _BLIP2_TIED_HEAD:
            continue
        m = re.match(r"^vision_model\.encoder\.layers\.(\d+)\.self_attn\."
                     r"(qkv\.weight|qkv\.bias|q_bias|v_bias)$", k)
        if m:
            layer, leaf = m.groups()
            pre = f"vision_model.layers.{layer}.attn"
            if leaf.startswith("qkv"):
                for name, part in zip("qkv", v.chunk(3, dim=0)):
                    out[f"{pre}.{name}.{leaf[4:]}"] = part
            else:
                out[f"{pre}.{leaf[0]}.bias"] = v
                out[f"{pre}.k.bias"] = torch.zeros_like(v)
            continue
        for pat, rep in _BLIP2_MAP:
            nk = re.sub(pat, rep, k)
            if nk != k:
                k = nk
                break
        out[k] = v
    head = sd.get(_BLIP2_TIED_HEAD)
    emb = out.get("language_model.embed_tokens.weight")
    if head is not None and emb is not None and not torch.equal(
            torch.as_tensor(head), torch.as_tensor(emb)):
        raise ValueError("BLIP-2 state dict: lm_head is not tied to "
                         "embed_tokens; the port's head is x @ embed_tokens.T")
    return out


_SWIN_DROP = ("relative_position_index", "attn_mask")


def swin_state_dict(sd: Mapping) -> Dict:
    """A Swin backbone's state dict (timm / detectron2 ``bottom_up``
    naming) -> ``models/swin.py``'s: the ``backbone.bottom_up.`` or
    ``backbone.`` prefix stripped, the ``relative_position_index`` and
    ``attn_mask`` buffers and a classifier ``head.`` dropped, as the JAX
    package's ``swin_to_tree`` does."""
    out: Dict = {}
    for k, v in sd.items():
        k = k.replace("backbone.bottom_up.", "").replace("backbone.", "")
        if k.endswith(_SWIN_DROP) or k.startswith("head."):
            continue
        out[k] = v
    return out


# aliases of the official GroundingDINO file that the port does not keep:
# the decoder's view of the box MLP and its five tied copies, the unused
# label encoder and BERT pooler, the position-embedding module (no
# parameters), and buffers
_DINO_SKIP = re.compile(
    r"^(transformer\.decoder\.bbox_embed\.|bbox_embed\.[1-9]\d*\.|label_enc"
    r"|bert\.pooler|bert\.embeddings\.(position|token_type)_ids$|backbone\.1\.)")


def dino_state_dict(sd: Mapping) -> Dict:
    """The official ``groundingdino_swint_ogc.pth`` layout ->
    ``models/groundingdino.py``'s, the JAX package's ``dino_to_tree``
    (checkpoints/detectors.py:146-195) without its splits: the port keeps
    ``nn.MultiheadAttention``'s packed ``in_proj_weight`` and ``out_proj``,
    ``input_proj.I.0``/``.1`` and BERT's HF names. ``module.`` is stripped;
    ``backbone.0.`` becomes ``backbone.`` (through ``swin_state_dict``) and
    the shared ``bbox_embed.0.`` becomes ``bbox_embed.``; the aliases of
    ``_DINO_SKIP`` are dropped. Names already the port's pass through."""
    out: Dict = {}
    swin: Dict = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if _DINO_SKIP.match(k):
            continue
        if k.startswith("backbone."):
            swin[re.sub(r"^backbone\.(0\.)?", "", k)] = v
            continue
        out[re.sub(r"^bbox_embed\.0\.", "bbox_embed.", k)] = v
    out.update({f"backbone.{k}": v for k, v in swin_state_dict(swin).items()})
    return out


def _clip_rn50_text_state_dict(sd: Mapping) -> Dict:
    """open_clip's text tower (``token_embedding``, ``positional_embedding``,
    ``transformer.resblocks.N.{attn.in_proj_*, attn.out_proj, ln_1, ln_2,
    mlp.c_fc, mlp.c_proj}``, ``ln_final``, ``text_projection``) ->
    ``models/clip_text.py``'s names under ``clip.``, the fused ``in_proj``
    split into q/k/v, as the JAX package's ``_clip_rn50_text_remap``."""
    out: Dict = {}
    fixed = {"token_embedding.weight": "clip.embeddings.token_embedding.weight",
             "positional_embedding":
                 "clip.embeddings.position_embedding.weight",
             "ln_final.weight": "clip.final_layer_norm.weight",
             "ln_final.bias": "clip.final_layer_norm.bias",
             "text_projection": "text_projection"}
    for k, v in sd.items():
        if k in fixed:
            out[fixed[k]] = v
            continue
        m = re.match(r"transformer\.resblocks\.(\d+)\.(.*)", k)
        if not m:
            continue
        n, rest = m.groups()
        pre = f"clip.encoder.layers.{n}."
        if rest in ("attn.in_proj_weight", "attn.in_proj_bias"):
            leaf = rest.rsplit("_", 1)[1]
            for name, part in zip(("q_proj", "k_proj", "v_proj"),
                                  v.chunk(3, dim=0)):
                out[f"{pre}self_attn.{name}.{leaf}"] = part
            continue
        for a, b in (("attn.out_proj", "self_attn.out_proj"),
                     ("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                     ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
            rest = rest.replace(a, b)
        out[pre + rest] = v
    return out


def vlpart_state_dict(sd: Mapping) -> Dict:
    """VLPart's detectron2 checkpoint (``swinbase_part_0a0000.pth``) ->
    ``models/vlpart.py``'s, the JAX package's ``vlpart_to_tree``:
    ``backbone.bottom_up.*`` the Swin, ``backbone.fpn_{lateral,output}{2..5}``
    ``fpn.{lateral,output}.{0..3}``, the RPN head ``rpn.*``, the cascade's
    ``box_head.K`` / ``box_predictor.K.{bbox_pred,cls_score.linear}``
    ``roi_heads.K.*``, the open_clip text tower ``text_encoder.clip.*``
    (``_clip_rn50_text_state_dict``). Other entries (the pixel mean and
    std) are dropped; names already the port's pass through."""
    out: Dict = {}
    swin: Dict = {}
    text: Dict = {}
    for k, v in sd.items():
        if k.startswith("backbone.bottom_up."):
            swin[k] = v
        elif k.startswith("backbone.fpn_"):
            m = re.match(r"backbone\.fpn_(lateral|output)(\d)\.(weight|bias)$",
                         k)
            if m:
                kind, lvl, leaf = m.groups()
                out[f"fpn.{kind}.{int(lvl) - 2}.{leaf}"] = v
        elif k.startswith("text_encoder.") and not k.startswith(
                ("text_encoder.clip.", "text_encoder.text_projection")):
            text[k[len("text_encoder."):]] = v
        elif k.startswith(("proposal_generator.", "roi_heads.")):
            nk = k.replace("proposal_generator.rpn_head.", "rpn.")
            nk = re.sub(r"roi_heads\.box_head\.(\d)\.", r"roi_heads.\1.", nk)
            nk = re.sub(r"roi_heads\.box_predictor\.(\d)\.cls_score\.linear\.",
                        r"roi_heads.\1.cls_score.", nk)
            nk = re.sub(r"roi_heads\.box_predictor\.(\d)\.bbox_pred\.",
                        r"roi_heads.\1.bbox_pred.", nk)
            out[nk] = v
        elif k.startswith(("backbone.", "fpn.", "rpn.", "text_encoder.")):
            out[k] = v
    out.update({f"backbone.{k}": v for k, v in swin_state_dict(swin).items()})
    out.update({f"text_encoder.{k}": v
                for k, v in _clip_rn50_text_state_dict(text).items()})
    return out


def state_dict_from_tree(tree: Mapping, prefix: str = "", *,
                         conv_transpose: Sequence[str] = ()
                         ) -> Dict[str, torch.Tensor]:
    """`conv_transpose`: module paths of ConvTranspose2d layers, whose torch
    weights are (I, O, H, W)."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + [str(k)])
            return
        a = np.asarray(node)
        leaf, mod = path[-1], ".".join(path[:-1])
        if leaf == "kernel" and a.ndim == 4 and mod in conv_transpose:
            name, a = f"{mod}.weight", a.transpose(2, 3, 0, 1)
        elif leaf == "kernel" and a.ndim == 4:
            name, a = f"{mod}.weight", a.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and a.ndim == 2:
            name, a = f"{mod}.weight", a.T
        elif leaf == "scale":
            name = f"{mod}.weight"
        else:
            name = ".".join(path)
        out[name] = torch.from_numpy(np.array(a, order="C"))

    walk(tree, [prefix] if prefix else [])
    return out


def sam_state_dict_from_tree(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of the JAX package's ``sam_to_tree``
    (checkpoints/convert.py:176-211): a ``models/sam.py`` tree -> the
    official SAM state dict. The decoder's two transposed convs take the
    (I, O, H, W) layout; LayerNorm2d leaves already carry ``weight``;
    ``pos_embed``, ``rel_pos_h/w``, the embeddings and the Fourier matrix
    keep their layout."""
    return state_dict_from_tree(tree, conv_transpose=(
        "mask_decoder.output_upscaling.0", "mask_decoder.output_upscaling.3"))
