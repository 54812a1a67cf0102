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
