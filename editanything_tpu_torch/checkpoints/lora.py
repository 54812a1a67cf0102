"""kohya-format LoRA merging and textual-inversion embeddings.

Counterpart of ``editanything_tpu/checkpoints/lora.py`` (:24-204) and of
the appending TI loader of ``editanything_tpu/train/textual_inversion.py``
(:132). A kohya LoRA file (editany_lora.py:197-329) holds
``lora_unet_<module_path>.lora_{up,down}.weight`` (+ ``.alpha``), merged as
W += multiplier * (alpha / rank) * (up @ down); ``lora_te_*`` targets the
text encoder. The port's modules are named after the diffusers and HF ones,
so a target resolves to a submodule by name, and torch's (out, in[, kh,
kw]) layout takes up @ down as it is. The product is taken in float32 numpy
and rounded to the weight's dtype before the scale and the add, as the JAX
package does (:150-161), so a bf16 merge rounds as there.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from editanything_tpu_torch.checkpoints import safetensors_io


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


def _kohya_groups(sd: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """Group flat kohya keys -> {target: {up, down, alpha}}."""
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        if ".lora_up.weight" in k:
            tgt, part = k.split(".lora_up.weight")[0], "up"
        elif ".lora_down.weight" in k:
            tgt, part = k.split(".lora_down.weight")[0], "down"
        elif k.endswith(".alpha"):
            tgt, part = k[: -len(".alpha")], "alpha"
        else:
            continue
        groups.setdefault(tgt, {})[part] = _to_numpy(v)
    return groups


# module names that kohya flattens and that hold underscores themselves,
# longest first for a greedy re-split; some expand to nested paths
_KNOWN = sorted([
    "down_blocks", "up_blocks", "mid_block", "transformer_blocks",
    "attentions", "resnets", "proj_in", "proj_out", "to_q", "to_k",
    "to_v", "to_out", "ff_net", "time_emb_proj", "conv_shortcut",
    "conv_in", "conv_out", "conv1", "conv2", "text_model",
    "encoder_layers", "self_attn", "q_proj", "k_proj", "v_proj",
    "out_proj", "mlp_fc1", "mlp_fc2", "layers",
], key=len, reverse=True)
_ALIASES = {"ff_net": ["ff", "net"], "encoder_layers": ["encoder", "layers"],
            "mlp_fc1": ["mlp", "fc1"], "mlp_fc2": ["mlp", "fc2"]}


def _target_to_path(tgt: str) -> Tuple[str, List[str]]:
    """kohya target name -> (model, module path).

    ``lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q``
    -> ("unet", [down_blocks, 0, attentions, 0, transformer_blocks, 0,
    attn1, to_q]): underscores re-split, known multi-word names glued back,
    kohya's ``to_out`` -> ``to_out.0``."""
    if tgt.startswith("lora_unet_"):
        model, rest = "unet", tgt[len("lora_unet_"):]
    elif tgt.startswith("lora_te_"):
        model, rest = "text_encoder", tgt[len("lora_te_"):]
    else:
        raise ValueError(f"unknown lora target {tgt!r}")
    path: List[str] = []
    parts = rest.split("_")
    i = 0
    while i < len(parts):
        for name in _KNOWN:
            toks = name.split("_")
            if parts[i:i + len(toks)] == toks:
                path += _ALIASES.get(name, [name])
                i += len(toks)
                break
        else:
            path.append(parts[i])
            i += 1
    if path and path[-1] == "to_out":
        path.append("0")
    return model, path


def _find(module: nn.Module, path: Sequence[str]):
    """The submodule at `path`, or None."""
    try:
        return module.get_submodule(".".join(path))
    except AttributeError:
        return None


def resolve_lora_target(modules: Mapping[str, nn.Module], tgt: str):
    """The Linear or Conv2d a kohya target names in `modules` ({"unet",
    "text_encoder"}), or None. ``lora_te_*`` names keep HF's
    ``text_model.`` prefix, which the port's text tower lacks: the path is
    tried again without it (JAX :136-139)."""
    model, path = _target_to_path(tgt)
    root = modules.get(model)
    if root is None:
        return None
    node = _find(root, path)
    if node is None and path and path[0] == "text_model":
        node = _find(root, path[1:])
    return node if isinstance(node, (nn.Linear, nn.Conv2d)) else None


def lora_delta(grp: Mapping[str, np.ndarray], weight_ndim: int,
               multiplier: float = 1.0):
    """(up @ down in float32 numpy, multiplier * alpha / rank) of one
    target, the product shaped as a weight of `weight_ndim` dims; None for
    other ranks. A missing alpha is the rank."""
    up = grp["up"].astype(np.float32)
    down = grp["down"].astype(np.float32)
    rank = down.shape[0]
    alpha = float(grp.get("alpha", rank))
    scale = multiplier * alpha / rank
    if weight_ndim == 2:
        delta = ((up[:, :, 0, 0] if up.ndim == 4 else up)
                 @ (down[:, :, 0, 0] if down.ndim == 4 else down))
    elif weight_ndim == 4:
        # conv lora: up (out, r, 1, 1), down (r, in, kh, kw)
        u = up.reshape(up.shape[0], up.shape[1])
        d = down.reshape(down.shape[0], -1)
        delta = (u @ d).reshape(up.shape[0], down.shape[1],
                                down.shape[2], down.shape[3])
    else:
        return None
    return delta, scale


@torch.no_grad()
def merge_kohya_lora(modules: Mapping[str, nn.Module], sd: Mapping,
                     multiplier: float = 1.0) -> Dict[str, int]:
    """Merge one kohya LoRA state dict into {"unet": module, "text_encoder":
    module} in place. Returns {"merged": n, "skipped": n}: a target skips
    without both factors or where it names no Linear or Conv2d."""
    merged = skipped = 0
    for tgt, grp in _kohya_groups(sd).items():
        if "up" not in grp or "down" not in grp:
            skipped += 1
            continue
        layer = resolve_lora_target(modules, tgt)
        found = (None if layer is None
                 else lora_delta(grp, layer.weight.ndim, multiplier))
        if found is None:
            skipped += 1
            continue
        delta, scale = found
        w = layer.weight
        step = torch.from_numpy(delta).to(device=w.device, dtype=w.dtype)
        # the scale in the weight's dtype too, as JAX takes a Python float
        w.copy_(w + torch.tensor(scale, dtype=w.dtype, device=w.device) * step)
        merged += 1
    return {"merged": merged, "skipped": skipped}


def load_ti_file(path: str) -> np.ndarray:
    """A textual-inversion embedding file -> (N, D) float32: ``.npy`` (the
    JAX package's trainer), a torch ``.bin/.pt`` dict, either diffusers'
    {placeholder: (N, D)} (utils/texutal_inversion.py:160-168) or A1111's
    {"string_to_param": {"*": ...}}, and a single-tensor ``.safetensors``."""
    path = str(path)
    if path.endswith(".npy"):
        arr = np.load(path)
    elif path.endswith(".safetensors"):
        arr = _to_numpy(next(iter(safetensors_io.load_file(path).values())))
    else:
        obj = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "string_to_param" in obj:
            obj = next(iter(obj["string_to_param"].values()))
        elif isinstance(obj, dict):
            obj = next(v for v in obj.values()
                       if isinstance(v, (torch.Tensor, np.ndarray)))
        arr = _to_numpy(obj)
    arr = np.asarray(arr, np.float32)
    return arr[None] if arr.ndim == 1 else arr


@torch.no_grad()
def load_textual_inversion(text: nn.Module, embedding,
                           token_ids: Sequence[int]) -> nn.Module:
    """Overwrite token-embedding rows `token_ids` with TI vectors (the JAX
    package's ``checkpoints.lora.load_textual_inversion``)."""
    table = text.embeddings.token_embedding.weight
    emb = torch.as_tensor(np.asarray(embedding, np.float32))
    table[torch.as_tensor(list(token_ids), dtype=torch.long)] = emb.to(
        table.device, table.dtype)
    return text


@torch.no_grad()
def append_textual_inversion(text: nn.Module, embedding) -> List[int]:
    """Append TI vectors as new token-embedding rows (the
    ``pipe.load_textual_inversion`` path the editor takes,
    editany_lora.py:734; the JAX package's
    ``train.textual_inversion.load_textual_inversion``): the table becomes
    a new ``nn.Embedding`` on the same device and dtype, its rows past the
    config's ``vocab_size``. Returns the new rows' ids."""
    old = text.embeddings.token_embedding
    emb = torch.as_tensor(embedding).detach().float().to(old.weight.device,
                                                         old.weight.dtype)
    grown = nn.Embedding(old.num_embeddings + emb.shape[0],
                         old.embedding_dim, device=old.weight.device,
                         dtype=old.weight.dtype)
    grown.weight.copy_(torch.cat([old.weight, emb], dim=0))
    text.embeddings.token_embedding = grown
    return list(range(old.num_embeddings, grown.num_embeddings))
