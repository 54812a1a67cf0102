"""Parameter trees of the JAX package -> state dicts of the port.

The inverse of ``editanything_tpu/checkpoints/convert.py``
(``state_dict_to_tree``, :84-127). Both packages name parameters after the
torch modules, so the mapping is per leaf:

    conv ``kernel`` (H, W, I, O) -> ``weight`` (O, I, H, W)
    transposed-conv ``kernel`` (H, W, I, O) -> ``weight`` (I, O, H, W)
    linear ``kernel`` (in, out)  -> ``weight`` (out, in)
    norm ``scale``               -> ``weight``
    ``bias`` and embedding ``weight`` unchanged

Leaves may be numpy or JAX arrays (read with ``np.asarray``; nothing here
imports jax). Each port module loads the result with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch


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
