"""Checkpoint surgery on the port's state dicts.

Counterpart of ``editanything_tpu/checkpoints/surgery.py`` (:20-51), which
works on parameter trees:

- ``graft_controlnet_from_unet``: a base UNet's encoder copied into a
  ControlNet whose own layers keep their (zero) init, the behaviour of
  tools/tool_add_control_sd21.py:27-50.
- ``transfer_control_offset``: a trained ControlNet moved to another base,
  its shared encoder shifted by new_base - old_base
  (tool_transfer_control.py:35-58).
"""

from __future__ import annotations

from typing import Dict, Mapping

_SHARED_KEYS = ("conv_in", "time_embedding", "down_blocks", "mid_block")


def _shared(key: str) -> bool:
    return key.split(".", 1)[0] in _SHARED_KEYS


def graft_controlnet_from_unet(unet_sd: Mapping, cn_init: Mapping) -> Dict:
    """A ControlNet state dict whose shared encoder (conv_in,
    time_embedding, down_blocks, mid_block) is the UNet's, copied, and
    whose other entries are `cn_init`'s."""
    out = dict(cn_init)
    for k in cn_init:
        if _shared(k):
            out[k] = unet_sd[k].clone()
    return out


def transfer_control_offset(cn_sd: Mapping, old_unet_sd: Mapping,
                            new_unet_sd: Mapping) -> Dict:
    """ControlNet trained on old base -> adapted to new base: shared =
    cn + (new - old), each difference cast to the ControlNet's dtype before
    it is added; the control-specific entries unchanged."""
    out = dict(cn_sd)
    for k, v in cn_sd.items():
        if _shared(k):
            offset = new_unet_sd[k] - old_unet_sd[k].to(new_unet_sd[k].dtype)
            out[k] = v + offset.to(v.dtype)
    return out
