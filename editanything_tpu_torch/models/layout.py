"""The memory layout of the SD models' conv weights, and so of their
activations.

In half precision on the GPU every conv weight of the UNet, the
ControlNets and the VAE is held channels-last (NHWC), so cuDNN's sm90 conv
kernels, which run NHWC, take the activations and weights as they are:
an NCHW weight would make it transpose both around every conv. With a
channels-last weight PyTorch's conv returns a channels-last output, which
the next GroupNorm (kernel A's NHWC path), the elementwise ops, ``cat`` and
the nearest upsampling keep, so the whole model runs channels-last. fp32
weights stay NCHW: with TF32 off, cuDNN's fp32 convs run NCHW-native kernels
with no transposes. CPU and meta tensors stay NCHW. The rule reads only
what a weight shows, its dtype and device (``channels_last_for``); the
bundle applies it where it is built or moved (pipelines/bundle.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn

HALF = (torch.bfloat16, torch.float16)


def channels_last_for(dtype: torch.dtype, device_type: str) -> bool:
    """Whether a conv weight of `dtype` on a `device_type` device is held
    channels-last: half precision on CUDA only."""
    return dtype in HALF and device_type == "cuda"


def _strides(shape, channels_last: bool):
    o, i, kh, kw = shape
    if channels_last:
        return (kh * kw * i, 1, kw * i, i)
    return (i * kh * kw, kh * kw, kw, 1)


@torch.no_grad()
def relayout_(p: nn.Parameter, channels_last: bool) -> bool:
    """Lay the 4-D parameter `p` out channels-last or NCHW in its own
    storage: the elements in the new order go back through one temporary
    the size of the weight, and `p` becomes a view of that storage with
    the new strides, so its ``data_ptr()`` and values stay and nothing is
    left allocated. Returns whether anything changed."""
    w = p.data
    want = _strides(w.shape, channels_last)
    if w.stride() == want:
        return False
    dense = w.is_contiguous() or w.is_contiguous(
        memory_format=torch.channels_last)
    if not dense:                 # another view: a copy in the new layout
        p.data = w.contiguous(memory_format=torch.channels_last
                              if channels_last else torch.contiguous_format)
        return True
    if w.shape[2] * w.shape[3] > 1:   # a 1x1 kernel's orders coincide
        order = w.permute(0, 2, 3, 1) if channels_last else w
        w.as_strided((w.numel(),), (1,)).copy_(order.contiguous().view(-1))
    p.data = w.as_strided(w.shape, want)
    return True


def lay_out_(module: nn.Module) -> None:
    """Every ``nn.Conv2d`` weight of `module` laid out by
    ``channels_last_for`` its own dtype and device (``relayout_``)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            w = m.weight
            relayout_(w, channels_last_for(w.dtype, w.device.type))
