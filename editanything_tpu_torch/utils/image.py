"""Host-side image helpers.

``HWC3`` and ``resize_image`` follow ``editanything_tpu/utils/image.py``;
PIL is imported only when ``resize_image`` really resizes, so a 512^2 edit
runs where PIL is not installed. ``resize_nearest``/``resize_bilinear``
reproduce ``jax.image.resize``: its "nearest" samples at half-pixel centres
(torch's ``nearest-exact``), its "bilinear" antialiases when downscaling.
``resize_uint8_bilinear`` stands in for PIL's BILINEAR resize of uint8
images (within one level of it), so the SAM phase needs no PIL.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def HWC3(x: np.ndarray) -> np.ndarray:
    """uint8 gray/RGB/RGBA -> RGB; alpha composited over white."""
    if x.dtype != np.uint8:
        raise TypeError(f"HWC3 takes uint8, got {x.dtype}")
    if x.ndim == 2:
        x = x[:, :, None]
    if x.ndim != 3 or x.shape[2] not in (1, 3, 4):
        raise ValueError(f"HWC3 takes HxW, HxWx1, x3 or x4, got {x.shape}")
    c = x.shape[2]
    if c == 3:
        return x
    if c == 1:
        return np.concatenate([x, x, x], axis=2)
    color = x[:, :, 0:3].astype(np.float32)
    alpha = x[:, :, 3:4].astype(np.float32) / 255.0
    y = color * alpha + 255.0 * (1.0 - alpha)
    return y.clip(0, 255).astype(np.uint8)


def resize_image(input_image: np.ndarray, resolution: int) -> np.ndarray:
    """Short side -> `resolution`; H and W rounded to multiples of 64;
    LANCZOS when upscaling, BOX when downscaling."""
    h0, w0 = input_image.shape[:2]
    k = float(resolution) / min(h0, w0)
    h = int(np.round(h0 * k / 64.0)) * 64
    w = int(np.round(w0 * k / 64.0)) * 64
    if (h, w) == (h0, w0):
        return input_image
    from PIL import Image
    resample = Image.LANCZOS if k > 1 else Image.BOX
    return np.asarray(Image.fromarray(input_image).resize((w, h), resample))


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, *size), jax.image.resize "nearest"."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """(N, C, H, W) float -> (N, C, *size), jax.image.resize "bilinear"."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)


def resize_uint8_bilinear(img, size):
    """uint8 (H, W, C) numpy array or tensor -> (h, w, C) of the same kind,
    on the same device: antialiased bilinear with half-pixel centres, rounded
    and clamped. It stands in for PIL's ``Image.resize(..., BILINEAR)``,
    which the JAX package's SAM resize uses (editor.py:131-136,
    predictor.py:64-71): at most one level apart from it. The same size
    returns the input unchanged, as PIL does."""
    if tuple(img.shape[:2]) == tuple(size):
        return img
    x = torch.as_tensor(img)
    y = F.interpolate(x.permute(2, 0, 1)[None].float(), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=True)
    y = y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
    return y.numpy() if isinstance(img, np.ndarray) else y


def resize_points(clicked_points: Sequence[Tuple[int, int, int]],
                  original_shape: Tuple[int, ...],
                  resolution: int) -> List[Tuple[int, int, int]]:
    """Scale (x, y, label) click coordinates with ``resize_image``'s
    short-side resize (editanything_tpu/utils/image.py:55)."""
    oh, ow = original_shape[0], original_shape[1]
    scale = float(resolution) / min(float(oh), float(ow))
    return [(int(round(x * scale)), int(round(y * scale)), lab)
            for (x, y, lab) in clicked_points]
