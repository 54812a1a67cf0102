"""Host-side image helpers.

``HWC3`` and ``resize_image`` follow ``editanything_tpu/utils/image.py``.
``resize_image`` resamples as PIL's ``Image.resize`` does (LANCZOS when
upscaling, BOX when downscaling), in numpy and to the level, so no path of
the port needs PIL at any resolution. ``resize_nearest``/``resize_bilinear``
reproduce ``jax.image.resize``: its "nearest" samples at half-pixel centres
(torch's ``nearest-exact``), its "bilinear" antialiases when downscaling.
``resize_uint8_bilinear`` stands in for PIL's BILINEAR resize of uint8
images (within one level of it), so the SAM phase needs no PIL.
"""

from __future__ import annotations

import math
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


# PIL's separable resampling (libImaging/Resample.c): its filters and
# supports, and its 8-bit path's fixed-point coefficients
_PRECISION_BITS = 22


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def _box(x: float) -> float:
    return 1.0 if -0.5 < x <= 0.5 else 0.0


_FILTERS = {"lanczos": (_lanczos, 3.0), "box": (_box, 0.5)}


def _resample_matrix(in_size: int, out_size: int, filt: str) -> np.ndarray:
    """(out, in) fixed-point weights of one pass, as Resample.c's
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` make them: the window
    ``center +- support * max(scale, 1)`` clipped to the image, the weights
    normalised to sum 1 and rounded to 22 fractional bits. Held as float64,
    in which every product with a uint8 and every sum of a pass is an exact
    integer (below 2^53), so a BLAS product sums them exactly."""
    fn, support = _FILTERS[filt]
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support *= fscale
    ss = 1.0 / fscale
    mat = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:             # in order, as the C loop sums
            ww += v
        for x, v in enumerate(w):
            k = v / ww if ww != 0.0 else v
            mat[xx, xmin + x] = int(k * (1 << _PRECISION_BITS)
                                    + (-0.5 if k < 0 else 0.5))
    return mat


def _clip8(acc: np.ndarray) -> np.ndarray:
    """Fixed-point sums -> uint8: rounded from half a unit, shifted down
    and clipped, as Resample.c's ``clip8``."""
    acc = acc.astype(np.int64) + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_image(input_image: np.ndarray, resolution: int) -> np.ndarray:
    """Short side -> `resolution`; H and W rounded to multiples of 64;
    LANCZOS when upscaling, BOX when downscaling, as PIL's ``Image.resize``
    computes them for a uint8 image (horizontal pass first, each pass
    clipped to uint8)."""
    h0, w0 = input_image.shape[:2]
    k = float(resolution) / min(h0, w0)
    h = int(np.round(h0 * k / 64.0)) * 64
    w = int(np.round(w0 * k / 64.0)) * 64
    if (h, w) == (h0, w0):
        return input_image
    if input_image.dtype != np.uint8:
        raise TypeError(f"resize_image takes uint8, got {input_image.dtype}")
    filt = "lanczos" if k > 1 else "box"
    out = input_image if input_image.ndim == 3 else input_image[:, :, None]
    if w != w0:     # (H * C, W) @ (W, w)
        mat = _resample_matrix(w0, w, filt)
        hh, _, c = out.shape
        rows = out.transpose(0, 2, 1).reshape(hh * c, w0).astype(np.float64)
        out = _clip8(rows @ mat.T).reshape(hh, c, w).transpose(0, 2, 1)
    if h != h0:     # (h, H) @ (H, W * C)
        mat = _resample_matrix(h0, h, filt)
        hh, ww, c = out.shape
        out = _clip8(mat @ out.reshape(hh, ww * c).astype(np.float64)
                     ).reshape(h, ww, c)
    return np.ascontiguousarray(
        out if input_image.ndim == 3 else out[:, :, 0])


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
