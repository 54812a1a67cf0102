"""Image resizes of the reference, in float64 numpy: PIL's separable
resampling (``Image.resize``: the horizontal pass first, each pass
rounded and clipped to uint8; a filter's support widened by the scale
when shrinking) and Stable Diffusion's ``resize_image`` (short side to a
resolution, sides rounded to multiples of 64, LANCZOS up and BOX down).
PIL sums in 22-bit fixed point where this sums in float64, so a pixel may
differ from PIL's by one level.
"""

from __future__ import annotations

import numpy as np


def _bilinear(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _lanczos(x):
    return np.where(np.abs(x) < 3.0, np.sinc(x) * np.sinc(x / 3.0), 0.0)


def _box(x):
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


FILTERS = {"bilinear": (_bilinear, 1.0), "lanczos": (_lanczos, 3.0),
           "box": (_box, 0.5)}


def weights(n_in: int, n_out: int, filt: str) -> np.ndarray:
    """(n_out, n_in) resampling matrix of PIL's ``precompute_coeffs``."""
    fn, support = FILTERS[filt]
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support *= fscale
    mat = np.zeros((n_out, n_in))
    for i in range(n_out):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        x = np.arange(lo, hi)
        k = fn((x - center + 0.5) / fscale)
        mat[i, lo:hi] = k / k.sum()
    return mat


def _pass(img: np.ndarray, axis: int, n_out: int, filt: str) -> np.ndarray:
    n_in = img.shape[axis]
    if n_in == n_out:
        return img
    mat = weights(n_in, n_out, filt)
    out = np.tensordot(mat, np.moveaxis(img.astype(np.float64), axis, 0),
                       axes=(1, 0))
    out = np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_pil(img: np.ndarray, size, filt: str) -> np.ndarray:
    """uint8 (H, W[, C]) -> (h, w[, C]), PIL's ``resize((w, h), filt)``."""
    h, w = size
    return _pass(_pass(img, 1, w, filt), 0, h, filt)


def resize_pil_bilinear(img: np.ndarray, size) -> np.ndarray:
    return resize_pil(img, size, "bilinear")


def resize_image(img: np.ndarray, resolution: int) -> np.ndarray:
    """Stable Diffusion's ``resize_image``: the short side to
    `resolution`, each side rounded to a multiple of 64."""
    h0, w0 = img.shape[:2]
    k = float(resolution) / min(h0, w0)
    h = int(np.round(h0 * k / 64.0)) * 64
    w = int(np.round(w0 * k / 64.0)) * 64
    if (h, w) == (h0, w0):
        return img
    return resize_pil(img, (h, w), "lanczos" if k > 1 else "box")


def nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """Source index of each output pixel under a half-pixel nearest
    resize (``jax.image.resize``'s "nearest")."""
    return np.minimum(np.floor((np.arange(n_out) + 0.5) * n_in / n_out),
                      n_in - 1).astype(np.int64)


def resize_nearest(mask: np.ndarray, size) -> np.ndarray:
    """(H, W) -> (h, w) by half-pixel nearest sampling."""
    return mask[nearest_index(mask.shape[0], size[0])][
        :, nearest_index(mask.shape[1], size[1])]
