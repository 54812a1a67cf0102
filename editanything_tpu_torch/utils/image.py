"""Host-side image helpers.

``HWC3`` and ``resize_image`` follow ``editanything_tpu/utils/image.py``.
``resize_image`` resamples as PIL's ``Image.resize`` does (LANCZOS when
upscaling, BOX when downscaling), in numpy and to the level, so no path of
the port needs PIL at any resolution; ``resize_pil`` takes any of those
filters, BICUBIC (the safety checker's resize) and BILINEAR (the
detectors') at a given size.
``write_png`` writes an 8-bit RGB PNG with ``zlib`` alone, and
``read_image`` reads one (8-bit gray, gray + alpha, RGB or RGBA, any of
the five row filters) the same way, and ``image_size`` reads a PNG's size
from its header; any other file goes through PIL,
imported for it alone, so the training data needs no PIL on a machine
without it. ``resize_pil(..., "nearest")`` is PIL's NEAREST (the SAM
condition's resize in the training data).
``resize_nearest``/``resize_bilinear`` reproduce ``jax.image.resize``: its
"nearest" samples at half-pixel centres (torch's ``nearest-exact``), its
"bilinear" antialiases when downscaling. ``resize_jax`` is
``jax.image.resize``'s "bilinear" and "bicubic" (Keys' cubic at a = -0.5;
torch's bicubic without antialiasing takes a = -0.75) with JAX's own fp32
weight matrices, whose sample positions carry the fp32 rounding of
in/out, where a value's exact side of an integer matters (a truncating
uint8 cast).
``resize_uint8_bilinear`` stands in for PIL's BILINEAR resize of uint8
images (within one level of it), so the SAM phase needs no PIL.
``get_bounding_box`` is the JAX package's, the reference's swapped axes
and all.
"""

from __future__ import annotations

import math
import struct
import zlib
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


def get_bounding_box(mask) -> List[int]:
    """Mask (H, W) or (H, W, C), channel 0 read -> [rmin, cmin, rmax,
    cmax] with the reference's swapped axes kept (annotator/util.py:57-73,
    as the JAX package keeps them): "rows" are the columns that hold the
    mask, "cols" the rows. An empty mask raises IndexError, as there."""
    mask = np.array(mask).astype(np.uint8)
    if mask.ndim == 3:
        mask = mask[:, :, 0]
    rows = np.any(mask, axis=0)
    cols = np.any(mask, axis=1)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return [int(rmin), int(cmin), int(rmax), int(cmax)]


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


def _triangle(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_FILTERS = {"lanczos": (_lanczos, 3.0), "box": (_box, 0.5),
            "bilinear": (_triangle, 1.0), "bicubic": (_bicubic, 2.0)}


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
    return resize_pil(input_image, (h, w), "lanczos" if k > 1 else "box")


def resize_pil(image: np.ndarray, size: Tuple[int, int],
               filt: str) -> np.ndarray:
    """uint8 (H, W[, C]) -> (h, w[, C]) as PIL's ``Image.resize((w, h),
    filt)`` computes it (filt "lanczos", "box", "bilinear" or "bicubic"):
    horizontal pass first, each pass clipped to uint8, a pass skipped where
    its side keeps its size. Downscaling widens every filter's support by
    the scale, as PIL does, so "bilinear" averages over the whole
    footprint there (the detectors' resize). "nearest" picks source
    pixels as PIL's NEAREST (``_nearest_index``)."""
    if image.dtype != np.uint8:
        raise TypeError(f"resize_pil takes uint8, got {image.dtype}")
    h, w = size
    h0, w0 = image.shape[:2]
    if filt == "nearest":
        return np.ascontiguousarray(
            image[_nearest_index(h0, h)][:, _nearest_index(w0, w)])
    out = image if image.ndim == 3 else image[:, :, None]
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
    return np.ascontiguousarray(out if image.ndim == 3 else out[:, :, 0])


def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """The source index of each output pixel under PIL's NEAREST resize
    (Geometry.c ``ImagingScaleAffine``): the sample position starts at half
    a step and adds the step n_in / n_out in double precision, one output
    pixel at a time, and is truncated; the running sum, not the product,
    decides where a position lands on an integer."""
    step = n_in / n_out
    pos = np.add.accumulate(np.concatenate([[0.5 * step],
                                            np.full(n_out - 1, step)]))
    return np.minimum(pos.astype(np.int64), n_in - 1)


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}    # gray, RGB, gray + alpha, RGBA


def _png_unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """The filtered scanlines (h, 1 + w * bpp) -> (h, w, bpp) uint8. Rows
    filtered None, Sub or Up are undone a row at a time; where an Average
    or Paeth row occurs, the image is undone by anti-diagonals (a pixel
    needs its left, upper and upper-left neighbours), each vectorised."""
    kinds = raw[:, 0]
    data = raw[:, 1:].reshape(h, w, bpp).astype(np.int32)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {int(kinds.max())}")
    out = np.zeros((h + 1, w + 1, bpp), np.int32)     # a zero row and column
    if kinds.max(initial=0) <= 2:
        for y in range(h):
            row = data[y]
            if kinds[y] == 1:
                row = np.cumsum(row, axis=0)
            elif kinds[y] == 2:
                row = row + out[y, 1:]
            out[y + 1, 1:] = row & 255
        return out[1:, 1:].astype(np.uint8)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a, b, c = out[ys + 1, xs], out[ys, xs + 1], out[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = kinds[ys][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (data[ys, xs] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def _read_png(buf: bytes):
    """An 8-bit, non-interlaced gray / gray + alpha / RGB / RGBA PNG ->
    (H, W, C) uint8, or None for any other PNG."""
    pos, header, idat = 8, None, []
    while pos < len(buf):
        n = struct.unpack(">I", buf[pos:pos + 4])[0]
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in _PNG_CHANNELS:
        return None
    bpp = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _png_unfilter(raw[:h * (1 + w * bpp)].reshape(h, 1 + w * bpp),
                         h, w, bpp)


def read_image(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB, as PIL's
    ``Image.open(path).convert("RGB")`` gives it: gray is repeated and
    alpha dropped. 8-bit PNGs (gray, gray + alpha, RGB, RGBA) are decoded
    with ``zlib`` alone; any other file (JPEG, a palette or 16-bit PNG)
    needs PIL, imported here only, and raises an ImportError naming the
    file without it."""
    with open(path, "rb") as f:
        buf = f.read()
    img = _read_png(buf) if buf.startswith(_PNG_SIGNATURE) else None
    if img is not None:
        c = img.shape[2]
        return np.ascontiguousarray(
            np.repeat(img[..., :1], 3, axis=2) if c <= 2 else img[..., :3])
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path} needs PIL (only 8-bit PNGs are "
                          f"decoded without it)") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def image_size(path: str) -> Tuple[int, int]:
    """(height, width) of an image file, as ``read_image(path).shape[:2]``
    gives it, from its header alone: a PNG's IHDR, any other file through
    PIL (imported here only), which opens images lazily."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head.startswith(_PNG_SIGNATURE) and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return h, w
    from PIL import Image
    with Image.open(path) as im:
        return im.height, im.width


def write_png(path: str, image: np.ndarray) -> None:
    """uint8 (H, W, 3) -> an 8-bit RGB PNG (no filter on any row, zlib
    level 6)."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes uint8 (H, W, 3), got "
                         f"{image.dtype} {image.shape}")
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(h, w * 3)],
                          axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


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


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


_JAX_KERNELS = {"bilinear": lambda x: torch.clamp(1.0 - x.abs(), min=0.0),
                "bicubic": _keys_cubic}


def _jax_weight_mat(in_size: int, out_size: int, method: str,
                    device) -> torch.Tensor:
    """(in, out) fp32 weights of one axis, computed as
    jax/_src/image/scale.py's ``compute_weight_mat`` computes them
    (antialiased, no translation): sample positions from the fp32 in/out,
    the kernel widened by it when downscaling, each column normalised."""
    inv_scale = torch.tensor(in_size / out_size, dtype=torch.float32,
                             device=device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32,
                                          device=device)[:, None]).abs()
    w = _JAX_KERNELS[method](x / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def resize_jax(x: torch.Tensor, size, method: str) -> torch.Tensor:
    """(N, C, H, W) float -> (N, C, *size), jax.image.resize with `method`
    "bilinear" or "bicubic": JAX's fp32 weights, the products summed in
    fp64 and rounded to x's dtype once."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(size):
        return x
    wh = _jax_weight_mat(h, size[0], method, x.device).double()
    ww = _jax_weight_mat(w, size[1], method, x.device).double()
    return torch.einsum("nchw,hH,wW->ncHW", x.double(), wh, ww).to(x.dtype)


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
