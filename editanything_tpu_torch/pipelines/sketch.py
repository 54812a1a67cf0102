"""Sketch -> image: each sketch colour becomes a region of the SAM-style
condition map.

Counterpart of ``editanything_tpu/pipelines/sketch.py``: every non-white
colour of the sketch becomes region id 1..K of a uint16 ID map, encoded
R = id % 256, G = id // 256; white is background, where the per-pixel
scale map is 0 so the ControlNet exerts no force (the reference's
sketch2image.py:93-111). The palette is given or taken from the sketch's
frequent colours, near-duplicates merged. These are host-side numpy ops;
the image comes from ``GenerationPipeline`` with the scale map.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from editanything_tpu_torch.pipelines.generate import GenerationPipeline


def sketch_condition(image: np.ndarray,
                     colors: Optional[Sequence[Tuple[int, int, int]]] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """RGB sketch -> (condition map uint8 (H, W, 3), scale map float32
    (H, W)). `colors`: the palette in region order (non-white entries get
    ids 1..K); default ``high_freq_colors`` of the sketch. White pixels get
    scale 0."""
    arr = np.asarray(image, np.uint8)
    h, w = arr.shape[:2]
    if colors is None:
        colors = high_freq_colors(arr)
    id_map = np.zeros((h, w), np.uint16)
    ptr = 0
    for r, g, b in colors:
        if (r, g, b) == (255, 255, 255):
            continue
        ptr += 1
        id_map[np.all(arr == np.array([r, g, b], np.uint8), axis=-1)] = ptr
    scale_map = (~np.all(arr == 255, axis=-1)).astype(np.float32)
    cond = np.zeros((h, w, 3), np.uint8)
    cond[..., 0] = (id_map % 256).astype(np.uint8)
    cond[..., 1] = (id_map // 256).astype(np.uint8)
    return cond, scale_map


def color_distance(c1, c2) -> float:
    return float(sum((a - b) ** 2 for a, b in zip(c1, c2)) ** 0.5)


def opaque_color_on_white(color, a: float):
    """`color` at alpha `a` composited on white."""
    return tuple(int((1 - a) * 255 + a * c) for c in color)


def high_freq_colors(arr: np.ndarray,
                     similarity_threshold: float = 30.0
                     ) -> List[Tuple[int, int, int]]:
    """The sketch's frequent colours (more than max(2, 1.25 x the mean
    count) pixels), most frequent first, each dropped where a more frequent
    one lies within `similarity_threshold` of it or of its half-alpha
    shade on white."""
    flat = arr.reshape(-1, 3)
    uniq, counts = np.unique(flat, axis=0, return_counts=True)
    order = np.argsort(-counts)
    uniq, counts = uniq[order], counts[order]
    keep = counts > max(2, counts.mean() * 1.25)
    cands = [tuple(int(v) for v in c) for c in uniq[keep]]
    freqs = list(counts[keep])
    merged: List[Tuple[int, int, int]] = []
    for i, c in enumerate(cands):
        dominated = any(
            (color_distance(c, other) < similarity_threshold
             or color_distance(c, opaque_color_on_white(other, 0.5)) < 5)
            and freqs[j] > freqs[i]
            for j, other in enumerate(cands) if j != i)
        if not dominated:
            merged.append(c)
    return merged


def quantize_to_palette(arr: np.ndarray,
                        palette: Sequence[Tuple[int, int, int]]) -> np.ndarray:
    """Pixels whose colour is not in `palette` become white."""
    out = np.full_like(arr, 255)
    pal = np.array(list(palette), np.uint8)
    mask = np.any(np.all(arr[:, :, None, :] == pal[None, None], axis=-1),
                  axis=-1)
    out[mask] = arr[mask]
    return out


class SketchPipeline:
    """Sketch -> condition map and scale map -> ``GenerationPipeline``."""

    def __init__(self, bundle, controlnet: str = "sam"):
        self.gen = GenerationPipeline(bundle, controlnet=controlnet)

    def __call__(self, *, sketch: np.ndarray, prompt: str,
                 colors: Optional[Sequence[Tuple[int, int, int]]] = None,
                 use_scale_map: bool = True, control_scale: float = 1.0,
                 **kwargs) -> np.ndarray:
        """(num_samples, H, W, 3) uint8; `kwargs` go to
        ``GenerationPipeline.__call__`` (``noise``/``generator`` among
        them)."""
        cond, scale_map = sketch_condition(sketch, colors)
        return self.gen(prompt=prompt, condition_image=cond,
                        control_scale=control_scale,
                        scale_map=scale_map if use_scale_map else None,
                        **kwargs)
