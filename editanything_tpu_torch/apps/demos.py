"""The semantic-label overlay of ``EditAnythingEditor.semantic``.

Counterpart of ``show_semantic_image_label`` and ``semantic_overlay`` in
``editanything_tpu/apps/demos.py`` (sam2semantic.py:100-146: random-colour
region fills and centred, wrapped labels, drawn with PIL where the
reference uses cv2). This is the port's only use of PIL, imported where the
text is drawn: without PIL the overlay raises ``ImportError``.
"""

from __future__ import annotations

import textwrap
from typing import List, Sequence, Tuple

import numpy as np
import torch

from editanything_tpu_torch.utils.image import resize_bilinear


def show_semantic_image_label(image_hw: Tuple[int, int],
                              regions: Sequence[Tuple[np.ndarray, str]],
                              seed: int = 0) -> np.ndarray:
    """[(mask (H, W) bool, label)] -> (H, W, 3) uint8 overlay: each region
    filled with a random colour, its label wrapped at 20 characters and
    centred on the region's mean pixel, in another random colour."""
    try:
        from PIL import Image, ImageDraw
    except ImportError as e:
        raise ImportError("the semantic overlay draws its labels with PIL "
                          "(Pillow), which is not installed") from e
    rng = np.random.RandomState(seed)
    h, w = image_hw
    full = np.zeros((h, w, 3), np.float32)
    for mask, _ in regions:
        full[np.asarray(mask) != 0] = rng.random(3)
    img = Image.fromarray((full * 255).astype(np.uint8))
    draw = ImageDraw.Draw(img)
    for mask, label in regions:
        ys, xs = np.nonzero(np.asarray(mask))
        if len(ys) == 0:
            continue
        cx, cy = int(xs.mean()), int(ys.mean())
        lines = textwrap.wrap(label, width=20)
        color = tuple(int(c) for c in rng.randint(0, 255, 3))
        spacing = 14
        y0 = cy - (len(lines) - 1) * spacing // 2
        for i, line in enumerate(lines):
            tw = draw.textlength(line)
            draw.text((cx - tw / 2, y0 + i * spacing - 6), line, fill=color)
    return np.asarray(img)


def semantic_overlay(image: np.ndarray, masks: np.ndarray,
                     valid: np.ndarray, labels: List[Tuple[int, str]], *,
                     mask_threshold: float = 0.0, seed: int = 0) -> np.ndarray:
    """Mask logits (N, h, w) and (index, label) pairs -> the overlay at the
    image's size, each valid labelled mask resized with jax.image.resize
    "bilinear" semantics and thresholded."""
    h, w = image.shape[:2]
    regions = []
    for idx, label in labels:
        if not valid[idx]:
            continue
        m = torch.from_numpy(np.asarray(masks[idx], np.float32))
        up = resize_bilinear(m[None, None], (h, w))[0, 0].numpy()
        regions.append((up > mask_threshold, label))
    return show_semantic_image_label((h, w), regions, seed=seed)
