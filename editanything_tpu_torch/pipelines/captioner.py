"""BLIP-2 auto captions and region-level semantic labels.

Counterpart of ``editanything_tpu/pipelines/captioner.py``:
- auto prompt: the reference's ``get_blip2_text`` (editany_lora.py:512-520,
  ``generate(max_new_tokens=50)``, stripped), put before the user's prompt
  by ``EditAnythingEditor.process``;
- region labels (sam2semantic.py:60-146): SAM masks ranked by area, each
  region's padded bounding box cropped, every crop resized to the vision
  input and captioned in ONE captioner call (the reference loops BLIP-2 per
  region).

``preprocess`` resizes as ``jax.image.resize(..., "bicubic")`` does and
normalises with CLIP's constants; ``semantic_labels`` resizes each crop as
its "bilinear" does and casts to uint8 by truncation, as the JAX package's
``.astype(np.uint8)`` does; both through ``utils/image.py::resize_jax``,
JAX's own weights. No PIL.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from editanything_tpu_torch.models import blip2 as B
from editanything_tpu_torch.utils.image import resize_jax

# CLIP's normalisation, as BLIP-2's vision tower takes it
_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess(images_uint8: np.ndarray, image_size: int,
               device="cpu") -> torch.Tensor:
    """(B, H, W, 3) uint8 -> normalised (B, 3, S, S) fp32 on `device`."""
    x = torch.as_tensor(np.ascontiguousarray(images_uint8), device=device)
    x = x.permute(0, 3, 1, 2).float() / 255.0
    x = resize_jax(x, (image_size, image_size), "bicubic")
    mean = torch.tensor(_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(_STD, device=x.device)[None, :, None, None]
    return (x - mean) / std


class Captioner:
    """Greedy BLIP-2 captioner over a ``models.blip2.BLIP2`` on its device
    and in its dtype."""

    def __init__(self, model: B.BLIP2, tokenizer, *, prompt: str = "",
                 max_new_tokens: int = 50):
        self.model = model
        self.cfg = model.cfg
        self.tokenizer = tokenizer
        self.max_new_tokens = max_new_tokens
        self.prompt_ids = ([tokenizer.bos_id] + tokenizer.encode(prompt)
                           if prompt else [tokenizer.bos_id])

    @torch.inference_mode()
    def tokens(self, images_uint8: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, max_new_tokens) token ids."""
        w = self.model.language_projection.weight
        px = preprocess(images_uint8, self.cfg.image_size, w.device)
        prompt = torch.tensor(self.prompt_ids, device=w.device)[None].expand(
            px.shape[0], -1)
        return B.caption(self.model, px.to(w.dtype), prompt,
                         max_new_tokens=self.max_new_tokens).cpu().numpy()

    def __call__(self, images_uint8: np.ndarray) -> List[str]:
        """(B, H, W, 3) uint8 -> one caption string per image: the tokens
        before eos decoded and stripped."""
        return [self.tokenizer.decode(row[row != self.cfg.eos_token_id]).strip()
                for row in self.tokens(images_uint8)]


def rank_and_crop_regions(image_uint8: np.ndarray, masks: np.ndarray,
                          valid: np.ndarray, areas: np.ndarray, *,
                          top_k: int = 10, pad: int = 8
                          ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Masks ranked by area (largest first, invalid ones last), the padded
    bounding box of each of the top_k valid non-empty ones cropped
    (sam2semantic.py:73-98). Returns (mask indices, crops)."""
    order = np.argsort(-np.where(np.asarray(valid), np.asarray(areas), -1))
    h, w = image_uint8.shape[:2]
    idxs, crops = [], []
    for i in order[:top_k]:
        if not valid[i]:
            break
        ys, xs = np.nonzero(np.asarray(masks[i]))
        if len(ys) == 0:
            continue
        y0, y1 = max(ys.min() - pad, 0), min(ys.max() + pad + 1, h)
        x0, x1 = max(xs.min() - pad, 0), min(xs.max() + pad + 1, w)
        idxs.append(int(i))
        crops.append(image_uint8[y0:y1, x0:x1])
    return np.asarray(idxs), crops


def resize_crop(crop: np.ndarray, size: int) -> np.ndarray:
    """uint8 (h, w, 3) -> float32 (size, size, 3), jax.image.resize
    "bilinear"."""
    x = torch.from_numpy(np.ascontiguousarray(crop)).float()
    return resize_jax(x.permute(2, 0, 1)[None], (size, size), "bilinear")[0] \
        .permute(1, 2, 0).numpy()


def semantic_labels(image_uint8: np.ndarray, masks: np.ndarray,
                    valid: np.ndarray, areas: np.ndarray,
                    captioner: Captioner, *, top_k: int = 10
                    ) -> List[Tuple[int, str]]:
    """(mask index, label) for the top_k largest regions, every crop in one
    captioner call."""
    idxs, crops = rank_and_crop_regions(image_uint8, masks, valid, areas,
                                        top_k=top_k)
    if len(crops) == 0:
        return []
    s = captioner.cfg.image_size
    batch = np.stack([resize_crop(c, s) for c in crops]).astype(np.uint8)
    return list(zip(idxs.tolist(), captioner(batch)))
