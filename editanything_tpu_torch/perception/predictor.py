"""Interactive SAM predictor: one encoder pass per image, then point and box
prompts against the cached embedding.

Counterpart of ``editanything_tpu/perception/predictor.py``: prompts are
padded to ``MAX_POINTS`` slots with label -1 (box corners take labels 2 and
3), the decoder runs with the shared no-mask dense prompt (so its two-way
transformer is kernel D), and the 256^2 logits are upscaled as the official
postprocess does: to the padded input size, cropped, then to the original
size. The long side is resized to ``img_size`` with
``resize_uint8_bilinear`` (torch), where the JAX package uses PIL.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from editanything_tpu_torch.models import sam as SAM
from editanything_tpu_torch.perception.amg import upscale_masks

MAX_POINTS = 16     # fixed prompt slots, as in the JAX package


class SamPredictor:
    """Caches one image's embedding; ``predict`` decodes prompts against it."""

    def __init__(self, sam: SAM.Sam, cfg: SAM.SAMConfig):
        self.sam = sam
        self.cfg = cfg
        self._embedding = None
        self._input_hw: Optional[Tuple[int, int]] = None
        self._orig_hw: Optional[Tuple[int, int]] = None

    @property
    def device(self) -> torch.device:
        return self.sam.mask_decoder.iou_token.weight.device

    @torch.inference_mode()
    def set_image(self, image: np.ndarray):
        """image: (H, W, 3) uint8. Resizes the long side to img_size, pads,
        encodes once."""
        self._orig_hw = image.shape[:2]
        x, self._input_hw = SAM.prepare_image(image, self.cfg, self.device)
        dtype = self.sam.mask_decoder.iou_token.weight.dtype
        self._embedding = self.sam.image_encoder(x.to(dtype))

    def _transform_points(self, coords):
        h, w = self._orig_hw
        nh, nw = self._input_hw
        return coords.astype(np.float32) * np.array([nw / w, nh / h],
                                                    np.float32)

    @torch.inference_mode()
    def predict(self, point_coords=None, point_labels=None, box=None,
                multimask_output: bool = True):
        """Returns (masks (K, H, W) bool, iou (K,), logits (K, H, W)) as
        numpy arrays at the original image size."""
        if self._embedding is None:
            raise RuntimeError("call set_image first")
        coords = np.zeros((MAX_POINTS, 2), np.float32)
        labels = np.full((MAX_POINTS,), -1, np.int64)
        n = 0
        if point_coords is not None:
            pts = self._transform_points(np.asarray(point_coords))
            coords[:len(pts)] = pts
            labels[:len(pts)] = np.asarray(point_labels, np.int64)
            n += len(pts)
        if box is not None:
            coords[n:n + 2] = self._transform_points(
                np.asarray(box, np.float32).reshape(2, 2))
            labels[n:n + 2] = (2, 3)
        dev = self.device
        pe_mod, dec = self.sam.prompt_encoder, self.sam.mask_decoder
        sparse = pe_mod.encode_points(torch.from_numpy(coords).to(dev)[None],
                                      torch.from_numpy(labels).to(dev)[None])
        dense = pe_mod.no_mask_dense_embedding(1)
        masks, iou = dec(self._embedding, pe_mod.dense_positional_encoding(),
                         sparse, dense)
        sl = slice(1, 4) if multimask_output else slice(0, 1)
        up = self._upscale(masks[0, sl]).cpu().numpy()
        return up > 0.0, iou[0, sl].float().cpu().numpy(), up

    def _upscale(self, lowres):
        """(K, 256, 256) logits -> (K, H_orig, W_orig) fp32: resize to the
        padded img_size, crop the unpadded region, resize to the original."""
        s = self.cfg.img_size
        nh, nw = self._input_hw
        up = upscale_masks(lowres, (s, s))[:, :nh, :nw]
        return upscale_masks(up, self._orig_hw)
