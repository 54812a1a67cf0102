"""A folder of images for the finetune trainers, on the host in numpy.

Counterpart of ``editanything_tpu/data/image_folder.py`` (the reference's
TextualInversionDataset and DreamBoothDataset): a flat directory of images,
optionally centre-cropped to a square, resized to `resolution` (BICUBIC,
``utils/image.py::resize_pil``, equal to PIL's), flipped at random and
normalised to [-1, 1]. The draws come from ``np.random.RandomState`` in the
JAX package's order, so the same folder and seed give the same batches.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from editanything_tpu_torch.utils.image import read_image, resize_pil

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def list_images(directory: str) -> List[str]:
    return sorted(os.path.join(directory, n) for n in os.listdir(directory)
                  if n.lower().endswith(IMAGE_EXTS))


class ImageFolder:
    """Indexable folder of images -> (resolution, resolution, 3) float32
    arrays in [-1, 1] with the reference's crop and flip augmentation."""

    def __init__(self, directory: str, *, resolution: int = 512,
                 center_crop: bool = False, flip_p: float = 0.5,
                 seed: int = 0):
        self.paths = list_images(directory)
        if not self.paths:
            raise FileNotFoundError(f"no images in {directory}")
        self.resolution = resolution
        self.center_crop = center_crop
        self.flip_p = flip_p
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        arr = read_image(self.paths[idx % len(self.paths)])
        if self.center_crop:
            h, w = arr.shape[:2]
            c = min(h, w)
            arr = arr[(h - c) // 2:(h + c) // 2, (w - c) // 2:(w + c) // 2]
        r = self.resolution
        arr = resize_pil(arr, (r, r), "bicubic").astype(np.float32)
        if self._rng.uniform() < self.flip_p:
            arr = arr[:, ::-1]
        return arr / 127.5 - 1.0

    def sample_batch(self, batch_size: int) -> np.ndarray:
        """(B, R, R, 3) float32 in [-1, 1], images drawn with replacement."""
        idx = self._rng.randint(0, len(self.paths), size=batch_size)
        return np.stack([self[i] for i in idx])
