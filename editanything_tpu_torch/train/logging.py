"""Training observability: metric logging and sample-grid images.

Counterpart of ``editanything_tpu/train/logging.py`` (the reference logs
through Lightning and dumps DDIM grids with its ``ImageLogger``,
cldm/logger.py:11-76, rank 0 only). The main process is rank 0 of
``torch.distributed`` when it is initialised, and otherwise the only one.
Grids are PNGs written by ``utils/image.py::write_png``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from editanything_tpu_torch.utils import trace
from editanything_tpu_torch.utils.image import write_png


def is_main_process() -> bool:
    """Rank 0 of an initialised ``torch.distributed``, else True."""
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class MetricLogger:
    """JSONL metric stream + stdout, from the main process only."""

    def __init__(self, log_dir: str, *, every: int = 10,
                 is_main: Optional[bool] = None):
        self.is_main = is_main_process() if is_main is None else is_main
        self.every = every
        self.path = os.path.join(log_dir, "metrics.jsonl")
        if self.is_main:
            os.makedirs(log_dir, exist_ok=True)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict) -> None:
        if not self.is_main or step % self.every != 0:
            return
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            try:
                rec[k] = trace.host_read(v, "train.log", float)
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(" ".join(f"{k}={v}" for k, v in rec.items()), flush=True)


class ImageLogger:
    """Sample-grid dumps every N steps (cldm/logger.py:11-76: inputs,
    reconstructions and samples, each batch one PNG strip)."""

    def __init__(self, log_dir: str, *, every: int = 300, max_images: int = 4,
                 is_main: Optional[bool] = None):
        self.is_main = is_main_process() if is_main is None else is_main
        self.dir = os.path.join(log_dir, "images")
        self.every = every
        self.max_images = max_images
        if self.is_main:
            os.makedirs(self.dir, exist_ok=True)

    def maybe_log(self, step: int, images: Dict[str, np.ndarray]) -> bool:
        """images: name -> (B, H, W, 3) in [-1, 1] or [0, 1]."""
        if not self.is_main or step % self.every != 0:
            return False
        for name, batch in images.items():
            arr = np.asarray(batch)[:self.max_images]
            if arr.min() < -0.01:                    # [-1, 1] -> [0, 1]
                arr = (arr + 1.0) / 2.0
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(self.dir, f"{name}_{step:08d}.png"),
                      np.concatenate(list(arr), axis=1))   # a strip
        return True

