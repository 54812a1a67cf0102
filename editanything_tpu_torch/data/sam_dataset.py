"""The SA-1B ControlNet training dataset, on the host in numpy.

Counterpart of ``editanything_tpu/data/sam_dataset.py`` (the reference's
utils/sam_dataset.py): ``data.txt`` lines are Python dict literals
{'target': image, 'source': SA-1B json, 'prompt': str}; every mask's COCO
RLE is painted id = i + 1 into a uint16 map by the native codec
(ops/rle.py) and encoded R = id % 256, G = id // 256; the paired
augmentation is RandomResizedCrop(512, scale (0.9, 1)), BILINEAR for the
image and NEAREST for the hint, then a horizontal flip with p 0.5; the
image is normalised to [-1, 1], the hint left in [0, 1].

The draws come from ``np.random.RandomState`` in the JAX package's order,
so the same files and seed give the same crops, flips and batch order.
Images are read by ``utils/image.py::read_image`` (PNGs without PIL) and
resized by ``resize_pil``, equal to PIL's BILINEAR and NEAREST.
"""

from __future__ import annotations

import ast
import json
import os
import queue
import threading
from typing import Dict, Iterator, List

import numpy as np

from editanything_tpu_torch.ops import rle as rle_codec
from editanything_tpu_torch.utils.image import read_image, resize_pil


def _random_resized_crop_params(rng: np.random.RandomState, h: int, w: int,
                                scale=(0.9, 1.0),
                                ratio=(3. / 4., 4. / 3.)):
    """torchvision ``RandomResizedCrop.get_params``: (top, left, ch, cw)."""
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            top = rng.randint(0, h - ch + 1)
            left = rng.randint(0, w - cw + 1)
            return top, left, ch, cw
    # fallback: a centre crop at the clamped aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    return (h - ch) // 2, (w - cw) // 2, ch, cw


class SAMDataset:
    """Indexable dataset of (image, caption, SAM ID-map hint) samples."""

    def __init__(self, data_path: str, txt_path: str, *,
                 resolution: int = 512, scale=(0.9, 1.0),
                 hflip_p: float = 0.5, seed: int = 0):
        self.data: List[Dict] = []
        with open(txt_path, "rt") as f:
            for line in f:
                line = line.strip()
                if line:
                    self.data.append(ast.literal_eval(line))
        self.data_path = data_path
        self.resolution = resolution
        self.scale = scale
        self.hflip_p = hflip_p
        self._rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.data)

    def load_hint(self, json_path: str) -> np.ndarray:
        """Annotation json -> (H, W, 3) uint8 R/G-encoded ID map."""
        with open(json_path, "r", encoding="utf-8") as f:
            anno = json.load(f)
        h = int(anno["image"]["height"])
        w = int(anno["image"]["width"])
        idm = rle_codec.id_map([a["segmentation"] for a in anno["annotations"]],
                               h, w)
        out = np.zeros((h, w, 3), np.uint8)
        out[..., 0] = (idm % 256).astype(np.uint8)
        out[..., 1] = (idm // 256).astype(np.uint8)
        return out

    def __getitem__(self, idx: int) -> Dict:
        item = self.data[idx]
        target = read_image(os.path.join(self.data_path, item["target"]))
        hint = self.load_hint(os.path.join(self.data_path, item["source"]))
        h, w = target.shape[:2]
        top, left, ch, cw = _random_resized_crop_params(
            self._rng, h, w, scale=self.scale)
        r = self.resolution
        img = resize_pil(target[top:top + ch, left:left + cw], (r, r),
                         "bilinear").astype(np.float32)
        hnt = resize_pil(hint[top:top + ch, left:left + cw], (r, r),
                         "nearest").astype(np.float32)
        if self._rng.rand() < self.hflip_p:
            img, hnt = img[:, ::-1], hnt[:, ::-1]
        return dict(jpg=(img / 255.0 * 2.0 - 1.0).astype(np.float32),
                    txt=item["prompt"], hint=(hnt / 255.0).astype(np.float32))


def make_batcher(dataset: SAMDataset, *, batch_size: int,
                 num_workers: int = 8, prefetch: int = 4,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True) -> Iterator[Dict]:
    """One epoch of batches dict(jpg=(B, H, W, 3) f32, txt=list[str],
    hint=(B, H, W, 3) f32), prefetched by a pool of threads; batch i holds
    the samples of ``order[i * B:(i + 1) * B]`` with the order shuffled by
    ``RandomState(seed)``. The threads share the dataset's generator, so
    with more than one worker the crops follow the order in which the
    workers reach it, as in the JAX package."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    n_batches = (len(order) // batch_size if drop_last
                 else -(-len(order) // batch_size))

    def gen():
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        sentinel = object()

        def worker(batch_ids_list):
            for ids in batch_ids_list:
                samples = [dataset[int(i)] for i in ids]
                q.put({"jpg": np.stack([s["jpg"] for s in samples]),
                       "txt": [s["txt"] for s in samples],
                       "hint": np.stack([s["hint"] for s in samples])})
            q.put(sentinel)

        batches = [order[i * batch_size:(i + 1) * batch_size]
                   for i in range(n_batches)]
        shards = [batches[i::num_workers] for i in range(num_workers)]
        threads = [threading.Thread(target=worker, args=(s,), daemon=True)
                   for s in shards if s]
        for t in threads:
            t.start()
        finished = 0
        while finished < len(threads):
            item = q.get()
            if item is sentinel:
                finished += 1
            else:
                yield item

    return gen()
