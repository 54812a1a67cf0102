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
so the same files and seed give the same crops, flips and batch order;
``make_batcher`` makes them before its threads decode, so the batches do
not depend on the number of threads.
Images are read by ``utils/image.py::read_image`` (PNGs without PIL) and
resized by ``resize_pil``, equal to PIL's BILINEAR and NEAREST.
"""

from __future__ import annotations

import ast
import collections
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np

from editanything_tpu_torch.ops import rle as rle_codec
from editanything_tpu_torch.utils.image import (image_size, read_image,
                                               resize_pil)


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

    def image_size(self, idx: int):
        """(height, width) of sample `idx`'s image, from its header."""
        return image_size(os.path.join(self.data_path,
                                       self.data[idx]["target"]))

    def draw(self, h: int, w: int):
        """The crop (top, left, height, width) and the flip of one sample
        of an (h, w) image, drawn from the dataset's generator as the JAX
        package draws them."""
        crop = _random_resized_crop_params(self._rng, h, w, scale=self.scale)
        return crop, self._rng.rand() < self.hflip_p

    def load(self, idx: int, crop, flip: bool) -> Dict:
        """Sample `idx` decoded and augmented by the given draws; draws
        nothing, so threads may call it in any order."""
        item = self.data[idx]
        target = read_image(os.path.join(self.data_path, item["target"]))
        hint = self.load_hint(os.path.join(self.data_path, item["source"]))
        top, left, ch, cw = crop
        r = self.resolution
        img = resize_pil(target[top:top + ch, left:left + cw], (r, r),
                         "bilinear").astype(np.float32)
        hnt = resize_pil(hint[top:top + ch, left:left + cw], (r, r),
                         "nearest").astype(np.float32)
        if flip:
            img, hnt = img[:, ::-1], hnt[:, ::-1]
        return dict(jpg=(img / 255.0 * 2.0 - 1.0).astype(np.float32),
                    txt=item["prompt"], hint=(hnt / 255.0).astype(np.float32))

    def __getitem__(self, idx: int) -> Dict:
        return self.load(idx, *self.draw(*self.image_size(idx)))


def make_batcher(dataset: SAMDataset, *, batch_size: int,
                 num_workers: int = 8, prefetch: int = 4,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, part=(0, 1)) -> Iterator[Dict]:
    """One epoch of batches dict(jpg=(B, H, W, 3) f32, txt=list[str],
    hint=(B, H, W, 3) f32); batch i holds the samples of
    ``order[i * B:(i + 1) * B]`` with the order shuffled by
    ``RandomState(seed)``. Every sample's crop and flip are drawn here, in
    that order (its image's size read from the header), and a pool of
    `num_workers` threads then decodes up to `prefetch` batches ahead, so
    the batches are the same for any number of workers: the JAX package's
    with one worker (its threads share the generator, so with more its
    crops follow the threads' timing).

    part = (k, n): yield only the k-th of n contiguous slices of each batch
    (a data-parallel rank's share, as ``parallel.sharding.shard_batch``
    slices a tensor); the draws are made for the whole batch, so the n
    parts together are the batch that (0, 1) yields."""
    k, n = part
    if batch_size % n:
        raise ValueError(f"a batch of {batch_size} does not divide over "
                         f"{n} parts")
    order = np.arange(len(dataset))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    n_batches = (len(order) // batch_size if drop_last
                 else -(-len(order) // batch_size))

    def stack(futures) -> Dict:
        samples = [f.result() for f in futures]
        return {"jpg": np.stack([s["jpg"] for s in samples]),
                "txt": [s["txt"] for s in samples],
                "hint": np.stack([s["hint"] for s in samples])}

    def gen():
        pool = ThreadPoolExecutor(num_workers)
        pending: collections.deque = collections.deque()
        try:
            for i in range(n_batches):
                ids = [int(j) for j in order[i * batch_size:
                                             (i + 1) * batch_size]]
                draws = [dataset.draw(*dataset.image_size(j)) for j in ids]
                if len(ids) % n:
                    raise ValueError(f"a batch of {len(ids)} does not "
                                     f"divide over {n} parts")
                per = len(ids) // n
                mine = list(zip(ids, draws))[k * per:(k + 1) * per]
                pending.append([pool.submit(dataset.load, j, *d)
                                for j, d in mine])
                if len(pending) > prefetch:
                    yield stack(pending.popleft())
            while pending:
                yield stack(pending.popleft())
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    return gen()
