"""The benchmark's inputs, made from the seed: a word-level CLIP
tokenizer, photo-like images, brush masks, and an SA-1B-layout folder
(PNG images, annotation JSONs with COCO compressed-RLE masks, data.txt).

Everything here is the benchmark's own: the program receives only what
these functions make, and the reference reads the same.
"""

from __future__ import annotations

import json
import os
import re
import struct
from concurrent.futures import ThreadPoolExecutor
import zlib

import numpy as np
import torch
import torch.nn.functional as F

BOS, EOS = 49406, 49407


class WordTokenizer:
    """Token ids of a prompt: each lower-cased word or punctuation mark an
    id in [1, 49000) from its CRC-32, between CLIP's BOS and EOS, padded
    with EOS. The interface is the one the port's pipelines and trainer
    call (``context_length``, ``bos_id``, ``eos_id``, ``encode``,
    ``__call__``)."""

    bos_id, eos_id = BOS, EOS

    def __init__(self, context_length: int = 77):
        self.context_length = context_length

    def encode(self, text: str):
        words = re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text.lower())
        return [1 + zlib.crc32(w.encode()) % 48999 for w in words]

    def __call__(self, texts, *, pad_to=None, truncate: bool = False):
        if isinstance(texts, str):
            texts = [texts]
        rows = [self.encode(t) for t in texts]
        if truncate:
            rows = [r[:(pad_to or self.context_length) - 2] for r in rows]
        length = pad_to or max(len(r) for r in rows) + 2
        out = np.full((len(rows), length), EOS, np.int32)
        for i, r in enumerate(rows):
            row = [BOS] + r[:length - 2] + [EOS]
            out[i, :len(row)] = row
        return out

    def windows(self, prompt: str, negative: str = ""):
        """(cond, uncond) id grids (W, 77), as the pipelines tokenize a
        prompt pair: BOS, ids, EOS, padded with EOS to a shared number W of
        77-token windows."""
        c = self.context_length
        p = [BOS] + self.encode(prompt) + [EOS]
        n = [BOS] + self.encode(negative) + [EOS]
        w = max(1, -(-max(len(p), len(n)) // c))

        def grid(ids):
            a = np.full(w * c, EOS, np.int64)
            a[:min(len(ids), w * c)] = ids[:w * c]
            return a.reshape(w, c)
        return grid(p), grid(n)


def photo(g: torch.Generator, h: int, w: int) -> np.ndarray:
    """A photo-like uint8 (h, w, 3) image drawn on `g`'s device: smooth
    colour regions at two scales, the edges between them, and sensor
    noise."""
    dev = g.device
    out = torch.full((1, 3, h, w), 128.0, device=dev)
    for cell, amp in ((max(h, w) // 6, 150.0), (max(h, w) // 40, 60.0)):
        grid = torch.rand((1, 3, -(-h // cell) + 1, -(-w // cell) + 1),
                          generator=g, device=dev) * 2 - 1
        out += amp * F.interpolate(grid, size=(h, w), mode="bilinear",
                                   align_corners=False)
    out += 6.0 * torch.randn((1, 3, h, w), generator=g, device=dev)
    return out.clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0).cpu().numpy()


def brush_mask(rng: np.random.Generator, h: int, w: int, lo: float,
               hi: float) -> np.ndarray:
    """A brush mask covering a share drawn from [lo, hi) of the image: a
    union of ellipses. uint8 (h, w) in {0, 255}."""
    target = rng.uniform(lo, hi)
    yy, xx = np.ogrid[0:h, 0:w]
    m = np.zeros((h, w), bool)
    while m.mean() < target:
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(0.08, 0.3) * h, rng.uniform(0.08, 0.3) * w
        m |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
    return (m * 255).astype(np.uint8)


def png_bytes(img: np.ndarray, level: int = 1) -> bytes:
    """An 8-bit RGB PNG of a uint8 (h, w, 3) image (filter 0 rows)."""
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind, data):
        body = kind + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def rle_counts_string(counts) -> str:
    """COCO's compressed form (pycocotools' ``rleToString``) of run
    lengths."""
    chars = []
    for i, x in enumerate(counts):
        x = int(x) - (int(counts[i - 2]) if i > 2 else 0)
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            chars.append(chr(c + 48))
    return "".join(chars)


def convex_rle(h: int, w: int, y0: np.ndarray, y1: np.ndarray) -> str:
    """COCO compressed RLE of a mask that holds rows [y0[x], y1[x]) of
    each column x (a convex shape), without painting it."""
    x = np.nonzero(y1 > y0)[0]
    if len(x) == 0:
        return rle_counts_string([h * w])
    starts, ends = x * h + y0[x], x * h + y1[x]
    # a run that ends at a column's foot and goes on at the next's head
    join = ends[:-1] == starts[1:]
    bounds = np.stack([starts, ends], 1).reshape(-1)
    keep = np.ones(len(bounds), bool)
    keep[1:-1:2][join] = False
    keep[2::2][join] = False
    counts = np.diff(np.concatenate([[0], bounds[keep], [h * w]]))
    return rle_counts_string(counts.tolist())


def shape_rle(rng: np.random.Generator, h: int, w: int, ellipse: bool):
    """A random ellipse or rectangle's COCO compressed RLE."""
    cy, cx = rng.uniform(0, h), rng.uniform(0, w)
    ry, rx = rng.uniform(0.02, 0.25) * h, rng.uniform(0.02, 0.25) * w
    xs = np.arange(w)
    u = (xs - cx) / rx
    inside = np.abs(u) <= 1.0
    dy = ry * np.sqrt(np.clip(1.0 - u * u, 0.0, 1.0)) if ellipse else \
        np.full(w, ry)
    y0 = np.clip(np.ceil(cy - dy), 0, h).astype(np.int64)
    y1 = np.clip(np.floor(cy + dy) + 1, 0, h).astype(np.int64)
    y1 = np.where(inside, y1, y0)
    return convex_rle(h, w, y0, y1)


def sa1b_folder(root: str, g: torch.Generator, rng: np.random.Generator, *,
                images: int, hw, masks: int, prompts, samples: int) -> str:
    """An SA-1B-layout folder under `root`: PNG images of size `hw` drawn
    on `g`'s device, each with `masks` RLE masks (ellipses and rectangles,
    overlapping), and data.txt of `samples` dict literals over them in
    turn (each sample is decoded from its files, so an epoch is as long as
    a large dataset's while little is written). Returns data.txt's
    path."""
    os.makedirs(root, exist_ok=True)
    h, w = hw
    pics = [photo(g, h, w) for _ in range(images)]
    with ThreadPoolExecutor(min(8, images)) as pool:
        blobs = list(pool.map(png_bytes, pics))
    for i, blob in enumerate(blobs):
        with open(os.path.join(root, f"sa_{i}.png"), "wb") as f:
            f.write(blob)
        anns = [{"segmentation": {"size": [h, w], "counts": shape_rle(
            rng, h, w, j % 2 == 1)}} for j in range(masks)]
        with open(os.path.join(root, f"sa_{i}.json"), "w") as f:
            json.dump({"image": {"height": h, "width": w},
                       "annotations": anns}, f)
    lines = [repr({"target": f"sa_{j % images}.png",
                   "source": f"sa_{j % images}.json",
                   "prompt": prompts[j % len(prompts)]})
             for j in range(samples)]
    path = os.path.join(root, "data.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
