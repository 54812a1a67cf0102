"""The port's training data against the JAX package's: the RLE codec
(native, its numpy twin and the JAX package's codec), ``read_image``
against PIL, PIL's NEAREST and BICUBIC in numpy, ``SAMDataset`` and
``make_batcher``, and ``ImageFolder``. Everything here is exact: the same
files and seed give the same bytes, crops, flips and batch order.
"""

import json
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from editanything_tpu.data import image_folder as JIF
from editanything_tpu.data import sam_dataset as JSD
from editanything_tpu.ops import rle as JR
from editanything_tpu_torch.data import image_folder as TIF
from editanything_tpu_torch.data import sam_dataset as TSD
from editanything_tpu_torch.ops import rle as TR
from editanything_tpu_torch.utils.image import read_image, resize_pil, write_png


def _masks(seed, n=6, h=37, w=53):
    rng = np.random.RandomState(seed)
    out = [rng.rand(h, w) > 0.5,                      # fragmented
           np.ones((h, w), bool), np.zeros((h, w), bool)]
    for _ in range(n - 3):
        m = np.zeros((h, w), bool)
        y, x = rng.randint(0, h - 5), rng.randint(0, w - 5)
        m[y:y + rng.randint(3, h), x:x + rng.randint(3, w)] = True
        out.append(m)
    return out


def test_rle_native_numpy_and_jax_agree():
    masks = _masks(0)
    for m in masks:
        want = JR.encode_numpy(m.astype(np.uint8))
        assert TR.encode(m.astype(np.uint8)) == want
        assert TR.encode_numpy(m) == want
        assert JR.encode(m.astype(np.uint8)) == want
        for dec in (TR.decode, TR.decode_numpy):
            np.testing.assert_array_equal(dec(want), m.astype(np.uint8))
        # bytes counts, as json loaders may give them
        np.testing.assert_array_equal(
            TR.decode({"size": want["size"],
                       "counts": want["counts"].encode()}), m.astype(np.uint8))


def test_rle_id_map_paints_later_masks_over_earlier():
    masks = _masks(1, n=8)
    rles = [TR.encode(m.astype(np.uint8)) for m in masks]
    got = TR.id_map(rles, 37, 53)
    np.testing.assert_array_equal(got, TR.id_map_numpy(rles, 37, 53))
    np.testing.assert_array_equal(got, JR.id_map(rles, 37, 53))
    want = np.zeros((37, 53), np.uint16)
    for i, m in enumerate(masks):
        want[m] = i + 1
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint16
    with pytest.raises(ValueError):
        TR.decode({"size": [4, 4], "counts": "\x7f"})


def _filtered_png(path, img, kinds):
    """An 8-bit PNG of `img` (H, W, C) whose row y is filtered with
    kinds[y % len(kinds)] (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w, c = img.shape
    x = img.astype(np.int64).reshape(h, w * c)
    rows = []
    for y in range(h):
        k = kinds[y % len(kinds)]
        prev = x[y - 1] if y else np.zeros(w * c, np.int64)
        left = np.concatenate([np.zeros(c, np.int64), x[y, :-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        p = left + prev - upleft
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) // 2, paeth][k]
        rows.append(bytes([k]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes())
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(rows))))
        f.write(chunk(b"IEND", b""))


def _pil_rgb(path):
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_read_image_matches_pil(tmp_path, channels):
    rng = np.random.RandomState(channels)
    yy, xx = np.mgrid[0:29, 0:41]
    img = rng.randint(0, 256, (29, 41, channels)).astype(np.uint8)
    img[..., 0] = (3 * xx + 5 * yy) % 256     # smooth rows favour prediction
    mode = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}[channels]
    Image.fromarray(img[..., 0] if channels == 1 else img, mode).save(
        tmp_path / "pil.png")
    np.testing.assert_array_equal(read_image(str(tmp_path / "pil.png")),
                                  _pil_rgb(tmp_path / "pil.png"))
    for kinds in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        path = tmp_path / f"f{''.join(map(str, kinds))}.png"
        _filtered_png(path, img, kinds)
        np.testing.assert_array_equal(read_image(str(path)), _pil_rgb(path))


def test_read_image_other_formats_need_pil(tmp_path, monkeypatch):
    img = np.random.RandomState(0).randint(0, 256, (16, 24, 3)).astype(np.uint8)
    write_png(str(tmp_path / "own.png"), img)
    np.testing.assert_array_equal(read_image(str(tmp_path / "own.png")), img)
    Image.fromarray(img).save(tmp_path / "a.jpg")
    np.testing.assert_array_equal(read_image(str(tmp_path / "a.jpg")),
                                  _pil_rgb(tmp_path / "a.jpg"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(read_image(str(tmp_path / "own.png")), img)
    with pytest.raises(ImportError, match="a.jpg"):
        read_image(str(tmp_path / "a.jpg"))


def test_resize_nearest_and_bicubic_match_pil():
    rng = np.random.RandomState(0)
    for _ in range(40):
        h0, w0, h, w = rng.randint(1, 200, 4)
        x = rng.randint(0, 256, (h0, w0, 3)).astype(np.uint8)
        for filt, pil in (("nearest", Image.NEAREST),
                          ("bicubic", Image.BICUBIC)):
            np.testing.assert_array_equal(
                resize_pil(x, (h, w), filt),
                np.asarray(Image.fromarray(x).resize((w, h), pil)))


@pytest.fixture()
def sa1b(tmp_path):
    """PNG targets of two sizes, SA-1B JSONs, data.txt."""
    rng = np.random.RandomState(0)
    lines = []
    for i in range(5):
        h, w = (80, 96) if i % 2 else (70, 50)
        write_png(str(tmp_path / f"im{i}.png"),
                  rng.randint(0, 255, (h, w, 3)).astype(np.uint8))
        masks = []
        for _ in range(4):
            m = np.zeros((h, w), np.uint8)
            y, x = rng.randint(0, h - 20), rng.randint(0, w - 20)
            m[y:y + 20, x:x + 25] = 1
            masks.append({"segmentation": TR.encode(m)})
        (tmp_path / f"im{i}.json").write_text(json.dumps(
            {"image": {"height": h, "width": w}, "annotations": masks}))
        lines.append(repr({"target": f"im{i}.png", "source": f"im{i}.json",
                           "prompt": f"a photo {i}"}))
    (tmp_path / "data.txt").write_text("\n".join(lines) + "\n")
    return tmp_path


def test_sam_dataset_matches_jax(sa1b):
    kw = dict(resolution=64, seed=3)
    jds = JSD.SAMDataset(str(sa1b), str(sa1b / "data.txt"), **kw)
    tds = TSD.SAMDataset(str(sa1b), str(sa1b / "data.txt"), **kw)
    assert len(tds) == len(jds) == 5
    for i in (0, 1, 2, 3, 4, 1):
        want, got = jds[i], tds[i]
        assert got["txt"] == want["txt"]
        for k in ("jpg", "hint"):
            assert got[k].dtype == np.float32 and got[k].shape == (64, 64, 3)
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(tds.load_hint(str(sa1b / "im1.json")),
                                  jds.load_hint(str(sa1b / "im1.json")))
    # the crop's draws, the fallback of extreme aspects included
    for seed in range(20):
        for h, w in ((80, 96), (10, 200), (200, 10), (1, 1)):
            assert (TSD._random_resized_crop_params(
                np.random.RandomState(seed), h, w)
                == JSD._random_resized_crop_params(
                    np.random.RandomState(seed), h, w))


def test_make_batcher_matches_jax(sa1b):
    kw = dict(resolution=32, seed=1)
    batches = []
    for mod in (JSD, TSD):
        ds = mod.SAMDataset(str(sa1b), str(sa1b / "data.txt"), **kw)
        batches.append(list(mod.make_batcher(ds, batch_size=2, num_workers=1,
                                             seed=4)))
    want, got = batches
    assert len(got) == len(want) == 2           # 5 samples, drop_last
    for g, w in zip(got, want):
        assert g["txt"] == w["txt"]
        np.testing.assert_array_equal(g["jpg"], w["jpg"])
        np.testing.assert_array_equal(g["hint"], w["hint"])


def test_image_folder_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    for i, shape in enumerate(((40, 60), (50, 50), (64, 30))):
        img = rng.randint(0, 256, shape + (3,)).astype(np.uint8)
        if i == 1:
            Image.fromarray(img).save(tmp_path / f"i{i}.jpg")
        else:
            write_png(str(tmp_path / f"i{i}.png"), img)
    (tmp_path / "notes.txt").write_text("not an image")
    assert TIF.list_images(str(tmp_path)) == JIF.list_images(str(tmp_path))
    for center_crop in (False, True):
        kw = dict(resolution=32, center_crop=center_crop, seed=2)
        jf, tf = JIF.ImageFolder(str(tmp_path), **kw), TIF.ImageFolder(
            str(tmp_path), **kw)
        for _ in range(3):
            want, got = jf.sample_batch(3), tf.sample_batch(3)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        TIF.ImageFolder(str(tmp_path / "empty"))
