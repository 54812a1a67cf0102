"""COCO RLE codec: the native ``csrc/rle.cc`` through ctypes, and its plain
numpy twin.

Counterpart of ``editanything_tpu/ops/rle.py``. The native library is
built with the host's C++ compiler at first use into ``build/``
(core/build.py ``load_library``); a failed build raises with the
compiler's log, and no call falls back to numpy. The numpy codec
(``decode_numpy``, ``encode_numpy``, ``id_map_numpy``) is the twin the
tests hold the native one to. The API is what the reference uses from
pycocotools (``maskUtils.decode``, the reference's utils/sam_dataset.py:44)
plus ``id_map``, which paints every mask of an SA-1B annotation into the
uint16 ControlNet condition in one pass.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence

import numpy as np


@functools.cache
def _library() -> ctypes.CDLL:
    from editanything_tpu_torch.core.build import load_library
    lib = load_library("rle")
    lib.rle_decode.restype = ctypes.c_int
    lib.rle_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_uint8)]
    lib.rle_id_map.restype = ctypes.c_int
    lib.rle_id_map.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_uint16)]
    lib.rle_encode.restype = ctypes.c_int64
    lib.rle_encode.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_char_p,
                               ctypes.c_int64]
    return lib


# ---------------------------------------------------------------------------
# the numpy twin
# ---------------------------------------------------------------------------

def _counts_from_string(s: str) -> List[int]:
    cnts: List[int] = []
    m = 0
    while m < len(s):
        x, k, more = 0, 0, 1
        while more:
            c = ord(s[m]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = c & 0x20
            m += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def _counts_to_string(cnts: Sequence[int]) -> str:
    out = []
    for i, x in enumerate(cnts):
        if i > 2:
            x -= cnts[i - 2]
        more = 1
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _as_str(counts) -> str:
    return counts.decode() if isinstance(counts, bytes) else counts


def decode_numpy(rle: Dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str} -> (h, w) uint8 (runs column-major)."""
    h, w = rle["size"]
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in _counts_from_string(_as_str(rle["counts"])):
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    return flat.reshape(w, h).T


def encode_numpy(mask: np.ndarray) -> Dict:
    """(h, w) mask -> {'size': [h, w], 'counts': str}."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(bool)).T.reshape(-1)
    changes = np.nonzero(np.diff(flat.astype(np.int8)))[0] + 1
    cnts = np.diff(np.concatenate([[0], changes, [flat.size]])).tolist()
    if flat[0]:                       # runs start with background
        cnts = [0] + cnts
    return {"size": [h, w], "counts": _counts_to_string(cnts)}


def id_map_numpy(rles: Sequence[Dict], h: int, w: int) -> np.ndarray:
    """Masks 1..N painted into a uint16 map, later over earlier."""
    out = np.zeros((h, w), np.uint16)
    for i, r in enumerate(rles):
        out[decode_numpy(r) > 0] = i + 1
    return out


# ---------------------------------------------------------------------------
# the native codec
# ---------------------------------------------------------------------------

def decode(rle: Dict) -> np.ndarray:
    """pycocotools-compatible decode -> (h, w) uint8."""
    h, w = rle["size"]
    out = np.zeros((h, w), np.uint8)
    rc = _library().rle_decode(
        _as_str(rle["counts"]).encode(), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError(f"bad RLE (code {rc})")
    return out


def encode(mask: np.ndarray) -> Dict:
    """(h, w) mask -> {'size': [h, w], 'counts': str}."""
    h, w = mask.shape
    m = np.ascontiguousarray(mask, np.uint8)
    cap = 6 * h * w + 16
    buf = ctypes.create_string_buffer(cap)
    n = _library().rle_encode(
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, buf, cap)
    if n < 0:
        raise ValueError("RLE encode overflow")
    return {"size": [h, w], "counts": buf.value.decode()}


def id_map(rles: Sequence[Dict], h: int, w: int) -> np.ndarray:
    """Paint masks 1..N into one uint16 ID map in a single native pass
    (later masks over earlier: show_anns' order, the reference's
    editany_lora.py:433-440)."""
    strs = (ctypes.c_char_p * len(rles))(
        *[_as_str(r["counts"]).encode() for r in rles])
    out = np.zeros((h, w), np.uint16)
    rc = _library().rle_id_map(
        strs, len(rles), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)))
    if rc != 0:
        raise ValueError(f"bad RLE (code {rc})")
    return out
