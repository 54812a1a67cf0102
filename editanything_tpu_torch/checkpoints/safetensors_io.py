"""The ``.safetensors`` format, read and written with the standard library
and torch alone.

Counterpart of the ``safetensors.numpy`` calls of the JAX package
(checkpoints/convert.py:37-39, checkpoints/lora.py:174-176); the port reads
the format itself so that no path needs the ``safetensors`` package. A file
is an 8-byte little-endian header length, a JSON header mapping each name to
its ``dtype``, ``shape`` and ``data_offsets`` (``[begin, end)`` into the
byte buffer that follows; ``__metadata__`` holds strings), then the buffer.

``load_file`` maps the file and copies one tensor at a time out of the
mapping, straight to the device and dtype asked for, so a large file is
never held twice in host memory. The module is not named ``safetensors``:
that name would shadow the package where both are importable.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Mapping, Optional

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def load_file(path: str, device=None, dtype: Optional[torch.dtype] = None
              ) -> Dict[str, torch.Tensor]:
    """name -> tensor for every tensor of the file, each on `device` (default
    the CPU) and, where it is floating point and `dtype` is given, cast to
    `dtype` there. ``__metadata__`` is not returned."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        base = 8 + n
        size = f.seek(0, 2)
        # copy-on-write: a writable view for torch.frombuffer, the file
        # itself untouched
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
    try:
        for name, info in header.items():
            if info["dtype"] not in _DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype "
                                 f"{info['dtype']}, which this reader lacks")
            dt = _DTYPES[info["dtype"]]
            shape = [int(s) for s in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
            numel = int(np.prod(shape)) if shape else 1
            itemsize = torch.empty((), dtype=dt).element_size()
            if end - begin != numel * itemsize or base + end > size:
                raise ValueError(f"{path}: tensor {name!r} has offsets "
                                 f"{info['data_offsets']} for shape {shape}")
            if numel == 0:
                t = torch.empty(shape, dtype=dt)
            else:
                t = torch.frombuffer(mm, dtype=dt, count=numel,
                                     offset=base + begin).reshape(shape)
            cast = dtype if dtype is not None and t.is_floating_point() else dt
            # a copy in every case: nothing returned refers to the mapping
            out[name] = t.to(device=device, dtype=cast, copy=True)
            del t
    finally:
        if mm is not None:
            mm.close()
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write name -> tensor (torch tensors or numpy arrays, on any device)
    as a ``.safetensors`` file. Tensors are laid out by descending element
    size, then by name, after a header padded with spaces to 8 bytes, so
    that each one starts aligned to its element size, as the safetensors
    package writes them."""
    items = []
    for name, value in tensors.items():
        t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
            np.ascontiguousarray(value))
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} has no "
                             f"safetensors name")
        items.append((name, t))
    items.sort(key=lambda it: (-it[1].element_size(), it[0]))
    header: Dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            if t.numel():
                data = t.detach().contiguous().reshape(-1).view(torch.uint8)
                f.write(data.cpu().numpy())
