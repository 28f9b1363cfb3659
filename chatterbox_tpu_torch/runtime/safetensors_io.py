"""The safetensors format, read and written with numpy alone.

The port's counterpart of the ``safetensors.numpy`` calls the JAX package
makes (``load_file`` / ``save_file``), for machines that have no
``safetensors`` package. A file is an 8-byte little-endian header length, a
JSON header that maps each tensor name to ``dtype``, ``shape`` and
``data_offsets`` (begin and end byte in the buffer that follows; an optional
``__metadata__`` entry maps strings to strings), then the raw little-endian
buffers.

``load_file`` maps the file into memory and returns views of it, so a 2 GB
checkpoint is not copied; ``BF16`` tensors (numpy has no bfloat16) are
widened to float32, as the JAX package's conds.pt reader does. ``save_file``
writes the layout ``safetensors`` writes: tensors ordered by dtype, widest
first, then by name; the header compact JSON, padded with spaces to a
multiple of 8 bytes.
"""
from __future__ import annotations

import json
import math
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np

# safetensors dtype name → numpy dtype (BF16 is read as raw 16-bit words)
_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"), "I64": np.dtype("<i8"), "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"), "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}
# the order safetensors writes tensors in: dtype rank (widest first), then name
_WRITE_RANK = {name: i for i, name in enumerate(
    ("I64", "F64", "F32", "I32", "F16", "I16", "I8", "U8", "BOOL"))}
_NAME_OF = {v: k for k, v in _DTYPES.items() if k != "BF16"}


def _widen_bf16(words: np.ndarray) -> np.ndarray:
    """Raw bfloat16 words → float32 (exact: bf16 is f32's upper half)."""
    return (words.astype(np.uint32) << 16).view(np.float32)


def read_header(path) -> tuple:
    """→ (the header dict, the byte offset of the data buffer, its length).
    Raises ValueError for a header that runs past the file or is not a
    JSON object."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as fh:
        head = fh.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: {size} bytes, too short for a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the file ({size} bytes)")
        try:
            header = json.loads(fh.read(n))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise ValueError(f"{path}: header is not JSON: {exc}") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: header is not a JSON object")
    return header, 8 + n, size - 8 - n


def _entries(path, header: Dict, data_len: int) -> Dict[str, tuple]:
    """Validated header entries → {name: (dtype name, shape, begin, end)}."""
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dt, shape, (b, e) = info["dtype"], tuple(int(d) for d in info["shape"]), info["data_offsets"]
        except (KeyError, TypeError, ValueError):
            raise ValueError(f"{path}: tensor '{name}': malformed header entry {info!r}") from None
        if dt not in _DTYPES:
            raise ValueError(f"{path}: tensor '{name}': unknown dtype {dt!r}")
        nbytes = math.prod(shape) * _DTYPES[dt].itemsize
        if any(d < 0 for d in shape) or not 0 <= b <= e or e - b != nbytes:
            raise ValueError(f"{path}: tensor '{name}': offsets [{b}, {e}] do not hold "
                             f"{dt} {list(shape)} ({nbytes} bytes)")
        if e > data_len:
            raise ValueError(f"{path}: tensor '{name}': offsets [{b}, {e}] run past the "
                             f"{data_len}-byte buffer")
        out[name] = (dt, shape, b, e)
    spans = sorted((b, e, name) for name, (_, _, b, e) in out.items() if e > b)
    for (_, e0, n0), (b1, _, n1) in zip(spans, spans[1:]):
        if b1 < e0:
            raise ValueError(f"{path}: tensor '{n1}' overlaps tensor '{n0}'")
    return out


def load_file(path) -> Dict[str, np.ndarray]:
    """Every tensor of a safetensors file, as read-only views of the mapped
    file (BF16 widened to float32 copies). Raises ValueError naming the
    tensor for an unknown dtype, offsets that overlap or run past the file,
    or a size that does not match the shape."""
    header, start, data_len = read_header(path)
    entries = _entries(path, header, data_len)
    buf = (np.memmap(path, np.uint8, "r", offset=start, shape=(data_len,)) if data_len
           else np.zeros((0,), np.uint8))
    out: Dict[str, np.ndarray] = {}
    for name, (dt, shape, b, e) in entries.items():
        a = buf[b:e].view(_DTYPES[dt]).reshape(shape)
        out[name] = _widen_bf16(a) if dt == "BF16" else a
    return out


def save_file(tensors: Dict[str, np.ndarray], path, metadata: Optional[Dict[str, str]] = None) -> None:
    """Write numpy arrays as a safetensors file (F64, F32, F16, I64, I32, I16,
    I8, U8 and BOOL; big-endian arrays are written little-endian)."""
    items = []
    for name, arr in tensors.items():
        a = np.asarray(arr)
        dt = _NAME_OF.get(a.dtype.newbyteorder("<"))
        if dt is None:
            raise ValueError(f"tensor '{name}': dtype {a.dtype} has no safetensors name here")
        items.append((_WRITE_RANK[dt], name, dt, a))
    items.sort(key=lambda it: (it[0], it[1]))
    header: Dict = {}
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for _, name, dt, a in items:
        header[name] = {"dtype": dt, "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    blob = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(blob)))
        fh.write(blob)
        for *_, a in items:
            fh.write(np.ascontiguousarray(a, a.dtype.newbyteorder("<")).tobytes())
