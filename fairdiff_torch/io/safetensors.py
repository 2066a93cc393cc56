"""A reader for `.safetensors` files that needs no `safetensors` package.

The format: an 8-byte little-endian header length n, n bytes of JSON
(`{name: {"dtype", "shape", "data_offsets": [begin, end]}}`, plus an
optional `"__metadata__"` of strings; padded with spaces to 8 bytes), then
the tensors' raw little-endian bytes, offsets counted from the end of the
header. The file is mapped copy-on-write, so the tensors share its pages
until they are written and need no copy of the whole file in memory.
"""

from __future__ import annotations

import json
import mmap
import struct
import sys
from pathlib import Path

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def read_header(path: str | Path) -> tuple[dict, int]:
    """-> (the JSON header, the byte offset of the data that follows it)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a `.safetensors` file, on the CPU, in file order."""
    if sys.byteorder != "little":
        raise RuntimeError("the safetensors reader assumes a little-endian host")
    header, start = read_header(path)
    header.pop("__metadata__", None)
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else b""
    out = {}
    for name, info in sorted(header.items(), key=lambda kv: kv[1]["data_offsets"][0]):
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which the reader does not know")
        begin, end = info["data_offsets"]
        shape = info["shape"]
        count = end - begin
        want = torch.Size(shape).numel() * dtype.itemsize
        if count != want or start + end > size:
            raise ValueError(f"{path}: tensor {name!r} {info['dtype']}{shape} spans {count} bytes, needs {want}")
        flat = torch.frombuffer(buf, dtype=dtype, count=count // dtype.itemsize, offset=start + begin) \
            if count else torch.empty(0, dtype=dtype)
        out[name] = flat.reshape(shape)
    return out
