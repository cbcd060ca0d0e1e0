"""The safetensors format, read and written with torch alone.

A file is an 8-byte little-endian header length N, N bytes of JSON, then
the tensors' raw bytes. The header maps each name to its `dtype`, `shape`
and `data_offsets` [begin, end) relative to the first byte after the
header, plus an optional `__metadata__` of strings. The writer pads the
header with spaces to a multiple of 8 bytes and orders the tensors by
element size, largest first, so that every tensor starts at a multiple of
its element size.

`load_file` maps one tensor's bytes at a time and copies them to the
tensor's device, so a checkpoint never passes through host memory as a
whole; `save_file` writes one tensor at a time, each in its own dtype.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from pathlib import Path
from typing import Dict, Optional, Union

import torch

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}
_MAX_HEADER = 100 << 20          # the format's own limit on the header


def read_header(path) -> Dict:
    """The JSON header of a safetensors file (names -> dtype, shape,
    data_offsets; `__metadata__` when present)."""
    with open(path, "rb") as f:
        return _read_header(f, os.fstat(f.fileno()).st_size)[0]


def _read_header(f, size: int):
    if size < 8:
        raise ValueError(f"{f.name}: {size} bytes, too short for a "
                         "safetensors file")
    (n,) = struct.unpack("<Q", f.read(8))
    if n > min(_MAX_HEADER, size - 8):
        raise ValueError(f"{f.name}: header length {n} does not fit the "
                         f"file of {size} bytes")
    header = json.loads(f.read(n))
    base = 8 + n
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{f.name}: {name} has dtype "
                             f"{info['dtype']!r}, which is not read here")
        numel = 1
        for d in info["shape"]:
            numel *= d
        itemsize = torch.empty((), dtype=_DTYPES[info["dtype"]]).itemsize
        if not 0 <= begin <= end <= size - base or \
                end - begin != numel * itemsize:
            raise ValueError(f"{f.name}: {name} has offsets {begin}-{end} "
                             f"for shape {info['shape']} {info['dtype']}")
    return header, base


def load_file(path, device: Optional[Union[str, torch.device]] = None
              ) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a safetensors file, each on `device` (the CPU when
    None), in the file's dtypes. Each tensor is read through a mapping of
    its own bytes and copied to `device`; the mapping is closed before the
    next tensor, so at most one tensor's pages are resident."""
    device = torch.device("cpu" if device is None else device)
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        header, base = _read_header(f, os.fstat(f.fileno()).st_size)
        for name, info in header.items():
            if name == "__metadata__":
                continue
            begin, end = (base + o for o in info["data_offsets"])
            dtype = _DTYPES[info["dtype"]]
            if end == begin:
                out[name] = torch.empty(info["shape"], dtype=dtype,
                                        device=device)
                continue
            start = begin - begin % mmap.ALLOCATIONGRANULARITY
            # a private mapping is writable, as torch.frombuffer wants,
            # and never writes back to the file
            with mmap.mmap(f.fileno(), end - start, access=mmap.ACCESS_COPY,
                           offset=start) as mm:
                raw = torch.frombuffer(mm, dtype=torch.uint8,
                                       count=end - begin,
                                       offset=begin - start)
                # a fresh allocation is aligned for any dtype; the bytes
                # in the file need not be
                t = raw.to(device, copy=True)
                del raw
            out[name] = t.view(dtype).reshape(info["shape"])
    return out


def save_file(tensors: Dict[str, torch.Tensor], path,
              metadata: Optional[Dict[str, str]] = None) -> Path:
    """Write `tensors` to `path` in the safetensors format, each in its own
    dtype and from whatever device it lives on, one at a time."""
    names = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} is not written here")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    path = Path(path)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            t = tensors[name].detach()
            if t.numel():
                flat = t.contiguous().reshape(-1).view(torch.uint8)
                f.write(memoryview(flat.cpu().numpy()))
    return path
