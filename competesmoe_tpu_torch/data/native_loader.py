"""ctypes bindings for the repo's native (C++) batch-assembly library
(port of competesmoe_tpu/data/native_loader.py).

Builds `native/dataloader.cpp` with g++ on first use into the port's own
build directory (`competesmoe_tpu_torch/_build/libdataloader.so`, written
under a temporary name and renamed, so a concurrent build never loads a
half-written file). The library's ABI version must be 1. Every entry
point has a numpy path, taken when the library cannot be built (no g++,
no source): the same bytes either way. This is host batch assembly, not a
device kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "dataloader.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LIB_PATH = _BUILD_DIR / "libdataloader.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Optional[ctypes.CDLL]:
    if not _SRC.exists():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not _LIB_PATH.exists() or (_LIB_PATH.stat().st_mtime
                                  < _SRC.stat().st_mtime):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
               str(_SRC), "-o", tmp, "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, _LIB_PATH)
        except (OSError, subprocess.CalledProcessError):
            Path(tmp).unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.gather_windows_u16.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p]
    lib.gather_windows_u16.restype = None
    lib.assemble_batch_u16.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.assemble_batch_u16.restype = None
    lib.pad_batch_i32.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    lib.pad_batch_i32.restype = None
    lib.dataloader_abi_version.restype = ctypes.c_int
    if lib.dataloader_abi_version() != 1:
        raise RuntimeError(f"{_LIB_PATH}: ABI version "
                           f"{lib.dataloader_abi_version()}, expected 1")
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            _lib = _build()
    return _lib


def native_available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u16(chunk: np.ndarray) -> np.ndarray:
    if chunk.dtype != np.uint16 or not chunk.flags["C_CONTIGUOUS"]:
        raise ValueError("chunks must be contiguous uint16 arrays")
    return chunk


def gather_windows(chunk: np.ndarray, window_ids: np.ndarray,
                   window: int) -> np.ndarray:
    """chunk: uint16 flat mmap; window_ids: [n] int64 -> [n, window] int32."""
    window_ids = np.ascontiguousarray(window_ids, np.int64)
    n = len(window_ids)
    out = np.empty((n, window), np.int32)
    if n and (window_ids.min() < 0
              or (window_ids.max() + 1) * window > len(chunk)):
        raise IndexError("window id out of the chunk")
    lib = get_lib()
    if lib is None:
        for i, w in enumerate(window_ids):
            out[i] = chunk[w * window:(w + 1) * window]
        return out
    lib.gather_windows_u16(_ptr(_u16(chunk)), _ptr(window_ids), n, window,
                           _ptr(out))
    return out


def assemble_batch(chunks: Sequence[np.ndarray], chunk_ids: np.ndarray,
                   local_ids: np.ndarray, window: int,
                   n_threads: int = 0) -> np.ndarray:
    """Gather windows across multiple chunks -> [n, window] int32."""
    chunk_ids = np.ascontiguousarray(chunk_ids, np.int64)
    local_ids = np.ascontiguousarray(local_ids, np.int64)
    n = len(chunk_ids)
    out = np.empty((n, window), np.int32)
    for c, w in zip(chunk_ids, local_ids):
        if not (0 <= c < len(chunks) and 0 <= w
                and (w + 1) * window <= len(chunks[c])):
            raise IndexError(f"window {w} of chunk {c} out of range")
    lib = get_lib()
    if lib is None:
        for i in range(n):
            c = chunks[chunk_ids[i]]
            off = local_ids[i] * window
            out[i] = c[off:off + window]
        return out
    arr_t = ctypes.c_void_p * len(chunks)
    ptrs = arr_t(*[_u16(c).ctypes.data_as(ctypes.c_void_p).value
                   for c in chunks])
    lib.assemble_batch_u16(ptrs, _ptr(chunk_ids), _ptr(local_ids), n,
                           window, _ptr(out), n_threads)
    return out


def pad_batch(seqs: List[np.ndarray], max_len: int, pad_id: int = 0):
    """Right-pad int32 sequences -> (ids [n, max_len], mask [n, max_len])."""
    seqs = [np.ascontiguousarray(s, np.int32) for s in seqs]
    n = len(seqs)
    ids = np.empty((n, max_len), np.int32)
    mask = np.empty((n, max_len), np.int32)
    lib = get_lib()
    if lib is None:
        for i, s in enumerate(seqs):
            L = min(len(s), max_len)
            ids[i, :L] = s[:L]
            ids[i, L:] = pad_id
            mask[i, :L] = 1
            mask[i, L:] = 0
        return ids, mask
    lens = np.asarray([len(s) for s in seqs], np.int64)
    arr_t = ctypes.c_void_p * n
    ptrs = arr_t(*[s.ctypes.data_as(ctypes.c_void_p).value for s in seqs])
    lib.pad_batch_i32(ptrs, _ptr(lens), n, max_len, pad_id, _ptr(ids),
                      _ptr(mask))
    return ids, mask
