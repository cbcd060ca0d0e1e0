"""Build and load the port's hand-written CUDA kernels.

Every kernel source is a `csrc/<name>.cu` file with a plain C interface;
device helpers that sources share are headers beside them (`csrc/*.cuh`).
`build()` compiles each source with nvcc into its own shared library under
the package's `_build/` directory (listed in .gitignore), named by the
hash of its source, the headers and the nvcc flags, so an edited source or
header rebuilds and an unchanged one is reused. All missing libraries are
compiled at once, one nvcc process per source. `load(name, bind)` opens a library with
ctypes (building it first if needed) and lets the caller declare its
entry points once.

Nothing here runs at import time: the CPU tests import every module of
the package on machines without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("matvec_int4", "matvec_small_m", "gmm2_fused", "gmm2_bwd",
           "flash_attn")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", f"-I{CSRC}")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "competesmoe_tpu_torch/csrc/*.cu at first use")


def library_path(name: str) -> Path:
    """Where the library built from csrc/<name>.cu lives: keyed by the
    hash of the source, of every header in csrc/ (any source may include
    any of them) and of the flags."""
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False
          ) -> Dict[str, Path]:
    """Compile every missing library among `names`, one nvcc process per
    source, all started together. Each library is written to a temporary
    name and renamed into place, so a concurrent build never loads a
    partial file. With `verbose`, nvcc's register and shared-memory report
    (-Xptxas=-v) is printed. Raises if any build fails."""
    names = list(names)
    out = {n: library_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compile_sources([(CSRC / f"{n}.cu", out[n]) for n in todo], verbose)
    return out


def compile_sources(jobs: Iterable[tuple], verbose: bool = False) -> None:
    """Compile each (source .cu, library .so) pair with nvcc, all at once
    (a source outside csrc/ still finds csrc's headers: -I); every library
    is written to a temporary name beside it and renamed
    into place. Raises if any build fails."""
    nvcc = _nvcc()
    procs = []
    for src, lib in jobs:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=Path(lib).parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS] + (["-Xptxas=-v"] if verbose else []) \
            + ["-o", tmp, str(src)]
        procs.append((Path(src).name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        try:
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc failed ({proc.returncode}):\n"
                              f"{log}")
                continue
            if verbose:
                print(f"--- nvcc {name}\n{log}", flush=True)
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, bind: Optional[Callable[[ctypes.CDLL], None]] = None
         ) -> ctypes.CDLL:
    """The ctypes library of csrc/<name>.cu, built on first use; `bind`
    declares its entry points' argument and result types once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            if bind is not None:
                bind(lib)
            _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
