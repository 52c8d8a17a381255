"""Build and load the port's CUDA kernels.

Each source under ``waldo_tpu_torch/csrc/`` is compiled on its own by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes``. Libraries go to ``build/waldo_tpu_torch/`` at the
repository root, named by a digest of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an unchanged
one is reused. Nothing is compiled at
import time: a kernel builds on its first launch, or all of them at once
(one ``nvcc`` process each, in parallel) through ``build_all``.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "waldo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home is None:
        from torch.utils.cpp_extension import CUDA_HOME

        home = CUDA_HOME
    cand = os.path.join(home, "bin", "nvcc") if home else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit "
                           "to build the waldo_tpu_torch kernels")
    return found


def library_path(source: str) -> Path:
    # the digest covers the shared headers too, which any source may include
    src = b"".join(p.read_bytes() for p in [SRC_DIR / source, *sorted(SRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(source).stem}_{digest}.so"


def build(sources: Iterable[str]) -> Dict[str, dict]:
    """Compile every source whose library is missing, one nvcc process per
    source, all started together. Returns {source: {"seconds", "log"}}
    (the log holds ptxas' register and spill report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / source)]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         tmp, lib, time.perf_counter())
    report = {}
    for source, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, lib)
        report[source] = {"seconds": time.perf_counter() - t0, "log": log}
    return report


class CudaKernel:
    """One kernel behind a C entry point: loads its library on first use,
    launches on the caller's stream and counts its launches.

    ``launches`` counts every launch; ``launches_by_key`` splits the same
    count by a key the wrapper gives each launch (the row count, and for the
    warp whether its ghost mask is given; the activation for bias_act), so a
    run can tell apart the calls made at different shapes or settings."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self._lib: Optional[ctypes.CDLL] = None
        self.launches = 0
        self.launches_by_key: collections.Counter = collections.Counter()

    def reset(self) -> None:
        self.launches = 0
        self.launches_by_key.clear()

    def _load(self) -> ctypes.CDLL:
        if self._lib is None:
            build([self.source])
            lib = ctypes.CDLL(str(library_path(self.source)))
            getattr(lib, self.symbol).argtypes = self.argtypes
            getattr(lib, self.symbol).restype = ctypes.c_int
            lib.waldo_cuda_error_string.argtypes = [ctypes.c_int]
            lib.waldo_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, key, *args) -> None:
        lib = self._load()
        err = getattr(lib, self.symbol)(*args)
        if err != 0:
            msg = lib.waldo_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {err} ({msg})")
        self.launches += 1
        self.launches_by_key[key] += 1
