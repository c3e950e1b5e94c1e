"""Build a ``csrc/*.cu`` file into a shared library at first use, and load it.

Each source has a plain C entry point (no PyTorch headers), so ``nvcc``
builds it in seconds. The library lands in ``ops/_build/`` inside the
package, named by a hash of the source, of the sources it includes and of
the headers beside it, so an edited source or header is never served by a
stale library. Kernels that
share a source share its one build. Nothing is built when a module is
imported: the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


_LIBRARIES: Dict[Path, Tuple[ctypes.CDLL, str]] = {}
_SOURCE_LOCKS: Dict[Path, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: Path) -> Path:
    """The library of ``source``, named by a hash of the source, the ``.cu``
    sources it includes (``fused_ce_rounded.cu`` is ``fused_ce.cu`` built
    once more with a macro defined), the headers of ``csrc/`` (which any
    source may include) and the flags."""
    text = source.read_bytes()
    included = re.findall(rb'^#include "([^"/]+\.cu)"', text, flags=re.M)
    key = text + b"".join((source.parent / name.decode()).read_bytes() for name in included)
    key += b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    digest = hashlib.sha256(key + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def build_library(source: Path) -> Tuple[ctypes.CDLL, str]:
    """Compile ``source`` (unless its library exists) and load it, once per
    process; returns the library and nvcc's output. Sources build in
    parallel, each at most once."""
    with _LOCKS_GUARD:
        lock = _SOURCE_LOCKS.setdefault(source, threading.Lock())
    with lock:
        if source in _LIBRARIES:
            return _LIBRARIES[source]
        lib, log = library_path(source), ""
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # the process and thread in the name: two source trees with the same
            # content (and so the same library) may build side by side
            tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                capture_output=True, text=True,
            )
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source} (rc {proc.returncode}):\n{log}")
            os.replace(tmp, lib)
        _LIBRARIES[source] = (ctypes.CDLL(str(lib)), log)
        return _LIBRARIES[source]


ALL_KERNELS: List["CudaKernel"] = []


class CudaKernel:
    """One kernel: its source, its C entry point, and a count of launches.

    ``launches`` is a plain integer that the wrapper raises by one for each
    launch of the kernel, and a replayed CUDA graph (``train/step_graph.py``)
    by the launches its capture counted, so a run can show which kernels
    its path went through. ``ALL_KERNELS`` lists every kernel made.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence[type]):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None
        ALL_KERNELS.append(self)

    @property
    def name(self) -> str:
        return self.symbol

    def build(self):
        """Compile the source (unless its library exists) and load it;
        returns the C function."""
        if self._fn is not None:
            return self._fn
        lib, self.build_log = build_library(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args) -> None:
        rc = self.build()(*args)
        if rc == -1:
            raise ValueError(f"{self.symbol}: the kernel does not take this shape")
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: launch failed with CUDA error {rc}")
        self.launches += 1
