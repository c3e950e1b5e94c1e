"""Build a ``csrc/*.cu`` file into a shared library at first use, and load it.

Each source has a plain C entry point (no PyTorch headers), so ``nvcc``
builds it in seconds. The library lands in ``ops/_build/`` inside the
package, named by a hash of the source, so an edited source is never served
by a stale library. Nothing is built when a module is imported: the CPU
tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaKernel:
    """One kernel: its source, its C entry point, and a count of launches.

    ``launches`` is a plain integer that the wrapper raises by one for each
    launch of the kernel, and nowhere else, so a run can show which kernels
    its path went through.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence[type]):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._fn = None

    @property
    def name(self) -> str:
        return self.source.stem

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def build(self):
        """Compile (unless this source's library exists) and load; returns
        the C function."""
        if self._fn is not None:
            return self._fn
        lib = self.library_path()
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True,
            )
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source} (rc {proc.returncode}):\n{self.build_log}"
                )
            os.replace(tmp, lib)
        fn = getattr(ctypes.CDLL(str(lib)), self.symbol)
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
