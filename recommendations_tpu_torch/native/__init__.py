"""Host-side C++ built at first use and loaded with ``ctypes``.

``fasthash.cpp`` is a copy of the JAX package's batch xxHash (XXH64 and
XXH32): one C call hashes a whole column. It is built with ``g++`` the first
time a hash is asked for, into ``native/_build/`` (gitignored), named by a
hash of the source and the flags, as ``ops/cuda_build.py`` builds the CUDA
kernels; nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fasthash.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libfasthash-{digest}.so"


def load() -> ctypes.CDLL:
    """Build the library (unless it exists) and load it, once per process."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = library_path()
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE} (rc {proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        cdll = ctypes.CDLL(str(lib))
        cdll.hash_strings_to_long.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_uint64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        cdll.hash_strings_to_long.restype = None
        cdll.xxh64_single.restype = ctypes.c_uint64
        cdll.xxh64_single.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64]
        cdll.xxh32_single.restype = ctypes.c_uint32
        cdll.xxh32_single.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint32]
        _LIB = cdll
        return cdll


def hash_strings_to_long(values: Iterable, seed: int, value_to_lower: bool) -> np.ndarray:
    """xxh64(str(value), seed) - 2**63 of every value, as int64. Lowercasing
    is Python's ``str.lower`` (Unicode-aware), applied before the C call."""
    encoded: List[bytes] = [
        (str(v).lower() if value_to_lower else str(v)).encode("utf-8") for v in values
    ]
    n = len(encoded)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.fromiter((len(e) for e in encoded), dtype=np.int64, count=n), out=offsets[1:])
    buf = b"".join(encoded)
    out = np.empty(n, dtype=np.int64)
    load().hash_strings_to_long(buf, offsets, n, ctypes.c_uint64(seed), out)
    return out


def xxh64(data: bytes, seed: int = 0) -> int:
    return int(load().xxh64_single(data, len(data), ctypes.c_uint64(seed)))


def xxh32(data: bytes, seed: int = 0) -> int:
    return int(load().xxh32_single(data, len(data), ctypes.c_uint32(seed)))
