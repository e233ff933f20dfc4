"""ctypes bindings for the native spatial-hash neighbour builder (hashgrid.cc).

The port's own copy of ``softbody_tpu/native``.  The shared library is
compiled with g++ at first use into the package's build directory
(``softbody_tpu_torch/_build``, git-ignored), never next to the source.  Its
name carries a hash of the source and flags, so an edited source is rebuilt,
and it is built for the generic x86-64 target (no ``-march=native``), so a
build directory copied to another host still loads.  The build writes a
temporary file and renames it, so concurrent first uses (test workers)
cannot load a half-written library.  Without a compiler, :func:`available`
is False and topology/neighbors.py uses scipy instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "hashgrid.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return BUILD_DIR / f"libhashgrid_{digest.hexdigest()[:16]}.so"


def _compile(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(tmp, out)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not path.exists() and not _compile(path):
            return None
        lib = ctypes.CDLL(str(path))
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int64)
        lib.nb_count.argtypes = [dp, ctypes.c_int64, ctypes.c_double, ip]
        lib.nb_count.restype = ctypes.c_int
        lib.nb_fill.argtypes = [dp, ctypes.c_int64, ctypes.c_double, ip, ip]
        lib.nb_fill.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def neighbor_csr(points: np.ndarray, radius: float):
    """(offsets (n+1,), indices) CSR neighbour structure within ``radius``
    (self excluded, each list ascending)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native hashgrid unavailable")
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = len(pts)
    counts = np.zeros(n, dtype=np.int64)
    dp = pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.nb_count(dp, n, radius, counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise RuntimeError(f"nb_count failed: {rc}")
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    indices = np.zeros(int(offsets[-1]), dtype=np.int64)
    rc = lib.nb_fill(
        dp, n, radius,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise RuntimeError(f"nb_fill failed: {rc}")
    return offsets, indices
