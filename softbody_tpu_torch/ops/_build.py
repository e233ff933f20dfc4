"""Build and load the hand-written CUDA kernels: csrc/pair_kernels.cu (the
v4 path: K1/K2 forward and backward, one launch per evaluation each, and
the fixed-order scatter),
csrc/fused_kernels.cu (the fused K1 + mid-section path, K2 v2 and the raw
K1 of the blocked layout) and csrc/separable_kernels.cu (the Taichi
pairing's separable K2 and its backward), each including csrc/common.cuh.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``,
one library per source, into the package's git-ignored build directory at
first use, from the sources in the repository only; the missing libraries
are compiled by one nvcc process each, all started together.  The libraries
have a plain C interface and are loaded with ctypes.  A library's name
carries a hash of its source, the shared header and the flags, so an edited
source is rebuilt, and the build writes a temporary file and renames it, so
concurrent first uses cannot load a half-written library.  ``ptxas -v``
output (registers, shared memory, spills per kernel) is kept beside each
library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("pair_kernels", "fused_kernels", "separable_kernels")
HEADER = CSRC / "common.cuh"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ROWS = 32      # tile rows the kernels take (one lane per row)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ctypes argument types of each entry point sb_<name>_<f32|f64>
_P, _I64, _I32, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
_K2_BWD = [_P, _P, _P, _I64, _P, _I64, _P, _P, _I64, _P, _I64, _I32, _I32, _I32,
           _F64, _F64, _P]
_SEP_BWD = [_P, _P, _P, _P, _I64, _P, _I64, _I32, _I32, _F64, _F64, _P]
SIGNATURES = {
    "pair_kernels": {
        "moments_v4": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P, _I64, _I32,
                       _F64, _F64, _F64, _P],
        "forces_warp_v4": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P, _I64,
                           _I32, _F64, _F64, _P],
        "moments_v4_bwd": [_P, _I32, _P, _P, _P, _I64, _P, _I64, _P, _I64, _P,
                           _I64, _I32, _F64, _F64, _F64, _P],
        "forces_warp_v4_bwd_rows": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P,
                                    _I64, _I32, _F64, _F64, _P],
        "forces_warp_v4_bwd_slab": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P,
                                    _I64, _P, _I64, _I32, _F64, _F64, _P],
        "slab_to_slots": [_P, _I64, _P, _P, _P, _I64, _I32, _I32, _I32, _P],
    },
    "fused_kernels": {
        "moments_mid": [_P, _P, _P, _I64, _P, _I64, _P, _P, _P, _P, _P, _I64, _P,
                        _P, _I64, _P, _I64, _P, _I64, _I32, _I32, _I32, _F64,
                        _F64, _F64, _I32, _I32, _P],
        "forces_warp_v2": [_P, _P, _P, _I64, _P, _I64, _P, _P, _I64, _I32, _I32,
                           _I32, _F64, _F64, _P],
        "moments_raw_bwd": [_P, _P, _P, _I64, _P, _I64, _I32, _I32, _F64, _F64,
                            _F64, _P],
        "forces_warp_v2_bwd_rows": _K2_BWD,
        "forces_warp_v2_bwd_slab": _K2_BWD,
        "moments_raw": [_P, _P, _P, _I64, _P, _P, _I64, _I32, _I32, _I32, _F64,
                        _F64, _F64, _P],
    },
    "separable_kernels": {
        "forces_sep": [_P, _P, _P, _I64, _P, _I64, _P, _P, _P, _I64, _I32, _I32,
                       _I32, _F64, _F64, _P],
        "forces_sep_bwd_rows": _SEP_BWD,
        "forces_sep_bwd_slab": _SEP_BWD,
    },
}

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    nvcc on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return found


def source_path(source: str) -> Path:
    return CSRC / f"{source}.cu"


def library_path(source: str) -> Path:
    digest = hashlib.sha256(source_path(source).read_bytes() + HEADER.read_bytes()
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source}_{digest.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every source whose library does not exist yet, one nvcc each,
    all at once.  Returns {source: library path}."""
    out = {s: library_path(s) for s in SOURCES}
    missing = [s for s in SOURCES if not out[s].exists()]
    if not missing:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for s in missing:
        tmp = out[s].with_name(f"{out[s].name}.{os.getpid()}.tmp")
        procs[s] = (tmp, subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(source_path(s))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for s, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on "
                          f"{source_path(s)}:\n{stderr}")
            continue
        out[s].with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out[s])
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def library(source: str = "pair_kernels") -> ctypes.CDLL:
    """The loaded kernel library of csrc/<source>.cu (every library is built
    on the first call)."""
    with _lock:
        if source in _libs:
            return _libs[source]
        lib = ctypes.CDLL(str(build()[source]))
        lib.sb_rows.argtypes = []
        lib.sb_rows.restype = _I32
        if source == "pair_kernels":
            lib.sb_error_string.argtypes = [_I32]
            lib.sb_error_string.restype = ctypes.c_char_p
            lib.sb_ragged_info.argtypes = [_I32, _I32, _P]
            lib.sb_ragged_info.restype = _I32
        for name, args in SIGNATURES[source].items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"sb_{name}_{suffix}")
                fn.argtypes = args
                fn.restype = _I32
        if lib.sb_rows() != ROWS:
            raise RuntimeError(f"{source} takes rows={lib.sb_rows()}, the "
                               f"wrappers expect {ROWS}")
        _libs[source] = lib
        return lib
