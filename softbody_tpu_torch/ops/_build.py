"""Build and load the hand-written CUDA kernels: csrc/pair_kernels.cu (the
whole-scene kernels, one launch per evaluation each: the v4 path's K1/K2
forward and backward, the fused path's K1 + mid-section, K2 v2 of the
fused path and the blocked layout and its backward, the raw K1's backward,
the Taichi pairing's separable K2 and its backward, and the fixed-order
scatter), csrc/fused_kernels.cu (the raw K1 of the blocked layout) and
csrc/mid_kernels.cu (the mid-section and its VJP as their own launches)
and csrc/gather_kernels.cu (the gather backend's moments and forces and
their VJPs), each including csrc/common.cuh (pair_kernels.cu and
mid_kernels.cu also csrc/mid.cuh).

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
(and ``--fmad=false`` for mid_kernels.cu), one library per source, into the package's git-ignored build directory at
first use, from the sources in the repository only; the missing libraries
are compiled by one nvcc process each, all started together.  The libraries
have a plain C interface and are loaded with ctypes.  A library's name
carries a hash of its source, the headers in csrc/ and the flags, so an
edited source or header is rebuilt, and the build writes a temporary file and renames it, so
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
SOURCES = ("pair_kernels", "fused_kernels", "mid_kernels", "gather_kernels")
HEADERS = ("common.cuh", "mid.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ROWS = 32      # tile rows the kernels take (one lane per row)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per source: the mid-section kernels round every operation on its own, as
# their plain version does (csrc/mid_kernels.cu says why)
SOURCE_FLAGS = {"mid_kernels": ["--fmad=false"]}


def flags(source: str) -> list:
    return NVCC_FLAGS + SOURCE_FLAGS.get(source, [])

# ctypes argument types of each entry point sb_<name>_<f32|f64>
_P, _I64, _I32, _F64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_double
SIGNATURES = {
    "pair_kernels": {
        "moments_v4": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P, _I64, _I32,
                       _F64, _F64, _F64, _P],
        "forces_warp_v4": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P, _I64,
                           _I32, _F64, _F64, _P],
        "moments_mid": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P, _P, _P, _P,
                        _I64, _P, _P, _I64, _P, _I64, _P, _I64, _I64, _I64, _I32,
                        _F64, _F64, _F64, _I32, _I32, _P],
        "moments_v4_bwd": [_P, _I32, _P, _P, _P, _I64, _P, _I64, _P, _I64, _P,
                           _I64, _I32, _F64, _F64, _F64, _P],
        "moments_raw_bwd": [_P, _I32, _P, _P, _P, _I64, _P, _I64, _P, _I64, _P,
                            _I64, _I32, _F64, _F64, _F64, _I32, _I32, _P],
        "forces_warp_v4_bwd_rows": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P,
                                    _I64, _I32, _F64, _F64, _P],
        "forces_warp_v4_bwd_slab": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P,
                                    _I64, _P, _I64, _I32, _F64, _F64, _P],
        "forces_warp_v2": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P, _I64, _P,
                           _I64, _I32, _F64, _F64, _I32, _P],
        "forces_warp_v2_bwd_rows": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P,
                                    _I64, _P, _I64, _P, _I64, _I32, _F64, _F64, _I32,
                                    _P],
        "forces_warp_v2_bwd_slab": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P,
                                    _I64, _P, _I64, _I32, _F64, _F64, _P],
        "forces_sep": [_P, _I32, _P, _P, _P, _P, _I64, _P, _P, _I64, _P, _I64, _I32,
                       _F64, _F64, _I32, _P],
        "forces_sep_bwd": [_P, _I32, _P, _P, _P, _P, _I64, _P, _I64, _P, _I64, _P,
                           _I64, _I32, _F64, _F64, _I32, _P],
        "slab_to_slots": [_P, _I64, _P, _P, _P, _I64, _I32, _I32, _I32, _P],
    },
    "fused_kernels": {
        "moments_raw": [_P, _P, _P, _I64, _P, _P, _I64, _I32, _I32, _I32, _F64,
                        _F64, _F64, _P],
    },
    "mid_kernels": {
        "mid_records": [_P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _P, _I64, _P, _P,
                        _I64, _P, _I64, _I64, _I64, _I32, _I32, _P],
        "mid_records_bwd": [_P, _I64, _P, _I64, _P, _I64, _P, _P, _P, _I64, _P, _P,
                            _I64, _P, _I64, _P, _I64, _P, _P, _I64, _I64, _I32, _I32,
                            _P],
        "mid_records_rec": [_P, _I64, _P, _P, _P, _P, _I64, _P, _P, _I64, _P, _I64, _P,
                            _I32, _I64, _I32, _I32, _P],
    },
    "gather_kernels": {
        "gather_moments": [_P, _P, _P, _P, _P, _I64, _I32, _P, _I64, _I64, _P, _I64,
                           _I64, _P, _I64, _P],
        "gather_moments_bwd": [_I64, _I32, _P, _P, _P, _P, _P, _I64, _P, _I64, _P, _P,
                               _I32, _P, _I64, _I64, _P],
        "gather_forces": [_P, _P, _I64, _I32, _P, _P, _I64, _P, _P, _I32, _P],
        "gather_forces_bwd": [_P, _P, _I64, _I32, _P, _P, _I64, _P, _I64, _P, _P, _P,
                              _P, _P, _I64, _P, _P, _I64, _I32, _P],
    },
}
# the ring kernels (csrc/mid_kernels.cu): the one-wave entry points' arguments
SIGNATURES["mid_kernels"].update(
    mid_records_ring=SIGNATURES["mid_kernels"]["mid_records"],
    mid_records_bwd_ring=SIGNATURES["mid_kernels"]["mid_records_bwd"])

# The K2 kernels that also take a bf16 srT slab (cfg.pair_dtype="bfloat16"),
# in f32: sb_<name>_bf16, with their f32 entry point's arguments.
BF16 = ("forces_warp_v4", "forces_warp_v4_bwd_rows", "forces_warp_v4_bwd_slab",
        "forces_warp_v2", "forces_warp_v2_bwd_rows", "forces_warp_v2_bwd_slab")
# ... and the scatter of that slab's cotangent, f32 sums into bf16
SLAB_TO_SLOTS_BF16 = [_P, _I64, _P, _P, _P, _I32, _P, _I64, _I32, _I32, _I32, _P]

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
    digest = hashlib.sha256(source_path(source).read_bytes()
                            + b"".join((CSRC / h).read_bytes() for h in HEADERS)
                            + " ".join(flags(source)).encode())
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
            [compiler, *flags(s), "-o", str(tmp), str(source_path(s))],
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
            lib.sb_slab_to_slots_bf16.argtypes = SLAB_TO_SLOTS_BF16
            lib.sb_slab_to_slots_bf16.restype = _I32
        if source == "mid_kernels":
            lib.sb_mid_info.argtypes = [_I32, _I32, _P]
            lib.sb_mid_info.restype = _I32
            lib.sb_mid_ring_plan.argtypes = [_I32, _I32, _I64, _P]
            lib.sb_mid_ring_plan.restype = _I32
        if source == "gather_kernels":
            lib.sb_gather_info.argtypes = [_I32, _I32, _F64, _I32, _P]
            lib.sb_gather_info.restype = _I32
        for name, args in SIGNATURES[source].items():
            suffixes = ("f32", "f64", "bf16") if name in BF16 else ("f32", "f64")
            for suffix in suffixes:
                fn = getattr(lib, f"sb_{name}_{suffix}")
                fn.argtypes = args
                fn.restype = _I32
        if lib.sb_rows() != ROWS:
            raise RuntimeError(f"{source} takes rows={lib.sb_rows()}, the "
                               f"wrappers expect {ROWS}")
        _libs[source] = lib
        return lib
