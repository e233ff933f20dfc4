"""Build and load the hand-written CUDA kernels (csrc/pair_kernels.cu: the
K1/K2 forward and backward kernels and the fixed-order scatter).

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into the package's git-ignored build directory, at first use, from the
sources in the repository only; the library has a plain C interface and is
loaded with ctypes.  The output name carries a hash of the source and flags,
so an edited source is rebuilt, and the build writes a temporary file and
renames it, so concurrent first uses cannot load a half-written library.
``ptxas -v`` output (registers, shared memory, spills per kernel) is kept
beside the library as ``<name>.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "csrc" / "pair_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ROWS = 32      # tile rows the kernels take (one lane per row)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


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


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpair_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source's library already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {SRC}:\n"
                           f"{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on the first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p, i64, i32, f64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                            ctypes.c_double)
        lib.sb_rows.argtypes = []
        lib.sb_rows.restype = i32
        lib.sb_error_string.argtypes = [i32]
        lib.sb_error_string.restype = ctypes.c_char_p
        moments = [p, p, p, i64, p, i64, p, p, i64, i32, i32, i32,
                   f64, f64, f64, p]
        forces = [p, p, p, i64, p, i64, p, p, i64, i32, i32, i32,
                  f64, f64, p]
        moments_bwd = [p, p, p, i64, p, i64, p, i64, p, i64, i32, i32,
                       f64, f64, f64, p]
        forces_bwd_rows = [p, p, p, i64, p, p, i64, p, i64, i32, i32, i32,
                           f64, f64, p]
        forces_bwd_slab = [p, p, p, i64, p, i64, p, p, i64, p, i64, i32, i32,
                           i32, f64, f64, p]
        to_slots = [p, i64, p, p, p, i64, i32, i32, i32, p]
        for name, args in (("moments_v4", moments),
                           ("forces_warp_v4", forces),
                           ("moments_v4_bwd", moments_bwd),
                           ("forces_warp_v4_bwd_rows", forces_bwd_rows),
                           ("forces_warp_v4_bwd_slab", forces_bwd_slab),
                           ("slab_to_slots", to_slots)):
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"sb_{name}_{suffix}")
                fn.argtypes = args
                fn.restype = i32
        if lib.sb_rows() != ROWS:
            raise RuntimeError(f"kernel library takes rows={lib.sb_rows()}, "
                               f"the wrappers expect {ROWS}")
        _lib = lib
        return _lib
