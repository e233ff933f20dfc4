"""Folder utilities + Eigen binary IO (capability parity with log.py:4-112):
the port's own copy of ``softbody_tpu/utils/io.py``.

The Eigen vector/sparse-matrix binary formats are vestigial in the reference
(unused by both sims — leftovers from a C++ host project) but kept here for
drop-in compatibility with any external tooling that produced such files.
"""

from __future__ import annotations

import pathlib
import shutil
import struct

import numpy as np
from scipy.sparse import csr_array


def create_folder(folder_name, exist_ok: bool):
    pathlib.Path(folder_name).mkdir(parents=True, exist_ok=exist_ok)


def delete_folder(folder_name):
    shutil.rmtree(folder_name)


def delete_file(file_name):
    pathlib.Path(file_name).unlink()


def file_exist(file_name) -> bool:
    return pathlib.Path(file_name).is_file()


# ---------------------------------------------------------------- Eigen binary
def load_real_vector(file_name) -> np.ndarray:
    """int64 length header + float64 payload (log.py:27-33)."""
    raw = pathlib.Path(file_name).read_bytes()
    (num,) = struct.unpack("=q", raw[:8])
    return np.frombuffer(raw[8: 8 + 8 * num], dtype="<f8").copy()


def save_real_vector(file_name, vec):
    vec = np.asarray(vec, np.float64).ravel()
    with open(file_name, "wb") as f:
        f.write(struct.pack("=q", len(vec)))
        f.write(vec.astype("<f8").tobytes())


def load_real_sparse_matrix(file_name) -> csr_array:
    """(rows, cols, nnz) int64 header + nnz * (row, col int64, value f64)
    triplets (log.py:69-94)."""
    raw = pathlib.Path(file_name).read_bytes()
    rows, cols, nnz = struct.unpack("=3q", raw[:24])
    trip = np.frombuffer(
        raw[24: 24 + 24 * nnz],
        dtype=np.dtype([("r", "<i8"), ("c", "<i8"), ("v", "<f8")]),
    )
    return csr_array((trip["v"].copy(), (trip["r"], trip["c"])), (rows, cols))


def save_real_sparse_matrix(file_name, mat):
    """Triplet dump in row-major order (log.py:96-112)."""
    mat = csr_array(mat)
    rows, cols = mat.shape
    with open(file_name, "wb") as f:
        f.write(struct.pack("=3q", rows, cols, mat.nnz))
        for r in range(rows):
            for c, v in zip(
                mat.indices[mat.indptr[r]: mat.indptr[r + 1]],
                mat.data[mat.indptr[r]: mat.indptr[r + 1]],
            ):
                f.write(struct.pack("=qq", r, c))
                f.write(struct.pack("=d", v))


def sparse_matrix_to_triplets(mat):
    mat = csr_array(mat)
    out = []
    for r in range(mat.shape[0]):
        for c, v in zip(
            mat.indices[mat.indptr[r]: mat.indptr[r + 1]],
            mat.data[mat.indptr[r]: mat.indptr[r + 1]],
        ):
            out.append((int(r), int(c), float(v)))
    return out


def triplets_to_sparse_matrix(row_num, col_num, triplets):
    if triplets:
        r, c, v = zip(*triplets)
    else:
        r = c = v = []
    return csr_array(
        (np.asarray(v, np.float64), (np.asarray(r, np.int64), np.asarray(c, np.int64))),
        (row_num, col_num),
    )
