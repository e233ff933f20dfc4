"""Asset IO: point clouds, meshes, UVs — plain parsers, no Open3D/trimesh
(the port's own copy of ``softbody_tpu/geometry/io.py``).

The reference loads outer/inner .ply point clouds, an outer.obj mesh and a
uv.npy (sim.py:41-53) through Open3D/trimesh (C++ deps).  These are simple
formats; the parsers here cover the subsets those assets use (ascii +
binary-little-endian PLY vertices, OBJ v/f records with polygon fans) and keep
everything in numpy.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_PLY_TYPES = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "i2", "ushort": "u2", "int16": "i2", "uint16": "u2",
    "int": "i4", "uint": "u4", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply_points(path) -> np.ndarray:
    """Vertex positions (N, 3) from an ascii or binary-little-endian PLY."""
    raw = Path(path).read_bytes()
    header_end = raw.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = raw[:header_end].decode("ascii", "replace").splitlines()
    body = raw[header_end + len(b"end_header\n"):]

    fmt = None
    elements = []  # (name, count, [(type, prop_name) ...])
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property" and elements:
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[1], tok[2]))

    vert = next((e for e in elements if e[0] == "vertex"), None)
    if vert is None:
        raise ValueError(f"{path}: no vertex element")
    _, count, props = vert
    names = [p[1] for p in props if p[0] != "list"]
    if fmt == "ascii":
        rows = body.decode("ascii").split("\n")
        data = np.array(
            [[float(x) for x in rows[i].split()[: len(names)]] for i in range(count)]
        )
        table = {n: data[:, k] for k, n in enumerate(names)}
    elif fmt == "binary_little_endian":
        if elements[0][0] != "vertex":
            raise ValueError(f"{path}: binary PLY with vertex not first unsupported")
        dtype = np.dtype([(p[1], "<" + _PLY_TYPES[p[0]]) for p in props if p[0] != "list"])
        arr = np.frombuffer(body, dtype=dtype, count=count)
        table = {n: arr[n].astype(np.float64) for n in names}
    else:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    return np.stack([table["x"], table["y"], table["z"]], axis=-1).astype(np.float64)


def read_obj(path):
    """(vertices (N, 3), faces (M, 3)) from an OBJ; polygons are fan-triangulated."""
    verts, faces = [], []
    for line in Path(path).read_text().splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "v":
            verts.append([float(x) for x in tok[1:4]])
        elif tok[0] == "f":
            idx = [int(t.split("/")[0]) - 1 for t in tok[1:]]
            for k in range(1, len(idx) - 1):
                faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def write_ply_points(path, points):
    """ascii PLY point cloud writer (for target/asset generation)."""
    points = np.asarray(points, np.float64)
    lines = [
        "ply", "format ascii 1.0", f"element vertex {len(points)}",
        "property float x", "property float y", "property float z", "end_header",
    ]
    lines += [f"{p[0]} {p[1]} {p[2]}" for p in points]
    Path(path).write_text("\n".join(lines) + "\n")


REFERENCE_ROTATION = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
REFERENCE_OFFSET = np.array([0.0, 0.07, 0.0])
REFERENCE_SCALE = 0.01


def load_reference_body(asset_dir, name):
    """Reference asset-loading semantics (sim.py:41-53): outer + inner .ply
    scaled x0.01, rotated by R = [[1,0,0],[0,0,-1],[0,1,0]] (right-multiplied),
    offset +0.07 y-hat; outer mesh faces + uv.npy for rendering.

    Returns dict(points, out_num, raw_points, faces, uv) where ``raw_points``
    are the pre-transform coordinates the DeepSDF is evaluated on (sim.py:50).
    """
    d = Path(asset_dir)
    outer = read_ply_points(d / f"{name}" / "point_cloud_downsampled.ply") * REFERENCE_SCALE
    inner = read_ply_points(d / f"{name}" / f"{name}_inner.ply") * REFERENCE_SCALE
    raw = np.vstack([outer, inner])
    points = raw @ REFERENCE_ROTATION + REFERENCE_OFFSET
    faces = uv = None
    obj = d / f"{name}" / "outer.obj"
    if obj.exists():
        _, faces = read_obj(obj)
    uv_path = d / f"{name}" / "uv.npy"
    if uv_path.exists():
        uv = np.load(uv_path)
    return {
        "points": points,
        "out_num": len(outer),
        "raw_points": raw,
        "faces": faces,
        "uv": uv,
    }
