"""Carry state built by the JAX package into the port, and back.

This system's parameters are the static scene (layout, rest geometry,
materials, rest correction, row sums or neighbour tables), its obstacles
and contact grid, and the inflation field ``x``.  :func:`scene_from_numpy`
takes a scene as a flat dict of numpy arrays and ints — every leaf of a
``softbody_tpu`` gather, sparse or blocked ``Scene`` plus the layout's
metadata — and returns the port's objects, so both packages compute from
identical state.  The backward's scatter indices (the slot layouts' CSR
index, the gather table's CSR inverse) are derived from the tables, so
they need no key of their own.  :func:`scene_to_numpy` is its inverse
(same keys, no ``x``).  :func:`deepsdf_from_numpy`,
:func:`obstacles_from_numpy` and :func:`contact_from_numpy` carry the
DeepSDF parameters, the obstacle set and the contact grid.

Keys of every scene: ``rest_position, mass, volume, mu, lam, free,
external, out_num`` and optionally ``x``.  A gather scene adds
``topology.<field>`` for each field of the JAX ``Topology`` (``idx, mask,
w, nw, xji, c, vj, sum_c_xji, rest_corr, sum_v_nw``).  A slot scene adds
``rest_corr (3,3,m), slot_of_particle, rs6T (6,m), rows, n_tiles,
n_slots, group``, ``x`` being (n_slots,).  A sparse scene
adds ``n_buckets`` and per bucket k ``bucket{k}.gidx8 / .restT_rows /
.static_slab / .tile_start``.  A blocked scene (``Blocked``) adds
``run_len`` and ``blocked.slab_start (t,9) / .gidx8 (t,slab/8) /
.restT_rows (t,3,rows) / .static_slab (t,5,slab)``, its rs6T being the JAX
``Blocked.rs6`` transposed; tiles of more than 32 rows (the ``cells``
layout's tz * C) are cut into 32-row tiles sharing their slab.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import Blocked, DevBucket, Materials, Scene, Topology
from .models.deepsdf import DeepSDFParams
from .ops import obstacles as obs
from .ops._build import ROWS
from .ops.contact import ContactGrid
from .ops.pair_kernels import schedules, slab_inverse, sparse_blocked
from .topology.neighbors import topology_to_torch

_MATERIALS = ("mass", "volume", "mu", "lam", "free", "external")
_TOPOLOGY = Topology._fields[:10]       # the JAX Topology's leaves


def scene_from_numpy(d: dict, device):
    """(Scene, x) on ``device``; ``x`` is None when ``d`` has none.  The
    floating dtype is that of ``d["rest_position"]``."""
    device = torch.device(device)
    dtype = {np.dtype("float32"): torch.float32,
             np.dtype("float64"): torch.float64}[np.asarray(d["rest_position"]).dtype]

    def dev(key, dt=dtype):
        return torch.from_numpy(np.array(d[key])).to(device=device, dtype=dt)

    x = dev("x") if "x" in d else None
    if "topology.idx" in d:
        topo = Topology(**{f: d[f"topology.{f}"] for f in _TOPOLOGY},
                        inv_order=None, inv_lengths=None)
        return Scene(rest_position=dev("rest_position"),
                     materials=Materials(*(dev(k) for k in _MATERIALS)),
                     out_num=int(d["out_num"]),
                     topology=topology_to_torch(topo, dtype, device)), x

    real = np.zeros(int(d["n_slots"]), bool)
    real[np.asarray(d["slot_of_particle"])] = True
    if "blocked.gidx8" in d:
        layout = _blocked_from_numpy(d, real, device, dtype)
    else:
        layout = _sparse_from_numpy(d, real, device, dtype)
    scene = Scene(
        rest_position=dev("rest_position"),
        materials=Materials(*(dev(k) for k in _MATERIALS)),
        out_num=int(d["out_num"]),
        blocked=layout,
        rest_corr=dev("rest_corr"),
        slot_of_particle=dev("slot_of_particle", torch.int64),
    )
    return scene, x


def _tensor(a, device, dt):
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dt)


def _sparse_from_numpy(d, real, device, dtype):
    parts = [(np.asarray(d[f"bucket{k}.gidx8"]), np.asarray(d[f"bucket{k}.restT_rows"]),
              np.asarray(d[f"bucket{k}.static_slab"]), int(d[f"bucket{k}.tile_start"]))
             for k in range(int(d["n_buckets"]))]
    sb = sparse_blocked(parts, np.asarray(d["rs6T"]), len(real), int(d["group"]),
                        real, device, dtype, int(d["rows"]))
    if sb.n_tiles != int(d["n_tiles"]):
        raise ValueError(f"the buckets hold {sb.n_tiles} tiles, n_tiles is "
                         f"{int(d['n_tiles'])}")
    return sb


def _blocked_from_numpy(d, real, device, dtype):
    rows, t = int(d["rows"]), int(d["n_tiles"])
    split = rows // ROWS
    if rows % ROWS:
        raise ValueError(f"tiles of {rows} rows: the kernels take multiples of {ROWS}")
    rr = np.asarray(d["blocked.restT_rows"])                      # (t, 3, rows)
    rr = rr.reshape(t, 3, split, ROWS).transpose(0, 2, 1, 3).reshape(-1, 3, ROWS)
    static = np.repeat(np.asarray(d["blocked.static_slab"]), split, axis=0)
    gidx8 = np.repeat(np.asarray(d["blocked.gidx8"], np.int32), split, axis=0)
    n_slots, group = len(real), int(d["group"])
    ptr, idx = slab_inverse([gidx8], n_slots, group, real)
    sched, chunks = schedules([gidx8.shape[0]], [static.shape[2]], [0], group, device)
    return Blocked(
        bucket=DevBucket(gidx8=_tensor(gidx8, device, torch.int32),
                         restT_rows=_tensor(rr, device, dtype),
                         static_slab=_tensor(static, device, dtype), tile_start=0,
                         rows=ROWS, slab_len=static.shape[2]),
        slab_start=_tensor(np.repeat(np.asarray(d["blocked.slab_start"]), split,
                                     axis=0), device, torch.int64),
        rs6T=_tensor(d["rs6T"], device, dtype), run_len=int(d["run_len"]),
        n_slots=n_slots, group=group,
        slab_ptr=torch.from_numpy(ptr).to(device),
        slab_idx=torch.from_numpy(idx).to(device), schedule=sched, chunks=chunks)


def scene_to_numpy(scene: Scene) -> dict:
    """The flat dict :func:`scene_from_numpy` reads, from a port scene."""
    sb = scene.blocked

    def host(t):
        return t.detach().cpu().numpy()

    if scene.topology is not None:
        d = {"rest_position": host(scene.rest_position), "out_num": scene.out_num}
        d.update({f"topology.{f}": host(getattr(scene.topology, f)) for f in _TOPOLOGY})
        d.update({name: host(scene.materials[k]) for k, name in enumerate(_MATERIALS)})
        return d
    d = {
        "rest_position": host(scene.rest_position),
        "rest_corr": host(scene.rest_corr),
        "slot_of_particle": host(scene.slot_of_particle),
        "rs6T": host(sb.rs6T),
        "out_num": scene.out_num,
        "rows": sb.rows,
        "n_tiles": sb.n_tiles,
        "n_slots": sb.n_slots,
        "group": sb.group,
    }
    for k, name in enumerate(_MATERIALS):
        d[name] = host(scene.materials[k])
    if isinstance(sb, Blocked):
        d["run_len"] = sb.run_len
        d["blocked.slab_start"] = host(sb.slab_start)
        for key in ("gidx8", "restT_rows", "static_slab"):
            d[f"blocked.{key}"] = host(getattr(sb.bucket, key))
        return d
    d["n_buckets"] = len(sb.buckets)
    for k, b in enumerate(sb.buckets):
        d[f"bucket{k}.gidx8"] = host(b.gidx8)
        d[f"bucket{k}.restT_rows"] = host(b.restT_rows)
        d[f"bucket{k}.static_slab"] = host(b.static_slab)
        d[f"bucket{k}.tile_start"] = b.tile_start
    return d


def deepsdf_from_numpy(weights, biases, device="cpu",
                       dtype=torch.float32) -> DeepSDFParams:
    """The JAX package's ``DeepSDFParams`` (as numpy: (in, out) weights and
    biases) -> the port's, in ``dtype`` on ``device``."""
    def dev(a):
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    return DeepSDFParams(tuple(dev(w) for w in weights), tuple(dev(b) for b in biases))


def obstacles_from_numpy(kinds, params, stiffness, margin, device="cpu"):
    """The JAX package's ``Obstacles`` (kinds, params as numpy, stiffness,
    margin) -> the port's on ``device``, every parameter kept at its dtype
    (the primitives' f32).  A "deepsdf" entry is ((weights, biases), scale,
    offset)."""
    def dev(a):
        return torch.from_numpy(np.array(a)).to(device)

    out = []
    for kind, p in zip(kinds, params):
        if kind == "deepsdf":
            (ws, bs), scale, offset = p
            dt = torch.from_numpy(np.array(ws[0])).dtype
            out.append(((deepsdf_from_numpy(ws, bs, device, dt), dev(scale),
                         dev(offset))))
        else:
            out.append(tuple(dev(a) for a in p))
    return obs.Obstacles(kinds=tuple(kinds), params=tuple(out),
                         stiffness=float(stiffness), margin=float(margin))


def contact_from_numpy(lo, cell, dims, cap, r_c, stiffness, exclude=None,
                       device="cpu") -> ContactGrid:
    """The JAX package's ``ContactGrid`` fields (``lo`` as numpy, its f32
    kept; ``exclude`` an (N, K) table or None) -> the port's on ``device``."""
    return ContactGrid(
        lo=torch.from_numpy(np.array(lo)).to(device), cell=float(cell),
        dims=tuple(int(v) for v in dims), cap=int(cap), r_c=float(r_c),
        stiffness=float(stiffness),
        exclude=None if exclude is None
        else torch.from_numpy(np.asarray(exclude, np.int64)).to(device))
