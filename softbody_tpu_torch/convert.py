"""Carry a scene built by the JAX package into the port, and back.

This system's parameters are the static scene (layout, rest geometry,
materials, rest correction, row sums) and the inflation field ``x``.
:func:`scene_from_numpy` takes them as a flat dict of numpy arrays and ints —
every leaf of a ``softbody_tpu`` sparse or blocked ``Scene`` plus the
layout's metadata — and returns the port's objects, so both packages
compute from identical state.  The backward's scatter index is derived from
the ``gidx8`` arrays and ``slot_of_particle``, so it needs no key of its
own.  :func:`scene_to_numpy` is its inverse (same keys, no ``x``).

Keys of every scene: ``rest_position, mass, volume, mu, lam, free,
external, rest_corr (3,3,m), slot_of_particle, rs6T (6,m), out_num, rows,
n_tiles, n_slots, group``, and optionally ``x`` (n_slots,).  A sparse scene
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

from .core.types import Blocked, DevBucket, Materials, Scene
from .ops._build import ROWS
from .ops.pair_kernels import schedules, slab_inverse, sparse_blocked

_MATERIALS = ("mass", "volume", "mu", "lam", "free", "external")


def scene_from_numpy(d: dict, device):
    """(Scene, x) on ``device``; ``x`` is None when ``d`` has none.  The
    floating dtype is that of ``d["rest_position"]``."""
    device = torch.device(device)
    dtype = {np.dtype("float32"): torch.float32,
             np.dtype("float64"): torch.float64}[np.asarray(d["rest_position"]).dtype]

    def dev(key, dt=dtype):
        return torch.from_numpy(np.array(d[key])).to(device=device, dtype=dt)

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
    x = dev("x") if "x" in d else None
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
