"""Carry a scene built by the JAX package into the port.

This system's parameters are the static scene (layout, rest geometry,
materials, rest correction, row sums) and the inflation field ``x``.
:func:`scene_from_numpy` takes them as a flat dict of numpy arrays and ints —
every leaf of a ``softbody_tpu`` sparse ``Scene`` plus the bucket metadata —
and returns the port's objects, so both packages compute from identical
state.  The backward's scatter index is derived from the ``gidx8`` arrays, so
it needs no key of its own.  :func:`scene_to_numpy` is its inverse (same keys, no ``x``).

Keys: ``rest_position, mass, volume, mu, lam, free, external, rest_corr
(3,3,m), slot_of_particle, rs6T (6,m), out_num, rows, n_tiles, n_slots,
group, n_buckets``, per bucket k ``bucket{k}.gidx8 / .restT_rows /
.static_slab / .tile_start``, and optionally ``x`` (n_slots,).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import DevBucket, Materials, Scene, SparseBlocked
from .ops.pair_kernels import slab_inverse

_MATERIALS = ("mass", "volume", "mu", "lam", "free", "external")


def scene_from_numpy(d: dict, device):
    """(Scene, x) on ``device``; ``x`` is None when ``d`` has none.  The
    floating dtype is that of ``d["rest_position"]``."""
    device = torch.device(device)
    dtype = {np.dtype("float32"): torch.float32,
             np.dtype("float64"): torch.float64}[np.asarray(d["rest_position"]).dtype]

    def dev(key, dt=dtype):
        return torch.from_numpy(np.array(d[key])).to(device=device, dtype=dt)

    rows = int(d["rows"])
    buckets = tuple(
        DevBucket(
            gidx8=dev(f"bucket{k}.gidx8", torch.int32),
            restT_rows=dev(f"bucket{k}.restT_rows"),
            static_slab=dev(f"bucket{k}.static_slab"),
            tile_start=int(d[f"bucket{k}.tile_start"]),
            rows=rows,
            slab_len=int(np.asarray(d[f"bucket{k}.static_slab"]).shape[2]),
        )
        for k in range(int(d["n_buckets"])))
    n_slots, group = int(d["n_slots"]), int(d["group"])
    ptr, idx = slab_inverse(
        [d[f"bucket{k}.gidx8"] for k in range(int(d["n_buckets"]))],
        n_slots, group)
    sb = SparseBlocked(buckets=buckets, rs6T=dev("rs6T"), rows=rows,
                       n_tiles=int(d["n_tiles"]), n_slots=n_slots, group=group,
                       slab_ptr=torch.from_numpy(ptr).to(device),
                       slab_idx=torch.from_numpy(idx).to(device))
    scene = Scene(
        rest_position=dev("rest_position"),
        materials=Materials(*(dev(k) for k in _MATERIALS)),
        out_num=int(d["out_num"]),
        blocked=sb,
        rest_corr=dev("rest_corr"),
        slot_of_particle=dev("slot_of_particle", torch.int64),
    )
    x = dev("x") if "x" in d else None
    return scene, x


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
        "n_buckets": len(sb.buckets),
    }
    for k, name in enumerate(_MATERIALS):
        d[name] = host(scene.materials[k])
    for k, b in enumerate(sb.buckets):
        d[f"bucket{k}.gidx8"] = host(b.gidx8)
        d[f"bucket{k}.restT_rows"] = host(b.restT_rows)
        d[f"bucket{k}.static_slab"] = host(b.static_slab)
        d[f"bucket{k}.tile_start"] = b.tile_start
    return d
