"""The pair kernels of the sparse path: K1 (moments) and K2 (Warp-pairing
forces), forward and backward, and the fixed-order scatter of the backward.

Counterpart of ``softbody_tpu/ops/pallas/pair_kernels.py`` +
``softbody_tpu/ops/pallas/packed.py`` for the v4 path:

* :func:`moments_v4` replaces ``_moments_kernel_v4`` (launched by
  ``packed.moments_packed_v4``): per tile row, the CENTERED moments
  A_pq (rows 0-8) and Y (rows 9-17) of ayT (18, m), row 3b+a.
* :func:`forces_warp_v4` replaces ``_forces_warp_kernel_v4`` (launched by
  ``packed.forces_warp_packed_v4``): per tile row, the Warp pairing sum
  termj_a = sum_j (R_j F_i S_j nw_ij)_a, fT (3, m).

* :func:`moments_v4_bwd` replaces ``_moments_bwd_kernel_v4``: dayT ->
  dps (3, n_entries) per slab entry and dprowT (3, m), the centering
  term's gradient against the STATIC row sums rs6T.
* :func:`forces_warp_v4_bwd` replaces ``_forces_warp_bwd_kernel_v4``: dfT ->
  df9T (9, m) and dsr (15, n_entries) = [dS_6 | dR^T_9] per slab entry, as
  two kernels, the row pass :func:`forces_warp_v4_bwd_rows` and the slab
  pass :func:`forces_warp_v4_bwd_slab`.

  All five take a whole scene and launch once per evaluation over every
  tile of every bucket: the forward kernels and the row pass in the order
  of the scene's :func:`tile_schedule` (longest slab first), the slab side
  of the backward over the 128-entry chunks of :func:`chunk_schedule`.  A
  per-slab-entry output is the (k, n_entries) buffer ``slab_to_slots``
  reads (n_entries = sum_b t_b slab_b, the buckets' tiles end to end; a
  tile's entry s at column gi_off * group + s).  Their plain versions stay
  per bucket (``*_v4_plain``, ``*_v4_bwd_plain``), and ``*_scene_plain``
  runs them over the buckets into the whole-scene outputs.
* :func:`slab_to_slots` adds a per-slab-entry buffer (k, sum_b t_b slab_b)
  into (k, n_slots) in a fixed order through the scene's CSR inverse of the
  buckets' ``gidx8`` (no float atomics: the episode gradient is bitwise
  repeatable).  The JAX path's ``scatter_packed_raw_T`` is XLA, not Pallas.
* The bf16 K2 slab (``cfg.pair_dtype = "bfloat16"``): the K2 wrappers here
  and in ``ops/fused_kernels.py`` take a bfloat16 srT under float32
  arithmetic and launch its instantiation of the same kernel, counted on
  the wrapper's ``bf16`` counter (``forces_warp_v4_bf16``, ...); the slab's
  cotangent, bf16, comes from :func:`slab_to_slots_bf16`, rounded where
  the JAX VJP rounds it (:func:`slab_cotangent`).

Each has a plain PyTorch version (``*_plain``): explicit formulas on the
tile's candidate slots, from the pair sums of ``ops/pair_common.py``
(which also holds the operand checks, the layouts and the precision
rule).  The wrapper takes it only for tensors on the CPU.  For CUDA
tensors it launches the hand-written kernel (csrc/pair_kernels.cu, built
at first use by ops/_build.py) and counts the launch in its ``launches``
attribute; any other device raises.  There is no fallback from a kernel to
its plain version.

:func:`moments_all` / :func:`forces_all` are the differentiable ops over all
buckets of a scene: one ``torch.autograd.Function`` each, whose forward and
backward go through a :class:`PairOps` — :data:`KERNELS` (the wrappers:
plain on the CPU, kernels on the card) or :data:`PLAIN` (the plain versions
on any device, the yardstick the kernels are held against on the card).
The two tables also carry the fused path's functions and the blocked
layout's raw K1 (``ops/fused_kernels.py``; the fused K1 + mid-section,
K2 v2 and its backward passes and the raw K1's backward are whole-scene
kernels of csrc/pair_kernels.cu, the v4 bodies with their own epilogues)
the Taichi pairing's separable K2 and its backward
(``ops/separable_kernels.py``, whole-scene kernels of the same file) and
the mid-section and its VJP (``ops/mid_kernels.py``, csrc/mid_kernels.cu,
one launch each per evaluation on every path that does not fuse the
mid-section into K1) and the gather backend's moments and forces and
their VJPs (``ops/gather_kernels.py``, csrc/gather_kernels.cu), and
:func:`launch_counts` counts every path's kernels.  The kernels read their slab operands
themselves through ``gidx8`` (slot = gidx8[tile, g] * group + k), so the
(t, 3, slab) / (t, 16, slab) gathered copies the TPU path materialised
(``packed.gather_packed_T``) do not exist here.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..core.types import DevBucket, SparseBlocked
from . import _build
from . import fused_kernels as fk
from . import gather_kernels as gk
from . import mid_kernels as mk
from . import separable_kernels as sk
from .pair_common import (BWD_CHUNK, RAGGED_CHUNK, SR_FIELDS, aligned, bf16_counted,
                          bucket_cols, centered_moments, check, check_lane_major,
                          check_scene, check_slab, counter, entry, flat_entries,
                          n_entries, on, raise_on, raw_moments_bwd, spline_constants,
                          stream, warp_termj, warp_termj_bwd, whole_pieces)


# ------------------------------------------------------------- plain versions
def moments_v4_plain(restT_rows, static_slab, posT, posT_rows, rs6T_rows,
                     gidx8, h):
    """Plain K1: centered moments ayT (18, t*rows), row 3b+a
    (:func:`~.pair_common.centered_moments`); rs6T_rows (6, t*rows), the
    static row sums, only the backward reads."""
    return centered_moments(restT_rows, static_slab, posT, posT_rows, gidx8, h)


def moments_v4_scene_plain(sb, posT, posT_rows, h):
    """Plain K1 over a whole scene: the per-bucket :func:`moments_v4_plain`
    concatenated in tile order, ayT (18, m)."""
    return torch.cat([
        moments_v4_plain(b.restT_rows, b.static_slab, posT,
                         posT_rows[:, bucket_cols(b, sb.rows)],
                         sb.rs6T[:, bucket_cols(b, sb.rows)], b.gidx8, h)
        for b in sb.buckets], dim=1)


def moments_v4_bwd_plain(restT_rows, static_slab, dayT, rs6T_rows, h):
    """Plain K1 backward (``_moments_bwd_kernel_v4``): dayT (18, t*rows) ->
    dpsT (t, 3, slab) (:func:`~.pair_common.raw_moments_bwd`) and
    dprowT (3, t*rows) = -sum_blk dayT[3 blk + a] * rs6T_rows[blk], the
    cotangent of the row positions against the STATIC row sums (the forward
    centers against its own coefficient sums: the gradient is exact for a
    function ~1e-7 relative away from the f32 forward, packed.py:376-383)."""
    t, _, rows = restT_rows.shape
    dps = raw_moments_bwd(restT_rows, static_slab, dayT, h)
    ct = dayT.reshape(6, 3, t, rows)                        # (blk, a, t, r)
    rs6 = rs6T_rows.reshape(6, t, rows)
    dprow = -sum(ct[k] * rs6[k][None] for k in range(6))    # (3, t, rows)
    return dps, dprow.reshape(3, t * rows)


def forces_warp_v4_plain(restT_rows, static_slab, f9T, srT, gidx8, h):
    """Plain K2: Warp-pairing termj fT (3, t*rows)
    (:func:`~.pair_common.warp_termj`)."""
    return warp_termj(restT_rows, static_slab, f9T, srT, gidx8, h)


def forces_warp_v4_scene_plain(sb, f9T, srT, h):
    """Plain K2 over a whole scene: the per-bucket
    :func:`forces_warp_v4_plain` concatenated in tile order, fT (3, m)."""
    return torch.cat([
        forces_warp_v4_plain(b.restT_rows, b.static_slab,
                             f9T[:, bucket_cols(b, sb.rows)], srT, b.gidx8, h)
        for b in sb.buckets], dim=1)


def forces_warp_v4_bwd_plain(restT_rows, static_slab, f9T, srT, gidx8, dfT, h):
    """Plain K2 backward (``_forces_warp_bwd_kernel_v4``): dfT (3, t*rows) ->
    (df9T (9, t*rows), dsrT (t, 15, slab))
    (:func:`~.pair_common.warp_termj_bwd`)."""
    return warp_termj_bwd(restT_rows, static_slab, f9T, srT, gidx8, dfT, h)


def moments_v4_bwd_scene_plain(sb, dayT, h):
    """Plain K1 backward over a whole scene: the per-bucket
    :func:`moments_v4_bwd_plain` placed into the whole-scene outputs,
    dps (3, n_entries) (:func:`~.pair_common.flat_entries`' order) and
    dprowT (3, m)."""
    parts = [moments_v4_bwd_plain(b.restT_rows, b.static_slab,
                                  dayT[:, bucket_cols(b, sb.rows)],
                                  sb.rs6T[:, bucket_cols(b, sb.rows)], h)
             for b in sb.buckets]
    return (flat_entries([p[0] for p in parts], 3),
            torch.cat([p[1] for p in parts], dim=1))


def forces_warp_v4_bwd_scene_plain(sb, f9T, srT, dfT, h):
    """Plain K2 backward over a whole scene: the per-bucket
    :func:`forces_warp_v4_bwd_plain` placed into the whole-scene outputs,
    df9T (9, m) and dsr (15, n_entries)."""
    parts = [forces_warp_v4_bwd_plain(b.restT_rows, b.static_slab,
                                      f9T[:, bucket_cols(b, sb.rows)], srT,
                                      b.gidx8, dfT[:, bucket_cols(b, sb.rows)], h)
             for b in sb.buckets]
    return (torch.cat([p[0] for p in parts], dim=1),
            flat_entries([p[1] for p in parts], SR_FIELDS))


# --------------------------------------------------- fixed-order scatter-reduce
def slab_inverse(gidx8s, n_slots: int, group: int, real):
    """CSR inverse of the buckets' candidate groups (host, numpy).

    The per-slab-entry buffers of all buckets lie end to end, bucket-major
    then tile-major, so the entries of candidate group (b, tile, g) start at
    group * p, with p the position of gidx8_b[tile, g] in the concatenation
    of the flattened gidx8s.  Returns (slab_ptr (n_groups + 1,),
    slab_idx (int32)): the positions p that read slot group k are
    slab_idx[slab_ptr[k]:slab_ptr[k + 1]], ascending.

    Only the readers of groups that hold a real particle are kept.  Every
    other slot sits on the far grid with zero mass and volume, so every
    pair term with it is exactly zero and so is its cotangent: the scatter
    writes 0 there.  Those groups are what every slab pads with: the sparse
    layout's all-empty last group (7,144 of the 52,608 group entries at 20k
    particles, against at most 26 for any other group) and a blocked
    layout's empty run, which every absent neighbour column points at, and
    its column padding; walking their readers would serialize the scatter.
    ``real`` (n_slots,) marks the particle slots."""
    if n_slots % group:
        raise ValueError(f"n_slots={n_slots} is not a multiple of group={group}")
    n_groups = n_slots // group
    flat = np.concatenate([np.asarray(g, np.int64).reshape(-1) for g in gidx8s])
    if flat.size and (flat.min() < 0 or flat.max() >= n_groups):
        raise ValueError("gidx8 names a group outside the scene")
    live = np.asarray(real, bool).reshape(n_groups, group).any(axis=1)
    keep = live[flat]
    order = np.flatnonzero(keep)[np.argsort(flat[keep], kind="stable")]
    ptr = np.zeros(n_groups + 1, np.int64)
    np.cumsum(np.bincount(flat[keep], minlength=n_groups), out=ptr[1:])
    return ptr.astype(np.int32), order.astype(np.int32)


def tile_schedule(n_tiles, slab_lens, tile_starts, group: int):
    """The ragged kernels' schedule (host, numpy): one row per tile of every
    bucket, [tile, slab, offset of its (5, slab) static block in the
    buckets' static slabs laid end to end, offset of its gidx8 row in their
    gidx8 laid end to end], int64, longest slab first (tile order within
    one slab length), so that the long tiles start first and the short ones
    fill the tail.  Per bucket: its tile count, slab length and first
    tile."""
    parts, st_off, gi_off = [], 0, 0
    for t, slab, t0 in zip(n_tiles, slab_lens, tile_starts):
        if slab % group:
            raise ValueError(f"slab {slab} is not a multiple of group={group}")
        k = np.arange(t, dtype=np.int64)
        parts.append(np.stack([t0 + k, np.full(t, slab, np.int64),
                               st_off + 5 * slab * k, gi_off + slab // group * k],
                              axis=1))
        st_off += 5 * slab * t
        gi_off += slab // group * t
    sched = np.concatenate(parts)
    return sched[np.argsort(-sched[:, 1], kind="stable")]


def chunk_schedule(sched, group: int, chunk: int = BWD_CHUNK):
    """The backward slab side's schedule (host, numpy): one row per
    ``chunk``-entry piece of every tile's slab, [tile, slab, st_off, gi_off,
    e0] (a row of the tile schedule ``sched`` and the piece's first entry),
    int64, in tile order and entry order within a tile.  A slab need only
    be a multiple of the slot ``group``: its last piece may be shorter
    (the kernels write nothing past the slab).  Every full piece is the
    same work, so no order balances better than another; tile order keeps
    neighbouring blocks on neighbouring memory."""
    sched = np.asarray(sched, np.int64)
    odd = sorted({int(s) for s in sched[:, 1] if s % group})
    if odd:
        raise ValueError(f"slabs {odd} are not multiples of the slot group {group}")
    sched = sched[np.argsort(sched[:, 0], kind="stable")]
    n = -(-sched[:, 1] // chunk)
    first = np.repeat(np.cumsum(n) - n, n)
    e0 = (np.arange(int(n.sum()), dtype=np.int64) - first) * chunk
    return np.concatenate([np.repeat(sched, n, axis=0), e0[:, None]], axis=1)


def schedules(n_tiles, slab_lens, tile_starts, group: int, device):
    """(schedule, chunks) of a scene on ``device``, int64: the
    :func:`tile_schedule` of its buckets (tile counts, slab lengths, first
    tiles) and its :func:`chunk_schedule`.  Both scene types take them from
    here, whichever way the scene was built."""
    sched = tile_schedule(n_tiles, slab_lens, tile_starts, group)
    return (torch.from_numpy(sched).to(device),
            torch.from_numpy(chunk_schedule(sched, group)).to(device))


def sparse_blocked(parts, rs6T, n_slots: int, group: int, real, device, dtype,
                   rows: int = _build.ROWS, n_shards: int = 1) -> SparseBlocked:
    """A :class:`SparseBlocked` on ``device`` from host buckets ``parts``:
    per bucket (gidx8 (t_b, slab_b / group), restT_rows (t_b, 3, rows),
    static_slab (t_b, 5, slab_b), tile_start), numpy, holding tiles
    [0, n_tiles) in order; rs6T (6, n_tiles * rows); ``real`` (n_slots,)
    marks the particle slots (:func:`slab_inverse`).  The buckets' arrays
    are views of the scene-wide ``rest_rows`` / ``static_all`` /
    ``gidx_all``, which the ragged kernels read through ``schedule`` and
    ``chunks``; ``n_shards`` the layout's (``SparseBlocked.n_shards``)."""
    counts = [np.shape(p[1])[0] for p in parts]
    starts = [int(p[3]) for p in parts]
    if starts != [int(x) for x in np.cumsum([0] + counts[:-1])]:
        raise ValueError(f"buckets must hold consecutive tiles in order: "
                         f"starts {starts}, counts {counts}")

    def dev(a, dt):
        a = np.require(a, requirements=["C", "W"])
        return torch.from_numpy(a).to(device=device, dtype=dt)

    rest_rows = dev(np.concatenate([np.asarray(p[1]) for p in parts]), dtype)
    static_all = dev(np.concatenate([np.asarray(p[2]).reshape(-1) for p in parts]),
                     dtype)
    gidx_all = dev(np.concatenate([np.asarray(p[0]).reshape(-1) for p in parts]),
                   torch.int32)
    buckets, st_off, gi_off = [], 0, 0
    for (gi, _, st, t0), t in zip(parts, counts):
        gshape, sshape = np.shape(gi), np.shape(st)
        g_n, s_n = int(np.prod(gshape)), int(np.prod(sshape))
        buckets.append(DevBucket(
            gidx8=gidx_all[gi_off:gi_off + g_n].view(gshape),
            restT_rows=rest_rows[t0:t0 + t],
            static_slab=static_all[st_off:st_off + s_n].view(sshape),
            tile_start=t0, rows=rows, slab_len=int(sshape[2])))
        gi_off += g_n
        st_off += s_n
    ptr, idx = slab_inverse([p[0] for p in parts], n_slots, group, real)
    sched, chunks = schedules(counts, [b.slab_len for b in buckets], starts, group,
                              device)
    return SparseBlocked(
        buckets=tuple(buckets), rs6T=dev(rs6T, dtype), rows=rows,
        n_tiles=sum(counts), n_slots=n_slots, group=group,
        slab_ptr=dev(ptr, torch.int32), slab_idx=dev(idx, torch.int32),
        rest_rows=rest_rows, static_all=static_all, gidx_all=gidx_all,
        schedule=sched, chunks=chunks, n_shards=int(n_shards))


def slab_to_slots_plain(buf, slab_ptr, slab_idx, n_slots, group):
    """Plain scatter-reduce: buf (k, n_entries) per slab entry ->
    (k, n_slots), each slot summing the entries that read it: the entries
    gathered in CSR order, then one segment sum per slot group."""
    k, n_entries = buf.shape
    n_groups = n_slots // group
    src = buf.reshape(k, n_entries // group, group)[:, slab_idx.long()]
    sums = torch.segment_reduce(src.permute(1, 0, 2).reshape(-1, k * group),
                                "sum", lengths=torch.diff(slab_ptr.long()),
                                axis=0)                      # (n_groups, k*group)
    return sums.reshape(n_groups, k, group).permute(1, 0, 2).reshape(k, n_slots)


def slab_to_slots_bf16_plain(buf, slab_ptr, slab_idx, bstart, n_slots, group):
    """Plain scatter of the bf16 K2 slab's cotangent: buf (k, n_entries) ->
    (k, n_slots) bfloat16, rounded where the JAX package rounds it: each
    bucket's slot sums (:func:`slab_to_slots_plain` over its entries) to
    bfloat16, then the buckets added in bfloat16, last first.  ``bstart``
    (n_buckets,) int32: the scene's ``bucket_starts``."""
    starts = [int(x) for x in bstart] + [buf.shape[1] // group]
    total = None
    for b in reversed(range(len(starts) - 1)):
        part = torch.zeros_like(buf)
        cols = slice(starts[b] * group, starts[b + 1] * group)
        part[:, cols] = buf[:, cols]
        c = slab_to_slots_plain(part, slab_ptr, slab_idx, n_slots, group).to(torch.bfloat16)
        total = c if total is None else (total.float() + c.float()).to(torch.bfloat16)
    return total


# ------------------------------------------------------------ kernel launches
RAGGED = ("moments_v4", "forces_warp_v4", "moments_v4_bwd",
          "forces_warp_v4_bwd_rows", "forces_warp_v4_bwd_slab", "forces_warp_v2",
          "forces_warp_v2_bwd_rows", "forces_warp_v2_bwd_slab",
          "forces_warp_v2 (tail)", "forces_warp_v2_bwd_rows (tail)", "moments_mid",
          "moments_raw_bwd", "moments_raw_bwd (tail)", "forces_sep", "forces_sep (tail)",
          "forces_sep_bwd", "forces_sep_bwd (tail)")


def ragged_info() -> dict:
    """What the card gives the whole-scene kernels (K1/K2 v4, K2 v2 and
    their backwards, the fused K1 + mid-section, the raw K1 backward, the
    separable K2 and its backward; the K2 ones also on the bf16 slab,
    dtype "float32/bfloat16"):
    {(kernel, dtype):
    {registers, static_smem, local_bytes, dynamic_smem, blocks_per_sm,
    threads}} (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Needs a card."""
    lib = _build.library("pair_kernels")
    keys = ("registers", "static_smem", "local_bytes", "dynamic_smem",
            "blocks_per_sm", "threads")
    out = {}
    for which, name in enumerate(RAGGED):
        modes = ["float32", "float64"]
        if name.split(" ")[0] in _build.BF16:
            modes.append("float32/bfloat16")
        for mode, dtype in enumerate(modes):
            buf = (ctypes.c_int * len(keys))()
            raise_on(lib.sb_ragged_info(which, mode, buf), f"{name} attributes")
            out[name, dtype] = dict(zip(keys, buf))
    return out


def _launch_moments(sb, posT, posT_rows, h):
    device, dtype = posT.device, posT.dtype
    check_scene(sb, dtype, device)
    whole_pieces(sb, RAGGED_CHUNK, "moments_v4")
    m = sb.n_tiles * sb.rows
    check_lane_major("posT", posT, dtype, device, 3, sb.n_slots)
    check_lane_major("posT_rows", posT_rows, dtype, device, 3, m)
    aligned("posT", posT, lane_major=True)
    out = torch.empty((18, m), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return out
    inv_h, c4, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "moments_v4", dtype)(
        sb.schedule.data_ptr(), sb.n_tiles, sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(),
        posT.data_ptr(), posT.stride(0), posT_rows.data_ptr(), posT_rows.stride(0),
        out.data_ptr(), out.stride(0), sb.group, inv_h, c4, c4h, stream())
    raise_on(rc, "moments_v4")
    moments_v4.launches += 1
    return out


def _launch_forces(sb, f9T, srT, h):
    device, dtype = f9T.device, f9T.dtype
    check_scene(sb, dtype, device)
    whole_pieces(sb, RAGGED_CHUNK, "forces_warp_v4")
    m = sb.n_tiles * sb.rows
    check_lane_major("f9T", f9T, dtype, device, 9, m)
    check_slab(srT, dtype, device, sb)
    aligned("srT", srT, lane_major=True)
    out = torch.empty((3, m), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return out
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "forces_warp_v4", dtype, srT.dtype)(
        sb.schedule.data_ptr(), sb.n_tiles, sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(),
        f9T.data_ptr(), f9T.stride(0), srT.data_ptr(), srT.stride(0),
        out.data_ptr(), out.stride(0), sb.group, inv_h, c4h, stream())
    raise_on(rc, "forces_warp_v4")
    counter(forces_warp_v4, srT).launches += 1
    return out


def _launch_moments_bwd(sb, dayT, h):
    """(dps (3, n_entries), dprowT (3, m)): a block per 128-entry chunk of
    every slab."""
    device, dtype = dayT.device, dayT.dtype
    check_scene(sb, dtype, device, chunks=True)
    whole_pieces(sb, BWD_CHUNK, "moments_v4_bwd")
    m = sb.n_tiles * sb.rows
    check_lane_major("dayT", dayT, dtype, device, 18, m)
    check_lane_major("rs6T", sb.rs6T, dtype, device, 6, m)
    dps = torch.empty((3, n_entries(sb)), dtype=dtype, device=device)
    dprow = torch.empty((3, m), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return dps, dprow
    inv_h, c4, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "moments_v4_bwd", dtype)(
        sb.chunks.data_ptr(), sb.chunks.shape[0], sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), dayT.data_ptr(), dayT.stride(0),
        sb.rs6T.data_ptr(), sb.rs6T.stride(0), dps.data_ptr(), dps.stride(0),
        dprow.data_ptr(), dprow.stride(0), sb.group, inv_h, c4, c4h, stream())
    raise_on(rc, "moments_v4_bwd")
    moments_v4_bwd.launches += 1
    return dps, dprow


def _check_forces_bwd(sb, f9T, srT, dfT, chunks):
    device, dtype = dfT.device, dfT.dtype
    check_scene(sb, dtype, device, chunks)
    m = sb.n_tiles * sb.rows
    check_lane_major("f9T", f9T, dtype, device, 9, m)
    check_slab(srT, dtype, device, sb)
    check_lane_major("dfT", dfT, dtype, device, 3, m)
    return device, dtype, m


def _launch_forces_bwd_rows(sb, f9T, srT, dfT, h):
    """df9T (9, m): the forward K2's structure, a lane per row, four warps
    splitting the slab."""
    device, dtype, m = _check_forces_bwd(sb, f9T, srT, dfT, False)
    whole_pieces(sb, RAGGED_CHUNK, "forces_warp_v4_bwd_rows")
    aligned("srT", srT, lane_major=True)
    df9 = torch.empty((9, m), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return df9
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "forces_warp_v4_bwd_rows", dtype, srT.dtype)(
        sb.schedule.data_ptr(), sb.n_tiles, sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(),
        srT.data_ptr(), srT.stride(0), dfT.data_ptr(), dfT.stride(0),
        df9.data_ptr(), df9.stride(0), sb.group, inv_h, c4h, stream())
    raise_on(rc, "forces_warp_v4_bwd_rows")
    counter(forces_warp_v4_bwd_rows, srT).launches += 1
    return df9


def _launch_forces_bwd_slab(sb, f9T, srT, dfT, h):
    """dsr (15, n_entries): a block per 128-entry chunk of every slab."""
    device, dtype, m = _check_forces_bwd(sb, f9T, srT, dfT, True)
    dsr = torch.empty((SR_FIELDS, n_entries(sb)), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return dsr
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "forces_warp_v4_bwd_slab", dtype, srT.dtype)(
        sb.chunks.data_ptr(), sb.chunks.shape[0], sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(),
        f9T.data_ptr(), f9T.stride(0), srT.data_ptr(), srT.stride(0),
        dfT.data_ptr(), dfT.stride(0), dsr.data_ptr(), dsr.stride(0),
        sb.group, inv_h, c4h, stream())
    raise_on(rc, "forces_warp_v4_bwd_slab")
    counter(forces_warp_v4_bwd_slab, srT).launches += 1
    return dsr


def _launch_slab_to_slots(buf, slab_ptr, slab_idx, n_slots, group):
    device, dtype = buf.device, buf.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    check_lane_major("buf", buf, dtype, device, buf.shape[0])
    check("slab_ptr", slab_ptr, torch.int32, device, 1)
    check("slab_idx", slab_idx, torch.int32, device, 1)
    if slab_ptr.shape[0] != n_slots // group + 1 or n_slots % group:
        raise ValueError(f"slab_ptr has {slab_ptr.shape[0]} entries for "
                         f"{n_slots} slots in groups of {group}")
    if buf.shape[1] % group or buf.shape[1] < slab_idx.shape[0] * group:
        raise ValueError(f"buf has {buf.shape[1]} entries, the index reads "
                         f"{slab_idx.shape[0] * group} in groups of {group}")
    if not (slab_ptr.is_contiguous() and slab_idx.is_contiguous()):
        raise ValueError("slab_ptr and slab_idx must be contiguous")
    k = buf.shape[0]
    out = torch.empty((k, n_slots), dtype=dtype, device=device)
    if k == 0 or n_slots == 0:
        return out
    rc = entry("pair_kernels", "slab_to_slots", dtype)(
        buf.data_ptr(), buf.stride(0), slab_ptr.data_ptr(), slab_idx.data_ptr(),
        out.data_ptr(), out.stride(0), k, n_slots, group, stream())
    raise_on(rc, "slab_to_slots")
    slab_to_slots.launches += 1
    return out


def _launch_slab_to_slots_bf16(buf, slab_ptr, slab_idx, bstart, n_slots, group):
    device = buf.device
    check_lane_major("buf", buf, torch.float32, device, buf.shape[0])
    check("slab_ptr", slab_ptr, torch.int32, device, 1)
    check("slab_idx", slab_idx, torch.int32, device, 1)
    check("bstart", bstart, torch.int32, device, 1)
    if slab_ptr.shape[0] != n_slots // group + 1 or n_slots % group:
        raise ValueError(f"slab_ptr has {slab_ptr.shape[0]} entries for "
                         f"{n_slots} slots in groups of {group}")
    if buf.shape[1] % group or buf.shape[1] < slab_idx.shape[0] * group:
        raise ValueError(f"buf has {buf.shape[1]} entries, the index reads "
                         f"{slab_idx.shape[0] * group} in groups of {group}")
    if not (slab_ptr.is_contiguous() and slab_idx.is_contiguous()
            and bstart.is_contiguous()) or bstart.shape[0] == 0:
        raise ValueError("slab_ptr, slab_idx and a non-empty bstart must be contiguous")
    # the kernel reads 4 slots of a field with one 16-byte load, 16 fields
    # at most (two lanes a field), and holds a bucket start a lane
    if group % 4:
        raise ValueError(f"the bf16 scatter takes slot groups of a multiple of 4, "
                         f"got {group}")
    if buf.shape[0] > 16 or bstart.shape[0] > 32:
        raise ValueError(f"the bf16 scatter takes at most 16 fields and 32 buckets, "
                         f"got {buf.shape[0]} and {bstart.shape[0]}")
    if buf.data_ptr() % 16 or buf.stride(0) % 4:
        raise ValueError("buf must be 16-byte aligned with a row stride that is a "
                         "multiple of 4")
    k = buf.shape[0]
    out = torch.empty((k, n_slots), dtype=torch.bfloat16, device=device)
    if k == 0 or n_slots == 0:
        return out
    rc = _build.library("pair_kernels").sb_slab_to_slots_bf16(
        buf.data_ptr(), buf.stride(0), slab_ptr.data_ptr(), slab_idx.data_ptr(),
        bstart.data_ptr(), bstart.shape[0], out.data_ptr(), out.stride(0), k, n_slots,
        group, stream())
    raise_on(rc, "slab_to_slots_bf16")
    slab_to_slots_bf16.launches += 1
    return out


# ------------------------------------------------------------ device dispatch
def moments_v4(sb, posT, posT_rows, h):
    """K1 over every tile of the scene ``sb``: centered moments ayT (18, m)
    from posT (3, n_slots) and the tile rows' posT_rows (3, m); one launch
    on the card, :func:`moments_v4_scene_plain` on the CPU."""
    fn = on("moments_v4", posT, moments_v4_scene_plain, _launch_moments)
    return fn(sb, posT, posT_rows, h)


@bf16_counted
def forces_warp_v4(sb, f9T, srT, h):
    """K2 over every tile of the scene ``sb``: Warp-pairing termj fT (3, m)
    from f9T (9, m) and srT (15, n_slots); one launch on the card,
    :func:`forces_warp_v4_scene_plain` on the CPU."""
    fn = on("forces_warp_v4", srT, forces_warp_v4_scene_plain, _launch_forces)
    return fn(sb, f9T, srT, h)


def moments_v4_bwd(sb, dayT, h):
    """K1 backward over every tile of the scene ``sb``: (dps (3, n_entries),
    dprowT (3, m)); one launch on the card, :func:`moments_v4_bwd_scene_plain`
    on the CPU."""
    fn = on("moments_v4_bwd", dayT, moments_v4_bwd_scene_plain, _launch_moments_bwd)
    return fn(sb, dayT, h)


@bf16_counted
def forces_warp_v4_bwd_rows(sb, f9T, srT, dfT, h):
    """The K2 backward's row pass over the scene: df9T (9, m)."""
    fn = on("forces_warp_v4_bwd_rows", dfT,
            lambda *a: forces_warp_v4_bwd_scene_plain(*a)[0], _launch_forces_bwd_rows)
    return fn(sb, f9T, srT, dfT, h)


@bf16_counted
def forces_warp_v4_bwd_slab(sb, f9T, srT, dfT, h):
    """The K2 backward's slab pass over the scene: dsr (15, n_entries)."""
    fn = on("forces_warp_v4_bwd_slab", dfT,
            lambda *a: forces_warp_v4_bwd_scene_plain(*a)[1], _launch_forces_bwd_slab)
    return fn(sb, f9T, srT, dfT, h)


def forces_warp_v4_bwd(sb, f9T, srT, dfT, h):
    """K2 backward over the scene: (df9T (9, m), dsr (15, n_entries)); see
    :func:`forces_warp_v4_bwd_scene_plain`.  On the card two kernels, one
    launch each: the row pass and the slab pass."""
    if dfT.device.type == "cpu":
        return forces_warp_v4_bwd_scene_plain(sb, f9T, srT, dfT, h)
    return (forces_warp_v4_bwd_rows(sb, f9T, srT, dfT, h),
            forces_warp_v4_bwd_slab(sb, f9T, srT, dfT, h))


def slab_to_slots(buf, slab_ptr, slab_idx, n_slots, group):
    """Fixed-order scatter-reduce (k, n_entries) -> (k, n_slots); see
    :func:`slab_to_slots_plain` and :func:`slab_inverse`."""
    fn = on("slab_to_slots", buf, slab_to_slots_plain, _launch_slab_to_slots)
    return fn(buf, slab_ptr, slab_idx, n_slots, group)


def slab_to_slots_bf16(buf, slab_ptr, slab_idx, bstart, n_slots, group):
    """The bf16 K2 slab's cotangent scatter (k, n_entries) float32 ->
    (k, n_slots) bfloat16; see :func:`slab_to_slots_bf16_plain`."""
    fn = on("slab_to_slots_bf16", buf, slab_to_slots_bf16_plain,
            _launch_slab_to_slots_bf16)
    return fn(buf, slab_ptr, slab_idx, bstart, n_slots, group)


def slab_cotangent(ops, dsr, sb, srT):
    """The slab cotangent of a K2 backward, (15, n_slots) in srT's dtype:
    ``ops.to_slots``, or on a bf16 slab ``ops.to_slots_bf16`` (its rounding
    is the JAX package's)."""
    if srT.dtype != torch.bfloat16:
        return ops.to_slots(dsr, sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
    return ops.to_slots_bf16(dsr, sb.slab_ptr, sb.slab_idx, sb.bucket_starts,
                             sb.n_slots, sb.group)


COUNTED = ((moments_v4, forces_warp_v4, moments_v4_bwd, forces_warp_v4_bwd_rows,
           forces_warp_v4_bwd_slab, slab_to_slots) + fk.COUNTED + sk.COUNTED + mk.COUNTED
           + gk.COUNTED)
# the six K2 kernels on a bfloat16 slab (cfg.pair_dtype), counted apart
BF16_COUNTED = tuple(fn.bf16 for fn in (forces_warp_v4, forces_warp_v4_bwd_rows,
                                        forces_warp_v4_bwd_slab, fk.forces_warp_v2,
                                        fk.forces_warp_v2_bwd_rows,
                                        fk.forces_warp_v2_bwd_slab)) + (slab_to_slots_bf16,)


def reset_launch_counts():
    for fn in COUNTED + BF16_COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}, every path's kernels
    (the bfloat16-slab K2 kernels as ``<name>_bf16``)."""
    return {fn.__name__: fn.launches for fn in COUNTED + BF16_COUNTED}


reset_launch_counts()


# ------------------------------------------------------- differentiable ops
class PairOps(NamedTuple):
    """The pair functions an evaluation goes through (each over the whole
    scene but the raw K1, per bucket), of the v4 path, the fused path and
    the blocked layout's raw K1 and K2 v2 (``ops/fused_kernels.py``), the
    Taichi pairing's separable K2 (``ops/separable_kernels.py``), the
    mid-section and its VJP between K1 and K2 (``ops/mid_kernels.py``) and
    the gather backend's moments and forces and their VJPs
    (``ops/gather_kernels.py``): :data:`KERNELS` (device dispatch) or
    :data:`PLAIN` (the plain versions on any device, the yardstick the
    kernels are held against on the card)."""

    moments: Callable
    forces: Callable
    moments_bwd: Callable
    forces_bwd: Callable
    to_slots: Callable
    moments_mid: Callable
    forces_v2: Callable
    moments_raw_bwd: Callable
    forces_v2_bwd: Callable
    moments_raw: Callable
    forces_sep: Callable
    forces_sep_bwd: Callable
    to_slots_bf16: Callable
    mid_records: Callable
    mid_records_bwd: Callable
    gather_moments: Callable
    gather_moments_bwd: Callable
    gather_forces: Callable
    gather_forces_bwd: Callable


KERNELS = PairOps(moments_v4, forces_warp_v4, moments_v4_bwd,
                  forces_warp_v4_bwd, slab_to_slots, fk.moments_mid,
                  fk.forces_warp_v2, fk.moments_raw_bwd, fk.forces_warp_v2_bwd,
                  fk.moments_raw, sk.forces_sep, sk.forces_sep_bwd, slab_to_slots_bf16,
                  mk.mid_records, mk.mid_records_bwd, gk.gather_moments,
                  gk.gather_moments_bwd, gk.gather_forces, gk.gather_forces_bwd)
PLAIN = PairOps(moments_v4_scene_plain, forces_warp_v4_scene_plain,
                moments_v4_bwd_scene_plain, forces_warp_v4_bwd_scene_plain,
                slab_to_slots_plain,
                fk.moments_mid_scene_plain, fk.forces_warp_v2_scene_plain,
                fk.moments_raw_bwd_scene_plain, fk.forces_warp_v2_bwd_scene_plain,
                fk.moments_raw_plain, sk.forces_sep_scene_plain,
                sk.forces_sep_bwd_scene_plain, slab_to_slots_bf16_plain,
                mk.mid_records_plain, mk.mid_records_bwd_plain, gk.gather_moments_plain,
                gk.gather_moments_bwd_plain, gk.gather_forces_plain,
                gk.gather_forces_bwd_plain)


class _MomentsV4(torch.autograd.Function):
    """K1 over every bucket: (posT (3, n_slots), posT_rows (3, m)) ->
    ayT (18, m).  ``posT_rows`` is a view of ``posT``: autograd adds the
    two cotangents."""

    @staticmethod
    def forward(ctx, posT, posT_rows, sb, h, ops):
        ctx.sb, ctx.h, ctx.ops = sb, h, ops
        return ops.moments(sb, posT, posT_rows, h)

    @staticmethod
    @once_differentiable
    def backward(ctx, dayT):
        sb, ops = ctx.sb, ctx.ops
        dps, dprow = ops.moments_bwd(sb, dayT.contiguous(), ctx.h)
        dposT = ops.to_slots(dps, sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
        return dposT, dprow, None, None, None


class _ForcesWarpV4(torch.autograd.Function):
    """K2 over every bucket: (f9T (9, m), srT (15, n_slots)) -> termjT (3, m);
    srT may be bfloat16 (``cfg.pair_dtype``), the arithmetic f9T's."""

    @staticmethod
    def forward(ctx, f9T, srT, sb, h, ops):
        ctx.sb, ctx.h, ctx.ops = sb, h, ops
        ctx.save_for_backward(f9T, srT)
        return ops.forces(sb, f9T, srT, h)

    @staticmethod
    @once_differentiable
    def backward(ctx, dfT):
        sb, ops = ctx.sb, ctx.ops
        f9T, srT = ctx.saved_tensors
        df9, dsr = ops.forces_bwd(sb, f9T, srT, dfT.contiguous(), ctx.h)
        return df9, slab_cotangent(ops, dsr, sb, srT), None, None, None


def moments_all(posT, posT_rows, sb, h, ops: PairOps = KERNELS):
    """Differentiable K1 over every bucket of ``sb`` (a SparseBlocked):
    ayT (18, m), one K1 launch on the card.  Its backward is one K1
    backward launch, then one :func:`slab_to_slots`."""
    return _MomentsV4.apply(posT, posT_rows, sb, h, ops)


def forces_all(f9T, srT, sb, h, ops: PairOps = KERNELS):
    """Differentiable K2 over every bucket of ``sb``: termjT (3, m), one K2
    launch on the card.  Its backward is one launch of each K2 backward
    pass, then one :func:`slab_to_slots`."""
    return _ForcesWarpV4.apply(f9T, srT, sb, h, ops)
