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
layout's raw K1 (``ops/fused_kernels.py``) and the Taichi pairing's
separable K2 (``ops/separable_kernels.py``), and :func:`launch_counts`
counts every path's kernels.  The kernels read their slab operands
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
from . import separable_kernels as sk
from .pair_common import (SR_FIELDS, bucket_cols, centered_moments, check,
                          check_lane_major, entry, flat_entries,
                          on, raise_on, raw_moments_bwd, spline_constants,
                          stream, warp_termj, warp_termj_bwd)


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


# Slab entries per block of the backward's slab side (csrc/pair_kernels.cu BCH).
BWD_CHUNK = 128


def chunk_schedule(sched, chunk: int = BWD_CHUNK):
    """The backward slab side's schedule (host, numpy): one row per
    ``chunk``-entry piece of every tile's slab, [tile, slab, st_off, gi_off,
    e0] (a row of the tile schedule ``sched`` and the piece's first entry),
    int64, in tile order and entry order within a tile.  Every piece is the
    same work, so no order balances better than another; tile order keeps
    neighbouring blocks on neighbouring memory."""
    sched = np.asarray(sched, np.int64)
    odd = sorted({int(s) for s in sched[:, 1] if s % chunk})
    if odd:
        raise ValueError(f"slabs {odd} are not multiples of {chunk}")
    sched = sched[np.argsort(sched[:, 0], kind="stable")]
    n = sched[:, 1] // chunk
    first = np.repeat(np.cumsum(n) - n, n)
    e0 = (np.arange(int(n.sum()), dtype=np.int64) - first) * chunk
    return np.concatenate([np.repeat(sched, n, axis=0), e0[:, None]], axis=1)


def sparse_blocked(parts, rs6T, n_slots: int, group: int, real, device, dtype,
                   rows: int = _build.ROWS) -> SparseBlocked:
    """A :class:`SparseBlocked` on ``device`` from host buckets ``parts``:
    per bucket (gidx8 (t_b, slab_b / group), restT_rows (t_b, 3, rows),
    static_slab (t_b, 5, slab_b), tile_start), numpy, holding tiles
    [0, n_tiles) in order; rs6T (6, n_tiles * rows); ``real`` (n_slots,)
    marks the particle slots (:func:`slab_inverse`).  The buckets' arrays
    are views of the scene-wide ``rest_rows`` / ``static_all`` /
    ``gidx_all``, which the ragged kernels read through ``schedule`` and
    ``chunks``."""
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
    sched = tile_schedule(counts, [b.slab_len for b in buckets], starts, group)
    return SparseBlocked(
        buckets=tuple(buckets), rs6T=dev(rs6T, dtype), rows=rows,
        n_tiles=sum(counts), n_slots=n_slots, group=group,
        slab_ptr=dev(ptr, torch.int32), slab_idx=dev(idx, torch.int32),
        rest_rows=rest_rows, static_all=static_all, gidx_all=gidx_all,
        schedule=dev(sched, torch.int64),
        chunks=dev(chunk_schedule(sched), torch.int64))


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


# ------------------------------------------------------------ kernel launches
# The ragged kernels' stage: slab entries copied per pass, in 16-byte pieces.
RAGGED_CHUNK = 32


def _aligned(name, x, lane_major=False):
    """The ragged kernels copy 16-byte pieces: a 16-byte base and, for a
    lane-major operand, a row stride of a multiple of 4 elements."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary "
                         f"(address {x.data_ptr():#x})")
    if lane_major and x.stride(0) % 4:
        raise ValueError(f"{name}'s leading dimension must be a multiple of 4 "
                         f"elements, got {x.stride(0)}")


def n_entries(sb) -> int:
    """Slab entries of the scene, sum_b t_b slab_b: the columns of a
    per-slab-entry buffer."""
    return sb.gidx_all.shape[0] * sb.group


def _check_scene(sb, dtype, device, chunks=False):
    """Operand checks of one ragged launch over ``sb`` (with ``chunks``, of
    the backward's slab side, also its chunk schedule)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    check("rest_rows", sb.rest_rows, dtype, device, 3)
    check("static_all", sb.static_all, dtype, device, 1)
    check("gidx_all", sb.gidx_all, torch.int32, device, 1)
    check("schedule", sb.schedule, torch.int64, device, 2)
    if (tuple(sb.rest_rows.shape) != (sb.n_tiles, 3, _build.ROWS)
            or tuple(sb.schedule.shape) != (sb.n_tiles, 4)):
        raise ValueError(f"rest_rows {tuple(sb.rest_rows.shape)} and schedule "
                         f"{tuple(sb.schedule.shape)} must cover {sb.n_tiles} "
                         f"tiles of {_build.ROWS} rows")
    for name in ("rest_rows", "static_all", "gidx_all", "schedule"):
        if not getattr(sb, name).is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    piece = 16 // sb.static_all.element_size()
    if sb.group % piece or RAGGED_CHUNK % sb.group:
        raise ValueError(f"slot groups of {sb.group}: the kernels copy "
                         f"{piece}-element pieces of {RAGGED_CHUNK}-entry stages")
    odd = [b.slab_len for b in sb.buckets if b.slab_len % RAGGED_CHUNK]
    if odd:
        raise ValueError(f"slabs {odd} are not multiples of {RAGGED_CHUNK}")
    _aligned("static_all", sb.static_all)
    _aligned("gidx_all", sb.gidx_all)
    if chunks:
        check("chunks", sb.chunks, torch.int64, device, 2)
        want = (n_entries(sb) // BWD_CHUNK, 5)
        if tuple(sb.chunks.shape) != want or not sb.chunks.is_contiguous():
            raise ValueError(f"chunks {tuple(sb.chunks.shape)} must be a contiguous "
                             f"{want}: every {BWD_CHUNK}-entry piece of every slab")


RAGGED = ("moments_v4", "forces_warp_v4", "moments_v4_bwd",
          "forces_warp_v4_bwd_rows", "forces_warp_v4_bwd_slab")


def ragged_info() -> dict:
    """What the card gives the whole-scene kernels: {(kernel, dtype):
    {registers, static_smem, local_bytes, dynamic_smem, blocks_per_sm,
    threads}} (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Needs a card."""
    lib = _build.library("pair_kernels")
    keys = ("registers", "static_smem", "local_bytes", "dynamic_smem",
            "blocks_per_sm", "threads")
    out = {}
    for which, name in enumerate(RAGGED):
        for f64, dtype in enumerate(("float32", "float64")):
            buf = (ctypes.c_int * len(keys))()
            raise_on(lib.sb_ragged_info(which, f64, buf), f"{name} attributes")
            out[name, dtype] = dict(zip(keys, buf))
    return out


def _launch_moments(sb, posT, posT_rows, h):
    device, dtype = posT.device, posT.dtype
    _check_scene(sb, dtype, device)
    m = sb.n_tiles * sb.rows
    check_lane_major("posT", posT, dtype, device, 3, sb.n_slots)
    check_lane_major("posT_rows", posT_rows, dtype, device, 3, m)
    _aligned("posT", posT, lane_major=True)
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
    device, dtype = srT.device, srT.dtype
    _check_scene(sb, dtype, device)
    m = sb.n_tiles * sb.rows
    check_lane_major("f9T", f9T, dtype, device, 9, m)
    check_lane_major("srT", srT, dtype, device, SR_FIELDS, sb.n_slots)
    _aligned("srT", srT, lane_major=True)
    out = torch.empty((3, m), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return out
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "forces_warp_v4", dtype)(
        sb.schedule.data_ptr(), sb.n_tiles, sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(),
        f9T.data_ptr(), f9T.stride(0), srT.data_ptr(), srT.stride(0),
        out.data_ptr(), out.stride(0), sb.group, inv_h, c4h, stream())
    raise_on(rc, "forces_warp_v4")
    forces_warp_v4.launches += 1
    return out


def _launch_moments_bwd(sb, dayT, h):
    """(dps (3, n_entries), dprowT (3, m)): a block per 128-entry chunk of
    every slab."""
    device, dtype = dayT.device, dayT.dtype
    _check_scene(sb, dtype, device, chunks=True)
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
    _check_scene(sb, dtype, device, chunks)
    m = sb.n_tiles * sb.rows
    check_lane_major("f9T", f9T, dtype, device, 9, m)
    check_lane_major("srT", srT, dtype, device, SR_FIELDS, sb.n_slots)
    check_lane_major("dfT", dfT, dtype, device, 3, m)
    return device, dtype, m


def _launch_forces_bwd_rows(sb, f9T, srT, dfT, h):
    """df9T (9, m): the forward K2's structure, a lane per row, four warps
    splitting the slab."""
    device, dtype, m = _check_forces_bwd(sb, f9T, srT, dfT, False)
    _aligned("srT", srT, lane_major=True)
    df9 = torch.empty((9, m), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return df9
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "forces_warp_v4_bwd_rows", dtype)(
        sb.schedule.data_ptr(), sb.n_tiles, sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(),
        srT.data_ptr(), srT.stride(0), dfT.data_ptr(), dfT.stride(0),
        df9.data_ptr(), df9.stride(0), sb.group, inv_h, c4h, stream())
    raise_on(rc, "forces_warp_v4_bwd_rows")
    forces_warp_v4_bwd_rows.launches += 1
    return df9


def _launch_forces_bwd_slab(sb, f9T, srT, dfT, h):
    """dsr (15, n_entries): a block per 128-entry chunk of every slab."""
    device, dtype, m = _check_forces_bwd(sb, f9T, srT, dfT, True)
    dsr = torch.empty((SR_FIELDS, n_entries(sb)), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return dsr
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "forces_warp_v4_bwd_slab", dtype)(
        sb.chunks.data_ptr(), sb.chunks.shape[0], sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(),
        f9T.data_ptr(), f9T.stride(0), srT.data_ptr(), srT.stride(0),
        dfT.data_ptr(), dfT.stride(0), dsr.data_ptr(), dsr.stride(0),
        sb.group, inv_h, c4h, stream())
    raise_on(rc, "forces_warp_v4_bwd_slab")
    forces_warp_v4_bwd_slab.launches += 1
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


# ------------------------------------------------------------ device dispatch
def moments_v4(sb, posT, posT_rows, h):
    """K1 over every tile of the scene ``sb``: centered moments ayT (18, m)
    from posT (3, n_slots) and the tile rows' posT_rows (3, m); one launch
    on the card, :func:`moments_v4_scene_plain` on the CPU."""
    fn = on("moments_v4", posT, moments_v4_scene_plain, _launch_moments)
    return fn(sb, posT, posT_rows, h)


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


def forces_warp_v4_bwd_rows(sb, f9T, srT, dfT, h):
    """The K2 backward's row pass over the scene: df9T (9, m)."""
    fn = on("forces_warp_v4_bwd_rows", dfT,
            lambda *a: forces_warp_v4_bwd_scene_plain(*a)[0], _launch_forces_bwd_rows)
    return fn(sb, f9T, srT, dfT, h)


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


COUNTED = (moments_v4, forces_warp_v4, moments_v4_bwd, forces_warp_v4_bwd_rows,
           forces_warp_v4_bwd_slab, slab_to_slots) + fk.COUNTED + sk.COUNTED


def reset_launch_counts():
    for fn in COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}, every path's kernels."""
    return {fn.__name__: fn.launches for fn in COUNTED}


reset_launch_counts()


# ------------------------------------------------------- differentiable ops
class PairOps(NamedTuple):
    """The pair functions an evaluation goes through (K1 and K2 of the v4
    path and their backwards over the whole scene, every other one per
    bucket), of the v4 path, the fused path and the blocked layout's raw K1
    (``ops/fused_kernels.py``) and the Taichi pairing's separable K2
    (``ops/separable_kernels.py``): :data:`KERNELS` (device dispatch) or
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


KERNELS = PairOps(moments_v4, forces_warp_v4, moments_v4_bwd,
                  forces_warp_v4_bwd, slab_to_slots, fk.moments_mid,
                  fk.forces_warp_v2, fk.moments_raw_bwd, fk.forces_warp_v2_bwd,
                  fk.moments_raw, sk.forces_sep, sk.forces_sep_bwd)
PLAIN = PairOps(moments_v4_scene_plain, forces_warp_v4_scene_plain,
                moments_v4_bwd_scene_plain, forces_warp_v4_bwd_scene_plain,
                slab_to_slots_plain,
                fk.moments_mid_plain, fk.forces_warp_v2_plain,
                fk.moments_raw_bwd_plain, fk.forces_warp_v2_bwd_plain,
                fk.moments_raw_plain, sk.forces_sep_plain, sk.forces_sep_bwd_plain)


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
    """K2 over every bucket: (f9T (9, m), srT (15, n_slots)) -> termjT (3, m)."""

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
        dsrT = ops.to_slots(dsr, sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
        return df9, dsrT, None, None, None


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
