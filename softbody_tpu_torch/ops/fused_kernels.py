"""The pair kernels of the fused K1 + mid-section path (``cfg.fused_mid``),
forward and backward, and the blocked layout's raw K1 with its backward.

Counterpart of ``softbody_tpu/ops/pallas/pair_kernels.py`` +
``softbody_tpu/ops/pallas/packed.py`` for the fused branch of
``softbody_tpu/sim/sparse.py:340-381`` and for ``packed.moments_packed``:

* :func:`moments_mid` replaces ``_moments_mid_kernel`` (launched by
  ``packed._fused_call``): K1's moments and the whole per-row mid-section
  in one kernel, emitting the K2 operand records fmT (19, m) =
  [F_9 | M_9 | V_i] and srT (15, n_slots) = [S_6 | R^T_9] (its padding
  columns zero), and for the backward the A | Y rows ayT (18, m).
* :func:`forces_warp_v2` replaces ``_forces_warp_kernel_v2`` (launched by
  ``packed._forces_warp_packed_fwd``): the Warp pairing with term_i and the
  0.5 V_i scale in the kernel, fT (3, m).
* :func:`moments_raw_bwd` replaces ``_moments_bwd_kernel`` (launched by
  ``_moments_vjp_bwd`` from ``packed._fused_vjp_bwd`` and from
  ``moments_packed``'s VJP): dayT -> dps (3, n_entries), the slab side of
  K1's VJP, and on the fused path (``rows=True``) also dprow (3, m) =
  -sum_blk dayT[3 blk + a] rs6T[blk], the row side against the scene's
  static row sums.
* :func:`forces_warp_v2_bwd` replaces ``_forces_warp_bwd_kernel_v2``
  (launched by ``_forces_warp_bwd_impl``): dfT -> dfmT (19, m) =
  [dF_9 | dM_9 | 0] and dsr (15, n_entries); on the card two kernels, the
  row pass and the slab pass.
* :func:`moments_raw` replaces ``_moments_kernel`` (launched by
  ``_moments_fwd_impl`` from ``packed.moments_packed``) and the inner
  kernel of ``_moments_fwd_manual`` (the same function, TPU-only manual
  DMA): the raw, uncentered K1 dots ayT (18, m) of the blocked layout.
  The caller subtracts pos_i * rs6 with rs6 from this same kernel on an
  all-ones RHS (``sim/blocked.build_blocked_scene``), never with a host
  row sum; its backward is :func:`moments_raw_bwd` without the row term.
  K2 v2 and the raw K1 are also the blocked layout's pair kernels
  (``sim/blocked.py``).

Every one but :func:`moments_raw` takes a whole scene (a SparseBlocked or
a Blocked: its ``schedule`` and ``chunks``) and launches once per
evaluation, as K1/K2 v4 and their backwards do: ``moments_mid`` is K1 v4's
kernel of csrc/pair_kernels.cu with the mid-section (csrc/mid.cuh) as its
epilogue, ``moments_raw_bwd`` the K1 v4 backward's body without the row
term where the caller keeps it (and for slabs that end inside a chunk),
K2 v2 and its passes K2 v4's kernels with the v2 record's epilogue,
svnw_b = sum_j gfac V_j dx_b read from the scene's static row sums
rs6T[3:6] (the same function as the TPU kernel's in-kernel sum; the plain
versions sum it over the slab, as the TPU kernel does).  A per-entry
output is the (k, n_entries) buffer ``slab_to_slots`` reads, a tile's
entry s at column gi_off * group + s.  Their plain yardsticks stay per
bucket (``*_plain``) and ``*_scene_plain`` runs them over the buckets
into the whole-scene outputs (what the wrappers run on the CPU, and
``PLAIN``).  :func:`moments_raw` launches per bucket (csrc/fused_kernels.cu).

The JAX layouts fm (t, rows, 19) / sr (t, rows, 16) become lane-major
(19, m) / (15, n_slots), the layouts of the v4 path, so srT is the v4
path's per-slot K2 record and K2 reads it through ``gidx8`` as the v4 K2
does.  The K1 stage centers in the kernel as ``moments_v4`` does
(csrc/pair_kernels.cu says why): A | Y are the v4 path's.  The per-row
static operands are the scene's own lane-major arrays (:class:`RowStatic`:
JAX's ``stat_rows`` record, ``sim/sparse.py:240-244``, left in place).

Each kernel has a plain PyTorch version (``*_plain``) for CPU tensors; for
CUDA tensors the wrapper launches the hand-written kernel and counts it in
its ``launches`` attribute; any other device raises.
:func:`moments_mid_all` / :func:`moments_raw_all` / :func:`forces_v2_all`
are the differentiable ops over a scene, going through a
``pair_kernels.PairOps`` (its ``KERNELS`` or ``PLAIN`` table).  The
backward of :func:`moments_mid_all` rebuilds the mid-section from the
saved A | Y under autograd (the port's counterpart of ``packed._mid_xla``;
the polar through its clamped VJP), then runs one :func:`moments_raw_bwd`
and one ``slab_to_slots``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..sim.blocked import mid_rows
from .pair_common import (BWD_CHUNK, RAGGED_CHUNK, SR_FIELDS, _no_tf32, aligned,
                          bucket_cols, centered_moments, check_lane_major,
                          check_scene, check_tiles, check_vector, entry,
                          flat_entries, has_tail, k1_lhs, n_entries, on,
                          raise_on, raw_moments_bwd, slab_slots,
                          spline_constants, stream, tile_chunked, warp_nw,
                          warp_termj, warp_termj_bwd, whole_pieces)

FM_FIELDS = 19     # rows of fmT: F_9 | M_9 | V_i
SWEEPS = 8         # Jacobi sweeps of the polar (mat3.polar3's default)


class RowStatic(NamedTuple):
    """The fused kernel's per-row static operands, lane-major views of the
    scene's arrays: mu / lam / vol (k,), rcT (9, k) the rest correction,
    row 3a+b = rc[a][b].  (The static row sums, the rest of JAX's
    ``stat_rows`` record, are the scene's own ``rs6T``.)"""

    mu: torch.Tensor
    lam: torch.Tensor
    vol: torch.Tensor
    rcT: torch.Tensor

    def cols(self, c: slice) -> "RowStatic":
        return RowStatic(self.mu[c], self.lam[c], self.vol[c], self.rcT[:, c])


def row_static(sb, mats, rest_corr) -> RowStatic:
    """The :class:`RowStatic` of every tile row of a scene: ``sb`` its
    SparseBlocked, ``mats`` its Materials, ``rest_corr`` (3, 3, m)."""
    m = sb.n_tiles * sb.rows
    return RowStatic(mats.mu[:m], mats.lam[:m], mats.volume[:m], rest_corr.reshape(9, m))


# ------------------------------------------------------------- plain versions
def mid_records(ayT, rs: RowStatic, scale, corotated: bool):
    """The mid-section from K1's A | Y rows ayT (18, k): (fmT (19, k),
    srT (15, k)).  Differentiable (the polar through its clamped VJP)."""
    A = [[ayT[3 * b + a] for b in range(3)] for a in range(3)]
    Y = [[ayT[9 + 3 * b + a] for b in range(3)] for a in range(3)]
    R, F, S, M = mid_rows(A, Y, rs.rcT.unflatten(0, (3, 3)), rs.mu, rs.lam,
                          scale, corotated)
    fmT = torch.stack([F[a][b] for a in range(3) for b in range(3)]
                      + [M[a][b] for a in range(3) for b in range(3)] + [rs.vol])
    srT = torch.stack([S[0][0], S[0][1], S[0][2], S[1][1], S[1][2], S[2][2]]
                      + [R[a][c] for c in range(3) for a in range(3)])
    return fmT, srT


def moments_mid_plain(restT_rows, static_slab, posT, posT_rows, rs: RowStatic,
                      scale, gidx8, h, corotated, emit_ay=False):
    """Plain fused K1 + mid-section of one bucket: (fmT (19, t*rows),
    srT (15, t*rows), ayT (18, t*rows) or None).  The K1 stage is
    :func:`~.pair_common.centered_moments`; scale (t*rows,) is the rows'
    stiffness scale."""
    ayT = centered_moments(restT_rows, static_slab, posT, posT_rows, gidx8, h)
    fmT, srT = mid_records(ayT, rs, scale, corotated)
    return fmT, srT, (ayT if emit_ay else None)


def _svnw(restT_rows, static_slab, h):
    """sum_j nw over each row's slab: 3 x (t*rows,)."""
    return [n.sum(dim=2).reshape(-1) for n in warp_nw(restT_rows, static_slab, h)]


@tile_chunked(tile_args=(0, 1, 4), row_args=(2,))
def forces_warp_v2_plain(restT_rows, static_slab, fmT, srT, gidx8, h):
    """Plain K2 v2: fT (3, t*rows), f_a = 0.5 V_i (termj_a +
    sum_b M_i[a][b] svnw_b) with termj the Warp pairing sum of
    :func:`~.pair_common.warp_termj` and svnw = sum_j gfac V_j dx."""
    termj = warp_termj(restT_rows, static_slab, fmT[0:9], srT, gidx8, h)
    sv = _svnw(restT_rows, static_slab, h)
    half_v = 0.5 * fmT[18]
    return torch.stack([
        half_v * (termj[a] + sum(fmT[9 + 3 * a + b] * sv[b] for b in range(3)))
        for a in range(3)])


@tile_chunked(tile_args=(0, 1, 3), row_args=())
def moments_raw_plain(restT_rows, static_slab, posT, gidx8, h):
    """Plain raw K1 (``_moments_kernel``): the uncentered dots ayT
    (18, t*rows), row 3 blk + a = sum_j lhs_blk pos_j[a] with lhs =
    [-w m_j dx ; gfac V_j dx]; posT (3, n_slots)."""
    _no_tf32()
    t, _, rows = restT_rows.shape
    pos_slab = posT[:, slab_slots(gidx8, static_slab.shape[2])]   # (3, t, slab)
    lhs = k1_lhs(restT_rows, static_slab, h)                      # (t, 6, rows, slab)
    return torch.einsum("ats,tbrs->batr", pos_slab, lhs).reshape(18, t * rows)


@tile_chunked(tile_args=(0, 1), row_args=(2,))
def moments_raw_bwd_plain(restT_rows, static_slab, dayT, h):
    """Plain K1 raw backward (``_moments_bwd_kernel``): dayT (18, t*rows) ->
    dpsT (t, 3, slab) (:func:`~.pair_common.raw_moments_bwd`)."""
    return raw_moments_bwd(restT_rows, static_slab, dayT, h)


def moments_mid_scene_plain(sb, posT, posT_rows, rs: RowStatic, scale, h, corotated,
                            emit_ay=False):
    """Plain fused K1 + mid-section over a whole scene: the per-bucket
    :func:`moments_mid_plain` concatenated in tile order, (fmT (19, m),
    srT (15, n_slots) with its n_slots - m padding columns zero, ayT
    (18, m) or None)."""
    parts = []
    for b in sb.buckets:
        c = bucket_cols(b, sb.rows)
        parts.append(moments_mid_plain(b.restT_rows, b.static_slab, posT,
                                       posT_rows[:, c], rs.cols(c), scale[c], b.gidx8,
                                       h, corotated, emit_ay))
    m = sb.n_tiles * sb.rows
    pad = torch.zeros((SR_FIELDS, sb.n_slots - m), dtype=posT.dtype, device=posT.device)
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts] + [pad], dim=1),
            torch.cat([p[2] for p in parts], dim=1) if emit_ay else None)


def moments_raw_bwd_scene_plain(sb, dayT, h, rows=False):
    """Plain raw K1 backward over a whole scene: the per-bucket
    :func:`moments_raw_bwd_plain` placed into dps (3, n_entries)
    (:func:`~.pair_common.flat_entries`' order: a tile's entry s at column
    gi_off * group + s) and, with ``rows``, dprow (3, m) =
    -sum_blk dayT[3 blk + a] * rs6T[blk] against the scene's static row
    sums (else None)."""
    dps = flat_entries([moments_raw_bwd_plain(b.restT_rows, b.static_slab,
                                              dayT[:, bucket_cols(b, sb.rows)], h)
                        for b in sb.buckets], 3)
    if not rows:
        return dps, None
    ct = dayT.reshape(6, 3, sb.n_tiles * sb.rows)
    return dps, -sum(ct[k] * sb.rs6T[k] for k in range(6))


@tile_chunked(tile_args=(0, 1, 4), row_args=(2, 5))
def forces_warp_v2_bwd_plain(restT_rows, static_slab, fmT, srT, gidx8, dfT, h):
    """Plain K2 v2 backward (``_forces_warp_bwd_kernel_v2``): dfT (3, t*rows)
    -> dfmT (19, t*rows) = [dF_9 | dM_9 | 0] and dsrT (t, 15, slab).  With
    df scaled by 0.5 V_i, dF and dsrT are termj's VJP
    (:func:`~.pair_common.warp_termj_bwd`) and dM[3a+b] = df_a svnw_b;
    V_i is a material constant."""
    dfs = dfT * (0.5 * fmT[18])
    df9, dsr = warp_termj_bwd(restT_rows, static_slab, fmT[0:9], srT, gidx8,
                              dfs, h)
    sv = _svnw(restT_rows, static_slab, h)
    dM = torch.stack([dfs[a] * sv[b] for a in range(3) for b in range(3)])
    return torch.cat([df9, dM, torch.zeros_like(dM[:1])]), dsr


def forces_warp_v2_scene_plain(sb, fmT, srT, h):
    """Plain K2 v2 over a whole scene: the per-bucket
    :func:`forces_warp_v2_plain` concatenated in tile order, fT (3, m)."""
    return torch.cat([
        forces_warp_v2_plain(b.restT_rows, b.static_slab,
                             fmT[:, bucket_cols(b, sb.rows)], srT, b.gidx8, h)
        for b in sb.buckets], dim=1)


def forces_warp_v2_bwd_scene_plain(sb, fmT, srT, dfT, h):
    """Plain K2 v2 backward over a whole scene: the per-bucket
    :func:`forces_warp_v2_bwd_plain` placed into the whole-scene outputs,
    dfmT (19, m) and dsr (15, n_entries) (:func:`~.pair_common.flat_entries`'
    order: a tile's entry s at column gi_off * group + s)."""
    parts = [forces_warp_v2_bwd_plain(b.restT_rows, b.static_slab,
                                      fmT[:, bucket_cols(b, sb.rows)], srT, b.gidx8,
                                      dfT[:, bucket_cols(b, sb.rows)], h)
             for b in sb.buckets]
    return (torch.cat([p[0] for p in parts], dim=1),
            flat_entries([p[1] for p in parts], SR_FIELDS))


# ------------------------------------------------------------ kernel launches
def _launch_moments_mid(sb, posT, posT_rows, rs, scale, h, corotated, emit_ay=False):
    """(fmT (19, m), srT (15, n_slots), ayT (18, m) or None): K1 v4's
    kernel with the mid-section as its epilogue, a block per tile of the
    schedule; block 0 also zeroes srT's padding columns."""
    device, dtype = posT.device, posT.dtype
    check_scene(sb, dtype, device)
    whole_pieces(sb, RAGGED_CHUNK, "moments_mid")
    m = sb.n_tiles * sb.rows
    check_lane_major("posT", posT, dtype, device, 3, sb.n_slots)
    check_lane_major("posT_rows", posT_rows, dtype, device, 3, m)
    aligned("posT", posT, lane_major=True)
    check_lane_major("rcT", rs.rcT, dtype, device, 9, m)
    for name in ("mu", "lam", "vol"):
        check_vector(name, getattr(rs, name), dtype, device, m)
    check_vector("scale", scale, dtype, device, m)
    fmT = torch.empty((FM_FIELDS, m), dtype=dtype, device=device)
    srT = torch.empty((SR_FIELDS, sb.n_slots), dtype=dtype, device=device)
    ayT = torch.empty((18, m), dtype=dtype, device=device) if emit_ay else None
    if sb.n_tiles == 0:
        return fmT, srT.zero_(), ayT
    inv_h, c4, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "moments_mid", dtype)(
        sb.schedule.data_ptr(), sb.n_tiles, sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(),
        posT.data_ptr(), posT.stride(0), posT_rows.data_ptr(), posT_rows.stride(0),
        rs.mu.data_ptr(), rs.lam.data_ptr(), rs.vol.data_ptr(),
        rs.rcT.data_ptr(), rs.rcT.stride(0), scale.data_ptr(),
        fmT.data_ptr(), fmT.stride(0), srT.data_ptr(), srT.stride(0),
        None if ayT is None else ayT.data_ptr(), 0 if ayT is None else ayT.stride(0),
        m, sb.n_slots, sb.group, inv_h, c4, c4h, int(corotated), SWEEPS, stream())
    raise_on(rc, "moments_mid")
    moments_mid.launches += 1
    return fmT, srT, ayT


def _check_v2(sb, fmT, srT, dfT=None, chunks=False):
    """Operand checks of one whole-scene K2 v2 launch (with ``chunks``, of
    the backward's slab pass)."""
    device, dtype = srT.device, srT.dtype
    check_scene(sb, dtype, device, chunks)
    m = sb.n_tiles * sb.rows
    check_lane_major("fmT", fmT, dtype, device, FM_FIELDS, m)
    check_lane_major("srT", srT, dtype, device, SR_FIELDS, sb.n_slots)
    if dfT is not None:
        check_lane_major("dfT", dfT, dtype, device, 3, m)
    if not chunks:      # the epilogue's svnw; the ring copies 16-byte pieces of srT
        check_lane_major("rs6T", sb.rs6T, dtype, device, 6, m)
        aligned("srT", srT, lane_major=True)
    return device, dtype, m


def _launch_forces_v2(sb, fmT, srT, h):
    """fT (3, m): a block per tile of the schedule, a lane per row, four
    warps splitting the slab."""
    device, dtype, m = _check_v2(sb, fmT, srT)
    out = torch.empty((3, m), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return out
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "forces_warp_v2", dtype)(
        sb.schedule.data_ptr(), sb.n_tiles, sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(),
        fmT.data_ptr(), fmT.stride(0), srT.data_ptr(), srT.stride(0),
        sb.rs6T.data_ptr(), sb.rs6T.stride(0), out.data_ptr(), out.stride(0),
        sb.group, inv_h, c4h, has_tail(sb, RAGGED_CHUNK), stream())
    raise_on(rc, "forces_warp_v2")
    forces_warp_v2.launches += 1
    return out


def _launch_forces_v2_bwd_rows(sb, fmT, srT, dfT, h):
    """dfmT (19, m): the forward's structure."""
    device, dtype, m = _check_v2(sb, fmT, srT, dfT)
    dfm = torch.empty((FM_FIELDS, m), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return dfm
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "forces_warp_v2_bwd_rows", dtype)(
        sb.schedule.data_ptr(), sb.n_tiles, sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(),
        fmT.data_ptr(), fmT.stride(0), srT.data_ptr(), srT.stride(0),
        sb.rs6T.data_ptr(), sb.rs6T.stride(0), dfT.data_ptr(), dfT.stride(0),
        dfm.data_ptr(), dfm.stride(0), sb.group, inv_h, c4h, has_tail(sb, RAGGED_CHUNK),
        stream())
    raise_on(rc, "forces_warp_v2_bwd_rows")
    forces_warp_v2_bwd_rows.launches += 1
    return dfm


def _launch_forces_v2_bwd_slab(sb, fmT, srT, dfT, h):
    """dsr (15, n_entries): a block per 128-entry chunk of every slab."""
    device, dtype, m = _check_v2(sb, fmT, srT, dfT, chunks=True)
    dsr = torch.empty((SR_FIELDS, n_entries(sb)), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return dsr
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "forces_warp_v2_bwd_slab", dtype)(
        sb.chunks.data_ptr(), sb.chunks.shape[0], sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(),
        fmT.data_ptr(), fmT.stride(0), srT.data_ptr(), srT.stride(0),
        dfT.data_ptr(), dfT.stride(0), dsr.data_ptr(), dsr.stride(0),
        sb.group, inv_h, c4h, stream())
    raise_on(rc, "forces_warp_v2_bwd_slab")
    forces_warp_v2_bwd_slab.launches += 1
    return dsr


def _launch_moments_raw(restT_rows, static_slab, posT, gidx8, h):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab = check_tiles(restT_rows, static_slab, device, gidx8)
    check_lane_major("posT", posT, dtype, device, 3)
    out = torch.empty((18, t * rows), dtype=dtype, device=device)
    if t == 0:
        return out
    inv_h, c4, c4h = spline_constants(h, dtype)
    rc = entry("fused_kernels", "moments_raw", dtype)(
        restT_rows.data_ptr(), static_slab.data_ptr(), posT.data_ptr(),
        posT.stride(0), gidx8.data_ptr(), out.data_ptr(), out.stride(0),
        t, slab, slab // gidx8.shape[1], inv_h, c4, c4h, stream())
    raise_on(rc, "moments_raw")
    moments_raw.launches += 1
    return out


def _launch_moments_raw_bwd(sb, dayT, h, rows=False):
    """(dps (3, n_entries), dprow (3, m) or None): a block per 128-entry
    chunk of every slab, the chunk-0 blocks writing dprow with ``rows``."""
    device, dtype = dayT.device, dayT.dtype
    check_scene(sb, dtype, device, chunks=True)
    m = sb.n_tiles * sb.rows
    check_lane_major("dayT", dayT, dtype, device, 18, m)
    if rows:
        check_lane_major("rs6T", sb.rs6T, dtype, device, 6, m)
    dps = torch.empty((3, n_entries(sb)), dtype=dtype, device=device)
    dprow = torch.empty((3, m), dtype=dtype, device=device) if rows else None
    if sb.n_tiles == 0:
        return dps, dprow
    inv_h, c4, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "moments_raw_bwd", dtype)(
        sb.chunks.data_ptr(), sb.chunks.shape[0], sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), dayT.data_ptr(), dayT.stride(0),
        sb.rs6T.data_ptr() if rows else None, sb.rs6T.stride(0) if rows else 0,
        dps.data_ptr(), dps.stride(0),
        dprow.data_ptr() if rows else None, dprow.stride(0) if rows else 0,
        sb.group, inv_h, c4, c4h, int(rows), has_tail(sb, BWD_CHUNK), stream())
    raise_on(rc, "moments_raw_bwd")
    moments_raw_bwd.launches += 1
    return dps, dprow


# ------------------------------------------------------------ device dispatch
def moments_mid(sb, posT, posT_rows, rs, scale, h, corotated, emit_ay=False):
    """Fused K1 + mid-section over every tile of the scene ``sb``: (fmT
    (19, m), srT (15, n_slots), ayT (18, m) or None) from posT (3, n_slots)
    and the tile rows' posT_rows (3, m); one launch on the card,
    :func:`moments_mid_scene_plain` on the CPU."""
    fn = on("moments_mid", posT, moments_mid_scene_plain, _launch_moments_mid)
    return fn(sb, posT, posT_rows, rs, scale, h, corotated, emit_ay)


def forces_warp_v2(sb, fmT, srT, h):
    """K2 v2 over every tile of the scene ``sb``: fT (3, m) from fmT (19, m)
    and srT (15, n_slots); one launch on the card,
    :func:`forces_warp_v2_scene_plain` on the CPU."""
    fn = on("forces_warp_v2", srT, forces_warp_v2_scene_plain, _launch_forces_v2)
    return fn(sb, fmT, srT, h)


def moments_raw(restT_rows, static_slab, posT, gidx8, h):
    """Raw K1 of one bucket: the uncentered dots ayT (18, t*rows); see
    :func:`moments_raw_plain`."""
    fn = on("moments_raw", posT, moments_raw_plain, _launch_moments_raw)
    return fn(restT_rows, static_slab, posT, gidx8, h)


def moments_raw_bwd(sb, dayT, h, rows=False):
    """K1 raw backward over every tile of the scene ``sb``: (dps
    (3, n_entries), dprow (3, m) with ``rows``, else None); one launch on
    the card, :func:`moments_raw_bwd_scene_plain` on the CPU."""
    fn = on("moments_raw_bwd", dayT, moments_raw_bwd_scene_plain, _launch_moments_raw_bwd)
    return fn(sb, dayT, h, rows)


def forces_warp_v2_bwd_rows(sb, fmT, srT, dfT, h):
    """The K2 v2 backward's row pass over the scene: dfmT (19, m)."""
    fn = on("forces_warp_v2_bwd_rows", dfT,
            lambda *a: forces_warp_v2_bwd_scene_plain(*a)[0], _launch_forces_v2_bwd_rows)
    return fn(sb, fmT, srT, dfT, h)


def forces_warp_v2_bwd_slab(sb, fmT, srT, dfT, h):
    """The K2 v2 backward's slab pass over the scene: dsr (15, n_entries)."""
    fn = on("forces_warp_v2_bwd_slab", dfT,
            lambda *a: forces_warp_v2_bwd_scene_plain(*a)[1], _launch_forces_v2_bwd_slab)
    return fn(sb, fmT, srT, dfT, h)


def forces_warp_v2_bwd(sb, fmT, srT, dfT, h):
    """K2 v2 backward over the scene: (dfmT (19, m), dsr (15, n_entries));
    see :func:`forces_warp_v2_bwd_scene_plain`.  On the card two kernels,
    one launch each: the row pass and the slab pass."""
    if dfT.device.type == "cpu":
        return forces_warp_v2_bwd_scene_plain(sb, fmT, srT, dfT, h)
    return (forces_warp_v2_bwd_rows(sb, fmT, srT, dfT, h),
            forces_warp_v2_bwd_slab(sb, fmT, srT, dfT, h))


COUNTED = (moments_mid, forces_warp_v2, moments_raw_bwd, forces_warp_v2_bwd_rows,
           forces_warp_v2_bwd_slab, moments_raw)


# ------------------------------------------------------- differentiable ops
class _MomentsMid(torch.autograd.Function):
    """Fused K1 + mid-section over the whole scene: (posT (3, n_slots),
    posT_rows (3, m), scale (m,)) -> (fmT (19, m), srT (15, n_slots), its
    padding columns zero).  ``posT_rows`` is a view of ``posT``: autograd
    adds the two cotangents."""

    @staticmethod
    def forward(ctx, posT, posT_rows, scale, sb, rs, h, corotated, ops):
        ctx.sb, ctx.rs, ctx.h, ctx.corotated, ctx.ops = sb, rs, h, corotated, ops
        emit = any(ctx.needs_input_grad[:3])
        fmT, srT, ayT = ops.moments_mid(sb, posT, posT_rows, rs, scale, h, corotated,
                                        emit)
        if emit:
            ctx.save_for_backward(ayT, scale)
        return fmT, srT

    @staticmethod
    @once_differentiable
    def backward(ctx, dfmT, dsrT):
        sb, rs, ops = ctx.sb, ctx.rs, ctx.ops
        ayT, scale = ctx.saved_tensors
        m = sb.n_tiles * sb.rows
        with torch.enable_grad():
            ay = ayT.detach().requires_grad_()
            sc = scale.detach().requires_grad_()
            fm, sr = mid_records(ay, rs, sc, ctx.corotated)
            dayT, dscale = torch.autograd.grad((fm, sr), (ay, sc),
                                               (dfmT, dsrT[:, :m]))
        # the slab side, and the rows' own positions entering as
        # -pos_i * rowsum against the static row sums (as the JAX VJP
        # takes them): one launch
        dps, dprow = ops.moments_raw_bwd(sb, dayT.contiguous(), ctx.h, True)
        dposT = ops.to_slots(dps, sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
        return dposT, dprow, dscale, None, None, None, None, None


class _MomentsRaw(torch.autograd.Function):
    """Raw K1 over every bucket: posT (3, n_slots) -> the uncentered dots
    ayT (18, m).  The rows' own positions enter only through the caller's
    - pos_i * rs6 correction, so the backward is the slab side alone: one
    raw K1 backward launch over the scene, then one ``slab_to_slots`` (the
    JAX VJP of ``packed.moments_packed``, packed.py:283-309)."""

    @staticmethod
    def forward(ctx, posT, sb, h, ops):
        ctx.sb, ctx.h, ctx.ops = sb, h, ops
        return torch.cat([ops.moments_raw(b.restT_rows, b.static_slab, posT,
                                          b.gidx8, h) for b in sb.buckets], dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dayT):
        sb, ops = ctx.sb, ctx.ops
        dps, _ = ops.moments_raw_bwd(sb, dayT.contiguous(), ctx.h, False)
        dposT = ops.to_slots(dps, sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
        return dposT, None, None, None


class _ForcesWarpV2(torch.autograd.Function):
    """K2 v2 over the whole scene: (fmT (19, m), srT (15, n_slots)) -> fT
    (3, m)."""

    @staticmethod
    def forward(ctx, fmT, srT, sb, h, ops):
        ctx.sb, ctx.h, ctx.ops = sb, h, ops
        ctx.save_for_backward(fmT, srT)
        return ops.forces_v2(sb, fmT, srT, h)

    @staticmethod
    @once_differentiable
    def backward(ctx, dfT):
        sb, ops = ctx.sb, ctx.ops
        fmT, srT = ctx.saved_tensors
        dfm, dsr = ops.forces_v2_bwd(sb, fmT, srT, dfT.contiguous(), ctx.h)
        dsrT = ops.to_slots(dsr, sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
        return dfm, dsrT, None, None, None


def moments_mid_all(posT, posT_rows, scale, sb, rs: RowStatic, h, corotated, ops):
    """Differentiable fused K1 + mid-section over every tile of ``sb``:
    (fmT (19, m), srT (15, n_slots)), one launch on the card.  Its backward
    rebuilds the mid-section from the saved A | Y under autograd, then runs
    one raw K1 backward launch (with the row term) and one
    ``slab_to_slots``."""
    return _MomentsMid.apply(posT, posT_rows, scale, sb, rs, h, corotated, ops)


def moments_raw_all(posT, sb, h, ops):
    """Differentiable raw K1 over every bucket of ``sb``: ayT (18, m), the
    uncentered dots.  Its backward is one raw K1 backward launch over the
    scene, then one ``slab_to_slots``."""
    return _MomentsRaw.apply(posT, sb, h, ops)


def forces_v2_all(fmT, srT, sb, h, ops):
    """Differentiable K2 v2 over every tile of ``sb``: fT (3, m), one launch
    on the card.  Its backward is one launch of each K2 v2 backward pass,
    then one ``slab_to_slots``."""
    return _ForcesWarpV2.apply(fmT, srT, sb, h, ops)
