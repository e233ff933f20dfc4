"""The mid-section and its VJP as kernels of their own: every path that
does not fuse the mid-section into K1 (the default path, the Taichi
pairing, the blocked layout, the SPMD episode and the gather backend,
between ``ops/gather_kernels``' moments and forces) and the fused path's
backward.

Counterpart of ``softbody_tpu/ops/pallas/packed.py`` :: ``_mid_xla`` (the
XLA reference of the fused kernel's epilogue; on the unfused paths XLA
compiles the same function, ``softbody_tpu/sim/blocked.py`` ::
``_mid_section``, into the jitted step) and of ``jax.vjp`` of it inside
``packed._fused_vjp_bwd``:

* :func:`mid_records` replaces ``_mid_xla``: from K1's A | Y rows ayT
  (18, m) (row 3b+a = [a][b]), the rows' statics (:class:`RowStatic`) and
  the stiffness scale (m,), the K2 records fmT (19, m) = [F_9 | M_9 | V]
  and srT (15, n_sr) = [S_6 | R^T_9], srT's columns [m, n_sr) zero.  With
  ``posT_rows`` (3, m) and ``rs6T`` (6, m) it first subtracts
  pos_i[a] rs6[b] from the raw dots, as ``_mid_xla`` does with its ``dyn``
  / ``stat`` operands (the blocked layout's uncentered K1).
* :func:`mid_records_bwd` replaces that VJP: the cotangents dfmT (19, m)
  and dsrT (15, m) -> (dayT (18, m), dscale (m,), dposT_rows (3, m) or
  None).

On the card each is one launch of csrc/mid_kernels.cu (one thread per row,
every block at once, the forward recomputed in registers for the
backward, mid.cuh's per-row routines, which the fused K1's epilogue also
runs; :func:`kernel_info` gives what the card allots them).
:func:`mid_records_ring` and :func:`mid_records_bwd_ring` launch the same
functions in persistent blocks that stage rows through a cp.async ring
(:func:`ring_plan` gives their launch), bit for bit the same outputs: the
design measured against the one-wave kernels and left off every path
(``pair_times.py`` times both).  On the CPU each wrapper runs the plain
version: :func:`mid_records_plain`, the eager mid-section of
``sim/blocked.mid_rows`` on component lists, and
:func:`mid_records_bwd_plain`, autograd through it (the polar through its
clamped analytic VJP).  :func:`mid_records_all` is the differentiable op
over them, going through a ``pair_kernels.PairOps`` (``KERNELS`` or
``PLAIN``, as every pair kernel does).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..sim.blocked import mid_rows
from . import _build
from .gather_kernels import REC_W, packed_record
from .pair_common import (SR_FIELDS, check_lane_major, check_vector, entry, on, raise_on,
                          stream)

FM_FIELDS = 19     # rows of fmT: F_9 | M_9 | V_i
SWEEPS = 8         # Jacobi sweeps of the polar (mat3.polar3's default)
# the kernels' instantiations, in sb_mid_info's order
INSTANCES = ("mid_records", "mid_records (correction)", "mid_records_bwd",
             "mid_records_bwd (correction)")


class RowStatic(NamedTuple):
    """The mid-section's per-row static operands, lane-major views of the
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
    SparseBlocked or Blocked, ``mats`` its Materials, ``rest_corr``
    (3, 3, m)."""
    m = sb.n_tiles * sb.rows
    return RowStatic(mats.mu[:m], mats.lam[:m], mats.volume[:m], rest_corr.reshape(9, m))


def gather_row_static(mats, topo) -> RowStatic:
    """The :class:`RowStatic` of a gather scene's rows (every particle, or a
    shard's): ``mats`` its Materials, ``topo`` its Topology (``rcT`` built
    with the tables)."""
    return RowStatic(mats.mu, mats.lam, mats.volume, topo.rcT)


# ------------------------------------------------------------- plain versions
def mid_records_plain(ayT, rs: RowStatic, scale, corotated: bool, n_sr: int,
                      posT_rows=None, rs6T=None, rec: int = 0):
    """The mid-section from K1's A | Y rows ayT (18, k): (fmT (19, k),
    srT (15, n_sr) with its columns [k, n_sr) zero).  With ``posT_rows``
    (3, k) and ``rs6T`` (6, k): A, Y = dots - pos_i * rs6.  With ``rec``
    (16 or 12; n_sr = k, no correction): (fmT, srT, the gather path's
    packed source record (k, rec), ``gather_kernels.packed_record``), srT
    then a view of the record's first 15 fields in the Warp pairing's 16.
    Differentiable (the polar through its clamped VJP)."""
    if posT_rows is None:
        A = [[ayT[3 * b + a] for b in range(3)] for a in range(3)]
        Y = [[ayT[9 + 3 * b + a] for b in range(3)] for a in range(3)]
    else:
        p = posT_rows
        A = [[ayT[3 * b + a] - p[a] * rs6T[b] for b in range(3)] for a in range(3)]
        Y = [[ayT[9 + 3 * b + a] - p[a] * rs6T[3 + b] for b in range(3)]
             for a in range(3)]
    R, F, S, M = mid_rows(A, Y, rs.rcT.unflatten(0, (3, 3)), rs.mu, rs.lam, scale,
                          corotated)
    fmT = torch.stack([F[a][b] for a in range(3) for b in range(3)]
                      + [M[a][b] for a in range(3) for b in range(3)] + [rs.vol])
    srT = torch.stack([S[0][0], S[0][1], S[0][2], S[1][1], S[1][2], S[2][2]]
                      + [R[a][c] for c in range(3) for a in range(3)])
    if n_sr > srT.shape[1]:
        srT = torch.cat([srT, srT.new_zeros((SR_FIELDS, n_sr - srT.shape[1]))], dim=1)
    if not rec:
        return fmT, srT
    packed = packed_record(fmT, srT, rec == REC_W[True])
    return fmT, packed[:, :SR_FIELDS].T if rec == REC_W[False] else srT, packed


def mid_records_bwd_plain(ayT, rs: RowStatic, scale, corotated: bool, dfmT, dsrT,
                          posT_rows=None, rs6T=None):
    """VJP of :func:`mid_records_plain`: the cotangents dfmT (19, k) and
    dsrT (15, k) of its outputs' first k columns -> (dayT (18, k), dscale
    (k,), dposT_rows (3, k) or None), by autograd through it."""
    k = ayT.shape[1]
    with torch.enable_grad():
        ins = [ayT.detach().requires_grad_(), scale.detach().requires_grad_()]
        if posT_rows is not None:
            ins.append(posT_rows.detach().requires_grad_())
        fm, sr = mid_records_plain(ins[0], rs, ins[1], corotated, k, *ins[2:], rs6T)
        grads = torch.autograd.grad((fm, sr), ins, (dfmT, dsrT))
    return grads[0], grads[1], grads[2] if posT_rows is not None else None


# ------------------------------------------------------------ kernel launches
def kernel_info() -> dict:
    """What the card gives each instantiation of csrc/mid_kernels.cu:
    {(instance, dtype): {registers, local_bytes, static_smem, threads,
    blocks_per_sm}} (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Needs a card."""
    lib = _build.library("mid_kernels")
    keys = ("registers", "local_bytes", "static_smem", "threads", "blocks_per_sm")
    out = {}
    for which, name in enumerate(INSTANCES):
        for mode, dtype in enumerate(("float32", "float64")):
            buf = (ctypes.c_int * len(keys))()
            raise_on(lib.sb_mid_info(which, mode, buf), f"{name} attributes")
            out[name, dtype] = dict(zip(keys, buf))
    return out


def ring_plan(instance: str, dtype, m: int) -> dict:
    """The ring kernels' launch at m rows on the current card, for an
    instance of :data:`INSTANCES`: {grid, stages, smem_bytes,
    blocks_per_sm}.  Needs a card."""
    buf = (ctypes.c_int * 4)()
    raise_on(_build.library("mid_kernels").sb_mid_ring_plan(
        INSTANCES.index(instance), int(dtype == torch.float64), m, buf),
        f"{instance} ring plan")
    return dict(zip(("grid", "stages", "smem_bytes", "blocks_per_sm"), buf))


def _check(ayT, rs, scale, posT_rows, rs6T):
    """Operand checks of either launch; returns (device, dtype, m)."""
    device, dtype = ayT.device, ayT.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    check_lane_major("ayT", ayT, dtype, device, 18)
    m = ayT.shape[1]
    check_lane_major("rcT", rs.rcT, dtype, device, 9, m)
    for name in ("mu", "lam", "vol"):
        check_vector(name, getattr(rs, name), dtype, device, m)
    check_vector("scale", scale, dtype, device, m)
    if (posT_rows is None) != (rs6T is None):
        raise ValueError("the raw-dot correction takes both posT_rows and rs6T")
    if posT_rows is not None:
        check_lane_major("posT_rows", posT_rows, dtype, device, 3, m)
        check_lane_major("rs6T", rs6T, dtype, device, 6, m)
    return device, dtype, m


def _corr(posT_rows, rs6T):
    """The correction's pointer and row-stride arguments (null without)."""
    if posT_rows is None:
        return None, 0, None, 0
    return posT_rows.data_ptr(), posT_rows.stride(0), rs6T.data_ptr(), rs6T.stride(0)


def _launch_mid_records(ayT, rs, scale, corotated, n_sr, posT_rows=None, rs6T=None,
                        rec=0, ring=False):
    """(fmT (19, m), srT (15, n_sr)): one thread per column of srT, the
    columns past the m rows only zeroing their record (with ``ring``, the
    ring kernel: one thread per row of each tile it walks; with ``rec``,
    see :func:`mid_records_plain`)."""
    device, dtype, m = _check(ayT, rs, scale, posT_rows, rs6T)
    if rec:
        return _launch_mid_records_rec(ayT, rs, scale, corotated, n_sr, posT_rows, rec)
    if n_sr < m:
        raise ValueError(f"srT has {n_sr} columns, fewer than the {m} rows")
    fmT = torch.empty((FM_FIELDS, m), dtype=dtype, device=device)
    srT = torch.empty((SR_FIELDS, n_sr), dtype=dtype, device=device)
    if n_sr == 0:
        return fmT, srT
    name = "mid_records_ring" if ring else "mid_records"
    rc = entry("mid_kernels", name, dtype)(
        ayT.data_ptr(), ayT.stride(0), *_corr(posT_rows, rs6T),
        rs.mu.data_ptr(), rs.lam.data_ptr(), rs.vol.data_ptr(), rs.rcT.data_ptr(),
        rs.rcT.stride(0), scale.data_ptr(), fmT.data_ptr(), fmT.stride(0),
        srT.data_ptr(), srT.stride(0), m, n_sr, int(corotated), SWEEPS, stream())
    raise_on(rc, name)
    (mid_records_ring if ring else mid_records).launches += 1
    return fmT, srT


def _launch_mid_records_rec(ayT, rs, scale, corotated, n_sr, posT_rows, rec):
    """(fmT, srT, the packed record (m, rec)): one thread per row; in the
    Warp pairing's record (16) srT is a view of it."""
    device, dtype, m = ayT.device, ayT.dtype, ayT.shape[1]
    if rec not in REC_W.values() or n_sr != m or posT_rows is not None:
        raise ValueError(f"the packed record takes rec 16 or 12, n_sr = m and no "
                         f"raw-dot correction, got rec {rec}, n_sr {n_sr} of {m} rows")
    fmT = torch.empty((FM_FIELDS, m), dtype=dtype, device=device)
    packed = torch.empty((m, rec), dtype=dtype, device=device)
    srT = (packed[:, :SR_FIELDS].T if rec == REC_W[False]
           else torch.empty((SR_FIELDS, m), dtype=dtype, device=device))
    if m == 0:
        return fmT, srT, packed
    rc = entry("mid_kernels", "mid_records_rec", dtype)(
        ayT.data_ptr(), ayT.stride(0), rs.mu.data_ptr(), rs.lam.data_ptr(),
        rs.vol.data_ptr(), rs.rcT.data_ptr(), rs.rcT.stride(0), scale.data_ptr(),
        fmT.data_ptr(), fmT.stride(0), srT.data_ptr(), srT.stride(0), packed.data_ptr(),
        rec, m, int(corotated), SWEEPS, stream())
    raise_on(rc, "mid_records")
    mid_records.launches += 1
    return fmT, srT, packed


def _launch_mid_records_bwd(ayT, rs, scale, corotated, dfmT, dsrT, posT_rows=None,
                            rs6T=None, ring=False):
    """(dayT (18, m), dscale (m,), dposT_rows (3, m) or None): one thread per
    row (with ``ring``, through the ring kernel)."""
    device, dtype, m = _check(ayT, rs, scale, posT_rows, rs6T)
    check_lane_major("dfmT", dfmT, dtype, device, FM_FIELDS, m)
    check_lane_major("dsrT", dsrT, dtype, device, SR_FIELDS, m)
    dayT = torch.empty((18, m), dtype=dtype, device=device)
    dscale = torch.empty((m,), dtype=dtype, device=device)
    dpos = None if posT_rows is None else torch.empty((3, m), dtype=dtype, device=device)
    if m == 0:
        return dayT, dscale, dpos
    name = "mid_records_bwd_ring" if ring else "mid_records_bwd"
    rc = entry("mid_kernels", name, dtype)(
        ayT.data_ptr(), ayT.stride(0), *_corr(posT_rows, rs6T),
        rs.mu.data_ptr(), rs.lam.data_ptr(), rs.rcT.data_ptr(), rs.rcT.stride(0),
        scale.data_ptr(), dfmT.data_ptr(), dfmT.stride(0), dsrT.data_ptr(),
        dsrT.stride(0), dayT.data_ptr(), dayT.stride(0), dscale.data_ptr(),
        None if dpos is None else dpos.data_ptr(), 0 if dpos is None else dpos.stride(0),
        m, int(corotated), SWEEPS, stream())
    raise_on(rc, name)
    (mid_records_bwd_ring if ring else mid_records_bwd).launches += 1
    return dayT, dscale, dpos


# ------------------------------------------------------------ device dispatch
def mid_records(ayT, rs, scale, corotated, n_sr, posT_rows=None, rs6T=None, rec=0):
    """The mid-section of every row: (fmT (19, m), srT (15, n_sr)), with
    ``rec`` also the gather path's packed source record (see
    :func:`mid_records_plain`); one launch on the card,
    :func:`mid_records_plain` on the CPU."""
    fn = on("mid_records", ayT, mid_records_plain, _launch_mid_records)
    return fn(ayT, rs, scale, corotated, n_sr, posT_rows, rs6T, rec)


def mid_records_bwd(ayT, rs, scale, corotated, dfmT, dsrT, posT_rows=None, rs6T=None):
    """The mid-section's VJP: (dayT (18, m), dscale (m,), dposT_rows (3, m)
    or None); one launch on the card, :func:`mid_records_bwd_plain` on the
    CPU."""
    fn = on("mid_records_bwd", dfmT, mid_records_bwd_plain, _launch_mid_records_bwd)
    return fn(ayT, rs, scale, corotated, dfmT, dsrT, posT_rows, rs6T)


COUNTED = (mid_records, mid_records_bwd)


def mid_records_ring(ayT, rs, scale, corotated, n_sr, posT_rows=None, rs6T=None):
    """:func:`mid_records` through the ring kernel (persistent blocks, each
    walking tiles of rows staged by cp.async): the same outputs bit for
    bit; on no path, so not in :data:`COUNTED` (its own ``launches``
    count)."""
    fn = on("mid_records_ring", ayT, mid_records_plain,
            functools.partial(_launch_mid_records, rec=0, ring=True))
    return fn(ayT, rs, scale, corotated, n_sr, posT_rows, rs6T)


def mid_records_bwd_ring(ayT, rs, scale, corotated, dfmT, dsrT, posT_rows=None, rs6T=None):
    """:func:`mid_records_bwd` through the ring kernel (as
    :func:`mid_records_ring`)."""
    fn = on("mid_records_bwd_ring", dfmT, mid_records_bwd_plain,
            functools.partial(_launch_mid_records_bwd, ring=True))
    return fn(ayT, rs, scale, corotated, dfmT, dsrT, posT_rows, rs6T)


mid_records_ring.launches = mid_records_bwd_ring.launches = 0


# ------------------------------------------------------- differentiable op
def add_record_m(dfmT, drec):
    """dfmT (19, m) plus the cotangent of the Taichi pairing's packed record
    [M_9 | V | 0 | 0] (drec (m, 12)) on its M rows: the record is made from
    fmT, so its M fields' cotangent is M's.  A new tensor."""
    out = dfmT.clone()
    out[9:18] += drec[:, :9].T
    return out


class _MidRecords(torch.autograd.Function):
    """(ayT (18, m), scale (m,), posT_rows (3, m) or None) -> (fmT (19, m),
    srT (15, n_sr)); with ``rec`` 16 (fmT, the packed record), with 12
    (fmT, srT, the packed record).  ``posT_rows`` (with the scene's
    ``rs6T``) only on the uncentered dots of the blocked layout; it is a
    view of the positions, so autograd adds its cotangent to theirs."""

    @staticmethod
    def forward(ctx, ayT, scale, posT_rows, rs, rs6T, corotated, n_sr, ops, rec):
        ctx.rs, ctx.rs6T, ctx.corotated, ctx.ops, ctx.rec = rs, rs6T, corotated, ops, rec
        ctx.save_for_backward(ayT, scale, posT_rows)
        ctx.set_materialize_grads(False)
        out = ops.mid_records(ayT, rs, scale, corotated, n_sr, posT_rows, rs6T, rec=rec)
        return (out[0], out[2]) if rec == REC_W[False] else out

    @staticmethod
    @once_differentiable
    def backward(ctx, dfmT, *grads):
        ayT, scale, posT_rows = ctx.saved_tensors
        m = ayT.shape[1]
        if dfmT is None:
            dfmT = ayT.new_zeros((FM_FIELDS, m))
        if ctx.rec == REC_W[False]:      # dsrT: the record's first 15 fields
            drec = grads[0]
            dsrT = (ayT.new_zeros((SR_FIELDS, m)) if drec is None
                    else drec.T[:SR_FIELDS])
        else:
            dsrT = grads[0]
            if dsrT is None:
                dsrT = ayT.new_zeros((SR_FIELDS, m))
            if ctx.rec and grads[1] is not None:
                dfmT = add_record_m(dfmT, grads[1])
        dayT, dscale, dpos = ctx.ops.mid_records_bwd(
            ayT, ctx.rs, scale, ctx.corotated, dfmT.contiguous(),
            dsrT.contiguous()[:, :m], posT_rows, ctx.rs6T)
        return dayT, dscale, dpos, None, None, None, None, None, None


def mid_records_all(ayT, scale, rs: RowStatic, corotated: bool, n_sr: int, ops,
                    posT_rows=None, rs6T=None, rec=0):
    """Differentiable mid-section of every row: (fmT (19, m), srT
    (15, n_sr)), one launch on the card, its backward one launch.  With
    ``posT_rows`` and ``rs6T``, on raw dots (see :func:`mid_records`); with
    ``rec`` (16 or 12) also the gather path's packed source record (fmT,
    srT, rec), srT a view of the Warp pairing's record."""
    out = _MidRecords.apply(ayT, scale, posT_rows, rs, rs6T, corotated, n_sr, ops, rec)
    if rec == REC_W[False]:
        return out[0], out[1][:, :SR_FIELDS].T, out[1]
    return out
