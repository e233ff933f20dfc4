"""The pair kernels of the fused K1 + mid-section path (``cfg.fused_mid``),
forward and backward.

Counterpart of ``softbody_tpu/ops/pallas/pair_kernels.py`` +
``softbody_tpu/ops/pallas/packed.py`` for the fused branch of
``softbody_tpu/sim/sparse.py:340-381``:

* :func:`moments_mid` replaces ``_moments_mid_kernel`` (launched by
  ``packed._fused_call``): K1's moments and the whole per-row mid-section
  in one kernel, emitting the K2 operand records fmT (19, m) =
  [F_9 | M_9 | V_i] and srT (15, m) = [S_6 | R^T_9], and for the backward
  the A | Y rows ayT (18, m).
* :func:`forces_warp_v2` replaces ``_forces_warp_kernel_v2`` (launched by
  ``packed._forces_warp_packed_fwd``): the Warp pairing with term_i and the
  0.5 V_i scale in the kernel, fT (3, m).
* :func:`moments_raw_bwd` replaces ``_moments_bwd_kernel`` (launched by
  ``_moments_vjp_bwd`` from ``packed._fused_vjp_bwd``): dayT -> dpsT
  (t, 3, slab), the slab side of K1's VJP.
* :func:`forces_warp_v2_bwd` replaces ``_forces_warp_bwd_kernel_v2``
  (launched by ``_forces_warp_bwd_impl``): dfT -> dfmT (19, m) =
  [dF_9 | dM_9 | 0] and dsrT (t, 15, slab); on the card two kernels, the
  row pass and the slab pass.
* :func:`moments_raw` replaces ``_moments_kernel`` (launched by
  ``_moments_fwd_impl`` from ``packed.moments_packed``) and the inner
  kernel of ``_moments_fwd_manual`` (the same function, TPU-only manual
  DMA): the raw, uncentered K1 dots ayT (18, m) of the blocked layout.
  The caller subtracts pos_i * rs6 with rs6 from this same kernel on an
  all-ones RHS (``sim/blocked.build_blocked_scene``), never with a host
  row sum; its backward is :func:`moments_raw_bwd`.  K2 v2 and the raw K1
  are also the blocked layout's pair kernels (``sim/blocked.py``).

The JAX layouts fm (t, rows, 19) / sr (t, rows, 16) become lane-major
(19, m) / (15, n_slots), the layouts of the v4 path, so srT is the v4
path's per-slot K2 record and K2 reads it through ``gidx8`` as the v4 K2
does.  The K1 stage centers in the kernel as ``moments_v4`` does
(csrc/fused_kernels.cu says why): A | Y are the v4 path's.  The per-row
static operands are the scene's own lane-major arrays (:class:`RowStatic`:
JAX's ``stat_rows`` record, ``sim/sparse.py:240-244``, left in place).

Each kernel has a plain PyTorch version (``*_plain``) for CPU tensors; for
CUDA tensors the wrapper launches the hand-written kernel of
csrc/fused_kernels.cu and counts it in its ``launches`` attribute; any
other device raises.  :func:`moments_mid_all` / :func:`forces_v2_all` are
the differentiable ops over every bucket, going through a
``pair_kernels.PairOps`` (its ``KERNELS`` or ``PLAIN`` table).  The
backward of :func:`moments_mid_all` rebuilds the mid-section from the saved
A | Y under autograd (the port's counterpart of ``packed._mid_xla``; the
polar through its clamped VJP), then runs :func:`moments_raw_bwd` per
bucket and one ``slab_to_slots``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.autograd.function import once_differentiable

from ..sim.blocked import mid_rows
from .pair_common import (SR_FIELDS, _no_tf32, bucket_cols, centered_moments,
                          check_lane_major, check_tiles, check_vector, entry,
                          flat_entries, k1_lhs, on, raise_on, raw_moments_bwd,
                          slab_slots, spline_constants, stream, tile_chunked,
                          warp_nw, warp_termj, warp_termj_bwd)

FM_FIELDS = 19     # rows of fmT: F_9 | M_9 | V_i
SWEEPS = 8         # Jacobi sweeps of the polar (mat3.polar3's default)


class RowStatic(NamedTuple):
    """The fused kernel's per-row static operands, lane-major views of the
    scene's arrays: rs6T (6, k) the static row sums, mu / lam / vol (k,),
    rcT (9, k) the rest correction, row 3a+b = rc[a][b]."""

    rs6T: torch.Tensor
    mu: torch.Tensor
    lam: torch.Tensor
    vol: torch.Tensor
    rcT: torch.Tensor

    def cols(self, c: slice) -> "RowStatic":
        return RowStatic(self.rs6T[:, c], self.mu[c], self.lam[c],
                         self.vol[c], self.rcT[:, c])


def row_static(sb, mats, rest_corr) -> RowStatic:
    """The :class:`RowStatic` of every tile row of a scene: ``sb`` its
    SparseBlocked, ``mats`` its Materials, ``rest_corr`` (3, 3, m)."""
    m = sb.n_tiles * sb.rows
    return RowStatic(sb.rs6T, mats.mu[:m], mats.lam[:m], mats.volume[:m],
                     rest_corr.reshape(9, m))


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


# ------------------------------------------------------------ kernel launches
def _launch_moments_mid(restT_rows, static_slab, posT, posT_rows, rs, scale,
                        gidx8, h, corotated, emit_ay=False):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab = check_tiles(restT_rows, static_slab, device, gidx8)
    mb = t * rows
    check_lane_major("posT", posT, dtype, device, 3)
    check_lane_major("posT_rows", posT_rows, dtype, device, 3, mb)
    check_lane_major("rcT", rs.rcT, dtype, device, 9, mb)
    for name in ("mu", "lam", "vol"):
        check_vector(name, getattr(rs, name), dtype, device, mb)
    check_vector("scale", scale, dtype, device, mb)
    fmT = torch.empty((FM_FIELDS, mb), dtype=dtype, device=device)
    srT = torch.empty((SR_FIELDS, mb), dtype=dtype, device=device)
    ayT = torch.empty((18, mb), dtype=dtype, device=device) if emit_ay else None
    if t == 0:
        return fmT, srT, ayT
    inv_h, c4, c4h = spline_constants(h, dtype)
    rc = entry("fused_kernels", "moments_mid", dtype)(
        restT_rows.data_ptr(), static_slab.data_ptr(),
        posT.data_ptr(), posT.stride(0), posT_rows.data_ptr(), posT_rows.stride(0),
        gidx8.data_ptr(), rs.mu.data_ptr(), rs.lam.data_ptr(), rs.vol.data_ptr(),
        rs.rcT.data_ptr(), rs.rcT.stride(0), scale.data_ptr(),
        fmT.data_ptr(), mb, srT.data_ptr(), mb,
        None if ayT is None else ayT.data_ptr(), mb,
        t, slab, slab // gidx8.shape[1], inv_h, c4, c4h, int(corotated), SWEEPS,
        stream())
    raise_on(rc, "moments_mid")
    moments_mid.launches += 1
    return fmT, srT, ayT


def _check_k2(restT_rows, static_slab, fmT, srT, gidx8, dfT=None):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab = check_tiles(restT_rows, static_slab, device, gidx8)
    check_lane_major("fmT", fmT, dtype, device, FM_FIELDS, t * rows)
    check_lane_major("srT", srT, dtype, device, SR_FIELDS)
    if dfT is not None:
        check_lane_major("dfT", dfT, dtype, device, 3, t * rows)
    return t, rows, slab


def _launch_forces_v2(restT_rows, static_slab, fmT, srT, gidx8, h):
    t, rows, slab = _check_k2(restT_rows, static_slab, fmT, srT, gidx8)
    dtype = restT_rows.dtype
    out = torch.empty((3, t * rows), dtype=dtype, device=restT_rows.device)
    if t == 0:
        return out
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("fused_kernels", "forces_warp_v2", dtype)(
        restT_rows.data_ptr(), static_slab.data_ptr(),
        fmT.data_ptr(), fmT.stride(0), srT.data_ptr(), srT.stride(0),
        gidx8.data_ptr(), out.data_ptr(), out.stride(0),
        t, slab, slab // gidx8.shape[1], inv_h, c4h, stream())
    raise_on(rc, "forces_warp_v2")
    forces_warp_v2.launches += 1
    return out


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


def _launch_moments_raw_bwd(restT_rows, static_slab, dayT, h):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab = check_tiles(restT_rows, static_slab, device)
    check_lane_major("dayT", dayT, dtype, device, 18, t * rows)
    dps = torch.empty((3, t * slab), dtype=dtype, device=device)
    if t:
        inv_h, c4, c4h = spline_constants(h, dtype)
        rc = entry("fused_kernels", "moments_raw_bwd", dtype)(
            restT_rows.data_ptr(), static_slab.data_ptr(),
            dayT.data_ptr(), dayT.stride(0), dps.data_ptr(), dps.stride(0),
            t, slab, inv_h, c4, c4h, stream())
        raise_on(rc, "moments_raw_bwd")
        moments_raw_bwd.launches += 1
    # field-major per tile entry; the (t, 3, slab) view is the JAX layout
    return dps.view(3, t, slab).permute(1, 0, 2)


def _launch_forces_v2_bwd_rows(restT_rows, static_slab, fmT, srT, gidx8, dfT, h):
    """dfmT (19, t*rows): one lane per row, four warps splitting the slab."""
    t, rows, slab = _check_k2(restT_rows, static_slab, fmT, srT, gidx8, dfT)
    dtype = restT_rows.dtype
    dfm = torch.empty((FM_FIELDS, t * rows), dtype=dtype, device=restT_rows.device)
    if t == 0:
        return dfm
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("fused_kernels", "forces_warp_v2_bwd_rows", dtype)(
        restT_rows.data_ptr(), static_slab.data_ptr(),
        fmT.data_ptr(), fmT.stride(0), srT.data_ptr(), srT.stride(0),
        gidx8.data_ptr(), dfT.data_ptr(), dfT.stride(0),
        dfm.data_ptr(), dfm.stride(0),
        t, slab, slab // gidx8.shape[1], inv_h, c4h, stream())
    raise_on(rc, "forces_warp_v2_bwd_rows")
    forces_warp_v2_bwd_rows.launches += 1
    return dfm


def _launch_forces_v2_bwd_slab(restT_rows, static_slab, fmT, srT, gidx8, dfT, h):
    """dsrT (t, 15, slab), field-major underneath: one thread per slab
    entry, looping over the tile's 32 rows."""
    t, rows, slab = _check_k2(restT_rows, static_slab, fmT, srT, gidx8, dfT)
    dtype = restT_rows.dtype
    dsr = torch.empty((SR_FIELDS, t * slab), dtype=dtype, device=restT_rows.device)
    if t == 0:
        return dsr.view(SR_FIELDS, 0, slab).permute(1, 0, 2)
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("fused_kernels", "forces_warp_v2_bwd_slab", dtype)(
        restT_rows.data_ptr(), static_slab.data_ptr(),
        fmT.data_ptr(), fmT.stride(0), srT.data_ptr(), srT.stride(0),
        gidx8.data_ptr(), dfT.data_ptr(), dfT.stride(0),
        dsr.data_ptr(), dsr.stride(0),
        t, slab, slab // gidx8.shape[1], inv_h, c4h, stream())
    raise_on(rc, "forces_warp_v2_bwd_slab")
    forces_warp_v2_bwd_slab.launches += 1
    return dsr.view(SR_FIELDS, t, slab).permute(1, 0, 2)


# ------------------------------------------------ per-bucket device dispatch
def moments_mid(restT_rows, static_slab, posT, posT_rows, rs, scale, gidx8, h,
                corotated, emit_ay=False):
    """Fused K1 + mid-section of one bucket: (fmT, srT, ayT or None); see
    :func:`moments_mid_plain`."""
    fn = on("moments_mid", posT, moments_mid_plain, _launch_moments_mid)
    return fn(restT_rows, static_slab, posT, posT_rows, rs, scale, gidx8, h,
              corotated, emit_ay)


def forces_warp_v2(restT_rows, static_slab, fmT, srT, gidx8, h):
    """K2 v2 of one bucket: fT (3, t*rows); see :func:`forces_warp_v2_plain`."""
    fn = on("forces_warp_v2", srT, forces_warp_v2_plain, _launch_forces_v2)
    return fn(restT_rows, static_slab, fmT, srT, gidx8, h)


def moments_raw(restT_rows, static_slab, posT, gidx8, h):
    """Raw K1 of one bucket: the uncentered dots ayT (18, t*rows); see
    :func:`moments_raw_plain`."""
    fn = on("moments_raw", posT, moments_raw_plain, _launch_moments_raw)
    return fn(restT_rows, static_slab, posT, gidx8, h)


def moments_raw_bwd(restT_rows, static_slab, dayT, h):
    """K1 raw backward of one bucket: dpsT (t, 3, slab); see
    :func:`moments_raw_bwd_plain`."""
    fn = on("moments_raw_bwd", dayT, moments_raw_bwd_plain, _launch_moments_raw_bwd)
    return fn(restT_rows, static_slab, dayT, h)


def forces_warp_v2_bwd_rows(restT_rows, static_slab, fmT, srT, gidx8, dfT, h):
    """The K2 v2 backward's row pass: dfmT (19, t*rows)."""
    fn = on("forces_warp_v2_bwd_rows", dfT,
            lambda *a: forces_warp_v2_bwd_plain(*a)[0], _launch_forces_v2_bwd_rows)
    return fn(restT_rows, static_slab, fmT, srT, gidx8, dfT, h)


def forces_warp_v2_bwd_slab(restT_rows, static_slab, fmT, srT, gidx8, dfT, h):
    """The K2 v2 backward's slab pass: dsrT (t, 15, slab)."""
    fn = on("forces_warp_v2_bwd_slab", dfT,
            lambda *a: forces_warp_v2_bwd_plain(*a)[1], _launch_forces_v2_bwd_slab)
    return fn(restT_rows, static_slab, fmT, srT, gidx8, dfT, h)


def forces_warp_v2_bwd(restT_rows, static_slab, fmT, srT, gidx8, dfT, h):
    """K2 v2 backward of one bucket: (dfmT (19, t*rows), dsrT (t, 15, slab));
    see :func:`forces_warp_v2_bwd_plain`.  On the card two kernels, the row
    pass and the slab pass."""
    args = (restT_rows, static_slab, fmT, srT, gidx8, dfT, h)
    if dfT.device.type == "cpu":
        return forces_warp_v2_bwd_plain(*args)
    return forces_warp_v2_bwd_rows(*args), forces_warp_v2_bwd_slab(*args)


COUNTED = (moments_mid, forces_warp_v2, moments_raw_bwd, forces_warp_v2_bwd_rows,
           forces_warp_v2_bwd_slab, moments_raw)


# ------------------------------------------------------- differentiable ops
class _MomentsMid(torch.autograd.Function):
    """Fused K1 + mid-section over every bucket: (posT (3, n_slots),
    posT_rows (3, m), scale (m,)) -> (fmT (19, m), srT (15, n_slots), its
    padding columns zero).  ``posT_rows`` is a view of ``posT``: autograd
    adds the two cotangents."""

    @staticmethod
    def forward(ctx, posT, posT_rows, scale, sb, rs, h, corotated, ops):
        ctx.sb, ctx.rs, ctx.h, ctx.corotated, ctx.ops = sb, rs, h, corotated, ops
        emit = any(ctx.needs_input_grad[:3])
        fm, sr, ay = [], [], []
        for b in sb.buckets:
            c = bucket_cols(b, sb.rows)
            f, s, a = ops.moments_mid(b.restT_rows, b.static_slab, posT,
                                      posT_rows[:, c], rs.cols(c), scale[c],
                                      b.gidx8, h, corotated, emit)
            fm.append(f)
            sr.append(s)
            ay.append(a)
        m = sb.n_tiles * sb.rows
        sr.append(torch.zeros((SR_FIELDS, sb.n_slots - m), dtype=posT.dtype,
                              device=posT.device))
        if emit:
            ctx.save_for_backward(torch.cat(ay, dim=1), scale)
        return torch.cat(fm, dim=1), torch.cat(sr, dim=1)

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
        dps = [ops.moments_raw_bwd(b.restT_rows, b.static_slab,
                                   dayT[:, bucket_cols(b, sb.rows)], ctx.h)
               for b in sb.buckets]
        dposT = ops.to_slots(flat_entries(dps, 3), sb.slab_ptr, sb.slab_idx,
                             sb.n_slots, sb.group)
        # the rows' own positions enter as -pos_i * rowsum, against the
        # static row sums (as the JAX VJP takes them)
        ct = dayT.view(6, 3, m)
        dprow = -sum(ct[k] * rs.rs6T[k] for k in range(6))
        return dposT, dprow, dscale, None, None, None, None, None


class _MomentsRaw(torch.autograd.Function):
    """Raw K1 over every bucket: posT (3, n_slots) -> the uncentered dots
    ayT (18, m).  The rows' own positions enter only through the caller's
    - pos_i * rs6 correction, so the backward is the slab side alone: the
    raw K1 backward per bucket, then one ``slab_to_slots`` (the JAX VJP of
    ``packed.moments_packed``, packed.py:283-309)."""

    @staticmethod
    def forward(ctx, posT, sb, h, ops):
        ctx.sb, ctx.h, ctx.ops = sb, h, ops
        return torch.cat([ops.moments_raw(b.restT_rows, b.static_slab, posT,
                                          b.gidx8, h) for b in sb.buckets], dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dayT):
        sb, ops = ctx.sb, ctx.ops
        dayT = dayT.contiguous()
        dps = [ops.moments_raw_bwd(b.restT_rows, b.static_slab,
                                   dayT[:, bucket_cols(b, sb.rows)], ctx.h)
               for b in sb.buckets]
        dposT = ops.to_slots(flat_entries(dps, 3), sb.slab_ptr, sb.slab_idx,
                             sb.n_slots, sb.group)
        return dposT, None, None, None


class _ForcesWarpV2(torch.autograd.Function):
    """K2 v2 over every bucket: (fmT (19, m), srT (15, n_slots)) -> fT (3, m)."""

    @staticmethod
    def forward(ctx, fmT, srT, sb, h, ops):
        ctx.sb, ctx.h, ctx.ops = sb, h, ops
        ctx.save_for_backward(fmT, srT)
        return torch.cat([
            ops.forces_v2(b.restT_rows, b.static_slab,
                          fmT[:, bucket_cols(b, sb.rows)], srT, b.gidx8, h)
            for b in sb.buckets], dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dfT):
        sb, ops = ctx.sb, ctx.ops
        fmT, srT = ctx.saved_tensors
        dfT = dfT.contiguous()
        dfm, dsr = [], []
        for b in sb.buckets:
            c = bucket_cols(b, sb.rows)
            d_fm, d_sr = ops.forces_v2_bwd(b.restT_rows, b.static_slab, fmT[:, c],
                                           srT, b.gidx8, dfT[:, c], ctx.h)
            dfm.append(d_fm)
            dsr.append(d_sr)
        dsrT = ops.to_slots(flat_entries(dsr, SR_FIELDS), sb.slab_ptr,
                            sb.slab_idx, sb.n_slots, sb.group)
        return torch.cat(dfm, dim=1), dsrT, None, None, None


def moments_mid_all(posT, posT_rows, scale, sb, rs: RowStatic, h, corotated, ops):
    """Differentiable fused K1 + mid-section over every bucket of ``sb``:
    (fmT (19, m), srT (15, n_slots)).  Its backward rebuilds the
    mid-section from the saved A | Y under autograd, then runs the raw K1
    backward per bucket and one ``slab_to_slots``."""
    return _MomentsMid.apply(posT, posT_rows, scale, sb, rs, h, corotated, ops)


def moments_raw_all(posT, sb, h, ops):
    """Differentiable raw K1 over every bucket of ``sb``: ayT (18, m), the
    uncentered dots.  Its backward runs the raw K1 backward per bucket,
    then one ``slab_to_slots``."""
    return _MomentsRaw.apply(posT, sb, h, ops)


def forces_v2_all(fmT, srT, sb, h, ops):
    """Differentiable K2 v2 over every bucket of ``sb``: fT (3, m).  Its
    backward runs the K2 v2 backward per bucket, then one
    ``slab_to_slots``."""
    return _ForcesWarpV2.apply(fmT, srT, sb, h, ops)
