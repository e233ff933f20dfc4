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
  dpsT (t, 3, slab) per slab entry and dprowT (3, t*rows), the centering
  term's gradient against the STATIC row sums rs6T_rows.
* :func:`forces_warp_v4_bwd` replaces ``_forces_warp_bwd_kernel_v4``: dfT ->
  df9T (9, t*rows) and dsrT (t, 15, slab) = [dS_6 | dR^T_9] per slab entry.
* :func:`slab_to_slots` adds a per-slab-entry buffer (k, sum_b t_b slab_b)
  into (k, n_slots) in a fixed order through the scene's CSR inverse of the
  buckets' ``gidx8`` (no float atomics: the episode gradient is bitwise
  repeatable).  The JAX path's ``scatter_packed_raw_T`` is XLA, not Pallas.

Each has a plain PyTorch version (``*_plain``): explicit formulas on the
tile's candidate slots.  The wrapper takes it only for tensors on the CPU.
For CUDA tensors it launches the hand-written kernel (csrc/pair_kernels.cu,
built at first use by ops/_build.py) and counts the launch in its
``launches`` attribute; any other device raises.  There is no fallback from
a kernel to its plain version.

:func:`moments_all` / :func:`forces_all` are the differentiable ops over all
buckets of a scene: one ``torch.autograd.Function`` each, whose forward and
backward go through a :class:`PairOps` — :data:`KERNELS` (the wrappers:
plain on the CPU, kernels on the card) or :data:`PLAIN` (the plain versions
on any device, the yardstick the kernels are held against on the card).

Operands keep the JAX package's lane-major layouts: positions (3, n_slots),
the per-slot K2 record srT (15, n_slots) = [S_6 | R^T_9] with
S_6 = [s00 s01 s02 s11 s12 s22] and R^T_9 = [R00 R10 R20 R01 R11 R21 R02 R12
R22], and the tile-row operands (k, t*rows).  The kernels read their slab
operands themselves through ``gidx8`` (slot = gidx8[tile, g] * group + k), so
the (t, 3, slab) / (t, 16, slab) gathered copies the TPU path materialised
(``packed.gather_packed_T``) do not exist here.

The plain versions state the precision they need: float32 contractions run
as true f32 (TF32 off), because a single-pass reduced-precision dot was
measured to destabilise the episode on the TPU (pair_kernels.py:191-242).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _build

# The K2 symmetric-stress remap: (d, b) -> index into S_6.
SYM6 = (0, 1, 2, 1, 3, 4, 2, 4, 5)
# Rows of the per-slot K2 record srT: S_6 then R^T_9.
SR_FIELDS = 15


def _no_tf32():
    """The plain versions' contractions must be true f32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def spline_constants(h: float, dtype: torch.dtype):
    """(inv_h, c4, c4 * inv_h) of the cubic spline as Python floats, rounded
    as ``dtype`` arithmetic rounds them (the JAX kernels compute them in the
    kernel dtype), so they enter float32 arithmetic exactly.  numpy scalars,
    not tensors: this runs on every kernel launch."""
    f = np.float32 if dtype == torch.float32 else np.float64
    h_t = f(h)
    inv_h = f(1.0) / h_t
    c4 = f(0.25) / (f(math.pi) * (h_t * h_t * h_t))
    return float(inv_h), float(c4), float(c4 * inv_h)


def pair_coeffs(restT_rows, restT_slab, h):
    """Per-pair dx components, kernel value w and gradient factor gfac.

    restT_rows: (..., 3, rows); restT_slab: (..., 3, S) ->
    dx: 3 x (..., rows, S); w, gfac: (..., rows, S).  grad_W(x_ij) = gfac dx
    with dx = X_i - X_j.  rsqrt form: q = r2 rsqrt(r2 + tiny) / h and the
    gradient polynomial is exactly zero at q = 0 (12 - 3*4), so the
    self-pair needs no mask.
    """
    dx = [restT_rows[..., b, :, None] - restT_slab[..., b, None, :]
          for b in range(3)]
    r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
    inv_h, c4, c4h = spline_constants(h, r2.dtype)
    rs = torch.rsqrt(r2 + 1e-30)
    q = r2 * rs * inv_h
    tq = torch.clamp(2.0 - q, min=0.0)
    oq = torch.clamp(1.0 - q, min=0.0)
    tq2 = tq * tq
    oq2 = oq * oq
    w = c4 * (tq2 * tq - 4.0 * oq2 * oq)
    gfac = c4h * (12.0 * oq2 - 3.0 * tq2) * rs
    return dx, w, gfac


def pair_coeffs_g(restT_rows, restT_slab, h):
    """:func:`pair_coeffs` without W (the force kernel never uses it)."""
    dx = [restT_rows[..., b, :, None] - restT_slab[..., b, None, :]
          for b in range(3)]
    r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
    inv_h, _, c4h = spline_constants(h, r2.dtype)
    rs = torch.rsqrt(r2 + 1e-30)
    q = r2 * rs * inv_h
    tq = torch.clamp(2.0 - q, min=0.0)
    oq = torch.clamp(1.0 - q, min=0.0)
    gfac = c4h * (12.0 * oq * oq - 3.0 * tq * tq) * rs
    return dx, gfac


def slab_slots(gidx8: torch.Tensor, slab: int) -> torch.Tensor:
    """(t, G) candidate group ids -> (t, slab) slot ids."""
    group = slab // gidx8.shape[1]
    k = torch.arange(group, device=gidx8.device)
    return (gidx8.long()[:, :, None] * group + k).reshape(gidx8.shape[0], slab)


# ------------------------------------------------------------------ K1 moments
def _k1_lhs(restT_rows, static_slab, h):
    """K1's per-pair coefficients lhs (t, 6, rows, slab) =
    [-w m_j dx ; gfac V_j dx]."""
    dx, w, gfac = pair_coeffs(restT_rows, static_slab[:, 0:3], h)
    cA = w * static_slab[:, 3:4]
    gv = gfac * static_slab[:, 4:5]
    return torch.stack([cA * (-dx[b]) for b in range(3)]
                       + [gv * dx[b] for b in range(3)], dim=1)


def moments_v4_plain(restT_rows, static_slab, posT, posT_rows, rs6T_rows,
                     gidx8, h):
    """Plain K1: centered moments ayT (18, t*rows), row 3b+a.

    restT_rows (t, 3, rows); static_slab (t, 5, slab) = [rest_3 | m | V];
    posT (3, n_slots) positions; posT_rows (3, t*rows) the tile rows'
    positions; rs6T_rows (6, t*rows) the static row sums, which only the
    backward reads; gidx8 (t, slab/group).  Row 3*blk + a holds
    dots[a] - (pos_i[a] - c_a) * rowsum_blk, with c the tile's first rest
    row, lhs = [-w m_j dx ; gfac V_j dx] and dots = lhs @ [pos_j - c] — the
    rowsum comes from the same coefficients as the dots."""
    _no_tf32()
    t, _, rows = restT_rows.shape
    slab = static_slab.shape[2]
    pos_slab = posT[:, slab_slots(gidx8, slab)]             # (3, t, slab)
    lhs = _k1_lhs(restT_rows, static_slab, h)               # (t, 6, rows, slab)
    c = restT_rows[:, :, 0]                                  # (t, 3)
    shifted = torch.cat(
        [pos_slab.permute(1, 0, 2) - c[:, :, None],
         torch.ones((t, 1, slab), dtype=lhs.dtype, device=lhs.device)],
        dim=1)                                               # (t, 4, slab)
    dots = torch.einsum("tks,tbrs->tkbr", shifted, lhs)      # (t, 4, 6, rows)
    prow_sh = posT_rows.reshape(3, t, rows) - c.T[:, :, None]  # (3, t, rows)
    out = dots[:, :3] - prow_sh.permute(1, 0, 2)[:, :, None, :] * dots[:, 3:4]
    # (t, a, blk, rows) -> (blk, a, t, rows) -> row 3*blk + a
    return out.permute(2, 1, 0, 3).reshape(18, t * rows)


def moments_v4_bwd_plain(restT_rows, static_slab, dayT, rs6T_rows, h):
    """Plain K1 backward (``_moments_bwd_kernel_v4``): dayT (18, t*rows) ->
    dpsT (t, 3, slab) = CT @ lhs, the cotangent of the slab positions (the
    centering adds only terms that do not depend on them), and
    dprowT (3, t*rows) = -sum_blk dayT[3 blk + a] * rs6T_rows[blk], the
    cotangent of the row positions against the STATIC row sums (the forward
    centers against its own coefficient sums: the gradient is exact for a
    function ~1e-7 relative away from the f32 forward, packed.py:376-383)."""
    _no_tf32()
    t, _, rows = restT_rows.shape
    lhs = _k1_lhs(restT_rows, static_slab, h)               # (t, 6, rows, slab)
    ct = dayT.reshape(6, 3, t, rows)                        # (blk, a, t, r)
    dps = torch.einsum("katr,tkrs->tas", ct, lhs)
    rs6 = rs6T_rows.reshape(6, t, rows)
    dprow = -sum(ct[k] * rs6[k][None] for k in range(6))    # (3, t, rows)
    return dps, dprow.reshape(3, t * rows)


# ------------------------------------------------------------------ K2 forces
def forces_warp_v4_plain(restT_rows, static_slab, f9T, srT, gidx8, h):
    """Plain K2: Warp-pairing termj fT (3, t*rows).

    f9T (9, t*rows): F_i, row 3c+d = F_i[c, d]; srT (15, n_slots): the
    per-slot [S_6 | R^T_9] record.  Per pair nw = gfac V_j dx,
    Z_d = sum_b nw_b S_j[d, b]; D = R^T-rows @ Z over the slab; then
    termj[a] = sum_{c,d} F_i[c, d] D[3c+a, d] (the JAX association)."""
    _no_tf32()
    t, _, rows = restT_rows.shape
    slab = static_slab.shape[2]
    sT = srT[:, slab_slots(gidx8, slab)]                     # (15, t, slab)
    dx, gfac = pair_coeffs_g(restT_rows, static_slab[:, 0:3], h)
    gv = gfac * static_slab[:, 4:5]
    nw = [gv * dx[b] for b in range(3)]
    Z = torch.stack(
        [sum(nw[b] * sT[SYM6[3 * d + b]][:, None, :] for b in range(3))
         for d in range(3)], dim=1)                          # (t, 3, rows, slab)
    D = torch.einsum("kts,tdrs->tkdr", sT[6:15], Z)          # (t, 9, 3, rows)
    fi = f9T.reshape(9, t, rows)
    t_rows = []
    for a in range(3):
        acc = None
        for c in range(3):
            for d in range(3):
                term = fi[3 * c + d] * D[:, 3 * c + a, d]
                acc = term if acc is None else acc + term
        t_rows.append(acc.reshape(t * rows))
    return torch.stack(t_rows)


def forces_warp_v4_bwd_plain(restT_rows, static_slab, f9T, srT, gidx8, dfT, h):
    """Plain K2 backward (``_forces_warp_bwd_kernel_v4``): dfT (3, t*rows),
    the cotangent of termj, -> df9T (9, t*rows) and dsrT (t, 15, slab) =
    [dS_6 | dR^T_9] per slab entry.  With z_d = sum_b nw_b S_j[d, b],
    u_c = sum_d F_i[c, d] z_d and w'_c = sum_a df_a R_j[a, c]:
    df9[3c+d] = sum_j z_d w'_c; dR^T[3c+a] = sum_i df_a u_c;
    dS_6[SYM6[3d+b]] += sum_i nw_b y_d with y_d = sum_c F_i[c, d] w'_c."""
    _no_tf32()
    t, _, rows = restT_rows.shape
    slab = static_slab.shape[2]
    sT = srT[:, slab_slots(gidx8, slab)][:, :, None, :]     # (15, t, 1, slab)
    dx, gfac = pair_coeffs_g(restT_rows, static_slab[:, 0:3], h)
    gv = gfac * static_slab[:, 4:5]
    nw = [gv * dx[b] for b in range(3)]                      # (t, rows, slab)
    z = [sum(nw[b] * sT[SYM6[3 * d + b]] for b in range(3)) for d in range(3)]
    fi = f9T.reshape(9, t, rows, 1)
    df = dfT.reshape(3, t, rows, 1)
    d_rt, wp = [None] * 9, []
    for c in range(3):
        u_c = sum(fi[3 * c + d] * z[d] for d in range(3))
        for a in range(3):
            d_rt[3 * c + a] = torch.sum(df[a] * u_c, dim=1)  # (t, slab)
        wp.append(sum(df[a] * sT[6 + 3 * c + a] for a in range(3)))
    df9 = [None] * 9
    ds6 = [None] * 6
    for d in range(3):
        for c in range(3):
            df9[3 * c + d] = torch.sum(z[d] * wp[c], dim=2)  # (t, rows)
        y_d = sum(fi[3 * c + d] * wp[c] for c in range(3))
        for b in range(3):
            k6 = SYM6[3 * d + b]
            term = torch.sum(nw[b] * y_d, dim=1)
            ds6[k6] = term if ds6[k6] is None else ds6[k6] + term
    return (torch.stack(df9).reshape(9, t * rows),
            torch.stack(ds6 + d_rt, dim=1))


# --------------------------------------------------- fixed-order scatter-reduce
def slab_inverse(gidx8s, n_slots: int, group: int):
    """CSR inverse of the buckets' candidate groups (host, numpy).

    The per-slab-entry buffers of all buckets lie end to end, bucket-major
    then tile-major, so the entries of candidate group (b, tile, g) start at
    group * p, with p the position of gidx8_b[tile, g] in the concatenation
    of the flattened gidx8s.  Returns (slab_ptr (n_groups + 1,),
    slab_idx (int32)): the positions p that read slot group k are
    slab_idx[slab_ptr[k]:slab_ptr[k + 1]], ascending.

    The last group is the layout's all-empty group (topology/sparse.py):
    every slab pads with it, and its slots sit on the far grid with zero
    mass and volume, so every pair term with them is exactly zero and so is
    their cotangent.  Its readers are left out: they are every slab's
    padding (7,144 of the 52,608 group entries at 20k particles, against at
    most 26 for any other group), and walking them would serialize the
    scatter."""
    if n_slots % group:
        raise ValueError(f"n_slots={n_slots} is not a multiple of group={group}")
    n_groups = n_slots // group
    flat = np.concatenate([np.asarray(g, np.int64).reshape(-1) for g in gidx8s])
    if flat.size and (flat.min() < 0 or flat.max() >= n_groups):
        raise ValueError("gidx8 names a group outside the scene")
    keep = flat < n_groups - 1
    order = np.flatnonzero(keep)[np.argsort(flat[keep], kind="stable")]
    ptr = np.zeros(n_groups + 1, np.int64)
    np.cumsum(np.bincount(flat[keep], minlength=n_groups), out=ptr[1:])
    return ptr.astype(np.int32), order.astype(np.int32)


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
def _check(name, x, dtype, device, ndim):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")


def _check_tiles(restT_rows, static_slab, device, gidx8=None):
    """Shared operand checks of the tile launches; returns (t, rows, slab)."""
    dtype = restT_rows.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    _check("restT_rows", restT_rows, dtype, device, 3)
    _check("static_slab", static_slab, dtype, device, 3)
    t, three, rows = restT_rows.shape
    slab = static_slab.shape[2]
    if three != 3 or static_slab.shape[:2] != (t, 5):
        raise ValueError("tile operand shapes disagree: restT_rows "
                         f"{tuple(restT_rows.shape)}, static_slab "
                         f"{tuple(static_slab.shape)}")
    if rows != _build.ROWS:
        raise ValueError(f"the kernels take rows={_build.ROWS} tiles, got {rows}")
    tensors = [("restT_rows", restT_rows), ("static_slab", static_slab)]
    if gidx8 is not None:
        _check("gidx8", gidx8, torch.int32, device, 2)
        if gidx8.shape[0] != t:
            raise ValueError(f"gidx8 has {gidx8.shape[0]} tiles, expected {t}")
        if gidx8.shape[1] == 0 or slab % gidx8.shape[1]:
            raise ValueError(f"slab {slab} is not a multiple of {gidx8.shape[1]} groups")
        tensors.append(("gidx8", gidx8))
    for name, x in tensors:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return t, rows, slab


def _check_lane_major(name, x, dtype, device, k, n=None):
    """A (k, n) lane-major operand: unit stride along lanes, any row stride."""
    _check(name, x, dtype, device, 2)
    if x.shape[0] != k or (n is not None and x.shape[1] != n):
        raise ValueError(f"{name} must be ({k}, {n or 'n'}), got {tuple(x.shape)}")
    if x.stride(1) != 1:
        raise ValueError(f"{name} must have unit stride along its lanes")


def _raise_on(rc: int, what: str):
    if rc != 0:
        msg = _build.library().sb_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _entry(name, dtype):
    lib = _build.library()
    return getattr(lib, f"sb_{name}_{'f32' if dtype == torch.float32 else 'f64'}")


def _launch_moments(restT_rows, static_slab, posT, posT_rows, rs6T_rows,
                    gidx8, h):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab = _check_tiles(restT_rows, static_slab, device, gidx8)
    _check_lane_major("posT", posT, dtype, device, 3)
    _check_lane_major("posT_rows", posT_rows, dtype, device, 3, t * rows)
    _check_lane_major("rs6T_rows", rs6T_rows, dtype, device, 6, t * rows)
    out = torch.empty((18, t * rows), dtype=dtype, device=device)
    if t == 0:
        return out
    inv_h, c4, c4h = spline_constants(h, dtype)
    rc = _entry("moments_v4", dtype)(
        restT_rows.data_ptr(), static_slab.data_ptr(),
        posT.data_ptr(), posT.stride(0),
        posT_rows.data_ptr(), posT_rows.stride(0),
        gidx8.data_ptr(), out.data_ptr(), out.stride(0),
        t, slab, slab // gidx8.shape[1], inv_h, c4, c4h, _stream())
    _raise_on(rc, "moments_v4")
    moments_v4.launches += 1
    return out


def _launch_forces(restT_rows, static_slab, f9T, srT, gidx8, h):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab = _check_tiles(restT_rows, static_slab, device, gidx8)
    _check_lane_major("f9T", f9T, dtype, device, 9, t * rows)
    _check_lane_major("srT", srT, dtype, device, SR_FIELDS)
    out = torch.empty((3, t * rows), dtype=dtype, device=device)
    if t == 0:
        return out
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = _entry("forces_warp_v4", dtype)(
        restT_rows.data_ptr(), static_slab.data_ptr(),
        f9T.data_ptr(), f9T.stride(0), srT.data_ptr(), srT.stride(0),
        gidx8.data_ptr(), out.data_ptr(), out.stride(0),
        t, slab, slab // gidx8.shape[1], inv_h, c4h, _stream())
    _raise_on(rc, "forces_warp_v4")
    forces_warp_v4.launches += 1
    return out


def _launch_moments_bwd(restT_rows, static_slab, dayT, rs6T_rows, h):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab = _check_tiles(restT_rows, static_slab, device)
    _check_lane_major("dayT", dayT, dtype, device, 18, t * rows)
    _check_lane_major("rs6T_rows", rs6T_rows, dtype, device, 6, t * rows)
    dps = torch.empty((3, t * slab), dtype=dtype, device=device)
    dprow = torch.empty((3, t * rows), dtype=dtype, device=device)
    if t:
        inv_h, c4, c4h = spline_constants(h, dtype)
        rc = _entry("moments_v4_bwd", dtype)(
            restT_rows.data_ptr(), static_slab.data_ptr(),
            dayT.data_ptr(), dayT.stride(0),
            rs6T_rows.data_ptr(), rs6T_rows.stride(0),
            dps.data_ptr(), dps.stride(0), dprow.data_ptr(), dprow.stride(0),
            t, slab, inv_h, c4, c4h, _stream())
        _raise_on(rc, "moments_v4_bwd")
        moments_v4_bwd.launches += 1
    # field-major per tile entry; the (t, 3, slab) view is the JAX layout
    return dps.view(3, t, slab).permute(1, 0, 2), dprow


def _check_forces_bwd(restT_rows, static_slab, f9T, srT, gidx8, dfT):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab = _check_tiles(restT_rows, static_slab, device, gidx8)
    _check_lane_major("f9T", f9T, dtype, device, 9, t * rows)
    _check_lane_major("srT", srT, dtype, device, SR_FIELDS)
    _check_lane_major("dfT", dfT, dtype, device, 3, t * rows)
    return t, rows, slab


def _launch_forces_bwd_rows(restT_rows, static_slab, f9T, srT, gidx8, dfT, h):
    """df9T (9, t*rows): one lane per row, four warps splitting the slab."""
    t, rows, slab = _check_forces_bwd(restT_rows, static_slab, f9T, srT,
                                      gidx8, dfT)
    dtype, device = restT_rows.dtype, restT_rows.device
    df9 = torch.empty((9, t * rows), dtype=dtype, device=device)
    if t == 0:
        return df9
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = _entry("forces_warp_v4_bwd_rows", dtype)(
        restT_rows.data_ptr(), static_slab.data_ptr(),
        srT.data_ptr(), srT.stride(0), gidx8.data_ptr(),
        dfT.data_ptr(), dfT.stride(0), df9.data_ptr(), df9.stride(0),
        t, slab, slab // gidx8.shape[1], inv_h, c4h, _stream())
    _raise_on(rc, "forces_warp_v4_bwd_rows")
    forces_warp_v4_bwd_rows.launches += 1
    return df9


def _launch_forces_bwd_slab(restT_rows, static_slab, f9T, srT, gidx8, dfT, h):
    """dsrT (t, 15, slab), field-major underneath: one thread per slab
    entry, looping over the tile's 32 rows."""
    t, rows, slab = _check_forces_bwd(restT_rows, static_slab, f9T, srT,
                                      gidx8, dfT)
    dtype, device = restT_rows.dtype, restT_rows.device
    dsr = torch.empty((SR_FIELDS, t * slab), dtype=dtype, device=device)
    if t == 0:
        return dsr.view(SR_FIELDS, 0, slab).permute(1, 0, 2)
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = _entry("forces_warp_v4_bwd_slab", dtype)(
        restT_rows.data_ptr(), static_slab.data_ptr(),
        f9T.data_ptr(), f9T.stride(0), srT.data_ptr(), srT.stride(0),
        gidx8.data_ptr(), dfT.data_ptr(), dfT.stride(0),
        dsr.data_ptr(), dsr.stride(0),
        t, slab, slab // gidx8.shape[1], inv_h, c4h, _stream())
    _raise_on(rc, "forces_warp_v4_bwd_slab")
    forces_warp_v4_bwd_slab.launches += 1
    return dsr.view(SR_FIELDS, t, slab).permute(1, 0, 2)


def _launch_slab_to_slots(buf, slab_ptr, slab_idx, n_slots, group):
    device, dtype = buf.device, buf.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    _check_lane_major("buf", buf, dtype, device, buf.shape[0])
    _check("slab_ptr", slab_ptr, torch.int32, device, 1)
    _check("slab_idx", slab_idx, torch.int32, device, 1)
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
    rc = _entry("slab_to_slots", dtype)(
        buf.data_ptr(), buf.stride(0), slab_ptr.data_ptr(), slab_idx.data_ptr(),
        out.data_ptr(), out.stride(0), k, n_slots, group, _stream())
    _raise_on(rc, "slab_to_slots")
    slab_to_slots.launches += 1
    return out


# ------------------------------------------------ per-bucket device dispatch
def _on(name, x, plain, launch):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    kind = x.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return launch
    raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")


def moments_v4(restT_rows, static_slab, posT, posT_rows, rs6T_rows, gidx8, h):
    """K1 of one bucket: centered moments ayT (18, t*rows); see
    :func:`moments_v4_plain`."""
    fn = _on("moments_v4", posT, moments_v4_plain, _launch_moments)
    return fn(restT_rows, static_slab, posT, posT_rows, rs6T_rows, gidx8, h)


def forces_warp_v4(restT_rows, static_slab, f9T, srT, gidx8, h):
    """K2 of one bucket: Warp-pairing termj fT (3, t*rows); see
    :func:`forces_warp_v4_plain`."""
    fn = _on("forces_warp_v4", srT, forces_warp_v4_plain, _launch_forces)
    return fn(restT_rows, static_slab, f9T, srT, gidx8, h)


def moments_v4_bwd(restT_rows, static_slab, dayT, rs6T_rows, h):
    """K1 backward of one bucket: (dpsT (t, 3, slab), dprowT (3, t*rows));
    see :func:`moments_v4_bwd_plain`."""
    fn = _on("moments_v4_bwd", dayT, moments_v4_bwd_plain, _launch_moments_bwd)
    return fn(restT_rows, static_slab, dayT, rs6T_rows, h)


def forces_warp_v4_bwd_rows(restT_rows, static_slab, f9T, srT, gidx8, dfT, h):
    """The K2 backward's row pass: df9T (9, t*rows)."""
    fn = _on("forces_warp_v4_bwd_rows", dfT,
             lambda *a: forces_warp_v4_bwd_plain(*a)[0], _launch_forces_bwd_rows)
    return fn(restT_rows, static_slab, f9T, srT, gidx8, dfT, h)


def forces_warp_v4_bwd_slab(restT_rows, static_slab, f9T, srT, gidx8, dfT, h):
    """The K2 backward's slab pass: dsrT (t, 15, slab)."""
    fn = _on("forces_warp_v4_bwd_slab", dfT,
             lambda *a: forces_warp_v4_bwd_plain(*a)[1], _launch_forces_bwd_slab)
    return fn(restT_rows, static_slab, f9T, srT, gidx8, dfT, h)


def forces_warp_v4_bwd(restT_rows, static_slab, f9T, srT, gidx8, dfT, h):
    """K2 backward of one bucket: (df9T (9, t*rows), dsrT (t, 15, slab));
    see :func:`forces_warp_v4_bwd_plain`.  On the card two kernels, the row
    pass and the slab pass."""
    args = (restT_rows, static_slab, f9T, srT, gidx8, dfT, h)
    if dfT.device.type == "cpu":
        return forces_warp_v4_bwd_plain(*args)
    return forces_warp_v4_bwd_rows(*args), forces_warp_v4_bwd_slab(*args)


def slab_to_slots(buf, slab_ptr, slab_idx, n_slots, group):
    """Fixed-order scatter-reduce (k, n_entries) -> (k, n_slots); see
    :func:`slab_to_slots_plain` and :func:`slab_inverse`."""
    fn = _on("slab_to_slots", buf, slab_to_slots_plain, _launch_slab_to_slots)
    return fn(buf, slab_ptr, slab_idx, n_slots, group)


COUNTED = (moments_v4, forces_warp_v4, moments_v4_bwd, forces_warp_v4_bwd_rows,
           forces_warp_v4_bwd_slab, slab_to_slots)


def reset_launch_counts():
    for fn in COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {fn.__name__: fn.launches for fn in COUNTED}


reset_launch_counts()


# ------------------------------------------------------- differentiable ops
class PairOps(NamedTuple):
    """The per-bucket pair functions an evaluation goes through:
    :data:`KERNELS` (device dispatch) or :data:`PLAIN` (the plain versions
    on any device, the yardstick the kernels are held against on the card)."""

    moments: Callable
    forces: Callable
    moments_bwd: Callable
    forces_bwd: Callable
    to_slots: Callable


KERNELS = PairOps(moments_v4, forces_warp_v4, moments_v4_bwd,
                  forces_warp_v4_bwd, slab_to_slots)
PLAIN = PairOps(moments_v4_plain, forces_warp_v4_plain, moments_v4_bwd_plain,
                forces_warp_v4_bwd_plain, slab_to_slots_plain)


def _cols(b, rows):
    return slice(b.row_start, b.row_start + b.n_tiles * rows)


def _flat(parts, k):
    """(t_b, k, slab_b) per bucket -> the (k, sum_b t_b slab_b) buffer."""
    return torch.cat([p.permute(1, 0, 2).reshape(k, -1) for p in parts], dim=1)


class _MomentsV4(torch.autograd.Function):
    """K1 over every bucket: (posT (3, n_slots), posT_rows (3, m)) ->
    ayT (18, m).  ``posT_rows`` is a view of ``posT``: autograd adds the
    two cotangents."""

    @staticmethod
    def forward(ctx, posT, posT_rows, sb, h, ops):
        ctx.sb, ctx.h, ctx.ops = sb, h, ops
        r = sb.rows
        return torch.cat([
            ops.moments(b.restT_rows, b.static_slab, posT,
                        posT_rows[:, _cols(b, r)], sb.rs6T[:, _cols(b, r)],
                        b.gidx8, h)
            for b in sb.buckets], dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dayT):
        sb, ops = ctx.sb, ctx.ops
        dayT = dayT.contiguous()
        dps, dprow = [], []
        for b in sb.buckets:
            cols = _cols(b, sb.rows)
            d_ps, d_row = ops.moments_bwd(b.restT_rows, b.static_slab,
                                          dayT[:, cols], sb.rs6T[:, cols], ctx.h)
            dps.append(d_ps)
            dprow.append(d_row)
        dposT = ops.to_slots(_flat(dps, 3), sb.slab_ptr, sb.slab_idx,
                             sb.n_slots, sb.group)
        return dposT, torch.cat(dprow, dim=1), None, None, None


class _ForcesWarpV4(torch.autograd.Function):
    """K2 over every bucket: (f9T (9, m), srT (15, n_slots)) -> termjT (3, m)."""

    @staticmethod
    def forward(ctx, f9T, srT, sb, h, ops):
        ctx.sb, ctx.h, ctx.ops = sb, h, ops
        ctx.save_for_backward(f9T, srT)
        return torch.cat([
            ops.forces(b.restT_rows, b.static_slab, f9T[:, _cols(b, sb.rows)],
                       srT, b.gidx8, h)
            for b in sb.buckets], dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dfT):
        sb, ops = ctx.sb, ctx.ops
        f9T, srT = ctx.saved_tensors
        dfT = dfT.contiguous()
        df9, dsr = [], []
        for b in sb.buckets:
            cols = _cols(b, sb.rows)
            d9, d_sr = ops.forces_bwd(b.restT_rows, b.static_slab, f9T[:, cols],
                                      srT, b.gidx8, dfT[:, cols], ctx.h)
            df9.append(d9)
            dsr.append(d_sr)
        dsrT = ops.to_slots(_flat(dsr, SR_FIELDS), sb.slab_ptr, sb.slab_idx,
                            sb.n_slots, sb.group)
        return torch.cat(df9, dim=1), dsrT, None, None, None


def moments_all(posT, posT_rows, sb, h, ops: PairOps = KERNELS):
    """Differentiable K1 over every bucket of ``sb`` (a SparseBlocked):
    ayT (18, m).  Its backward runs the K1 backward per bucket, then one
    :func:`slab_to_slots`."""
    return _MomentsV4.apply(posT, posT_rows, sb, h, ops)


def forces_all(f9T, srT, sb, h, ops: PairOps = KERNELS):
    """Differentiable K2 over every bucket of ``sb``: termjT (3, m).  Its
    backward runs the K2 backward per bucket, then one :func:`slab_to_slots`."""
    return _ForcesWarpV4.apply(f9T, srT, sb, h, ops)
