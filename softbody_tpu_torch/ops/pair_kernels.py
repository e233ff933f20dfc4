"""The two pair kernels of the forward sparse path: K1 (moments) and K2
(Warp-pairing forces).

Counterpart of ``softbody_tpu/ops/pallas/pair_kernels.py`` +
``softbody_tpu/ops/pallas/packed.py`` for the v4 forward path:

* :func:`moments_v4` replaces ``_moments_kernel_v4`` (launched by
  ``packed.moments_packed_v4``): per tile row, the CENTERED moments
  A_pq (rows 0-8) and Y (rows 9-17) of ayT (18, m), row 3b+a.
* :func:`forces_warp_v4` replaces ``_forces_warp_kernel_v4`` (launched by
  ``packed.forces_warp_packed_v4``): per tile row, the Warp pairing sum
  termj_a = sum_j (R_j F_i S_j nw_ij)_a, fT (3, m).

Each has a plain PyTorch version (``*_plain``): an explicit gather of the
tile's candidate slots, then dense per-tile math.  The wrapper takes it only
for tensors on the CPU.  For CUDA tensors it launches the hand-written kernel
(csrc/pair_kernels.cu, built at first use by ops/_build.py) through a
``torch.autograd.Function`` and counts the launch in its ``launches``
attribute; any other device raises.  There is no fallback from the kernel to
the plain version.

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
def moments_v4_plain(restT_rows, static_slab, posT, posT_rows, gidx8, h):
    """Plain K1: centered moments ayT (18, t*rows), row 3b+a.

    restT_rows (t, 3, rows); static_slab (t, 5, slab) = [rest_3 | m | V];
    posT (3, n_slots) positions; posT_rows (3, t*rows) the tile rows'
    positions; gidx8 (t, slab/group).  Row 3*blk + a holds
    dots[a] - (pos_i[a] - c_a) * rowsum_blk, with c the tile's first rest
    row, lhs = [-w m_j dx ; gfac V_j dx] and dots = lhs @ [pos_j - c] — the
    rowsum comes from the same coefficients as the dots."""
    _no_tf32()
    t, _, rows = restT_rows.shape
    slab = static_slab.shape[2]
    pos_slab = posT[:, slab_slots(gidx8, slab)]             # (3, t, slab)
    dx, w, gfac = pair_coeffs(restT_rows, static_slab[:, 0:3], h)
    cA = w * static_slab[:, 3:4]
    gv = gfac * static_slab[:, 4:5]
    lhs = torch.stack([cA * (-dx[b]) for b in range(3)]
                      + [gv * dx[b] for b in range(3)], dim=1)  # (t, 6, rows, slab)
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


# ------------------------------------------------------------ kernel launches
def _check(name, x, dtype, device, ndim):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")


def _check_tiles(restT_rows, static_slab, gidx8, device):
    """Shared operand checks of both launches; returns (t, rows, slab, group)."""
    dtype = restT_rows.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    _check("restT_rows", restT_rows, dtype, device, 3)
    _check("static_slab", static_slab, dtype, device, 3)
    _check("gidx8", gidx8, torch.int32, device, 2)
    t, three, rows = restT_rows.shape
    slab = static_slab.shape[2]
    if three != 3 or static_slab.shape[:2] != (t, 5) or gidx8.shape[0] != t:
        raise ValueError("tile operand shapes disagree: restT_rows "
                         f"{tuple(restT_rows.shape)}, static_slab "
                         f"{tuple(static_slab.shape)}, gidx8 {tuple(gidx8.shape)}")
    if rows != _build.ROWS:
        raise ValueError(f"the kernels take rows={_build.ROWS} tiles, got {rows}")
    if gidx8.shape[1] == 0 or slab % gidx8.shape[1]:
        raise ValueError(f"slab {slab} is not a multiple of {gidx8.shape[1]} groups")
    for name, x in (("restT_rows", restT_rows), ("static_slab", static_slab),
                    ("gidx8", gidx8)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return t, rows, slab, slab // gidx8.shape[1]


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


def _launch_moments(restT_rows, static_slab, posT, posT_rows, gidx8, h):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab, group = _check_tiles(restT_rows, static_slab, gidx8, device)
    _check_lane_major("posT", posT, dtype, device, 3)
    _check_lane_major("posT_rows", posT_rows, dtype, device, 3, t * rows)
    out = torch.empty((18, t * rows), dtype=dtype, device=device)
    if t == 0:
        return out
    inv_h, c4, c4h = spline_constants(h, dtype)
    lib = _build.library()
    fn = lib.sb_moments_v4_f32 if dtype == torch.float32 else lib.sb_moments_v4_f64
    rc = fn(restT_rows.data_ptr(), static_slab.data_ptr(),
            posT.data_ptr(), posT.stride(0),
            posT_rows.data_ptr(), posT_rows.stride(0),
            gidx8.data_ptr(), out.data_ptr(), out.stride(0),
            t, slab, group, inv_h, c4, c4h, _stream())
    _raise_on(rc, "moments_v4")
    moments_v4.launches += 1
    return out


def _launch_forces(restT_rows, static_slab, f9T, srT, gidx8, h):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab, group = _check_tiles(restT_rows, static_slab, gidx8, device)
    _check_lane_major("f9T", f9T, dtype, device, 9, t * rows)
    _check_lane_major("srT", srT, dtype, device, SR_FIELDS)
    out = torch.empty((3, t * rows), dtype=dtype, device=device)
    if t == 0:
        return out
    inv_h, _, c4h = spline_constants(h, dtype)
    lib = _build.library()
    fn = (lib.sb_forces_warp_v4_f32 if dtype == torch.float32
          else lib.sb_forces_warp_v4_f64)
    rc = fn(restT_rows.data_ptr(), static_slab.data_ptr(),
            f9T.data_ptr(), f9T.stride(0), srT.data_ptr(), srT.stride(0),
            gidx8.data_ptr(), out.data_ptr(), out.stride(0),
            t, slab, group, inv_h, c4h, _stream())
    _raise_on(rc, "forces_warp_v4")
    forces_warp_v4.launches += 1
    return out


class _MomentsV4(torch.autograd.Function):
    """K1 on the card.  Its backward kernel (``_moments_bwd_kernel_v4``) is
    ROADMAP queue 2, item 3."""

    @staticmethod
    def forward(ctx, restT_rows, static_slab, posT, posT_rows, gidx8, h):
        return _launch_moments(restT_rows, static_slab, posT, posT_rows,
                               gidx8, h)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "moments_v4 backward: the K1 backward kernel is not ported yet "
            "(ROADMAP queue 2, item 3)")


class _ForcesWarpV4(torch.autograd.Function):
    """K2 on the card.  Its backward kernel (``_forces_warp_bwd_kernel_v4``)
    is ROADMAP queue 2, item 4."""

    @staticmethod
    def forward(ctx, restT_rows, static_slab, f9T, srT, gidx8, h):
        return _launch_forces(restT_rows, static_slab, f9T, srT, gidx8, h)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "forces_warp_v4 backward: the K2 backward kernel is not ported "
            "yet (ROADMAP queue 2, item 4)")


def moments_v4(restT_rows, static_slab, posT, posT_rows, gidx8, h):
    """K1: centered moments ayT (18, t*rows); see :func:`moments_v4_plain`.
    CPU tensors -> the plain version; CUDA tensors -> the kernel."""
    kind = posT.device.type
    if kind == "cpu":
        return moments_v4_plain(restT_rows, static_slab, posT, posT_rows,
                                gidx8, h)
    if kind == "cuda":
        return _MomentsV4.apply(restT_rows, static_slab, posT, posT_rows,
                                gidx8, h)
    raise ValueError(f"moments_v4 runs on cpu or cuda, not {posT.device}")


def forces_warp_v4(restT_rows, static_slab, f9T, srT, gidx8, h):
    """K2: Warp-pairing termj fT (3, t*rows); see :func:`forces_warp_v4_plain`.
    CPU tensors -> the plain version; CUDA tensors -> the kernel."""
    kind = srT.device.type
    if kind == "cpu":
        return forces_warp_v4_plain(restT_rows, static_slab, f9T, srT,
                                    gidx8, h)
    if kind == "cuda":
        return _ForcesWarpV4.apply(restT_rows, static_slab, f9T, srT,
                                   gidx8, h)
    raise ValueError(f"forces_warp_v4 runs on cpu or cuda, not {srT.device}")


moments_v4.launches = 0
forces_warp_v4.launches = 0


def reset_launch_counts():
    moments_v4.launches = 0
    forces_warp_v4.launches = 0


class PairOps(NamedTuple):
    """The K1/K2 pair: :data:`KERNELS` (device dispatch) or :data:`PLAIN`
    (the plain versions on any device, the yardstick the kernels are held
    against on the card)."""

    moments: Callable
    forces: Callable


KERNELS = PairOps(moments_v4, forces_warp_v4)
PLAIN = PairOps(moments_v4_plain, forces_warp_v4_plain)
