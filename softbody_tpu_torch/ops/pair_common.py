"""What the two families of pair-kernel wrappers share: the v4 path
(``ops/pair_kernels.py``) and the fused K1 + mid-section path
(``ops/fused_kernels.py``).

* The pair coefficients and the plain pair sums both families' plain
  versions are built from: :func:`pair_coeffs`, :func:`centered_moments`
  (K1's centered A | Y), :func:`warp_termj` (K2's Warp pairing sum) and
  :func:`warp_termj_bwd` (its VJP).
* The launch plumbing: operand checks (:func:`check_scene` for the
  whole-scene kernels of both families), the kernel library's entry
  points, the stream, and the device dispatch :func:`on` (plain version for
  CPU tensors, kernel for CUDA tensors, anything else raises — no
  fallback).

Operands keep the JAX package's lane-major layouts: positions (3, n_slots),
the per-slot K2 record srT (15, n_slots) = [S_6 | R^T_9] with
S_6 = [s00 s01 s02 s11 s12 s22] and R^T_9 = [R00 R10 R20 R01 R11 R21 R02 R12
R22], and the tile-row operands (k, t*rows).

The plain versions state the precision they need: float32 contractions run
as true f32 (TF32 off), because a single-pass reduced-precision dot was
measured to destabilise the episode on the TPU (pair_kernels.py:191-242).
"""

from __future__ import annotations

import ctypes
import functools
import math
import types

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
    """:func:`pair_coeffs` without W (the force kernels never use it)."""
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


def bucket_cols(b, rows):
    """The columns of bucket ``b``'s rows in any lane-major (k, m) array."""
    return slice(b.row_start, b.row_start + b.n_tiles * rows)


def flat_entries(parts, k):
    """(t_b, k, slab_b) per bucket -> the (k, sum_b t_b slab_b) buffer of
    per-slab-entry values that ``slab_to_slots`` reads."""
    return torch.cat([p.permute(1, 0, 2).reshape(k, -1) for p in parts], dim=1)


# A plain version materialises (rows, slab) per tile and per intermediate;
# over a whole blocked-layout scene (288 M pairs at ~112k) that is tens of
# GB, so it runs over chunks of tiles of at most this many pairs.  Every
# sparse bucket at ~112k holds fewer (at most 28.8 M), so it runs whole.
PLAIN_PAIRS = 1 << 25


def tile_chunked(tile_args, row_args):
    """Decorate a plain version ``fn(restT_rows, static_slab, ...)`` to run
    over chunks of tiles of at most :data:`PLAIN_PAIRS` pairs.  The
    arguments at ``tile_args`` are tile-major (first axis t), those at
    ``row_args`` lane-major over the tile rows (last axis t*rows); the rest
    pass whole.  Outputs (or each of a tuple of them) join by kind: 2-D
    lane-major ones along their last axis, 3-D per-tile ones along their
    first; None stays None.  Per tile the arithmetic is the same."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args):
            t, _, rows = args[0].shape
            per = max(1, PLAIN_PAIRS // max(1, rows * args[1].shape[2]))
            if t <= per:
                return fn(*args)
            outs = []
            for a in range(0, t, per):
                b = min(a + per, t)
                sub = list(args)
                for i in tile_args:
                    sub[i] = args[i][a:b]
                for i in row_args:
                    sub[i] = args[i][..., a * rows:b * rows]
                outs.append(fn(*sub))

            def join(parts):
                if parts[0] is None:
                    return None
                return torch.cat(parts, dim=1 if parts[0].dim() == 2 else 0)

            if isinstance(outs[0], tuple):
                return tuple(join(list(p)) for p in zip(*outs))
            return join(outs)
        return run
    return deco


# ------------------------------------------------------------ plain pair sums
def k1_lhs(restT_rows, static_slab, h):
    """K1's per-pair coefficients lhs (t, 6, rows, slab) =
    [-w m_j dx ; gfac V_j dx]."""
    dx, w, gfac = pair_coeffs(restT_rows, static_slab[:, 0:3], h)
    cA = w * static_slab[:, 3:4]
    gv = gfac * static_slab[:, 4:5]
    return torch.stack([cA * (-dx[b]) for b in range(3)]
                       + [gv * dx[b] for b in range(3)], dim=1)


def centered_moments(restT_rows, static_slab, posT, posT_rows, gidx8, h):
    """K1's centered moments ayT (18, t*rows), row 3b+a.

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
    lhs = k1_lhs(restT_rows, static_slab, h)                # (t, 6, rows, slab)
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


def raw_moments_bwd(restT_rows, static_slab, dayT, h):
    """The slab side of K1's VJP: dayT (18, t*rows) -> dpsT (t, 3, slab) =
    sum_blk ct_blk^T @ lhs_blk, the cotangent of the slab positions (the
    centering adds only terms that do not depend on them)."""
    _no_tf32()
    t, _, rows = restT_rows.shape
    lhs = k1_lhs(restT_rows, static_slab, h)                # (t, 6, rows, slab)
    ct = dayT.reshape(6, 3, t, rows)                        # (blk, a, t, r)
    return torch.einsum("katr,tkrs->tas", ct, lhs)


def warp_nw(restT_rows, static_slab, h):
    """nw = gfac V_j dx per pair: 3 x (t, rows, slab)."""
    dx, gfac = pair_coeffs_g(restT_rows, static_slab[:, 0:3], h)
    gv = gfac * static_slab[:, 4:5]
    return [gv * dx[b] for b in range(3)]


def warp_termj(restT_rows, static_slab, f9T, srT, gidx8, h):
    """K2's Warp-pairing sum termj fT (3, t*rows).

    f9T (9, t*rows): F_i, row 3c+d = F_i[c, d]; srT (15, n_slots): the
    per-slot [S_6 | R^T_9] record (a bfloat16 one is upcast once, then the
    same arithmetic: ``cfg.pair_dtype``).  Per pair nw = gfac V_j dx,
    Z_d = sum_b nw_b S_j[d, b]; D = R^T-rows @ Z over the slab; then
    termj[a] = sum_{c,d} F_i[c, d] D[3c+a, d] (the JAX association)."""
    _no_tf32()
    t, _, rows = restT_rows.shape
    slab = static_slab.shape[2]
    sT = srT[:, slab_slots(gidx8, slab)].to(restT_rows.dtype)   # (15, t, slab)
    nw = warp_nw(restT_rows, static_slab, h)
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


def warp_termj_bwd(restT_rows, static_slab, f9T, srT, gidx8, dfT, h):
    """VJP of :func:`warp_termj`: dfT (3, t*rows), the cotangent of termj,
    -> df9T (9, t*rows) and dsrT (t, 15, slab) = [dS_6 | dR^T_9] per slab
    entry.  With z_d = sum_b nw_b S_j[d, b], u_c = sum_d F_i[c, d] z_d and
    w'_c = sum_a df_a R_j[a, c]:
    df9[3c+d] = sum_j z_d w'_c; dR^T[3c+a] = sum_i df_a u_c;
    dS_6[SYM6[3d+b]] += sum_i nw_b y_d with y_d = sum_c F_i[c, d] w'_c."""
    _no_tf32()
    t, _, rows = restT_rows.shape
    slab = static_slab.shape[2]
    sT = srT[:, slab_slots(gidx8, slab)].to(restT_rows.dtype)[:, :, None, :]
    nw = warp_nw(restT_rows, static_slab, h)                 # (t, rows, slab)
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


# ------------------------------------------------------------ launch plumbing
def check(name, x, dtype, device, ndim):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(x.shape)}")


def check_tiles(restT_rows, static_slab, device, gidx8=None):
    """Shared operand checks of the tile launches; returns (t, rows, slab)."""
    dtype = restT_rows.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    check("restT_rows", restT_rows, dtype, device, 3)
    check("static_slab", static_slab, dtype, device, 3)
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
        check("gidx8", gidx8, torch.int32, device, 2)
        if gidx8.shape[0] != t:
            raise ValueError(f"gidx8 has {gidx8.shape[0]} tiles, expected {t}")
        if gidx8.shape[1] == 0 or slab % gidx8.shape[1]:
            raise ValueError(f"slab {slab} is not a multiple of {gidx8.shape[1]} groups")
        tensors.append(("gidx8", gidx8))
    for name, x in tensors:
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return t, rows, slab


def check_lane_major(name, x, dtype, device, k, n=None):
    """A (k, n) lane-major operand: unit stride along lanes, any row stride."""
    check(name, x, dtype, device, 2)
    if x.shape[0] != k or (n is not None and x.shape[1] != n):
        raise ValueError(f"{name} must be ({k}, {n or 'n'}), got {tuple(x.shape)}")
    if x.stride(1) != 1:
        raise ValueError(f"{name} must have unit stride along its lanes")


def check_vector(name, x, dtype, device, n):
    """A contiguous (n,) operand."""
    check(name, x, dtype, device, 1)
    if x.shape[0] != n or x.stride(0) != 1:
        raise ValueError(f"{name} must be a contiguous ({n},) vector, got "
                         f"shape {tuple(x.shape)} stride {x.stride()}")


# The whole-scene kernels' stage (slab entries copied per pass, in 16-byte
# pieces) and the backward slab side's block (entries per block),
# csrc/pair_kernels.cu CH and BCH.
RAGGED_CHUNK = 32
BWD_CHUNK = 128


def aligned(name, x, lane_major=False):
    """The whole-scene kernels copy 16-byte pieces: a 16-byte base and, for
    a lane-major operand, a row stride of a multiple of 16 bytes."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary "
                         f"(address {x.data_ptr():#x})")
    per = 16 // x.element_size()
    if lane_major and x.stride(0) % per:
        raise ValueError(f"{name}'s leading dimension must be a multiple of {per} "
                         f"elements, got {x.stride(0)}")


def check_slab(srT, dtype, device, sb):
    """The K2 slot record srT (15, n_slots): the kernels' ``dtype``, or
    bfloat16 under float32 arithmetic (``cfg.pair_dtype``: storage only, a
    slot group of 8 one 16-byte piece)."""
    slab_dtype = torch.bfloat16 if srT.dtype == torch.bfloat16 else dtype
    if slab_dtype == torch.bfloat16 and (dtype != torch.float32 or sb.group % 8):
        raise TypeError(f"a bfloat16 srT takes float32 kernels and slot groups of "
                        f"a multiple of 8, got {dtype} and {sb.group}")
    check_lane_major("srT", srT, slab_dtype, device, SR_FIELDS, sb.n_slots)


def whole_pieces(sb, piece, name):
    """Refuse a scene whose slabs are not whole ``piece``-entry pieces: the
    kernels that serve only the sparse scene (its slabs are multiples of
    128) have no partial-stage (or partial-chunk) form."""
    odd = [b.slab_len for b in sb.buckets if b.slab_len % piece]
    if odd:
        raise ValueError(f"{name} takes slabs of whole {piece}-entry pieces, "
                         f"got {odd}")


def has_tail(sb, piece) -> int:
    """1 when a slab of ``sb`` ends inside a ``piece``-entry piece (a ring
    stage, or a backward chunk): the kernels' ragged-tail instantiation
    runs (the blocked layout's slabs of 9 run_len)."""
    return int(any(b.slab_len % piece for b in sb.buckets))


def n_entries(sb) -> int:
    """Slab entries of the scene, sum_b t_b slab_b: the columns of a
    per-slab-entry buffer."""
    return sb.gidx_all.shape[0] * sb.group


def n_chunks(sb) -> int:
    """Blocks of the backward's slab side: every slab's ceil(slab / 128)
    pieces."""
    return sum(b.n_tiles * -(-b.slab_len // BWD_CHUNK) for b in sb.buckets)


def check_scene(sb, dtype, device, chunks=False):
    """Operand checks of one whole-scene launch over ``sb`` (a
    SparseBlocked or a Blocked; with ``chunks``, of the backward's slab
    side, also its chunk schedule).  A slab need only be a multiple of the
    slot group: the kernels zero-fill a partial last stage and skip the
    entries past a partial last chunk."""
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
    odd = [b.slab_len for b in sb.buckets if b.slab_len % sb.group]
    if odd:
        raise ValueError(f"slabs {odd} are not multiples of the slot group "
                         f"{sb.group}")
    aligned("static_all", sb.static_all)
    aligned("gidx_all", sb.gidx_all)
    if chunks:
        check("chunks", sb.chunks, torch.int64, device, 2)
        want = (n_chunks(sb), 5)
        if tuple(sb.chunks.shape) != want or not sb.chunks.is_contiguous():
            raise ValueError(f"chunks {tuple(sb.chunks.shape)} must be a contiguous "
                             f"{want}: every {BWD_CHUNK}-entry piece of every slab")


def raise_on(rc: int, what: str):
    if rc != 0:
        msg = _build.library().sb_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} (cudaError {rc})")


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def entry(source, name, dtype, slab_dtype=None):
    """The C entry point ``sb_<name>_<f32|f64>`` of csrc/<source>.cu, or
    ``sb_<name>_bf16`` (float32 on a bfloat16 K2 slab) when ``slab_dtype``
    is bfloat16."""
    lib = _build.library(source)
    if slab_dtype == torch.bfloat16:
        return getattr(lib, f"sb_{name}_bf16")
    return getattr(lib, f"sb_{name}_{'f32' if dtype == torch.float32 else 'f64'}")


def bf16_counted(fn):
    """Give the K2 wrapper ``fn`` a second launch counter, ``fn.bf16``
    (named ``<name>_bf16``), for its kernel's bfloat16-slab instantiation.
    Returns ``fn``."""
    fn.bf16 = types.SimpleNamespace(__name__=f"{fn.__name__}_bf16", launches=0)
    return fn


def counter(fn, srT):
    """What a launch of ``fn``'s kernel on ``srT`` counts on: ``fn``, or its
    bfloat16-slab counter."""
    return fn.bf16 if srT.dtype == torch.bfloat16 else fn


def on(name, x, plain, launch):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    kind = x.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return launch
    raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
