"""The gather backend's force evaluation and its VJP as kernels: the (N, K)
neighbour tables of ``core/types.Topology`` (``backend="gather"``, the
default of ``SimConfig`` and of the CLI).

Counterpart of what XLA compiles from ``softbody_tpu/ops/elasticity.py``
inside the jitted step (the JAX gather backend has no Pallas kernel):

* :func:`gather_moments` replaces ``deformation``'s gather and two
  einsums (``elasticity.py:41-52``): per row A_i = sum_k c_ik p_ji (x) X_ji
  and Y_i = sum_k vj_ik p_ji (x) nW_ik, p_ji = p_j - p_i, j = idx[i, k],
  into ayT (18, N) in ``mid_kernels.mid_records``' layout (row 3b+a =
  A[a][b], then Y the same way).  ``mid_records`` then gives the records
  fmT (19, N) = [F_9 | M_9 | V] and, with its ``rec`` option, each row's
  packed source record (:func:`packed_record`): Warp [S_6 | R^T_9 | V]
  (16 values, srT (15, N) = [S_6 | R^T_9] a view of it), Taichi
  [M_9 | V | 0 | 0] (12), row-major, 16-byte aligned.
* :func:`gather_forces` replaces ``elastic_forces``' gathers and einsums
  (``elasticity.py:70-100``): force_i = 0.5 V_i (term_j + M_i sum_v_nw_i),
  term_j = sum_k R_j F_i (V_j S_j) nW_ik in the Warp pairing and
  sum_k V_j M_j nW_ik in the Taichi pairing (``sep``), each neighbour's
  record read with vector loads.
* :func:`gather_moments_bwd` and :func:`gather_forces_bwd` replace XLA's
  VJPs of the same: the cotangents of the rows' own terms and of the
  source (the readers' terms, summed per source row in the fixed CSR
  order of the table's inverse: no float atomics, bitwise repeatable).
  Both source passes stream the Topology's ``inv_row`` (the reader row in
  that order) and a per-entry static in the same order: the forces
  backward ``inv_nw`` (the entry's nW), the moments backward ``inv_cxw``
  ([c X_ji | vj nW_ik]), gathering each reader's row of what the row pass
  wrote (the moments backward: the row-major cotangent, DAY_W values a
  row), whose own term comes from ``sum_c_xji`` / ``sum_v_nw``.  The
  forces backward's record cotangent is lane-major, (REC_W, n_src)
  transposed, so its first 15 rows are the dsrT that ``mid_records_bwd``
  reads.

The neighbours come from a *source*: the rows themselves on one device,
or on a shard of the particle mesh the all-gathered or halo-exchanged
array (``parallel/``).  ``gather_moments`` reads any (n_src, 3) position
tensor through its two strides; the forces read the packed record, the
rows' own on one device or the exchanged records on a shard (the record's
cotangent flows back through ``mid_kernels.mid_records_all``, which adds
the Taichi record's M fields into fmT's).

On the card each wrapper launches csrc/gather_kernels.cu (the forward
kernels once, a backward its row pass and its source pass) and counts one
call in its ``launches``; on the CPU it runs its plain version, the
gathers and einsums with which the JAX package writes this path (the
backward ones by autograd through them); any other device raises, and
nothing falls back.  :func:`moments_all` and :func:`forces_all` are the differentiable
ops, going through a ``pair_kernels.PairOps`` (``KERNELS`` or ``PLAIN``)
as every pair kernel does.  The row gather with a fixed-order backward
(:func:`gather`) and the table's CSR inverse (:func:`index_inverse`,
:func:`inverse_fields`) live here too: the plain versions are built on
them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as tnf
from torch.autograd.function import once_differentiable

from . import _build
from .pair_common import SYM6, _no_tf32, check, check_lane_major, entry, on, raise_on, stream

# R_9[3a+b] = R[a][b] from the record's R^T_9 fields (field 6 + 3b + a)
R9 = tuple(6 + 3 * b + a for a in range(3) for b in range(3))
# the packed source record's width in each pairing (sep): Warp [S_6 | R^T_9
# | V], Taichi [M_9 | V | 0 | 0]; V's field
REC_W = {False: 16, True: 12}
VOL = {False: 15, True: 9}
# the forces backward's per-row scratch: Warp F_9 | h_3, Taichi h_3 | 0
ROW_W = {False: 12, True: 4}
# the moments backward's per-row scratch: dayT's 18 values row-major | 0 | 0
DAY_W = 20


# ------------------------------------------------------------ the row gather
def index_inverse(idx: torch.Tensor, n: int):
    """CSR inverse of an index tensor over ``n`` rows, on its device:
    (order, ptr (n + 1,)), the flat positions reading row r in ascending
    order at order[ptr[r]:ptr[r + 1]].  A stable sort and an integer count,
    so the result does not depend on the run."""
    flat = idx.reshape(-1)
    lengths = torch.bincount(flat, minlength=n)
    return torch.argsort(flat, stable=True), tnf.pad(torch.cumsum(lengths, 0), (1, 0))


def inverse_fields(idx: torch.Tensor, n: int, table) -> dict:
    """A Topology's inverse fields of the (rows, K) table ``idx`` over ``n``
    source rows, with the table's ``nw``, ``xji`` (rows, K, 3), ``c`` and
    ``vj`` (rows, K) (``table[name]``): inv_order and inv_ptr
    (:func:`index_inverse`), which the plain row gather's backward walks,
    and in the same CSR order the reader row inv_row (int32, inv_order //
    K), its entry's nW inv_nw (rows K, 3) and its products inv_cxw (rows K,
    6) = [c X_ji | vj nW_ik], which the backwards' source passes stream."""
    order, ptr = index_inverse(idx, n)
    nw = table["nw"]
    cxw = torch.cat([table["c"][..., None] * table["xji"], table["vj"][..., None] * nw], -1)
    return dict(inv_order=order, inv_ptr=ptr,
                inv_row=torch.div(order, max(idx.shape[1], 1),
                                  rounding_mode="floor").to(torch.int32),
                inv_nw=nw.reshape(-1, 3)[order].contiguous(),
                inv_cxw=cxw.reshape(-1, 6)[order].contiguous())


def rest_corr_lanes(rest_corr: torch.Tensor) -> torch.Tensor:
    """The rest correction (N, 3, 3) lane-major, (9, N) with row 3a+b =
    rc[a][b]: a Topology's ``rcT``, the mid-section kernels' operand."""
    return rest_corr.permute(1, 2, 0).reshape(9, -1).contiguous()


class _Gather(torch.autograd.Function):
    """a (N, ...) -> a[idx] (*idx.shape, ...); the backward sums each row's
    readers in the CSR order (``order``, ``ptr``) with one
    ``segment_reduce``, computing that order from ``idx`` when none is
    given."""

    @staticmethod
    def forward(ctx, a, idx, order, ptr):
        ctx.save_for_backward(idx, order, ptr)
        ctx.rows = a.shape[0]
        return a[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        idx, order, ptr = ctx.saved_tensors
        if order.numel() == 0:
            order, ptr = index_inverse(idx, ctx.rows)
        tail = g.shape[idx.dim():]
        src = g.reshape(idx.numel(), -1)[order]
        out = torch.segment_reduce(src, "sum", offsets=ptr, axis=0)
        return out.reshape(ctx.rows, *tail), None, None, None


def gather(a: torch.Tensor, idx: torch.Tensor, inverse=None) -> torch.Tensor:
    """Row gather a (N, ...) -> (*idx.shape, ...), with a fixed-order
    backward (the default backward of ``a[idx]`` may add with float atomics
    in any order on the card).  ``inverse`` = (order, ptr) of ``idx`` when
    known (the topology's ``inv_order`` / ``inv_ptr``); else the backward
    derives it on the device."""
    if inverse is None:
        none = idx.new_empty(0)
        inverse = (none, none)
    return _Gather.apply(a, idx, *inverse)


def gather_topo(a: torch.Tensor, topo) -> torch.Tensor:
    """Row gather over the rest table: a (n_src, ...) -> (N, K, ...)."""
    return gather(a, topo.idx, (topo.inv_order, topo.inv_ptr))


# ------------------------------------------------------------- plain versions
def _lanes(m: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) -> (9, N), row 3b+a = m[a][b] (ayT's order)."""
    return m.permute(2, 1, 0).reshape(9, -1)


def moments_batched(pos, src, topo):
    """A and Y (each (N, 3, 3)) of the rows ``pos`` (N, 3) against the
    source ``src`` (n_src, 3), or ``pos`` when None: one (N, K, 3) position
    gather and two einsums."""
    _no_tf32()
    pj = gather_topo(pos if src is None else src, topo)      # (N, K, 3)
    pji = pj - pos[:, None, :]
    return (torch.einsum("ij,ija,ijb->iab", topo.c, pji, topo.xji),
            torch.einsum("ij,ija,ijb->iab", topo.vj, pji, topo.nw))


def gather_moments_plain(pos, src, topo):
    """ayT (18, N): :func:`moments_batched` lane-major."""
    return torch.cat([_lanes(m) for m in moments_batched(pos, src, topo)])


def gather_moments_bwd_plain(pos, src, topo, dayT):
    """VJP of :func:`gather_moments_plain`: dayT (18, N) -> (dpos (N, 3),
    dsrc (n_src, 3), or None when the source is the rows: dpos then holds
    the readers' terms too), by autograd through it."""
    with torch.enable_grad():
        ins = [pos.detach().requires_grad_()]
        if src is not None:
            ins.append(src.detach().requires_grad_())
        ay = gather_moments_plain(ins[0], ins[1] if src is not None else None, topo)
        grads = torch.autograd.grad(ay, ins, dayT)
    return grads[0], grads[1] if src is not None else None


def packed_record(fmT, srT, sep: bool):
    """The rows' packed source record (n, REC_W[sep]) from their records fmT
    (19, n) and srT (15, n): Warp [S_6 | R^T_9 | V], Taichi [M_9 | V | 0 |
    0] (what ``mid_kernels.mid_records(..., rec=...)`` writes)."""
    if sep:
        return torch.cat([fmT[9:19].T, fmT.new_zeros((fmT.shape[1], 2))], dim=1)
    return torch.cat([srT.T, fmT[18:19].T], dim=1)


def pair_forces(F, M, V, rec, topo, sep: bool):
    """force_i = 0.5 V_i (term_j + M_i sum_v_nw_i) from the rows' F, M
    (N, 3, 3) and V (N,) and the source's record ``rec``: (n_src, 9) =
    V_j M_j (``sep``) or (n_src, 18) = [V_j S_j | R_j], row-major 3x3
    blocks.  The gathers and einsums of the JAX package's
    ``elastic_forces``."""
    _no_tf32()
    n, K = topo.idx.shape
    term_i = torch.einsum("iab,ib->ia", M, topo.sum_v_nw)
    rj = gather_topo(rec, topo)
    if sep:
        term_j = torch.einsum("ijab,ijb->ia", rj.reshape(n, K, 3, 3), topo.nw)
    else:
        VSj, Rj = rj[..., :9].reshape(n, K, 3, 3), rj[..., 9:].reshape(n, K, 3, 3)
        y = torch.einsum("iab,ijbc,ijc->ija", F, VSj, topo.nw)     # F_i (V_j S_j) nW
        term_j = torch.einsum("ijab,ijb->ia", Rj, y)               # R_j y
    return 0.5 * V[:, None] * (term_j + term_i)


def gather_forces_plain(fmT, rec, topo, sep: bool):
    """Forces (N, 3) from the rows' records fmT (19, N) = [F_9 | M_9 | V] and
    the source's packed record ``rec`` (n_src, REC_W[sep]) (see
    :func:`packed_record`): :func:`pair_forces`.  Its V field is a material
    constant: no cotangent flows into it."""
    n = fmT.shape[1]
    vsrc = rec[:, VOL[sep]].detach()
    if sep:
        g = vsrc[:, None] * rec[:, :9]
    else:
        g = torch.cat([vsrc[:, None] * rec[:, list(SYM6)], rec[:, list(R9)]], dim=1)
    # contiguous (N, 3, 3): a batched product of a strided view runs row by
    # row on the CPU
    F, M = (fmT[r].T.contiguous().reshape(n, 3, 3) for r in (slice(0, 9), slice(9, 18)))
    return pair_forces(F, M, fmT[18], g, topo, sep)


def gather_forces_bwd_plain(fmT, rec, topo, sep: bool, df):
    """VJP of :func:`gather_forces_plain` wrt fmT and the record: df (N, 3)
    -> (dfmT (19, N), its V row zero, drec (n_src, REC_W[sep]), its V field
    and padding zero), by autograd through it."""
    with torch.enable_grad():
        ins = [fmT.detach().requires_grad_(), rec.detach().requires_grad_()]
        f = gather_forces_plain(*ins, topo, sep)
        dfmT, drec = torch.autograd.grad(f, ins, df)
    dfmT[18] = 0
    return dfmT, drec


# ------------------------------------------------------------ kernel launches
def _check_table(topo, dtype, device):
    """The table's operands; returns (n, K)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"kernels take float32 or float64, got {dtype}")
    check("idx", topo.idx, torch.int64, device, 2)
    n, K = topo.idx.shape
    for name, ndim in (("c", 2), ("vj", 2), ("xji", 3), ("nw", 3), ("sum_c_xji", 2),
                       ("sum_v_nw", 2)):
        check(name, getattr(topo, name), dtype, device, ndim)
    shapes = {"idx": (n, K), "c": (n, K), "vj": (n, K), "xji": (n, K, 3),
              "nw": (n, K, 3), "sum_c_xji": (n, 3), "sum_v_nw": (n, 3)}
    for name, shape in shapes.items():
        x = getattr(topo, name)
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}, got "
                             f"{tuple(x.shape)} stride {x.stride()}")
    return n, K


def _check_inverse(topo, device, n_src, static):
    """The table's CSR inverse over n_src source rows, inv_row and the
    per-entry ``static`` that a source pass streams with it (``inv_nw``,
    ``inv_cxw``)."""
    nk = topo.idx.numel()
    fields = [("inv_order", torch.int64, (nk,)), ("inv_ptr", torch.int64, (n_src + 1,)),
              ("inv_row", torch.int32, (nk,)),
              (static, topo.nw.dtype, (nk, {"inv_nw": 3, "inv_cxw": 6}[static]))]
    for name, dtype, shape in fields:
        x = getattr(topo, name)
        check(name, x, dtype, device, len(shape))
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} (the inverse over "
                             f"the source's {n_src} rows), got {tuple(x.shape)}")


def _check_rec(name, x, dtype, device, fields, rows=None):
    """A (rows, fields) record read through its strides."""
    check(name, x, dtype, device, 2)
    if x.shape[1] != fields or (rows is not None and x.shape[0] != rows):
        raise ValueError(f"{name} must be ({rows or 'n_src'}, {fields}), got "
                         f"{tuple(x.shape)}")


def _table_args(topo):
    return (topo.idx.data_ptr(), topo.c.data_ptr(), topo.vj.data_ptr(),
            topo.xji.data_ptr(), topo.nw.data_ptr())


def _strided(x):
    return x.data_ptr(), x.stride(0), x.stride(1)


def _launch_gather_moments(pos, src, topo):
    device, dtype = pos.device, pos.dtype
    n, K = _check_table(topo, dtype, device)
    _check_rec("pos", pos, dtype, device, 3, n)
    source = pos if src is None else src
    _check_rec("src", source, dtype, device, 3)
    if n and K and int(source.shape[0]) == 0:
        raise ValueError("an empty source for a non-empty table")
    ayT = torch.empty((18, n), dtype=dtype, device=device)
    rc = entry("gather_kernels", "gather_moments", dtype)(
        *_table_args(topo), n, K, *_strided(pos), *_strided(source), ayT.data_ptr(),
        ayT.stride(0), stream())
    raise_on(rc, "gather_moments")
    gather_moments.launches += 1
    return ayT


def _launch_gather_moments_bwd(pos, src, topo, dayT):
    device, dtype = dayT.device, dayT.dtype
    n, K = _check_table(topo, dtype, device)
    check_lane_major("dayT", dayT, dtype, device, 18, n)
    n_src = n if src is None else src.shape[0]
    _check_inverse(topo, device, n_src, "inv_cxw")
    dpos = torch.empty((n, 3), dtype=dtype, device=device)
    dayR = torch.empty((n, DAY_W), dtype=dtype, device=device)
    # the row pass writes the rows' own term into dpos; with one output (the
    # source is the rows) the source pass adds the readers' to it
    dsrc = dpos if src is None else torch.empty((n_src, 3), dtype=dtype, device=device)
    rc = entry("gather_kernels", "gather_moments_bwd", dtype)(
        n, K, topo.sum_c_xji.data_ptr(), topo.sum_v_nw.data_ptr(), topo.inv_ptr.data_ptr(),
        topo.inv_row.data_ptr(), topo.inv_cxw.data_ptr(), n_src, dayT.data_ptr(),
        dayT.stride(0), dayR.data_ptr(), dpos.data_ptr(), int(src is None),
        *_strided(dsrc), stream())
    raise_on(rc, "gather_moments_bwd")
    gather_moments_bwd.launches += 1
    return dpos, None if src is None else dsrc


def _forces_operands(fmT, rec, topo, sep):
    """Checks of the forces' operands; returns (n, K)."""
    device, dtype = fmT.device, fmT.dtype
    n, K = _check_table(topo, dtype, device)
    check_lane_major("fmT", fmT, dtype, device, 19, n)
    _check_rec("rec", rec, dtype, device, REC_W[sep])
    if not rec.is_contiguous() or rec.data_ptr() % 16:
        raise ValueError("rec must be a contiguous row-major record on a 16-byte "
                         "boundary (the kernels read it in 16-byte pieces)")
    if n and K and int(rec.shape[0]) == 0:
        raise ValueError("an empty source for a non-empty table")
    return n, K


def _launch_gather_forces(fmT, rec, topo, sep):
    n, K = _forces_operands(fmT, rec, topo, sep)
    out = torch.empty((n, 3), dtype=fmT.dtype, device=fmT.device)
    rc = entry("gather_kernels", "gather_forces", fmT.dtype)(
        topo.idx.data_ptr(), topo.nw.data_ptr(), n, K, topo.sum_v_nw.data_ptr(),
        fmT.data_ptr(), fmT.stride(0), rec.data_ptr(), out.data_ptr(), int(sep), stream())
    raise_on(rc, "gather_forces")
    gather_forces.launches += 1
    return out


def _launch_gather_forces_bwd(fmT, rec, topo, sep, df):
    n, K = _forces_operands(fmT, rec, topo, sep)
    device, dtype = fmT.device, fmT.dtype
    check("df", df, dtype, device, 2)
    if tuple(df.shape) != (n, 3) or not df.is_contiguous():
        raise ValueError(f"df must be a contiguous ({n}, 3), got {tuple(df.shape)}")
    n_src = rec.shape[0]
    _check_inverse(topo, device, n_src, "inv_nw")
    dfmT = torch.empty((19, n), dtype=dtype, device=device)
    rowrec = torch.empty((n, ROW_W[sep]), dtype=dtype, device=device)
    # the record's cotangent, lane-major (what mid_records_bwd reads as dsrT)
    dsrc = torch.empty((REC_W[sep], n_src), dtype=dtype, device=device)
    rc = entry("gather_kernels", "gather_forces_bwd", dtype)(
        topo.idx.data_ptr(), topo.nw.data_ptr(), n, K, topo.sum_v_nw.data_ptr(),
        fmT.data_ptr(), fmT.stride(0), rec.data_ptr(), n_src, df.data_ptr(),
        topo.inv_ptr.data_ptr(), topo.inv_row.data_ptr(), topo.inv_nw.data_ptr(),
        dfmT.data_ptr(), dfmT.stride(0), rowrec.data_ptr(), dsrc.data_ptr(),
        dsrc.stride(0), int(sep), stream())
    raise_on(rc, "gather_forces_bwd")
    gather_forces_bwd.launches += 1
    return dfmT, dsrc.T


def kernel_info(K: float) -> dict:
    """What the card gives each lane-group kernel on rows of K entries (and
    source rows of K readers): {(kernel, pairing, dtype): {registers,
    local_bytes, threads, blocks_per_sm, lanes}} (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; ``lanes`` a row), the
    forces kernels in each pairing, ``gather_moments_bwd_src`` under
    ``"both"``.  Needs a card."""
    lib = _build.library("gather_kernels")
    keys = ("registers", "local_bytes", "threads", "blocks_per_sm", "lanes")
    out = {}
    for which, name in enumerate(("gather_forces", "gather_forces_bwd_rows",
                                  "gather_forces_bwd_src", "gather_moments_bwd_src")):
        pairings = ((0, "both"),) if which == 3 else ((0, "warp"), (1, "taichi"))
        for sep, pairing in pairings:
            for mode, dtype in enumerate(("float32", "float64")):
                buf = (ctypes.c_int * len(keys))()
                raise_on(lib.sb_gather_info(which, sep, float(K), mode, buf),
                         f"{name} attributes")
                out[name, pairing, dtype] = dict(zip(keys, buf))
    return out


# ------------------------------------------------------------ device dispatch
def gather_moments(pos, src, topo):
    """ayT (18, N) of the rows ``pos`` (N, 3) against ``src`` (n_src, 3) or
    the rows themselves (None); one launch on the card."""
    fn = on("gather_moments", pos, gather_moments_plain, _launch_gather_moments)
    return fn(pos, src, topo)


def gather_moments_bwd(pos, src, topo, dayT):
    """VJP of :func:`gather_moments`: (dpos (N, 3), dsrc (n_src, 3) or None);
    a row pass and a source pass on the card."""
    fn = on("gather_moments_bwd", dayT, gather_moments_bwd_plain,
            _launch_gather_moments_bwd)
    return fn(pos, src, topo, dayT)


def gather_forces(fmT, rec, topo, sep):
    """Forces (N, 3) from fmT (19, N) and the source's packed record ``rec``
    (see :func:`gather_forces_plain`); one launch on the card."""
    fn = on("gather_forces", fmT, gather_forces_plain, _launch_gather_forces)
    return fn(fmT, rec, topo, sep)


def gather_forces_bwd(fmT, rec, topo, sep, df):
    """VJP of :func:`gather_forces`: (dfmT (19, N), drec (n_src, REC_W[sep])),
    see :func:`gather_forces_bwd_plain`; a row pass and a source pass on the
    card, drec a transposed lane-major buffer."""
    fn = on("gather_forces_bwd", df, gather_forces_bwd_plain, _launch_gather_forces_bwd)
    return fn(fmT, rec, topo, sep, df)


COUNTED = (gather_moments, gather_moments_bwd, gather_forces, gather_forces_bwd)


# ------------------------------------------------------- differentiable ops
class _GatherMoments(torch.autograd.Function):
    """(pos (N, 3), src (n_src, 3) or None) -> ayT (18, N)."""

    @staticmethod
    def forward(ctx, pos, src, topo, ops):
        ctx.topo, ctx.ops = topo, ops
        ctx.save_for_backward(pos, src)
        return ops.gather_moments(pos, src, topo)

    @staticmethod
    @once_differentiable
    def backward(ctx, dayT):
        pos, src = ctx.saved_tensors
        dpos, dsrc = ctx.ops.gather_moments_bwd(pos, src, ctx.topo, dayT.contiguous())
        return dpos, dsrc, None, None


class _GatherForces(torch.autograd.Function):
    """(fmT (19, N), rec (n_src, REC_W[sep])) -> forces (N, 3)."""

    @staticmethod
    def forward(ctx, fmT, rec, topo, sep, ops):
        ctx.topo, ctx.sep, ctx.ops = topo, sep, ops
        ctx.save_for_backward(fmT, rec)
        return ops.gather_forces(fmT, rec, topo, sep)

    @staticmethod
    @once_differentiable
    def backward(ctx, df):
        fmT, rec = ctx.saved_tensors
        dfmT, drec = ctx.ops.gather_forces_bwd(fmT, rec, ctx.topo, ctx.sep,
                                               df.contiguous())
        return dfmT, drec, None, None, None


def moments_all(pos, src, topo, ops):
    """Differentiable :func:`gather_moments`: ayT (18, N), one launch on the
    card; its backward one :func:`gather_moments_bwd`.  ``src`` None: the
    source is ``pos`` and the backward adds both terms into one
    cotangent."""
    return _GatherMoments.apply(pos, src, topo, ops)


def forces_all(fmT, rec, topo, sep, ops):
    """Differentiable :func:`gather_forces`: forces (N, 3), one launch on the
    card; its backward one :func:`gather_forces_bwd`."""
    return _GatherForces.apply(fmT, rec, topo, sep, ops)
