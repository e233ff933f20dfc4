"""The pair kernels of the Taichi pairing (``pair_def_grad="j"``): the
separable K2 and its backward.

Counterpart of ``softbody_tpu/ops/pallas/pair_kernels.py`` +
``softbody_tpu/ops/pallas/packed.py`` for the ``"j"`` branch of
``softbody_tpu/sim/sparse.py:398-406`` (and of the blocked layout,
``softbody_tpu/sim/blocked.py:298-303``):

* :func:`forces_sep` replaces ``_forces_kernel`` (launched by
  ``_forces_fwd_impl`` from ``packed.forces_packed``): per tile row
  f_a = 0.5 V_i (sum_j (G_j grad W_ij)_a + sum_b M_i[a][b] svnw_b) with
  G = V M, M_i = G_i / V_safe,i and svnw = sum_j V_j grad W_ij, fT (3, m).
* :func:`forces_sep_bwd` replaces ``_forces_bwd_kernel`` (launched by
  ``_forces_vjp_bwd``): dfT -> the rows' dG (9, m), the term_i path, and
  per slab entry dG (t, 9, slab), the term_j path; on the card two
  kernels, the row pass and the slab pass.  Volumes are material
  constants: no cotangent, as JAX returns None for them.

Operands are lane-major: G of every slot gT (9, n_slots), row 3a+b =
G[a][b] (``mat3.to_trailing(G)`` order); the tile rows' G is a column range
of the same array.  The kernels read the slab's G through ``gidx8`` (slot =
gidx8[tile, g] * group + k), so the gathered (t, slab, 16) copy the TPU path
staged (``packed.gather_packed``) does not exist here.

Each kernel has a plain PyTorch version (``*_plain``) for CPU tensors; for
CUDA tensors the wrapper launches the hand-written kernel of
csrc/separable_kernels.cu and counts it in its ``launches`` attribute; any
other device raises, and no wrapper falls back to its plain version.
:func:`forces_sep_all` is the differentiable op over every bucket, going
through a ``pair_kernels.PairOps`` (its ``KERNELS`` or ``PLAIN`` table).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .pair_common import (_no_tf32, bucket_cols, check_lane_major, check_tiles,
                          check_vector, entry, flat_entries, on, pair_coeffs_g,
                          raise_on, slab_slots, spline_constants, stream,
                          tile_chunked)

G_FIELDS = 9       # rows of gT: G = V M, row 3a+b = G[a][b]


# ------------------------------------------------------------- plain versions
def _nw(restT_rows, static_slab, h):
    """grad W_ij = gfac dx per pair: 3 x (t, rows, slab)."""
    dx, gfac = pair_coeffs_g(restT_rows, static_slab[:, 0:3], h)
    return [gfac * dx[b] for b in range(3)]


def _svnw(nw, static_slab):
    """sum_j V_j grad W_ij over each row's slab: 3 x (t*rows,)."""
    return [(n * static_slab[:, 4:5]).sum(dim=2).reshape(-1) for n in nw]


def _v_safe(vol_rows):
    return torch.where(vol_rows > 0, vol_rows, torch.ones_like(vol_rows))


@tile_chunked(tile_args=(0, 1, 5), row_args=(2, 4))
def forces_sep_plain(restT_rows, static_slab, gT_rows, gT, vol_rows, gidx8, h):
    """Plain separable K2 of one bucket: fT (3, t*rows).  gT_rows (9, t*rows)
    the rows' G, gT (9, n_slots) every slot's, vol_rows (t*rows,)."""
    _no_tf32()
    t, _, rows = restT_rows.shape
    slab = static_slab.shape[2]
    g_slab = gT[:, slab_slots(gidx8, slab)]                  # (9, t, slab)
    nw = _nw(restT_rows, static_slab, h)
    # D[t, b, k, r] = sum_j nw_b G_j[k]; term_a = sum_b D[b, 3a+b]
    D = torch.einsum("btrs,kts->tbkr", torch.stack(nw), g_slab)
    sv = _svnw(nw, static_slab)
    m_rows = gT_rows / _v_safe(vol_rows)
    half_v = 0.5 * vol_rows
    out = []
    for a in range(3):
        term = (D[:, 0, 3 * a] + D[:, 1, 3 * a + 1] + D[:, 2, 3 * a + 2]).reshape(-1)
        term_i = sum(m_rows[3 * a + b] * sv[b] for b in range(3))
        out.append(half_v * (term + term_i))
    return torch.stack(out)


@tile_chunked(tile_args=(0, 1), row_args=(2, 3))
def forces_sep_bwd_plain(restT_rows, static_slab, vol_rows, dfT, h):
    """Plain separable K2 backward of one bucket: dfT (3, t*rows) ->
    (dgrT (9, t*rows), dgs (t, 9, slab)).  With d = 0.5 V_i df:
    dgrT[3a+b] = (d_a / V_safe) svnw_b and dgs[3a+b] = sum_i grad W_b d_a."""
    _no_tf32()
    t, _, rows = restT_rows.shape
    d = dfT * (0.5 * vol_rows)
    d_over_v = d / _v_safe(vol_rows)
    nw = _nw(restT_rows, static_slab, h)
    sv = _svnw(nw, static_slab)
    dgr = torch.stack([d_over_v[a] * sv[b] for a in range(3) for b in range(3)])
    dgs = torch.einsum("btrs,atr->tabs", torch.stack(nw), d.reshape(3, t, rows))
    return dgr, dgs.reshape(t, G_FIELDS, -1)


# ------------------------------------------------------------ kernel launches
def _launch_forces_sep(restT_rows, static_slab, gT_rows, gT, vol_rows, gidx8, h):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab = check_tiles(restT_rows, static_slab, device, gidx8)
    check_lane_major("gT_rows", gT_rows, dtype, device, G_FIELDS, t * rows)
    check_lane_major("gT", gT, dtype, device, G_FIELDS)
    check_vector("vol_rows", vol_rows, dtype, device, t * rows)
    out = torch.empty((3, t * rows), dtype=dtype, device=device)
    if t == 0:
        return out
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("separable_kernels", "forces_sep", dtype)(
        restT_rows.data_ptr(), static_slab.data_ptr(),
        gT_rows.data_ptr(), gT_rows.stride(0), gT.data_ptr(), gT.stride(0),
        vol_rows.data_ptr(), gidx8.data_ptr(), out.data_ptr(), out.stride(0),
        t, slab, slab // gidx8.shape[1], inv_h, c4h, stream())
    raise_on(rc, "forces_sep")
    forces_sep.launches += 1
    return out


def _check_bwd(restT_rows, static_slab, vol_rows, dfT):
    device, dtype = restT_rows.device, restT_rows.dtype
    t, rows, slab = check_tiles(restT_rows, static_slab, device)
    check_vector("vol_rows", vol_rows, dtype, device, t * rows)
    check_lane_major("dfT", dfT, dtype, device, 3, t * rows)
    return t, rows, slab


def _launch_forces_sep_bwd_rows(restT_rows, static_slab, vol_rows, dfT, h):
    """dgrT (9, t*rows): one lane per row, four warps splitting the slab."""
    t, rows, slab = _check_bwd(restT_rows, static_slab, vol_rows, dfT)
    dtype = restT_rows.dtype
    dgr = torch.empty((G_FIELDS, t * rows), dtype=dtype, device=restT_rows.device)
    if t == 0:
        return dgr
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("separable_kernels", "forces_sep_bwd_rows", dtype)(
        restT_rows.data_ptr(), static_slab.data_ptr(), vol_rows.data_ptr(),
        dfT.data_ptr(), dfT.stride(0), dgr.data_ptr(), dgr.stride(0),
        t, slab, inv_h, c4h, stream())
    raise_on(rc, "forces_sep_bwd_rows")
    forces_sep_bwd_rows.launches += 1
    return dgr


def _launch_forces_sep_bwd_slab(restT_rows, static_slab, vol_rows, dfT, h):
    """dgs (t, 9, slab), field-major underneath: one thread per slab entry,
    looping over the tile's 32 rows."""
    t, rows, slab = _check_bwd(restT_rows, static_slab, vol_rows, dfT)
    dtype = restT_rows.dtype
    dgs = torch.empty((G_FIELDS, t * slab), dtype=dtype, device=restT_rows.device)
    if t:
        inv_h, _, c4h = spline_constants(h, dtype)
        rc = entry("separable_kernels", "forces_sep_bwd_slab", dtype)(
            restT_rows.data_ptr(), static_slab.data_ptr(), vol_rows.data_ptr(),
            dfT.data_ptr(), dfT.stride(0), dgs.data_ptr(), dgs.stride(0),
            t, slab, inv_h, c4h, stream())
        raise_on(rc, "forces_sep_bwd_slab")
        forces_sep_bwd_slab.launches += 1
    return dgs.view(G_FIELDS, t, slab).permute(1, 0, 2)


# ------------------------------------------------ per-bucket device dispatch
def forces_sep(restT_rows, static_slab, gT_rows, gT, vol_rows, gidx8, h):
    """Separable K2 of one bucket: fT (3, t*rows); see
    :func:`forces_sep_plain`."""
    fn = on("forces_sep", gT, forces_sep_plain, _launch_forces_sep)
    return fn(restT_rows, static_slab, gT_rows, gT, vol_rows, gidx8, h)


def forces_sep_bwd_rows(restT_rows, static_slab, vol_rows, dfT, h):
    """The separable K2 backward's row pass: dgrT (9, t*rows)."""
    fn = on("forces_sep_bwd_rows", dfT,
            lambda *a: forces_sep_bwd_plain(*a)[0], _launch_forces_sep_bwd_rows)
    return fn(restT_rows, static_slab, vol_rows, dfT, h)


def forces_sep_bwd_slab(restT_rows, static_slab, vol_rows, dfT, h):
    """The separable K2 backward's slab pass: dgs (t, 9, slab)."""
    fn = on("forces_sep_bwd_slab", dfT,
            lambda *a: forces_sep_bwd_plain(*a)[1], _launch_forces_sep_bwd_slab)
    return fn(restT_rows, static_slab, vol_rows, dfT, h)


def forces_sep_bwd(restT_rows, static_slab, vol_rows, dfT, h):
    """Separable K2 backward of one bucket: (dgrT (9, t*rows), dgs (t, 9,
    slab)); see :func:`forces_sep_bwd_plain`.  On the card two kernels, the
    row pass and the slab pass."""
    args = (restT_rows, static_slab, vol_rows, dfT, h)
    if dfT.device.type == "cpu":
        return forces_sep_bwd_plain(*args)
    return forces_sep_bwd_rows(*args), forces_sep_bwd_slab(*args)


COUNTED = (forces_sep, forces_sep_bwd_rows, forces_sep_bwd_slab)


# ------------------------------------------------------- differentiable op
class _ForcesSep(torch.autograd.Function):
    """Separable K2 over every bucket: gT (9, n_slots) -> fT (3, m).  The
    rows' G is gT's first m columns (tile rows are the slot prefix), so the
    backward adds the row pass's cotangent into those columns of the slab
    pass's scattered one."""

    @staticmethod
    def forward(ctx, gT, vol_m, sb, h, ops):
        ctx.sb, ctx.h, ctx.ops = sb, h, ops
        ctx.save_for_backward(vol_m)
        return torch.cat([
            ops.forces_sep(b.restT_rows, b.static_slab, gT[:, bucket_cols(b, sb.rows)],
                           gT, vol_m[bucket_cols(b, sb.rows)], b.gidx8, h)
            for b in sb.buckets], dim=1)

    @staticmethod
    @once_differentiable
    def backward(ctx, dfT):
        sb, ops = ctx.sb, ctx.ops
        (vol_m,) = ctx.saved_tensors
        dfT = dfT.contiguous()
        dgr, dgs = [], []
        for b in sb.buckets:
            c = bucket_cols(b, sb.rows)
            d_r, d_s = ops.forces_sep_bwd(b.restT_rows, b.static_slab, vol_m[c],
                                          dfT[:, c], ctx.h)
            dgr.append(d_r)
            dgs.append(d_s)
        dgT = ops.to_slots(flat_entries(dgs, G_FIELDS), sb.slab_ptr, sb.slab_idx,
                           sb.n_slots, sb.group)
        m = sb.n_tiles * sb.rows
        dgT[:, :m] += torch.cat(dgr, dim=1)
        return dgT, None, None, None, None


def forces_sep_all(gT, vol_m, sb, h, ops):
    """Differentiable separable K2 over every bucket of ``sb`` (one launch
    per bucket): gT (9, n_slots), vol_m (m,) -> fT (3, m).  Its backward
    runs the row and slab passes per bucket, then one ``slab_to_slots`` of
    the slab pass's 9 fields."""
    return _ForcesSep.apply(gT, vol_m, sb, h, ops)
