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
  ``_forces_vjp_bwd``): dfT -> per slab entry dG (9, n_entries), the
  term_j path, and the rows' dG (9, m), the term_i path.  Volumes are
  material constants: no cotangent, as JAX returns None for them.

Both take a whole scene (a SparseBlocked or a Blocked: its ``schedule``
and ``chunks``) and launch once per evaluation, as the other pair kernels
do: the forward is K2 v4's ragged kernel of csrc/pair_kernels.cu on the
12 fields rest_3 | G_9, the backward the slab side's chunk blocks with the
rows' term in the chunk-0 blocks.  Both read svnw from the scene's static
row sums rs6T[3:6] (the same function as the TPU kernel's in-kernel sum,
as K2 v2 reads it); the plain versions sum it over the slab, as the TPU
kernel does.  A per-entry output is the (9, n_entries) buffer
``slab_to_slots`` reads, a tile's entry s at column gi_off * group + s.
The per-bucket plain versions (``*_plain``) stay the yardstick;
``*_scene_plain`` runs them over the buckets into the whole-scene outputs
(what the wrappers run on the CPU, and ``PLAIN``).

Operands are lane-major: G of every slot gT (9, n_slots), row 3a+b =
G[a][b] (``mat3.to_trailing(G)`` order); the tile rows' G is a column range
of the same array.  The kernels read the slab's G through ``gidx8`` (slot =
gidx8[tile, g] * group + k), so the gathered (t, slab, 16) copy the TPU path
staged (``packed.gather_packed``) does not exist here.

For CUDA tensors the wrapper launches the hand-written kernel and counts
it in its ``launches`` attribute; for CPU tensors it runs the plain
version; any other device raises, and no wrapper falls back to its plain
version.  :func:`forces_sep_all` is the differentiable op over the scene,
going through a ``pair_kernels.PairOps`` (its ``KERNELS`` or ``PLAIN``
table).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .pair_common import (BWD_CHUNK, RAGGED_CHUNK, _no_tf32, aligned, bucket_cols,
                          check_lane_major, check_scene, check_vector, entry,
                          flat_entries, has_tail, n_entries, on, pair_coeffs_g,
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


def forces_sep_scene_plain(sb, gT, vol_m, h):
    """Plain separable K2 over a whole scene: the per-bucket
    :func:`forces_sep_plain` concatenated in tile order, fT (3, m)."""
    return torch.cat([
        forces_sep_plain(b.restT_rows, b.static_slab, gT[:, bucket_cols(b, sb.rows)],
                         gT, vol_m[bucket_cols(b, sb.rows)], b.gidx8, h)
        for b in sb.buckets], dim=1)


def forces_sep_bwd_scene_plain(sb, vol_m, dfT, h):
    """Plain separable K2 backward over a whole scene: the per-bucket
    :func:`forces_sep_bwd_plain` placed into the whole-scene outputs, (dgs
    (9, n_entries) in :func:`~.pair_common.flat_entries`' order, a tile's
    entry s at column gi_off * group + s; dgr (9, m), the rows' term)."""
    parts = [forces_sep_bwd_plain(b.restT_rows, b.static_slab,
                                  vol_m[bucket_cols(b, sb.rows)],
                                  dfT[:, bucket_cols(b, sb.rows)], h)
             for b in sb.buckets]
    return (flat_entries([p[1] for p in parts], G_FIELDS),
            torch.cat([p[0] for p in parts], dim=1))


# ------------------------------------------------------------ kernel launches
def _check_sep(sb, vol_m, dtype, device, chunks):
    """Operand checks of one whole-scene separable launch; returns m.  The
    epilogue (forward) and the row term (backward) read svnw from the
    scene's static row sums rs6T[3:6]."""
    check_scene(sb, dtype, device, chunks)
    m = sb.n_tiles * sb.rows
    check_vector("vol_m", vol_m, dtype, device, m)
    check_lane_major("rs6T", sb.rs6T, dtype, device, 6, m)
    return m


def _launch_forces_sep(sb, gT, vol_m, h):
    """fT (3, m): a block per tile of the schedule, a lane per row, four
    warps splitting the slab, G gathered in 16-byte pieces."""
    device, dtype = gT.device, gT.dtype
    m = _check_sep(sb, vol_m, dtype, device, False)
    check_lane_major("gT", gT, dtype, device, G_FIELDS, sb.n_slots)
    aligned("gT", gT, lane_major=True)
    out = torch.empty((3, m), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return out
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "forces_sep", dtype)(
        sb.schedule.data_ptr(), sb.n_tiles, sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), sb.gidx_all.data_ptr(), gT.data_ptr(), gT.stride(0),
        vol_m.data_ptr(), sb.rs6T.data_ptr(), sb.rs6T.stride(0),
        out.data_ptr(), out.stride(0), sb.group, inv_h, c4h,
        has_tail(sb, RAGGED_CHUNK), stream())
    raise_on(rc, "forces_sep")
    forces_sep.launches += 1
    return out


def _launch_forces_sep_bwd(sb, vol_m, dfT, h):
    """(dgs (9, n_entries), dgr (9, m)): a block per 128-entry chunk of
    every slab, two entries per thread, the chunk-0 blocks writing the
    rows' term."""
    device, dtype = dfT.device, dfT.dtype
    m = _check_sep(sb, vol_m, dtype, device, True)
    check_lane_major("dfT", dfT, dtype, device, 3, m)
    dgs = torch.empty((G_FIELDS, n_entries(sb)), dtype=dtype, device=device)
    dgr = torch.empty((G_FIELDS, m), dtype=dtype, device=device)
    if sb.n_tiles == 0:
        return dgs, dgr
    inv_h, _, c4h = spline_constants(h, dtype)
    rc = entry("pair_kernels", "forces_sep_bwd", dtype)(
        sb.chunks.data_ptr(), sb.chunks.shape[0], sb.rest_rows.data_ptr(),
        sb.static_all.data_ptr(), vol_m.data_ptr(), sb.rs6T.data_ptr(),
        sb.rs6T.stride(0), dfT.data_ptr(), dfT.stride(0), dgs.data_ptr(), dgs.stride(0),
        dgr.data_ptr(), dgr.stride(0), sb.group, inv_h, c4h, has_tail(sb, BWD_CHUNK),
        stream())
    raise_on(rc, "forces_sep_bwd")
    forces_sep_bwd.launches += 1
    return dgs, dgr


# ------------------------------------------------------------ device dispatch
def forces_sep(sb, gT, vol_m, h):
    """Separable K2 over every tile of the scene ``sb``: fT (3, m) from gT
    (9, n_slots) and the rows' volumes vol_m (m,); one launch on the card,
    :func:`forces_sep_scene_plain` on the CPU."""
    fn = on("forces_sep", gT, forces_sep_scene_plain, _launch_forces_sep)
    return fn(sb, gT, vol_m, h)


def forces_sep_bwd(sb, vol_m, dfT, h):
    """Separable K2 backward over the scene: (dgs (9, n_entries), dgr
    (9, m)); one launch on the card, :func:`forces_sep_bwd_scene_plain` on
    the CPU."""
    fn = on("forces_sep_bwd", dfT, forces_sep_bwd_scene_plain, _launch_forces_sep_bwd)
    return fn(sb, vol_m, dfT, h)


COUNTED = (forces_sep, forces_sep_bwd)


# ------------------------------------------------------- differentiable op
class _ForcesSep(torch.autograd.Function):
    """Separable K2 over the whole scene: gT (9, n_slots) -> fT (3, m).  The
    rows' G is gT's first m columns (tile rows are the slot prefix), so the
    backward adds the rows' term into those columns of the scattered slab
    side."""

    @staticmethod
    def forward(ctx, gT, vol_m, sb, h, ops):
        ctx.sb, ctx.h, ctx.ops = sb, h, ops
        ctx.save_for_backward(vol_m)
        return ops.forces_sep(sb, gT, vol_m, h)

    @staticmethod
    @once_differentiable
    def backward(ctx, dfT):
        sb, ops = ctx.sb, ctx.ops
        (vol_m,) = ctx.saved_tensors
        dgs, dgr = ops.forces_sep_bwd(sb, vol_m, dfT.contiguous(), ctx.h)
        dgT = ops.to_slots(dgs, sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
        dgT[:, :dgr.shape[1]] += dgr
        return dgT, None, None, None, None


def forces_sep_all(gT, vol_m, sb, h, ops):
    """Differentiable separable K2 over every tile of ``sb``: gT (9, n_slots),
    vol_m (m,) -> fT (3, m), one launch on the card.  Its backward is one
    launch (the slab side and the rows' term), then one ``slab_to_slots``
    of its 9 fields."""
    return _ForcesSep.apply(gT, vol_m, sb, h, ops)
