"""Dynamic particle-particle contact by re-binning every evaluation
(counterpart of ``softbody_tpu/ops/contact.py``).

The elastic topology is static (a rest-space neighbour table, sim.py:123-127),
so self-contact and contact between bodies need CURRENT-position neighbours.
Every evaluation re-bins the particles on the device:

  cell keys -> one stable sort -> per-cell windows via two ``searchsorted``
  per 3x3x3 offset -> fixed-cap candidate gathers -> short-range quadratic
  penalty forces.

The sort is stable (``torch.argsort(stable=True)``, as ``jnp.argsort``), so
the candidate order, the order of summation and the candidates dropped on
an overfull cell match the JAX package's.  Gradients flow through the
gathered position values (the sort is piecewise constant); the position
gather's backward adds each particle's readers in a fixed order
(``ops/gather_kernels.gather``), so gradients repeat bit for bit.  Each
unordered pair is enumerated from both sides, so the force field is
antisymmetric.

Out-of-grid particles (e.g. the far-grid padding slots of sparse and
blocked scenes) get a sentinel key that sorts past every real cell and is
never queried: they neither receive nor exert contact forces.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .gather_kernels import gather

@dataclasses.dataclass(frozen=True)
class ContactGrid:
    """Static contact-grid spec.

    ``cell >= r_c`` so the 27-cell stencil covers the interaction radius.
    ``cap`` bounds the particles per cell that are considered; a fuller
    cell drops candidates (``with_overflow`` reports it; size the grid
    with :func:`max_occupancy`).

    ``exclude``: optional (N, K) table of pairs contact skips — normally
    the static rest neighbours, which the elastic model already couples,
    so contact acts only on new proximity."""

    lo: torch.Tensor          # (3,) grid origin, f32
    cell: float
    dims: tuple               # (gx, gy, gz)
    cap: int
    r_c: float                # contact radius
    stiffness: float
    exclude: torch.Tensor | None = None

    def to(self, device) -> "ContactGrid":
        return dataclasses.replace(
            self, lo=self.lo.to(device),
            exclude=None if self.exclude is None else self.exclude.to(device))


def build_contact_grid(lo, hi, r_c, cap=16, stiffness=3e5, cell_scale=1.0,
                       exclude=None, device="cpu") -> ContactGrid:
    """Grid covering [lo, hi] with cell = r_c * cell_scale (>= r_c)."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    cell = float(r_c) * float(cell_scale)
    dims = tuple(int(d) for d in np.maximum(np.ceil((hi - lo) / cell), 1))
    return ContactGrid(
        lo=torch.as_tensor(lo.astype(np.float32), device=device), cell=cell,
        dims=dims, cap=int(cap), r_c=float(r_c), stiffness=float(stiffness),
        exclude=None if exclude is None
        else torch.as_tensor(np.asarray(exclude), dtype=torch.int64, device=device))


def slot_exclude(idx, slot_of_particle, n_slots: int) -> np.ndarray:
    """A particle-space (N, K) neighbour table (e.g. ``build_topology``'s
    ``idx``) mapped into the slot space of a sparse or blocked scene:
    (n_slots, K), slot ``sop[i]``'s row holding ``sop[idx[i]]``; every
    other slot's row names the slot itself (padding slots are out of the
    grid and inert anyway)."""
    idx = np.asarray(idx, np.int64)
    sop = np.asarray(slot_of_particle, np.int64)
    out = np.tile(np.arange(n_slots, dtype=np.int64)[:, None], (1, idx.shape[1]))
    out[sop] = sop[idx]
    return out


def _in_grid(qx, qy, qz, dims) -> torch.Tensor:
    gx, gy, gz = dims
    return (qx >= 0) & (qx < gx) & (qy >= 0) & (qy < gy) & (qz >= 0) & (qz < gz)


def _keys(pos: torch.Tensor, grid: ContactGrid):
    """Linear cell key per particle (out-of-grid -> sentinel n_cells), the
    cell coordinates and the in-grid flag.  The grid's sizes enter as
    Python ints: no host-to-device copy, which would wait for the device."""
    gx, gy, gz = grid.dims
    q = torch.floor((pos - grid.lo.to(pos)) / grid.cell).to(torch.int64)
    inb = _in_grid(q[:, 0], q[:, 1], q[:, 2], grid.dims)
    q = torch.stack([torch.clamp(q[:, k], 0, d - 1) for k, d in enumerate(grid.dims)],
                    dim=1)
    key = (q[:, 0] * gy + q[:, 1]) * gz + q[:, 2]
    return torch.where(inb, key, gx * gy * gz), q, inb


def _pair_force(dx: torch.Tensor, grid: ContactGrid) -> torch.Tensor:
    """Quadratic penalty f_i += k (r_c - r)^2 dx / r for r < r_c
    (dx = x_i - x_j)."""
    r2 = torch.sum(dx * dx, dim=-1)
    r = torch.sqrt(torch.clamp(r2, min=1e-30))
    depth = torch.clamp(grid.r_c - r, min=0.0)
    # r -> 0 (self / coincident) gives depth = r_c; callers mask those
    return (grid.stiffness * depth * depth / r)[..., None] * dx


def contact_forces(pos, grid: ContactGrid, exclude=None, with_overflow=False):
    """(N, 3) contact forces from current positions, re-binned on the device.

    ``exclude`` defaults to ``grid.exclude``.  ``with_overflow`` also
    returns a device bool, True when a queried cell holds more than ``cap``
    particles (candidates were dropped); it comes free from the windows the
    enumeration computes anyway.  The caller reads it (``sim/rollout``
    reads it once per episode or chunk)."""
    if exclude is None:
        exclude = grid.exclude
    return contact_forces_query(pos, pos, 0, grid, exclude_q=exclude,
                                with_overflow=with_overflow)


def contact_forces_query(pos_all, pos_q, gid_offset: int, grid: ContactGrid,
                         exclude_q=None, with_overflow=False):
    """Contact forces on a query subset against the full particle set.

    ``pos_all`` (N, 3) is binned; row i of ``pos_q`` (nq, 3) is global
    particle ``gid_offset + i`` (for self-exclusion; candidate ids are
    global).  ``exclude_q`` (nq, K): global ids each query row skips.

    The 27 stencil offsets are handled together, as (27, nq, cap) candidate
    arrays, so a call issues a few dozen device operations instead of 27
    times as many; the per-offset force sums are then added in the JAX
    package's offset order.  The exclude test looks each candidate up in
    its row's sorted exclude list (a batched binary search); the JAX
    package compares every candidate with every entry, an (nq, cap, K)
    mask per offset, with the same result."""
    n = pos_all.shape[0]
    nq = pos_q.shape[0]
    dev = pos_all.device
    gx, gy, gz = grid.dims
    key, _, _ = _keys(pos_all, grid)
    _, q, inb = _keys(pos_q, grid)
    order = torch.argsort(key, stable=True)
    skey = key[order]

    # stencil offset k is (k // 9, k // 3 % 3, k % 3) - 1: x outermost, the
    # order of JAX's three nested loops
    k = torch.arange(27, device=dev)[:, None]
    qx, qy, qz = q[:, 0] + k // 9 - 1, q[:, 1] + (k // 3) % 3 - 1, q[:, 2] + k % 3 - 1
    valid = inb & _in_grid(qx, qy, qz, grid.dims)                 # (27, nq)
    nkey = torch.where(valid, (qx * gy + qy) * gz + qz, gx * gy * gz)
    start = torch.searchsorted(skey, nkey)
    end = torch.searchsorted(skey, nkey, right=True)
    slots = start[..., None] + torch.arange(grid.cap, device=dev)  # (27, nq, cap)
    cand = order[torch.clamp(slots, 0, n - 1)]
    gid_q = gid_offset + torch.arange(nq, device=dev)
    mask = (slots < end[..., None]) & (cand != gid_q[:, None]) & valid[..., None]
    if exclude_q is not None:
        excl = torch.sort(exclude_q.to(torch.int64), dim=1).values.contiguous()
        per_row = cand.permute(1, 0, 2).reshape(nq, -1).contiguous()   # (nq, 27 cap)
        at = torch.clamp(torch.searchsorted(excl, per_row), max=excl.shape[1] - 1)
        hit = (torch.gather(excl, 1, at) == per_row).reshape(nq, -1, grid.cap)
        mask &= ~hit.permute(1, 0, 2)
    dx = pos_q[:, None, :] - gather(pos_all, cand)                 # (27, nq, cap, 3)
    sums = torch.sum(torch.where(mask[..., None], _pair_force(dx, grid), 0.0), dim=2)
    f = sums[0]
    for s in sums[1:]:
        f = f + s
    if with_overflow:
        return f, torch.any(valid & (end - start > grid.cap))
    return f


def contact_forces_allpairs(pos, grid: ContactGrid, exclude=None, rows=None,
                            chunk: int = 512):
    """The same pair law over every pair, O(N) per row (the oracle).
    ``rows``: the particles whose forces are computed (default all),
    ``chunk`` of them at a time; ``exclude`` defaults to ``grid.exclude``."""
    if exclude is None:
        exclude = grid.exclude
    n = pos.shape[0]
    _, _, inb = _keys(pos, grid)
    rows = torch.arange(n, device=pos.device) if rows is None else rows
    out = []
    for s in range(0, rows.numel(), chunk):
        r = rows[s:s + chunk]
        dx = pos[r][:, None, :] - pos[None, :, :]
        mask = torch.sum(dx * dx, dim=-1) < grid.r_c * grid.r_c
        mask[torch.arange(r.numel(), device=pos.device), r] = False
        mask &= inb[r][:, None] & inb[None, :]
        if exclude is not None:
            skip = torch.zeros_like(mask).scatter_(1, exclude[r], True)
            mask &= ~skip
        out.append(torch.sum(torch.where(mask[..., None], _pair_force(dx, grid), 0.0),
                             dim=1))
    return torch.cat(out)


def max_occupancy(pos, grid: ContactGrid) -> int:
    """The most particles in any cell; must stay <= cap for exact
    enumeration."""
    key, _, _ = _keys(pos, grid)
    gx, gy, gz = grid.dims
    return int(torch.bincount(key, minlength=gx * gy * gz + 1)[:-1].max())
