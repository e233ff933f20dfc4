"""Core state and scene records.

Counterpart of ``softbody_tpu/core/types.py`` and of the sparse-layout records
of ``softbody_tpu/sim/sparse.py`` (``DevBucket``, ``SparseBlocked``).  JAX
pytrees become NamedTuples / frozen dataclasses of torch tensors; every
tensor of one scene lives on one device and has one floating dtype.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch


class ParticleState(NamedTuple):
    """Dynamic per-slot state carried across timesteps.

    ``elastic_forces`` rides along because the trapezoidal integrator reuses
    the forces of the previous step (reference sim.py:353/357)."""

    position: torch.Tensor        # (N, 3)
    velocity: torch.Tensor        # (N, 3)
    elastic_forces: torch.Tensor  # (N, 3)


class Materials(NamedTuple):
    """Per-slot material and constraint fields (constant within an episode)."""

    mass: torch.Tensor      # (N,)   integrator mass (1 on empty slots)
    volume: torch.Tensor    # (N,)   V_i = m_i / rho_i (0 on empty slots)
    mu: torch.Tensor        # (N,)   first Lame parameter
    lam: torch.Tensor       # (N,)   second Lame parameter
    free: torch.Tensor      # (N, 3) Dirichlet mask (1 = free, 0 = clamped)
    external: torch.Tensor  # (N, 3) constant external force


@dataclasses.dataclass(frozen=True)
class DevBucket:
    """One bucket's static arrays: ``n_tiles`` tiles of ``rows`` slots, each
    against ``slab_len`` candidate slots.

    Tiles are bucket-major, so a bucket's tiles are rows
    [tile_start, tile_start + n_tiles) of any tile-major array, and its slot
    rows are columns [tile_start * rows, (tile_start + n_tiles) * rows) of
    any lane-major (k, n_slots) array."""

    gidx8: torch.Tensor        # (t_b, slab/group) int32 candidate group ids
    restT_rows: torch.Tensor   # (t_b, 3, rows) rest positions of the tile rows
    static_slab: torch.Tensor  # (t_b, 5, slab) [rest_3 | mass | vol] of the slab
    tile_start: int
    rows: int
    slab_len: int

    @property
    def n_tiles(self) -> int:
        return self.restT_rows.shape[0]

    @property
    def row_start(self) -> int:
        """First slot row of the bucket."""
        return self.tile_start * self.rows


@dataclasses.dataclass(frozen=True)
class SparseBlocked:
    """Sparse-bucketed topology (lives in ``Scene.blocked``).

    ``rs6T`` holds the static rest row sums, lane-major: rows 0:3 are
    sum_j w_ij m_j (X_j - X_i) and rows 3:6 sum_j V_j grad W_ij, host-built
    in f64 over the true pairs.  The forward path reads only rows 3:6, in
    the K2 ``term_i`` epilogue (the fused path's K2 sums its own), and the
    K1 backward of either path reads all six.

    ``slab_ptr`` / ``slab_idx`` are the CSR inverse of the buckets' ``gidx8``
    (``ops.pair_kernels.slab_inverse``): the fixed-order index through which
    the backward adds per-slab-entry gradients into slots."""

    buckets: tuple             # tuple[DevBucket, ...]
    rs6T: torch.Tensor         # (6, n_tiles * rows)
    rows: int
    n_tiles: int
    n_slots: int
    group: int
    slab_ptr: torch.Tensor     # (n_slots / group + 1,) int32
    slab_idx: torch.Tensor     # (sum_b t_b slab_b / group,) int32


class Scene(NamedTuple):
    """Everything an episode needs except the design variable ``x``.

    The particle axis is SLOTS; ``slot_of_particle`` maps particle order
    into it.  ``obstacles`` / ``contact`` are kept so that a scene carrying
    them is refused (their ports are still open ROADMAP items)."""

    rest_position: torch.Tensor        # (N, 3)
    materials: Materials
    out_num: int                       # outer-shell particles (sim.py:53)
    blocked: SparseBlocked
    rest_corr: torch.Tensor            # (3, 3, m) static nabla_u rest term
    slot_of_particle: torch.Tensor     # (n_particles,) int64
    obstacles: object = None
    contact: object = None

    @property
    def device(self) -> torch.device:
        return self.rest_position.device

    @property
    def dtype(self) -> torch.dtype:
        return self.rest_position.dtype
