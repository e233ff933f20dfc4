"""Core state and scene records.

Counterpart of ``softbody_tpu/core/types.py`` (``ParticleState``,
``Materials``, the gather backend's ``Topology`` and ``Scene``), of the sparse-layout records
of ``softbody_tpu/sim/sparse.py`` (``DevBucket``, ``SparseBlocked``) and of
the blocked layout's ``Blocked`` (``softbody_tpu/ops/blocked.py``).  JAX
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


class Topology(NamedTuple):
    """Static rest-space neighbour tables of the gather backend, with the
    rest-space constants precomputed (``softbody_tpu/core/types.py:45-77``).

    A padded (N, K) index table; padding entries point at the particle
    itself (``idx[i, k] = i``) with ``mask = 0``, so gathers stay in
    bounds and masked terms vanish.  ``inv_order`` / ``inv_lengths`` are
    the CSR inverse of ``idx`` (host-built): the flat positions i K + k
    that read row r are ``inv_order[sum(inv_lengths[:r]) :][:inv_lengths[r]]``,
    ascending — the fixed order in which the gather's backward adds them
    (``ops/elasticity.gather``)."""

    idx: torch.Tensor          # (N, K) int64 neighbour indices
    mask: torch.Tensor         # (N, K) {0, 1} validity
    w: torch.Tensor            # (N, K) W(X_i - X_j, h)
    nw: torch.Tensor           # (N, K, 3) grad W(X_i - X_j, h)
    xji: torch.Tensor          # (N, K, 3) X_j - X_i
    c: torch.Tensor            # (N, K) w_ij m_j  (A_pq weights)
    vj: torch.Tensor           # (N, K) V_j mask
    sum_c_xji: torch.Tensor    # (N, 3) sum_j c_ij X_ji
    rest_corr: torch.Tensor    # (N, 3, 3) sum_j V_j X_ji (x) nw_ij
    sum_v_nw: torch.Tensor     # (N, 3) sum_j V_j nw_ij
    inv_order: torch.Tensor    # (N K,) int64
    inv_lengths: torch.Tensor  # (N,) int64

    @property
    def n_particles(self) -> int:
        return self.idx.shape[0]

    @property
    def max_neighbors(self) -> int:
        return self.idx.shape[1]


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
    the K2 ``term_i`` epilogue (on the fused path inside the K2 v2 kernel;
    its plain version sums its own), and the K1 backward of either path
    reads all six.

    ``slab_ptr`` / ``slab_idx`` are the CSR inverse of the buckets' ``gidx8``
    (``ops.pair_kernels.slab_inverse``): the fixed-order index through which
    the backward adds per-slab-entry gradients into slots.

    The buckets' arrays are views of three scene-wide ones, so that one
    kernel launch reaches every tile (``ops.pair_kernels.sparse_blocked``
    builds them): ``rest_rows`` (n_tiles, 3, rows) in tile order,
    ``static_all`` the buckets' (t_b, 5, slab_b) static slabs end to end and
    ``gidx_all`` their (t_b, slab_b / group) gidx8.  ``schedule`` lists every
    tile once, longest slab first: [tile, slab, offset of its (5, slab)
    block in static_all, offset of its gidx8 row in gidx_all]
    (``ops.pair_kernels.tile_schedule``); ``chunks`` every 128-entry piece
    of every slab, in tile order: [tile, slab, the two offsets, first
    entry] (``ops.pair_kernels.chunk_schedule``), the backward's slab
    side.  A slab need only be a multiple of ``group``; the sparse layout's
    are multiples of 128."""

    buckets: tuple             # tuple[DevBucket, ...]
    rs6T: torch.Tensor         # (6, n_tiles * rows)
    rows: int
    n_tiles: int
    n_slots: int
    group: int
    slab_ptr: torch.Tensor     # (n_slots / group + 1,) int32
    slab_idx: torch.Tensor     # (sum_b t_b slab_b / group,) int32
    rest_rows: torch.Tensor    # (n_tiles, 3, rows)
    static_all: torch.Tensor   # (sum_b t_b 5 slab_b,)
    gidx_all: torch.Tensor     # (sum_b t_b slab_b / group,) int32
    schedule: torch.Tensor     # (n_tiles, 4) int64
    chunks: torch.Tensor       # (sum_b t_b ceil(slab_b / 128), 5) int64


@dataclasses.dataclass(frozen=True)
class Blocked:
    """Blocked (column-dense slot) topology (lives in ``Scene.blocked``),
    from ``topology/blocks.py``: tile t's rows are slots [32 t, 32 t + 32)
    (the tiles partition the slot prefix), its slab 9 runs of ``run_len``
    slots starting at ``slab_start[t]`` (one per neighbour column; an
    absent column points at the layout's empty run).

    To the pair kernels it is ONE bucket of the sparse machinery
    (``bucket``: restT_rows (t, 3, 32), static_slab (t, 5, 9 run_len) =
    [rest_3 | mass | vol], gidx8 (t, slab / 8), tile_start 0), so the
    per-bucket ops serve it unchanged, with its own CSR scatter index
    ``slab_ptr`` / ``slab_idx``.  ``rs6T`` (6, m) holds the raw K1's row
    sums on an all-ones RHS (rows 0:3 sum_j w m_j (-dx), rows 3:6 sum_j
    gfac V_j dx, from the same kernel and coefficients as the forward's
    dots), which the forward subtracts as pos_i * rs6 and K2 v2 reads as
    svnw.  The JAX layout's ``cells`` tiles of tz * C rows are cut into
    32-row tiles sharing their slab.

    To the whole-scene kernels it is a scene like a ``SparseBlocked``:
    ``rest_rows`` / ``static_all`` / ``gidx_all`` are views of its bucket's
    contiguous arrays, and ``schedule`` / ``chunks`` come from
    ``ops.pair_kernels.schedules`` (the scene build and
    ``convert.scene_from_numpy`` both take them from there).  Its slab of
    9 run_len entries need not be a multiple of the kernels' 32- or
    128-entry pieces (1,944 at the ~112k stretch scene): the last piece of
    every tile is partial."""

    bucket: DevBucket
    slab_start: torch.Tensor   # (n_tiles, 9) int64 first slot of each run
    rs6T: torch.Tensor         # (6, n_tiles * rows)
    run_len: int
    n_slots: int
    group: int
    slab_ptr: torch.Tensor     # (n_slots / group + 1,) int32
    slab_idx: torch.Tensor     # (n_tiles * slab / group,) int32, live groups only
    schedule: torch.Tensor     # (n_tiles, 4) int64
    chunks: torch.Tensor       # (n_tiles * ceil(slab / 128), 5) int64

    @property
    def buckets(self) -> tuple:
        return (self.bucket,)

    @property
    def rows(self) -> int:
        return self.bucket.rows

    @property
    def n_tiles(self) -> int:
        return self.bucket.n_tiles

    @property
    def slab_len(self) -> int:
        return self.bucket.slab_len

    @property
    def rest_rows(self) -> torch.Tensor:
        return self.bucket.restT_rows

    @property
    def static_all(self) -> torch.Tensor:
        return self.bucket.static_slab.view(-1)

    @property
    def gidx_all(self) -> torch.Tensor:
        return self.bucket.gidx8.view(-1)


class Scene(NamedTuple):
    """Everything an episode needs except the design variable ``x``.

    Exactly one of ``topology`` (the gather backend, ``sim/scene.build_scene``)
    and ``blocked`` (a sparse or blocked slot layout) is set.  On a slot
    scene the particle axis is SLOTS and ``slot_of_particle`` maps particle
    order into it; on a gather scene it is the particles themselves and
    ``blocked``, ``rest_corr`` and ``slot_of_particle`` are None.
    ``obstacles`` (``ops/obstacles.Obstacles``) and ``contact``
    (``ops/contact.ContactGrid``) add their forces in
    ``sim/rollout.total_force`` on every backend."""

    rest_position: torch.Tensor        # (N, 3)
    materials: Materials
    out_num: int                       # outer-shell particles (sim.py:53)
    blocked: SparseBlocked | Blocked | None = None
    rest_corr: torch.Tensor | None = None        # (3, 3, m) static nabla_u rest term
    slot_of_particle: torch.Tensor | None = None  # (n_particles,) int64
    obstacles: object = None
    contact: object = None
    topology: Topology | None = None

    @property
    def device(self) -> torch.device:
        return self.rest_position.device

    @property
    def dtype(self) -> torch.dtype:
        return self.rest_position.dtype
