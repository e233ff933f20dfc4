"""Column-dense slot layout (the blocked backend's neighbour structure).

The port's own numpy copy of ``softbody_tpu/topology/blocks.py``; its
output is bit-identical to the JAX package's (tests/test_torch_blocks.py).
The layout's text follows:


Replaces the reference's CUDA spatial hash (wp.HashGrid, sim.py:123-127) with a
layout engineered for contiguous DMA and dense tile compute:

* Space is divided into cells of edge >= 2h (one-cell reach).
* Particles are binned; every occupied (x, y) column stores its z-range of
  cells densely, each cell padded to a fixed capacity C of "slots".
* Slot order: column-major over (x, y), contiguous in z within a column.
* A tile = ``tz`` consecutive cells of one column (tz*C slot rows).
* The neighborhood of a tile = the 3x3 surrounding columns, each contributing
  one contiguous z-run of (tz + 2) cells -> the per-step "slab" is 9
  contiguous slot ranges, fetched with a single XLA gather-of-slices.

Per-pair SPH coefficients are *recomputed from rest geometry* inside the pair
kernels (cheaper than any stored-table scheme at TPU bandwidth), so the only
persistent structures are this layout + small static per-slab arrays.

Empty slots carry mass 0 / volume 0 so every pair term vanishes; self-pairs are
excluded by rest-distance == 0 (rest positions are deduplicated at build).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SlotLayout:
    """Host-side description of the slot space (all numpy)."""

    cell: float                  # cell edge length (>= 2h)
    capacity: int                # C: slots per cell
    tz: int                      # cells per tile (along z)
    n_slots: int
    n_tiles: int
    slab_runs: int               # 9 (3x3 columns)
    run_len: int                 # L: (tz + 2) * C slots per run
    slot_of_particle: np.ndarray  # (N,) particle -> slot
    particle_of_slot: np.ndarray  # (n_slots,) slot -> particle or -1
    tile_start: np.ndarray       # (n_tiles,) first slot row of each tile
    slab_start: np.ndarray       # (n_tiles, 9) start slot of each slab run

    @property
    def slab_len(self) -> int:
        return self.slab_runs * self.run_len

    @property
    def tile_rows(self) -> int:
        return self.tz * self.capacity


def build_slot_layout(
    rest: np.ndarray,
    support_radius: float,
    tz: int = 4,
    capacity: int | None = None,
    cell_scale: float = 1.0,
) -> SlotLayout:
    rest = np.asarray(rest, dtype=np.float64)
    n = rest.shape[0]
    cell = support_radius * cell_scale
    lo = rest.min(axis=0) - 1e-9
    q = np.floor((rest - lo) / cell).astype(np.int64)

    # capacity: max cell occupancy (median-ish bodies keep this near the mean)
    key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
    _, counts = np.unique(key, return_counts=True)
    occ_max = int(counts.max())
    C = capacity if capacity is not None else occ_max
    if C < occ_max:
        raise ValueError(f"cell capacity {C} < max occupancy {occ_max}")
    # Capacity is rounded to a multiple of 32 so that cell boundaries (and
    # hence slab-run starts) align to 32-slot groups: dynamic slab data is
    # fetched as packed 128-float rows (32 slots x 4f / 8 slots x 16f), which
    # is the only gather/DMA shape the TPU moves at bandwidth.  This also makes
    # tile rows (tz * C) a multiple of 8 (Mosaic sublane alignment).
    C = ((C + 31) // 32) * 32

    # columns: occupied (x, y) with padded z extents
    col_key = q[:, 0] << 21 | q[:, 1]
    cols, col_inv = np.unique(col_key, return_inverse=True)
    n_cols = len(cols)
    zlo = np.full(n_cols, np.iinfo(np.int64).max)
    zhi = np.full(n_cols, np.iinfo(np.int64).min)
    np.minimum.at(zlo, col_inv, q[:, 2])
    np.maximum.at(zhi, col_inv, q[:, 2])
    # extend extents by 1 cell both ways so a tile's own column run (tz+2 cells
    # starting one cell below the tile) always exists, then pad to tile multiple
    zlo = zlo - 1
    zhi = zhi + 1
    n_cells_col = zhi - zlo + 1
    n_cells_col = np.maximum(n_cells_col, tz + 2)
    n_cells_col = ((n_cells_col + tz - 1) // tz) * tz
    col_cell_start = np.concatenate([[0], np.cumsum(n_cells_col)])
    total_cells = int(col_cell_start[-1])
    run_cells = tz + 2
    # one dedicated all-empty run for missing neighbor columns
    empty_run_start = total_cells * C
    n_slots = (total_cells + run_cells) * C

    # assign particles to slots (vectorized rank-within-cell)
    cell_index = col_cell_start[col_inv] + (q[:, 2] - zlo[col_inv])
    order = np.argsort(cell_index, kind="stable")
    sorted_ci = cell_index[order]
    # rank of each particle within its cell = position - first index of its run
    run_first = np.zeros(n, dtype=np.int64)
    new_run = np.flatnonzero(np.diff(sorted_ci)) + 1
    run_first[new_run] = new_run
    np.maximum.accumulate(run_first, out=run_first)
    rank = np.arange(n, dtype=np.int64) - run_first
    slot_of_particle = np.empty(n, dtype=np.int64)
    slot_of_particle[order] = sorted_ci * C + rank
    particle_of_slot = np.full(n_slots, -1, dtype=np.int64)
    particle_of_slot[slot_of_particle] = np.arange(n)

    # tiles: tz cells per tile within each column
    n_tiles_col = n_cells_col // tz
    tile_col = np.repeat(np.arange(n_cols), n_tiles_col)
    tile_z = np.concatenate([np.arange(k) for k in n_tiles_col])  # tile idx within column
    n_tiles = len(tile_col)
    tile_cell = col_cell_start[tile_col] + tile_z * tz
    tile_start = (tile_cell * C).astype(np.int64)

    # slab: for the 3x3 neighbor columns, a z-run of (tz + 2) cells starting one
    # cell below the tile, clamped into the neighbor column's extent
    col_lookup = {int(c): i for i, c in enumerate(cols)}
    cx = (cols >> 21).astype(np.int64)
    cy = (cols & ((1 << 21) - 1)).astype(np.int64)
    slab_start = np.zeros((n_tiles, 9), dtype=np.int64)
    for t in range(n_tiles):
        ci = tile_col[t]
        # z of tile start within the column's padded extent
        z0 = tile_z[t] * tz - 1  # one cell below, in padded-extent coords
        k = 0
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                nb = col_lookup.get(int(((cx[ci] + dx) << 21) | (cy[ci] + dy)))
                if nb is None:
                    slab_start[t, k] = empty_run_start
                else:
                    # align the window into the neighbor column's coords:
                    # same absolute z; shift by extent offset difference
                    zz = z0 + (zlo[ci] - zlo[nb])
                    zz = min(max(zz, 0), n_cells_col[nb] - run_cells)
                    slab_start[t, k] = (col_cell_start[nb] + zz) * C
                k += 1
    return SlotLayout(
        cell=float(cell),
        capacity=int(C),
        tz=int(tz),
        n_slots=int(n_slots),
        n_tiles=int(n_tiles),
        slab_runs=9,
        run_len=int(run_cells * C),
        slot_of_particle=slot_of_particle,
        particle_of_slot=particle_of_slot,
        tile_start=tile_start.astype(np.int32),
        slab_start=slab_start.astype(np.int32),
    )


def validate_layout(layout: SlotLayout, rest: np.ndarray, support_radius: float) -> dict:
    """Check every true neighbor pair is covered by its tile's slab.

    Returns coverage/efficiency stats; raises on a miss.
    """
    from .neighbors import neighbor_csr

    n = rest.shape[0]
    off, nbr = neighbor_csr(np.asarray(rest, np.float64), support_radius)
    rows = layout.tile_rows
    # slot -> tile of each row slot
    tile_of_slot = np.full(layout.n_slots, -1, dtype=np.int64)
    for t in range(layout.n_tiles):
        tile_of_slot[layout.tile_start[t]: layout.tile_start[t] + rows] = t
    # slab membership per tile (set of slots)
    slab_sets: dict[int, set] = {}

    def slab_set(t):
        if t not in slab_sets:
            slab_sets[t] = set(
                np.concatenate(
                    [np.arange(s, s + layout.run_len) for s in layout.slab_start[t]]
                ).tolist()
            )
        return slab_sets[t]

    missing = 0
    for i in range(n):
        si = layout.slot_of_particle[i]
        t = tile_of_slot[si]
        ss = slab_set(int(t))
        for j in nbr[off[i]:off[i + 1]]:
            if int(layout.slot_of_particle[j]) not in ss:
                missing += 1
    if missing:
        raise AssertionError(f"{missing} neighbor pairs not covered by slabs")
    real = np.sum(layout.particle_of_slot >= 0)
    return {
        "slot_efficiency": real / layout.n_slots,
        "n_slots": layout.n_slots,
        "n_tiles": layout.n_tiles,
        "slab_len": layout.slab_len,
        "capacity": layout.capacity,
        "pairs_per_slot": layout.slab_len,
    }


def build_varcol_layout(
    rest: np.ndarray,
    support_radius: float,
    rows: int = 32,
    cell_scale: float = 1.0,
) -> SlotLayout:
    """Variable-capacity column layout ("varcol") — the low-waste successor to
    the fixed-capacity cell layout above.

    Columns are (x, y) cells of edge >= 2h; WITHIN a column particles are
    simply z-sorted and stored densely (no per-cell capacity padding).  A tile
    is ``rows`` consecutive slots of one column; its slab is one z-window per
    neighbor column, located by searchsorted on the column's z values:

        window = [z_min(tile) - 2h, z_max(tile) + 2h]

    All windows share one global length L (the max over (tile, column),
    8-aligned so packed-row gathers stay group-aligned); over-fetched slots are
    either > 2h away in z (w = 0 by geometry) or column padding (mass 0).
    Columns are padded to max(ceil(len/rows)*rows, L) so windows never cross
    column boundaries.

    Pair-count waste drops from ~50x (capacity-max x empty cells x cube vs
    sphere) to ~10-15x; see PERF_NOTES.md.
    """
    rest = np.asarray(rest, dtype=np.float64)
    n = rest.shape[0]
    cell = support_radius * cell_scale
    lo = rest.min(axis=0) - 1e-9
    q = np.floor((rest[:, :2] - lo[:2]) / cell).astype(np.int64)  # (x, y) cells
    col_key = (q[:, 0] << 21) | q[:, 1]
    cols, col_inv = np.unique(col_key, return_inverse=True)
    n_cols = len(cols)

    # sort particles by (column, z)
    order = np.lexsort((rest[:, 2], col_inv))
    col_sorted = col_inv[order]
    z_sorted = rest[order, 2]
    col_counts = np.bincount(col_inv, minlength=n_cols)
    col_first = np.concatenate([[0], np.cumsum(col_counts)])  # into sorted order

    # ---- pass 1: window spans in particle counts (padding-independent)
    # tiles enumerate rows-sized chunks of each column's REAL particles
    reach = support_radius
    col_lookup = {int(c): i for i, c in enumerate(cols)}
    cx = (cols >> 21).astype(np.int64)
    cy = (cols & ((1 << 21) - 1)).astype(np.int64)

    tile_specs = []      # (col, chunk_index, zlo_tile, zhi_tile)
    for ci in range(n_cols):
        cnt = int(col_counts[ci])
        n_chunks = max((cnt + rows - 1) // rows, 1)
        for k in range(n_chunks):
            a = col_first[ci] + k * rows
            b = min(col_first[ci] + cnt, a + rows)
            if b > a:
                zlo_t, zhi_t = z_sorted[a], z_sorted[b - 1]
            else:  # pure-padding tile (empty column chunk)
                zlo_t = zhi_t = 0.0
            tile_specs.append((ci, k, zlo_t - reach, zhi_t + reach))

    # window particle-counts per (tile, neighbor column), 8-aligned start slack
    L = 8
    win = []
    for (ci, k, wlo, whi) in tile_specs:
        entries = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                nb = col_lookup.get(int(((cx[ci] + dx) << 21) | (cy[ci] + dy)))
                if nb is None:
                    entries.append((None, 0, 0))
                    continue
                zs = z_sorted[col_first[nb]: col_first[nb] + col_counts[nb]]
                s = int(np.searchsorted(zs, wlo, side="left"))
                e = int(np.searchsorted(zs, whi, side="right"))
                s8 = (s // 8) * 8
                entries.append((nb, s8, e))
                L = max(L, e - s8)
        win.append(entries)
    L = ((L + 7) // 8) * 8

    # ---- pass 2: slot space with padded columns.  Lengths must be multiples
    # of ``rows`` (tiles partition the slot space contiguously — downstream
    # code reads tile rows as the [0, n_tiles*rows) prefix) AND >= L (windows
    # stay within their column).
    pad_len = np.maximum(((col_counts + rows - 1) // rows) * rows, rows)
    pad_len = np.maximum(pad_len, ((L + rows - 1) // rows) * rows)
    col_slot_start = np.concatenate([[0], np.cumsum(pad_len)])
    empty_run_start = int(col_slot_start[-1])
    n_slots = empty_run_start + L

    slot_of_particle = np.empty(n, dtype=np.int64)
    slot_of_particle[order] = (
        col_slot_start[col_sorted]
        + (np.arange(n) - col_first[col_sorted])
    )
    particle_of_slot = np.full(n_slots, -1, dtype=np.int64)
    particle_of_slot[slot_of_particle] = np.arange(n)

    n_tiles_col = pad_len // rows
    n_tiles = int(n_tiles_col.sum())
    tile_start = np.zeros(n_tiles, dtype=np.int64)
    slab_start = np.full((n_tiles, 9), empty_run_start, dtype=np.int64)

    # map pass-1 tiles (real chunks) onto pass-2 tile ids; extra padding tiles
    # (beyond the real chunk count) keep all-empty slabs
    t_id = 0
    spec_by_col = {}
    for idx, spec in enumerate(tile_specs):
        spec_by_col.setdefault(spec[0], []).append(idx)
    for ci in range(n_cols):
        for k in range(int(n_tiles_col[ci])):
            tile_start[t_id] = col_slot_start[ci] + k * rows
            specs = spec_by_col.get(ci, [])
            if k < len(specs):
                entries = win[specs[k]]
                for j, (nb, s8, e) in enumerate(entries):
                    if nb is None:
                        continue
                    start = min(s8, int(pad_len[nb]) - L)
                    start = max(start, 0)
                    # coverage check: the clamped window must still span [s8, e)
                    assert start + L >= e, "varcol window underflow — L too small"
                    slab_start[t_id, j] = col_slot_start[nb] + start
            t_id += 1
    assert t_id == n_tiles
    # contiguity invariant: tiles partition [0, n_tiles * rows)
    assert np.array_equal(tile_start, np.arange(n_tiles, dtype=np.int64) * rows), (
        "varcol tiles must be a contiguous slot prefix"
    )

    # tile_rows == rows is encoded as tz=1, capacity=rows (SlotLayout reuses
    # the v1 fields; tile_rows = tz * capacity)
    return SlotLayout(
        cell=float(cell),
        capacity=int(rows),
        tz=1,
        n_slots=int(n_slots),
        n_tiles=n_tiles,
        slab_runs=9,
        run_len=int(L),
        slot_of_particle=slot_of_particle,
        particle_of_slot=particle_of_slot,
        tile_start=tile_start.astype(np.int32),
        slab_start=slab_start.astype(np.int32),
    )
