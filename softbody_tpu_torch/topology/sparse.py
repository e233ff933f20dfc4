"""Sparse candidate-group slot layout — round-2 successor to the varcol window.

The PyTorch port's own numpy copy of ``softbody_tpu/topology/sparse.py``: the
layout integers it emits must stay bit-identical to the JAX package's
(tests/test_torch_layout.py), so edit both or neither.

The varcol layout (topology/blocks.py::build_varcol_layout) fetches, for every
32-row tile, a fixed 9-column x global-L slab: at 100k particles that is
~78x more candidate pairs than true rest neighbors (measured: slab 1944 vs
~25 true neighbor groups).  The waste is (a) the global max L, (b) the
box-vs-sphere geometry of the 3x3 column window, and (c) z-windows sized for
the whole tile.

This layout replaces the window with an explicit per-tile CANDIDATE GROUP
LIST.  Slot space is identical to varcol (columns of (x, y) cells, particles
z-sorted and dense within a column, columns padded to a multiple of ``rows``);
the unit of candidacy is a GROUP of 8 consecutive slots (= one packed 128-float
gather row, the minimum the TPU moves at bandwidth).  For each tile we keep
exactly the groups whose real-particle bounding box is within the support
radius of the tile's bounding box — an exact-over-approximation at 8-particle
granularity (inert padding slots inside a kept group contribute zero through
mass = volume = 0, like every other empty slot).

Tiles are then BUCKETED by candidate count: tiles whose padded slab length
matches share one statically-shaped Pallas kernel invocation.  Bucket sizes
are chosen by dynamic programming to minimize total padded pair count under a
budget of ``max_buckets`` distinct shapes.

Everything here is plain vectorized numpy — no Python loops over particles,
tiles, or candidates (the varcol builder's per-tile loops took minutes at
100k; this builds in seconds at 1M).

Replaces: wp.HashGrid built once over rest positions (reference sim.py:123-127)
— same static-rest-topology contract, restructured for dense TPU tiles.
"""

from __future__ import annotations

import dataclasses

import numpy as np

GROUP = 8  # slots per candidate group = one packed 128-float row (16 f/slot)


@dataclasses.dataclass
class SparseBucket:
    """Tiles sharing one padded slab length (all numpy, host-side)."""

    tile_ids: np.ndarray   # (t_b,) int32 tile indices (into global tile order)
    group_ids: np.ndarray  # (t_b, n_groups) int32 candidate group ids
                           # (padded entries = the trailing all-empty group)
    group: int = GROUP     # slots per candidate group

    @property
    def slab_len(self) -> int:
        return self.group_ids.shape[1] * self.group


@dataclasses.dataclass
class SparseLayout:
    """Host-side description of the sparse slot space."""

    cell: float
    rows: int                     # slot rows per tile
    n_slots: int                  # includes the trailing empty group
    n_tiles: int
    slot_of_particle: np.ndarray  # (N,)
    particle_of_slot: np.ndarray  # (n_slots,) slot -> particle or -1
    buckets: list[SparseBucket]
    stats: dict
    n_shards: int = 1             # >1: device-major tile order, one bucket per
                                  # (shard, cap); every shard has identical
                                  # bucket shapes (see build_sparse_layout)
    group: int = GROUP            # slots per candidate group

    @property
    def empty_group(self) -> int:
        return (self.n_slots - self.group) // self.group


def _bucket_boundaries(sizes: np.ndarray, counts: np.ndarray, max_buckets: int):
    """Pick <= max_buckets bucket caps over sorted unique ``sizes`` minimizing
    sum(count_in_bucket * bucket_cap) by exact DP."""
    v = len(sizes)
    if v <= max_buckets:
        return list(sizes)
    csum = np.concatenate([[0], np.cumsum(counts)])
    # cost[i, j] = (tiles with size index in [i, j]) * sizes[j], valid for i <= j
    cost = (csum[None, 1:] - csum[:-1, None]) * sizes[None, :]
    INF = float("inf")
    dp = np.full((max_buckets + 1, v + 1), INF)
    choice = np.zeros((max_buckets + 1, v + 1), dtype=np.int64)
    dp[0, 0] = 0.0
    for b in range(1, max_buckets + 1):
        for j in range(1, v + 1):
            # last bucket covers sizes[i..j-1], capped at sizes[j-1]
            cand = dp[b - 1, :j] + cost[:j, j - 1]
            i = int(np.argmin(cand))
            dp[b, j] = cand[i]
            choice[b, j] = i
    # walk back
    caps = []
    j = v
    b = max_buckets
    while j > 0:
        i = choice[b, j]
        caps.append(int(sizes[j - 1]))
        j = i
        b -= 1
    return sorted(caps)


def build_sparse_layout(
    rest: np.ndarray,
    support_radius: float,
    rows: int = 64,
    max_buckets: int = 8,
    pad_groups: int | None = None,
    cell_scale: float = 1.0,
    n_shards: int = 1,
    group: int = GROUP,
    tile_align: int = 8,
) -> SparseLayout:
    """Build the sparse candidate-group layout from rest positions.

    pad_groups: per-tile group counts are padded up to a multiple of this
    before bucketing, bounding the number of distinct slab lengths the DP
    sees.  Default (None) = 128/group groups = 128 SLOTS, so every bucket
    slab length is a 128-lane multiple — Mosaic cannot DMA-slice a memref
    whose lane extent is not 128-aligned (the manual-DMA K1 path needs this;
    measured pair inflation vs 64-slot padding is a few percent).

    n_shards > 1 prepares the layout for SPMD execution over an n_shards
    device mesh (parallel/sparse_shard.py): each cap's tile list is padded
    with inert tiles (rows of empty slots, empty candidate lists) to an
    n_shards multiple, tiles are ordered SHARD-MAJOR (shard 0's tiles for
    every cap, then shard 1's, ...), and one bucket is emitted per
    (shard, cap) — so every shard owns a contiguous, identically-shaped
    slice of tile space and of every bucket.  Group ids stay GLOBAL (the
    packed gather sources are all-gathered across shards at runtime).

    tile_align: every bucket's tile count is padded (with synthetic inert
    tiles — rows of empty slots, empty candidate lists) to a multiple of
    this, so manual-DMA kernels that slice 2D (t*K, slab) slabs in
    8-sublane-aligned blocks (Mosaic rule) never see a ragged tail.
    """
    gsz = int(group)
    del group  # the name is reused below for the candidate-group-id array
    if pad_groups is None:
        pad_groups = max(128 // gsz, 1)
    rest = np.asarray(rest, dtype=np.float64)
    n = rest.shape[0]
    reach = float(support_radius)
    cell = reach * cell_scale
    lo = rest.min(axis=0) - 1e-9

    # ---- columns: (x, y) cells, z-sorted dense, padded to a rows multiple
    q = np.floor((rest[:, :2] - lo[None, :2]) / cell).astype(np.int64)
    col_key = (q[:, 0] << 21) | q[:, 1]
    cols, col_inv = np.unique(col_key, return_inverse=True)
    n_cols = len(cols)
    order = np.lexsort((rest[:, 2], col_inv))
    col_sorted = col_inv[order]
    col_counts = np.bincount(col_inv, minlength=n_cols)
    col_first = np.concatenate([[0], np.cumsum(col_counts)])

    unit = int(np.lcm(rows, gsz))
    pad_len = np.maximum(((col_counts + unit - 1) // unit) * unit, unit)
    col_slot_start = np.concatenate([[0], np.cumsum(pad_len)])
    body_slots = int(col_slot_start[-1])
    n_slots = body_slots + gsz  # one trailing all-empty group
    n_tiles = body_slots // rows
    empty_gid = body_slots // gsz

    slot_of_particle = np.empty(n, dtype=np.int64)
    slot_of_particle[order] = (
        col_slot_start[col_sorted] + (np.arange(n) - col_first[col_sorted])
    )
    particle_of_slot = np.full(n_slots, -1, dtype=np.int64)
    particle_of_slot[slot_of_particle] = np.arange(n)

    # ---- bounding boxes via NaN-padded slot-space positions
    pos_slot = np.full((n_slots, 3), np.nan)
    pos_slot[slot_of_particle] = rest
    body = pos_slot[:body_slots]
    import warnings

    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        # all-NaN groups/tiles (pure padding) legitimately yield NaN boxes,
        # which the <= cull below treats as "never a candidate"
        warnings.simplefilter("ignore", category=RuntimeWarning)
        g_lo = np.nanmin(body.reshape(-1, gsz, 3), axis=1)  # (n_groups, 3)
        g_hi = np.nanmax(body.reshape(-1, gsz, 3), axis=1)
        t_lo = np.nanmin(body.reshape(n_tiles, rows, 3), axis=1)
        t_hi = np.nanmax(body.reshape(n_tiles, rows, 3), axis=1)

    # ---- candidate enumeration: tile x (groups of its 9 neighbor columns)
    # tile -> column
    n_tiles_col = (pad_len // rows).astype(np.int64)
    tile_col = np.repeat(np.arange(n_cols), n_tiles_col)
    col_group_start = (col_slot_start // gsz).astype(np.int64)
    col_ngroups = (pad_len // gsz).astype(np.int64)

    # neighbor columns (3x3) as column ids, -1 when absent
    cx = (cols >> 21).astype(np.int64)
    cy = (cols & ((1 << 21) - 1)).astype(np.int64)
    nbr = np.full((n_cols, 9), -1, dtype=np.int64)
    offs = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
    # vectorized lookup via sorted search on the unique keys
    for k, (dx, dy) in enumerate(offs):
        keys = ((cx + dx) << 21) | (cy + dy)
        pos = np.searchsorted(cols, keys)
        pos = np.clip(pos, 0, n_cols - 1)
        hit = cols[pos] == keys
        nbr[hit, k] = pos[hit]

    tile_nbr = nbr[tile_col]                     # (n_tiles, 9)
    valid = tile_nbr >= 0
    cnt_per = np.where(valid, col_ngroups[np.clip(tile_nbr, 0, None)], 0)
    flat_cnt = cnt_per.reshape(-1)               # (n_tiles * 9,)
    seg_end = np.cumsum(flat_cnt)
    total = int(seg_end[-1]) if len(seg_end) else 0

    # Enumerate + bb-cull CHUNKED over segments with preallocated scratch:
    # the flat pre-cull list is ~25x the kept size (28M entries at 1M
    # particles), and on this build VM first-touch of fresh pages runs at
    # ~13MB/s — unchunked, these two stages took 100s EACH at 1M.
    cap = int(min(4_000_000, max(total, 1)))
    seg_start_all = seg_end - flat_cnt
    # chunk boundaries: maximal runs of whole segments with <= cap entries
    # (a single segment is at most one column's group count, << cap)
    n_seg = len(flat_cnt)
    chunks = []
    s0 = 0
    while s0 < n_seg:
        s1 = max(int(np.searchsorted(seg_end, seg_start_all[s0] + cap,
                                     "right")), s0 + 1)
        chunks.append((s0, s1))
        s0 = s1
    sc_cap = cap + (int(flat_cnt.max()) if n_seg else 0)
    sc_seg = np.empty(sc_cap, dtype=np.int64)
    sc_within = np.empty(sc_cap, dtype=np.int64)
    sc_group = np.empty(sc_cap, dtype=np.int64)
    sc_tile = np.empty(sc_cap, dtype=np.int64)
    sc_d = np.empty(sc_cap)
    sc_gap = np.empty(sc_cap)
    sc_tmp = np.empty(sc_cap)
    kept_tiles, kept_groups = [], []
    tile_nbr_flat = tile_nbr.reshape(-1)
    for s0, s1 in chunks:
        e0 = int(seg_start_all[s0])
        e1 = int(seg_end[s1 - 1])
        m_ = e1 - e0
        seg = sc_seg[:m_]
        cnts = flat_cnt[s0:s1]
        seg[:] = np.repeat(np.arange(s0, s1, dtype=np.int64), cnts)
        within = sc_within[:m_]
        within[:] = np.arange(e0, e1, dtype=np.int64)
        within -= seg_start_all[seg]
        cand_col_c = tile_nbr_flat[seg]
        group = sc_group[:m_]
        np.take(col_group_start, cand_col_c, out=group)
        group += within
        tile = sc_tile[:m_]
        np.floor_divide(seg, 9, out=tile)
        d = sc_d[:m_]
        d[:] = 0.0
        gap = sc_gap[:m_]
        tmp = sc_tmp[:m_]
        for a in range(3):
            np.take(g_lo[:, a], group, out=gap)
            np.take(t_hi[:, a], tile, out=tmp)
            gap -= tmp
            np.take(t_lo[:, a], tile, out=tmp)
            tmp2 = np.take(g_hi[:, a], group)
            # reuse: tmp <- t_lo - g_hi
            tmp -= tmp2
            np.maximum(gap, tmp, out=gap)
            np.maximum(gap, 0.0, out=gap)
            gap *= gap
            d += gap
        with np.errstate(invalid="ignore"):
            keep = d <= reach * reach  # NaN -> False
        kept_tiles.append(tile[keep].copy())
        kept_groups.append(group[keep].copy())
    cand_tile = (np.concatenate(kept_tiles) if kept_tiles
                 else np.empty(0, dtype=np.int64))
    cand_group = (np.concatenate(kept_groups) if kept_groups
                  else np.empty(0, dtype=np.int64))

    # ---- per-tile counts, padding, buckets
    g_count = np.bincount(cand_tile, minlength=n_tiles)
    pad_to = max(pad_groups, 1)
    padded = np.maximum(((g_count + pad_to - 1) // pad_to) * pad_to, pad_to)
    sizes, inv_size, size_counts = np.unique(padded, return_inverse=True,
                                             return_counts=True)
    caps = _bucket_boundaries(sizes, size_counts, max_buckets)
    caps_arr = np.asarray(caps)
    tile_cap = caps_arr[np.searchsorted(caps_arr, padded)]

    # fill the (tile, slot-in-list) matrix then split by cap
    max_cap = int(caps_arr.max())
    mat = np.full((n_tiles, max_cap), empty_gid, dtype=np.int64)
    ord2 = np.argsort(cand_tile, kind="stable")
    ct = cand_tile[ord2]
    first = np.concatenate([[0], np.cumsum(g_count)])[:-1]
    rank = np.arange(len(ct)) - first[ct]
    mat[ct, rank] = cand_group[ord2]

    # per-cap tile-id lists; for n_shards > 1 pad each with synthetic inert
    # tiles (new ids >= n_tiles, rows of padding slots, empty candidate lists)
    # so every shard gets the same tile count per cap
    ids_per_cap = [np.flatnonzero(tile_cap == cap) for cap in caps]
    keep = [k for k, ids in enumerate(ids_per_cap) if len(ids)]
    caps = [caps[k] for k in keep]
    ids_per_cap = [ids_per_cap[k] for k in keep]
    empty_gid_old = empty_gid
    n_tiles_new = n_tiles
    # per-bucket tile count must be a multiple of tile_align; with n_shards
    # each SHARD's chunk of a cap is one bucket, so the cap's list needs a
    # multiple of n_shards * tile_align
    mult = max(int(n_shards), 1) * max(int(tile_align), 1)
    if mult > 1:
        for k, ids in enumerate(ids_per_cap):
            pad = (-len(ids)) % mult
            if pad:
                ids_per_cap[k] = np.concatenate(
                    [ids, np.arange(n_tiles_new, n_tiles_new + pad)])
                n_tiles_new += pad
        if n_tiles_new > n_tiles:
            mat = np.vstack([mat, np.full((n_tiles_new - n_tiles, max_cap),
                                          empty_gid_old, dtype=np.int64)])
    body_slots = n_tiles_new * rows
    n_slots = body_slots + gsz
    empty_gid = body_slots // gsz

    # ---- permute tiles BUCKET-MAJOR (shard-major first when n_shards > 1) so
    # each bucket is a contiguous tile range: per-bucket row gathers become
    # free slices, the bucket-concat order equals tile order (no unpermute),
    # and per-step s32 index staging disappears.
    if n_shards > 1:
        chunks_ = [len(ids) // n_shards for ids in ids_per_cap]
        order_tiles = np.concatenate(
            [ids[d * c:(d + 1) * c]
             for d in range(n_shards)
             for ids, c in zip(ids_per_cap, chunks_)])
    else:
        order_tiles = np.concatenate(ids_per_cap)  # old ids, new order
    inv_tile = np.empty(n_tiles_new, dtype=np.int64)
    inv_tile[order_tiles] = np.arange(n_tiles_new)
    gpt = max(rows // gsz, 1)  # groups per tile (gsz <= rows)

    slot_of_particle = (
        inv_tile[slot_of_particle // rows] * rows + slot_of_particle % rows
    )
    particle_of_slot = np.full(n_slots, -1, dtype=np.int64)
    particle_of_slot[slot_of_particle] = np.arange(n)

    def remap_groups(g):
        """Old group id -> new (the trailing empty group id moved if shard
        padding grew the body)."""
        body = g < empty_gid_old
        safe = np.where(body, g, 0)
        return np.where(body, inv_tile[safe // gpt] * gpt + safe % gpt,
                        empty_gid)

    buckets = []
    start = 0
    if n_shards > 1:
        for d in range(n_shards):
            for ids, c, cap in zip(ids_per_cap, chunks_, caps):
                chunk_ids = ids[d * c:(d + 1) * c]
                buckets.append(SparseBucket(
                    tile_ids=np.arange(start, start + len(chunk_ids),
                                       dtype=np.int32),
                    group_ids=remap_groups(mat[chunk_ids, :cap]).astype(np.int32),
                    group=gsz,
                ))
                start += len(chunk_ids)
    else:
        for cap, ids in zip(caps, ids_per_cap):
            buckets.append(SparseBucket(
                tile_ids=np.arange(start, start + len(ids), dtype=np.int32),
                group_ids=remap_groups(mat[ids, :cap]).astype(np.int32),
                group=gsz,
            ))
            start += len(ids)
    n_tiles = n_tiles_new

    true_pairs = None  # expensive; validator computes it on demand
    padded_pairs = int(sum(len(b.tile_ids) * b.slab_len * rows for b in buckets))
    stats = {
        "n_slots": n_slots,
        "n_tiles": n_tiles,
        "n_buckets": len(buckets),
        "n_shards": int(n_shards),
        "bucket_caps": [int(c) for c in caps],
        "bucket_tiles": [int(len(b.tile_ids)) for b in buckets],
        "mean_groups": float(g_count.mean()),
        "padded_pairs_per_step": padded_pairs,
        "pairs_per_particle": padded_pairs / max(n, 1),
        "true_pairs": true_pairs,
    }
    return SparseLayout(
        cell=float(cell),
        rows=int(rows),
        n_slots=int(n_slots),
        n_tiles=int(n_tiles),
        slot_of_particle=slot_of_particle,
        particle_of_slot=particle_of_slot,
        buckets=buckets,
        stats=stats,
        n_shards=int(n_shards),
        group=gsz,
    )


def validate_sparse_layout(layout: SparseLayout, rest: np.ndarray,
                           support_radius: float) -> dict:
    """Check every true rest-neighbor pair is covered: for each particle i in
    tile t, every j with |X_i - X_j| <= support_radius must be in a candidate
    group of t.  Vectorized via a slot->tile candidate membership matrix."""
    rest = np.asarray(rest, np.float64)
    n = rest.shape[0]
    # true pairs by cell binning (vectorized O(N * 27 * occupancy) via kd-ish
    # approach: use scipy-free grid pairing on the layout's own columns)
    from scipy.spatial import cKDTree  # available in the baked-in scipy

    tree = cKDTree(rest)
    pairs = tree.query_pairs(support_radius, output_type="ndarray")  # (P, 2)
    i, j = pairs[:, 0], pairs[:, 1]

    # membership[tile] = set of groups -> test group_of_slot[j] in tile list
    tile_of_slot = np.arange(layout.n_tiles * layout.rows) // layout.rows
    n_groups = layout.n_slots // layout.group
    member = np.zeros((layout.n_tiles, n_groups), dtype=bool)
    for b in layout.buckets:
        member[b.tile_ids[:, None], b.group_ids] = True

    si = layout.slot_of_particle[i]
    sj = layout.slot_of_particle[j]
    ti = tile_of_slot[si]
    tj = tile_of_slot[sj]
    gi = (si // layout.group).astype(np.int64)
    gj = (sj // layout.group).astype(np.int64)
    ok = member[ti, gj] & member[tj, gi]
    missing = int((~ok).sum())
    if missing:
        raise AssertionError(f"{missing}/{len(i)} true neighbor pairs uncovered")
    true_pairs = 2 * len(i) + n  # ordered pairs + self
    return {
        "true_pairs": true_pairs,
        "padded_pairs": layout.stats["padded_pairs_per_step"],
        "waste": layout.stats["padded_pairs_per_step"] / max(true_pairs, 1),
    }
