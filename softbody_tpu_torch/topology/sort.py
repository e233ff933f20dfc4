"""Spatial sorting + contiguous neighbor windows (the port's own numpy copy
of ``softbody_tpu/topology/sort.py``, bit-identical output).

Particles are sorted once along a Morton (Z-order) curve over their REST
positions, so each tile of T consecutive particles has all its
kernel-support neighbors inside one contiguous window of the sorted order,
and a contiguous run of the sorted particles (a shard of the particle mesh,
``parallel/sharding.py``) has few neighbors outside it
(``parallel/halo.py``'s plan).
"""

from __future__ import annotations

import numpy as np


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so there are 2 zero bits between each."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_codes(points: np.ndarray, cell: float) -> np.ndarray:
    """Z-order codes of points quantized to ``cell``-sized voxels."""
    q = np.floor((points - points.min(axis=0)) / cell).astype(np.int64)
    q = np.clip(q, 0, (1 << 21) - 1)
    return (
        _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << np.uint64(1)) | (_part1by2(q[:, 2]) << np.uint64(2))
    )


def morton_sort(points: np.ndarray, cell: float) -> np.ndarray:
    """Permutation sorting points along the Z-order curve (stable)."""
    return np.argsort(morton_codes(points, cell), kind="stable")


def neighbor_spans(rest_sorted: np.ndarray, radius: float):
    """Per-particle [lo, hi] span of sorted neighbor indices within ``radius``.

    Isolated particles (no neighbors) span only themselves.
    """
    from .neighbors import neighbor_lists

    lists = neighbor_lists(rest_sorted, radius)
    n = rest_sorted.shape[0]
    lo = np.arange(n, dtype=np.int64)
    hi = np.arange(n, dtype=np.int64)
    for i, js in enumerate(lists):
        if len(js):
            lo[i] = min(lo[i], js.min())
            hi[i] = max(hi[i], js.max())
    return lo, hi


def tile_windows(lo: np.ndarray, hi: np.ndarray, n: int, tile: int, lane: int = 128):
    """Per-tile window starts + the global (padded) window size S.

    Window of tile t must cover [min lo, max hi] of its rows plus the rows
    themselves.  Starts are aligned down to ``lane``; S is the max span rounded
    up to a multiple of ``lane``.  Returns (starts (n_tiles,), S).
    """
    n_tiles = (n + tile - 1) // tile
    starts = np.zeros(n_tiles, dtype=np.int64)
    spans = np.zeros(n_tiles, dtype=np.int64)
    for t in range(n_tiles):
        a, b = t * tile, min((t + 1) * tile, n)
        w_lo = min(lo[a:b].min(), a)
        w_hi = max(hi[a:b].max(), b - 1)
        w_lo = (w_lo // lane) * lane
        starts[t] = w_lo
        spans[t] = w_hi + 1 - w_lo
    S = int(((spans.max() + lane - 1) // lane) * lane)
    # clamp starts so [start, start + S) stays in range (requires n >= S)
    starts = np.minimum(starts, max(n - S, 0))
    return starts.astype(np.int32), S


def window_stats(rest: np.ndarray, radius: float, tile: int, cell: float | None = None):
    """Diagnostics: sort + window sizes for a candidate (tile, cell)."""
    cell = radius if cell is None else cell
    perm = morton_sort(rest, cell)
    rs = rest[perm]
    lo, hi = neighbor_spans(rs, radius)
    starts, S = tile_windows(lo, hi, len(rest), tile)
    return {
        "tile": tile,
        "cell": cell,
        "S": S,
        "n_tiles": len(starts),
        "mean_span": float(np.mean(hi - lo + 1)),
        "p99_span": float(np.percentile(hi - lo + 1, 99)),
    }
