"""Procedural point-cloud bodies (numpy).

The port's own copy of ``inflatable_sphere``, ``box_fill`` and ``suggest_h`` from
``softbody_tpu/geometry/shapes.py``: outer shell + inner filling, the
two-layer structure of the reference's .ply assets (sim.py:41-53).
"""

from __future__ import annotations

import numpy as np


def fibonacci_sphere(n: int, radius: float = 1.0) -> np.ndarray:
    """n approximately-uniform points on a sphere surface."""
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))          # golden angle
    y = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    theta = phi * i
    pts = np.stack([r * np.cos(theta), y, r * np.sin(theta)], axis=-1)
    return radius * pts


def ball_fill(radius: float, spacing: float, jitter: float = 0.0, seed: int = 0) -> np.ndarray:
    """Grid-fill the interior of a ball with the given lattice spacing."""
    k = int(np.floor(radius / spacing))
    ax = np.arange(-k, k + 1, dtype=np.float64) * spacing
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=-1) < radius - 0.5 * spacing]
    if jitter > 0:
        rng = np.random.default_rng(seed)
        pts = pts + rng.uniform(-jitter, jitter, pts.shape) * spacing
    return pts


def inflatable_sphere(
    n_outer: int = 512,
    radius: float = 0.05,
    spacing: float | None = None,
    center=(0.0, 0.07, 0.0),
    seed: int = 0,
):
    """Outer shell + inner filling (outer particles first, ``out_num`` of
    them — sim.py:49-53).  Returns (points (N,3), out_num)."""
    if spacing is None:
        # shell spacing ~ sqrt(area / n); fill a bit coarser
        spacing = float(np.sqrt(4.0 * np.pi * radius**2 / max(n_outer, 1)))
    outer = fibonacci_sphere(n_outer, radius)
    inner = ball_fill(radius * 0.92, spacing, jitter=0.05, seed=seed)
    pts = np.vstack([outer, inner]) + np.asarray(center, dtype=np.float64)
    return pts, n_outer


def box_fill(lo, hi, spacing: float) -> np.ndarray:
    """Grid-fill an axis-aligned box [lo, hi]."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    axes = [np.arange(lo[d], hi[d] + 1e-12, spacing) for d in range(3)]
    gx, gy, gz = np.meshgrid(*axes, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)


def suggest_h(points: np.ndarray, target_neighbors: int = 30) -> float:
    """Support radius h so the average particle sees ~target_neighbors
    within 2h, from the sample density."""
    n = points.shape[0]
    lo, hi = points.min(axis=0), points.max(axis=0)
    vol = float(np.prod(np.maximum(hi - lo, 1e-9)))
    density = n / vol
    r = (3.0 * target_neighbors / (4.0 * np.pi * density)) ** (1.0 / 3.0)
    return r / 2.0
