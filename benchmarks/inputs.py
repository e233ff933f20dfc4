"""The benchmark's inputs: the body, its support radius and clamp, and the
inflation fields a seed draws.

The body generator is a frozen copy of the procedural inflatable sphere
(outer Fibonacci shell + jittered lattice filling, sized to a particle
count), so the benchmark makes its particles itself and hands the same
array to the program and to the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def fibonacci_sphere(n: int, radius: float) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    phi = np.pi * (3.0 - np.sqrt(5.0))
    y = 1.0 - 2.0 * (i + 0.5) / n
    r = np.sqrt(np.maximum(1.0 - y * y, 0.0))
    theta = phi * i
    return radius * np.stack([r * np.cos(theta), y, r * np.sin(theta)], axis=-1)


def ball_fill(radius: float, spacing: float, jitter: float, seed: int = 0) -> np.ndarray:
    k = int(np.floor(radius / spacing))
    ax = np.arange(-k, k + 1, dtype=np.float64) * spacing
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    pts = pts[np.linalg.norm(pts, axis=-1) < radius - 0.5 * spacing]
    rng = np.random.default_rng(seed)
    return pts + rng.uniform(-jitter, jitter, pts.shape) * spacing


def inflatable_sphere(n_outer: int, radius: float, center=(0.0, 0.07, 0.0)):
    """(points (N, 3), n_outer): shell first, then the filling."""
    spacing = float(np.sqrt(4.0 * np.pi * radius ** 2 / max(n_outer, 1)))
    pts = np.vstack([fibonacci_sphere(n_outer, radius),
                     ball_fill(radius * 0.92, spacing, 0.05)])
    return pts + np.asarray(center, dtype=np.float64), n_outer


def fit_body(n_particles: int, radius: float):
    """The inflatable sphere sized to about ``n_particles``."""
    probe, _ = inflatable_sphere(1000, radius)
    a = (len(probe) - 1000) / 1000 ** 1.5
    n_outer = 1000.0
    for _ in range(40):
        n_outer = max((max(n_particles - n_outer, 8.0) / a) ** (2 / 3), 8.0)
    return inflatable_sphere(max(int(n_outer), 8), radius)


def suggest_h(points: np.ndarray, target_neighbors: int) -> float:
    """h such that a particle sees about ``target_neighbors`` within 2h."""
    lo, hi = points.min(axis=0), points.max(axis=0)
    density = points.shape[0] / float(np.prod(np.maximum(hi - lo, 1e-9)))
    return (3.0 * target_neighbors / (4.0 * np.pi * density)) ** (1.0 / 3.0) / 2.0


def clamp_mask(points: np.ndarray, top_share: float) -> np.ndarray:
    """(N, 3) Dirichlet mask: 0 on the particles above the (1 - top_share)
    quantile of y, 1 elsewhere."""
    mask = np.ones((len(points), 3))
    mask[points[:, 1] > np.quantile(points[:, 1], 1.0 - top_share)] = 0.0
    return mask


def radial_bands(points: np.ndarray, bands: float) -> np.ndarray:
    """x* = sin(r / r_max * bands * 2 pi): radial bands in [-1, 1]."""
    r = np.linalg.norm(points - points.mean(0), axis=1)
    return np.sin(r / r.max() * bands * 2.0 * np.pi)


def target_field(pts: np.ndarray, spec: dict) -> np.ndarray:
    """The field x* whose episode gives rollout targets."""
    field = spec["field"]
    if field["kind"] == "radial_bands":
        return radial_bands(pts, field["bands"])
    raise ValueError(f"unknown target field {field['kind']!r}")


def body(cfg: dict):
    """(points, n_outer, h, Dirichlet mask) of a configuration's ``body``."""
    b = cfg["body"]
    pts, n_outer = fit_body(b["particles"], b["radius"])
    h = suggest_h(pts, b["neighbors"])
    mask = clamp_mask(pts, b["clamp_top"]) if b.get("clamp_top") else np.ones((len(pts), 3))
    return pts, n_outer, h, mask


def seed_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def smooth_field(points: torch.Tensor, spec: dict, gen: torch.Generator) -> torch.Tensor:
    """A seed's inflation field over the particles: ``center`` plus
    ``amplitude`` times the mean of ``modes`` plane waves of random
    direction, wavelength (``wavelengths`` in body radii) and phase."""
    dev, dt = points.device, points.dtype
    k = int(spec["modes"])
    d = torch.randn((k, 3), generator=gen, device=dev, dtype=dt)
    d = d / d.norm(dim=1, keepdim=True)
    lo, hi = spec["wavelengths"]
    lam = lo + (hi - lo) * torch.rand(k, generator=gen, device=dev, dtype=dt)
    phase = 2.0 * math.pi * torch.rand(k, generator=gen, device=dev, dtype=dt)
    c = points - points.mean(0)
    radius = c.norm(dim=1).max()
    waves = torch.sin(2.0 * math.pi * (c @ d.T) / (lam * radius) + phase)
    return spec["center"] + spec["amplitude"] * waves.mean(1)
