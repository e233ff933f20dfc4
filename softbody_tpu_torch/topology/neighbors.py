"""Static rest-space neighbour tables and reductions (numpy, host f64).

The port's own copy of ``softbody_tpu/topology/neighbors.py``:

* the gather backend's padded (N, K) tables — ``neighbor_lists`` (the C++
  hash grid, then scipy's cKDTree, then a numpy cell hash),
  ``build_topology`` and ``topology_to_torch``;
* ``neighbor_csr`` and ``rest_density_and_corr``: rho, volume, the
  nabla_u rest correction and the static moment row sums over the TRUE
  pair list, O(pairs), for the slot layouts;
* the numpy cubic-spline ``W`` / ``nabla_W`` that module takes from
  ``softbody_tpu/oracle/sim.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig
from ..core.types import Topology
from ..native import hashgrid as _native
from ..ops.elasticity import index_inverse


def W(xij: np.ndarray, h: float) -> np.ndarray:
    """Cubic-spline SPH kernel (utils.py:25-33 / sim.py:133-141). xij: (..., 3)."""
    q = np.linalg.norm(xij, axis=-1) / h
    c = 1.0 / (np.pi * h**3)
    near = c * (1.0 - 1.5 * q**2 + 0.75 * q**3)
    far = 0.25 * c * (2.0 - q) ** 3
    return np.where(q < 1.0, near, np.where(q < 2.0, far, 0.0))


def nabla_W(xij: np.ndarray, h: float) -> np.ndarray:
    """Gradient of W wrt xij (utils.py:35-43 / sim.py:143-151). xij: (..., 3)."""
    q = np.linalg.norm(xij, axis=-1, keepdims=True) / h
    c = 1.0 / (np.pi * h**3)
    near = c * (-3.0 * xij / h**2 + 2.25 * q * xij / h**2)
    # q==0 only happens in the near branch (where the value is 0 anyway).
    q_safe = np.where(q > 0, q, 1.0)
    far = 0.25 * c * (-3.0) * (2.0 - q) ** 2 * xij / (q_safe * h * h)
    return np.where(q < 1.0, near, np.where(q < 2.0, far, 0.0))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def neighbor_lists_numpy(rest: np.ndarray, radius: float):
    """Pure-NumPy uniform-grid neighbour search. Returns list-of-arrays
    (j != i, ascending)."""
    n = rest.shape[0]
    keys = np.floor(rest / radius).astype(np.int64)
    k = keys - keys.min(axis=0)
    packed = (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]
    order = np.argsort(packed, kind="stable")
    sorted_keys = packed[order]
    uniq, first = np.unique(sorted_keys, return_index=True)
    bucket_of = {int(u): (int(f), int(np.searchsorted(sorted_keys, u, side="right")))
                 for u, f in zip(uniq, first)}
    r2 = radius * radius
    out = []
    for i in range(n):
        ki = k[i]
        cand = []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    key = int(((ki[0] + dx) << 42) | ((ki[1] + dy) << 21) | (ki[2] + dz))
                    rng = bucket_of.get(key)
                    if rng is not None:
                        cand.append(order[rng[0]:rng[1]])
        cand = np.concatenate(cand) if cand else np.empty(0, dtype=np.int64)
        d2 = np.sum((rest[cand] - rest[i]) ** 2, axis=-1)
        out.append(np.sort(cand[(d2 < r2) & (cand != i)]))
    return out


def neighbor_lists(rest: np.ndarray, radius: float):
    """Neighbour lists within ``radius`` (self excluded), from the best
    builder present: the native hash grid, scipy's cKDTree, numpy."""
    if _native.available():
        off, idx = _native.neighbor_csr(rest, radius)
        return [idx[off[i]:off[i + 1]] for i in range(len(rest))]
    try:
        from scipy.spatial import cKDTree
    except ImportError:
        return neighbor_lists_numpy(rest, radius)
    pairs = cKDTree(rest).query_ball_point(rest, r=radius * (1 - 1e-12))
    return [np.asarray([j for j in js if j != i], dtype=np.int64)
            for i, js in enumerate(pairs)]


def build_topology(rest: np.ndarray, mass: np.ndarray, cfg: SimConfig,
                   volume: np.ndarray | None = None):
    """The padded (N, K) neighbour table and its cached rest-space
    quantities, all numpy f64 (``topology_to_torch`` moves them).  K is the
    largest neighbour count rounded up to 8, capped at
    ``cfg.max_neighbors``, where each row keeps its K nearest.  Returns
    (Topology as numpy, rho, volume); the CSR inverse fields are None
    here."""
    rest = np.asarray(rest, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    n = rest.shape[0]
    lists = neighbor_lists(rest, 2.0 * cfg.h)
    counts = np.array([len(js) for js in lists])
    kmax = int(counts.max()) if n else 0
    K = max(_round_up(max(kmax, 1), 8), 8)
    if cfg.max_neighbors and K > cfg.max_neighbors:
        K = cfg.max_neighbors

    idx = np.tile(np.arange(n, dtype=np.int64)[:, None], (1, K))
    mask = np.zeros((n, K), dtype=np.float64)
    for i, js in enumerate(lists):
        if len(js) > K:  # keep the K nearest
            d2 = np.sum((rest[js] - rest[i]) ** 2, axis=-1)
            js = js[np.argsort(d2)[:K]]
        idx[i, : len(js)] = js
        mask[i, : len(js)] = 1.0

    xij = rest[:, None, :] - rest[idx]          # X_i - X_j  (N, K, 3)
    w = W(xij, cfg.h) * mask
    nw = nabla_W(xij, cfg.h) * mask[..., None]
    xji = -xij * mask[..., None]

    # the self term of the density follows cfg.self_density (sim.py:163
    # excludes it, sim_taichi.py:97-98 includes it)
    rho = np.sum(mass[idx] * w, axis=1)
    if cfg.self_density:
        rho = rho + mass * (1.0 / (np.pi * cfg.h**3))  # W(0, h)
    if volume is None:
        volume = mass / rho

    c = w * mass[idx]
    vj = volume[idx] * mask
    topo = Topology(
        idx=idx.astype(np.int32),
        mask=mask,
        w=w,
        nw=nw,
        xji=xji,
        c=c,
        vj=vj,
        sum_c_xji=np.einsum("ij,ija->ia", c, xji),
        rest_corr=np.einsum("ij,ija,ijb->iab", vj, xji, nw),
        sum_v_nw=np.einsum("ij,ija->ia", vj, nw),
        inv_order=None,
        inv_lengths=None,
    )
    return topo, rho, volume


def topology_to_torch(topo: Topology, dtype: torch.dtype, device) -> Topology:
    """Move a host-built (numpy f64) Topology to ``device`` in ``dtype``,
    with the CSR inverse of its index table."""
    def cast(a):
        return torch.from_numpy(np.array(a, np.float64)).to(device=device, dtype=dtype)

    idx = torch.from_numpy(np.asarray(topo.idx, np.int64)).to(device)
    order, lengths = index_inverse(idx, idx.shape[0])
    return Topology(idx=idx, **{f: cast(getattr(topo, f)) for f in Topology._fields[1:10]},
                    inv_order=order, inv_lengths=lengths)


def neighbor_csr(rest: np.ndarray, radius: float):
    """CSR neighbour structure (offsets (n+1,), flat indices), self excluded.

    The native C++ hash grid when a compiler is present, else scipy's
    cKDTree (same pairs, as the JAX package's fallback orders them)."""
    rest = np.ascontiguousarray(rest, dtype=np.float64)
    if _native.available():
        return _native.neighbor_csr(rest, radius)
    from scipy.spatial import cKDTree

    tree = cKDTree(rest)
    pairs = tree.query_pairs(radius * (1 - 1e-12), output_type="ndarray")
    n = rest.shape[0]
    src = np.concatenate([pairs[:, 0], pairs[:, 1]])
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
    order = np.argsort(src, kind="stable")
    counts = np.bincount(src, minlength=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, dst[order].astype(np.int64)


def rest_density_and_corr(rest: np.ndarray, mass: np.ndarray, cfg: SimConfig,
                          chunk: int = 1_000_000, rowsums: bool = False):
    """rho_i = sum_j m_j W_ij, V_i = m_i/rho_i, and the nabla_u rest
    correction Y_i = sum_j V_j (X_j - X_i) (x) grad_W(X_ij) over the CSR
    pair list.

    With ``rowsums=True`` also returns the two static moment row sums:
      scx_i  = sum_j w_ij m_j (X_j - X_i)        (A-moment row sum)
      svnw_i = sum_j V_j grad_W(X_i - X_j)       (Y-moment row sum)

    Chunked over pairs with preallocated scratch reused via ``out=``, so
    large builds touch few fresh pages."""
    rest = np.asarray(rest, dtype=np.float64)
    mass = np.asarray(mass, dtype=np.float64)
    n = rest.shape[0]
    off, idx = neighbor_csr(rest, 2.0 * cfg.h)
    p_total = len(idx)
    src_all = np.repeat(np.arange(n, dtype=np.int64), np.diff(off))

    h = float(cfg.h)
    c0 = 1.0 / (np.pi * h**3)
    c4 = 0.25 * c0

    rho = np.zeros(n)
    corr = np.zeros((n, 3, 3))
    scx = np.zeros((n, 3)) if rowsums else None
    svnw = np.zeros((n, 3)) if rowsums else None

    cap = int(min(chunk, max(p_total, 1)))
    xi = np.empty((cap, 3))
    xj = np.empty((cap, 3))
    q = np.empty(cap)
    tq = np.empty(cap)
    oq = np.empty(cap)
    f1 = np.empty(cap)
    f2 = np.empty(cap)

    def pair_geometry(se):
        """Fill xi <- X_i - X_j, q <- |x|/h, tq <- (2-q)+, oq <- (1-q)+."""
        m_ = se.stop - se.start
        np.take(rest, src_all[se], axis=0, out=xi[:m_])
        np.take(rest, idx[se], axis=0, out=xj[:m_])
        np.subtract(xi[:m_], xj[:m_], out=xi[:m_])
        np.einsum("pa,pa->p", xi[:m_], xi[:m_], out=q[:m_])
        np.sqrt(q[:m_], out=q[:m_])
        q[:m_] /= h
        np.subtract(2.0, q[:m_], out=tq[:m_])
        np.maximum(tq[:m_], 0.0, out=tq[:m_])
        np.subtract(1.0, q[:m_], out=oq[:m_])
        np.maximum(oq[:m_], 0.0, out=oq[:m_])
        return m_

    def fill_gfac(m_, out):
        """out <- c/4 (12 (1-q)+^2 - 3 (2-q)+^2) / (q h^2)  [= nabla_W / xij]."""
        np.multiply(tq[:m_], tq[:m_], out=tq[:m_])
        np.multiply(oq[:m_], oq[:m_], out=oq[:m_])
        np.multiply(oq[:m_], 12.0, out=oq[:m_])
        np.multiply(tq[:m_], 3.0, out=tq[:m_])
        np.subtract(oq[:m_], tq[:m_], out=out[:m_])
        out[:m_] *= c4
        np.maximum(q[:m_], 1e-300, out=q[:m_])
        out[:m_] /= q[:m_]
        out[:m_] /= h * h

    for s0 in range(0, p_total, cap):
        se = slice(s0, min(s0 + cap, p_total))
        m_ = pair_geometry(se)
        # branchless cubic spline: W = c/4 [(2-q)+^3 - 4 (1-q)+^3]
        np.multiply(tq[:m_], tq[:m_], out=f1[:m_])
        np.multiply(f1[:m_], tq[:m_], out=f1[:m_])
        np.multiply(oq[:m_], oq[:m_], out=f2[:m_])
        np.multiply(f2[:m_], oq[:m_], out=f2[:m_])
        np.multiply(f2[:m_], 4.0, out=f2[:m_])
        np.subtract(f1[:m_], f2[:m_], out=f1[:m_])
        f1[:m_] *= c4
        np.take(mass, idx[se], out=f2[:m_])
        np.multiply(f1[:m_], f2[:m_], out=f1[:m_])
        rho += np.bincount(src_all[se], weights=f1[:m_], minlength=n)
        if rowsums:
            # scx_b = sum_j (w m_j) (X_j - X_i)_b; xi holds X_i - X_j
            for b in range(3):
                np.multiply(f1[:m_], xi[:m_, b], out=f2[:m_])
                scx[:, b] -= np.bincount(src_all[se], weights=f2[:m_],
                                         minlength=n)

    if cfg.self_density:
        rho = rho + mass * c0
    with np.errstate(divide="ignore", invalid="ignore"):
        volume = np.where(rho > 0, mass / np.where(rho > 0, rho, 1.0), 0.0)

    for s0 in range(0, p_total, cap):
        se = slice(s0, min(s0 + cap, p_total))
        m_ = pair_geometry(se)
        fill_gfac(m_, f1)
        np.take(volume, idx[se], out=f2[:m_])
        np.multiply(f1[:m_], f2[:m_], out=f1[:m_])   # V_j * gfac
        if rowsums:
            # svnw_b = sum_j V_j gfac (X_i - X_j)_b
            for b in range(3):
                np.multiply(f1[:m_], xi[:m_, b], out=f2[:m_])
                svnw[:, b] += np.bincount(src_all[se], weights=f2[:m_],
                                          minlength=n)
        for a in range(3):
            # weight_a = -V_j gfac (X_i - X_j)_a = V_j gfac (X_j - X_i)_a
            np.multiply(f1[:m_], xi[:m_, a], out=q[:m_])
            np.negative(q[:m_], out=q[:m_])
            for b in range(3):
                np.multiply(q[:m_], xi[:m_, b], out=tq[:m_])
                corr[:, a, b] += np.bincount(src_all[se], weights=tq[:m_],
                                             minlength=n)

    if rowsums:
        return rho, volume, corr, scx, svnw
    return rho, volume, corr
