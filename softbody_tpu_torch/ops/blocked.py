"""Blocked (column-dense slot) layout: the plain torch reference of the
``backend="blocked"`` path (counterpart of ``softbody_tpu/ops/blocked.py``).

State lives in slot space (real particles in column slots, empty slots
inert); each tile's neighbour slab is 9 contiguous slot runs, and every
pair coefficient is recomputed from rest geometry.  This module is the
differentiable reference the ``pallas`` path (``sim/blocked.py``) and the
JAX package's blocked tests are held against: identical math on
materialized (n_tiles, rows, slab) tensors, the exact-branch cubic spline,
autograd for the VJP.  It is memory-hungry (per-pair tensors): a reference
for small bodies, not a path for the full-size scene.

Empty slots: rest position on a far grid (:func:`far_grid`: pairwise >= 4h
apart, far from the body), mass 0, volume 0, so every pair term with them
vanishes.  Self-pairs are excluded by rest distance 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import SimConfig
from ..core.types import Blocked

__all__ = ["Blocked", "far_grid", "gather_slab", "gather_rows", "scatter_rows",
           "pair_w_gfac", "moments_xla", "forces_xla"]


def far_grid(n: int, start: float, spacing: float) -> np.ndarray:
    """n unique positions, pairwise >= spacing apart, far from the body
    (rest positions of empty slots, so every pair term with them vanishes)."""
    k = int(np.ceil(n ** (1.0 / 3.0))) + 1
    ax = np.arange(k, dtype=np.float64) * spacing
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1).reshape(-1, 3)
    return g[:n] + start


def _slab_index(blk: Blocked) -> torch.Tensor:
    """(n_tiles, slab_len) slot of every slab entry: 9 runs per tile."""
    runs = blk.slab_start[:, :, None] + torch.arange(
        blk.run_len, device=blk.slab_start.device)
    return runs.reshape(blk.n_tiles, blk.slab_len)


def gather_slab(arr, blk: Blocked):
    """(n_slots, F) or (n_slots,) -> (n_tiles, slab_len, [F])."""
    return arr[_slab_index(blk)]


def gather_rows(arr, blk: Blocked):
    """(n_slots, F) or (n_slots,) -> (n_tiles, rows, [F]): the tiles' own
    rows (the slot prefix)."""
    m = blk.n_tiles * blk.rows
    return arr[:m].reshape((blk.n_tiles, blk.rows) + tuple(arr.shape[1:]))


def scatter_rows(tiles, blk: Blocked):
    """(n_tiles, rows, [F]) -> (n_slots, [F]): inverse of :func:`gather_rows`
    (the tiles partition the slot space except the trailing empty run)."""
    flat = tiles.reshape((blk.n_tiles * blk.rows,) + tuple(tiles.shape[2:]))
    out = flat.new_zeros((blk.n_slots,) + tuple(tiles.shape[2:]))
    out[:flat.shape[0]] = flat
    return out


def _rest(blk: Blocked):
    """(rest_rows (t, rows, 3), rest_slab (t, slab, 3), mass_slab, vol_slab)."""
    b = blk.bucket
    return (b.restT_rows.transpose(1, 2), b.static_slab[:, 0:3].transpose(1, 2),
            b.static_slab[:, 3], b.static_slab[:, 4])


# ------------------------------------------------------------------ pair math
def pair_w_gfac(rest_rows, rest_slab, h):
    """Per-pair cubic-spline value w and gradient factor gfac, grad_W(x_ij) =
    gfac * x_ij with x_ij = X_i - X_j, the exact-branch form.

    rest_rows (..., rows, 3), rest_slab (..., slab, 3) -> dx
    (..., rows, slab, 3), w, gfac (..., rows, slab).  Self-pairs (r = 0) get
    w = gfac = 0.  h enters in the tensors' dtype, as the JAX reference
    takes it."""
    dx = rest_rows[..., :, None, :] - rest_slab[..., None, :, :]
    r2 = torch.sum(dx * dx, dim=-1)
    r = torch.sqrt(r2)
    h = torch.tensor(h, dtype=dx.dtype, device=dx.device)
    q = r / h
    c = 1.0 / (math.pi * h ** 3)
    w_near = c * (1.0 - 1.5 * q ** 2 + 0.75 * q ** 3)
    w_far = 0.25 * c * (2.0 - q) ** 3
    zero = torch.zeros_like(q)
    w = torch.where(q < 1.0, w_near, torch.where(q < 2.0, w_far, zero))
    g_near = c * (-3.0 + 2.25 * q) / (h * h)
    q_safe = torch.where(q > 0, q, torch.ones_like(q))
    g_far = -0.75 * c * (2.0 - q) ** 2 / (q_safe * h * h)
    gfac = torch.where(q < 1.0, g_near, torch.where(q < 2.0, g_far, zero))
    self_pair = r2 == 0.0
    return dx, torch.where(self_pair, zero, w), torch.where(self_pair, zero, gfac)


def moments_xla(pos_rows, pos_slab, blk: Blocked, cfg: SimConfig):
    """K1 reference: per-slot A_pq and Y moments (n_tiles, rows, 3, 3),
    A = sum_j (w m_j) (p_j - p_i) (x) (X_j - X_i) and
    Y = sum_j V_j (p_j - p_i) (x) grad_W(X_ij)."""
    rest_rows, rest_slab, mass_slab, vol_slab = _rest(blk)
    dx, w, gfac = pair_w_gfac(rest_rows, rest_slab, cfg.h)
    cA = w * mass_slab[:, None, :]
    gv = gfac * vol_slab[:, None, :]
    dp = pos_slab[:, None, :, :] - pos_rows[:, :, None, :]
    A = torch.einsum("trs,trsa,trsb->trab", cA, dp, -dx)
    Y = torch.einsum("trs,trsa,trsb->trab", gv, dp, dx)
    return A, Y


def forces_xla(G_rows, G_slab, vol_rows, blk: Blocked, cfg: SimConfig,
               F_rows=None, S_slab=None, R_slab=None, vol_slab=None):
    """K2 reference: antisymmetrized pair forces (n_tiles, rows, 3).

    Taichi pairing (``pair_def_grad="j"``): f_i = 0.5 V_i [sum_j G_j
    grad_W + (G_i / V_i) sum_j V_j grad_W], G = V R F S.  Warp pairing:
    the first term becomes sum_j V_j R_j (F_i S_j) grad_W."""
    rest_rows, rest_slab, _, vslab = _rest(blk)
    dx, _, gfac = pair_w_gfac(rest_rows, rest_slab, cfg.h)
    nw = gfac[..., None] * dx
    gv = gfac * vslab[:, None, :]
    sum_v_nw = torch.einsum("trs,trsb->trb", gv, dx)
    if cfg.pair_def_grad == "j":
        term_j = torch.einsum("tsab,trsb->tra", G_slab, nw)
    else:
        FS = torch.einsum("trab,tsbc->trsac", F_rows, S_slab)
        y = torch.einsum("trsac,trsc->trsa", FS, nw)
        term_j = torch.einsum("ts,tsab,trsb->tra", vol_slab, R_slab, y)
    vol_safe = torch.where(vol_rows > 0, vol_rows, torch.ones_like(vol_rows))
    M_rows = G_rows / vol_safe[..., None, None]
    term_i = torch.einsum("trab,trb->tra", M_rows, sum_v_nw)
    return 0.5 * vol_rows[..., None] * (term_j + term_i)
