"""Corotated meshless StVK elasticity as dense gather-reduce ops: the gather
backend (counterpart of ``softbody_tpu/ops/elasticity.py``).

Each of the reference's three gather-reduce kernels per step (compute_A_pq,
compute_nabla_u, compute_elastic_forces, sim.py:170-235) becomes a row
gather over the static ``(N, K)`` rest table (``core/types.Topology``) and
dense einsum reductions, with the JAX package's two restructurings:
``nabla_u_i = R_i^T Y_i - C_i`` with ``C_i`` the rest-space constant
``Topology.rest_corr``, and the per-particle products (``V S``, ``R``, or
``G = V R F S``) formed once and gathered, not recomputed per pair.

The JAX package computes this path with XLA ops and no Pallas kernel, so
these plain torch ops are its port.  The one op written by hand is the row
gather's backward (:func:`gather`): the default backward of ``a[idx]``
scatters with ``index_put_(accumulate=True)``, whose CUDA path may add with
float atomics in any order; here every row sums its readers in one fixed
order through the CSR inverse of ``idx``, so gradients repeat bit for bit.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..config import SimConfig
from ..core.types import Materials, Topology
from . import mat3
from .pair_common import _no_tf32


def compute_ratio(x: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """ratio = 0.5 tanh(gain * x) + 0.5 (sim.py:107-110)."""
    return 0.5 * torch.tanh(cfg.tanh_gain * x) + 0.5


def index_inverse(idx: torch.Tensor, n: int):
    """CSR inverse of an index tensor on its device: (order, lengths), the
    flat positions reading row r in ascending order at
    order[ptr[r]:ptr[r + 1]], ptr the prefix sum of lengths.  A stable sort
    and an integer count, so the result does not depend on the run."""
    flat = idx.reshape(-1)
    return torch.argsort(flat, stable=True), torch.bincount(flat, minlength=n)


class _Gather(torch.autograd.Function):
    """a (N, ...) -> a[idx] (*idx.shape, ...); the backward sums each row's
    readers in the CSR order (``order``, ``lengths``) with one
    ``segment_reduce``, computing that order from ``idx`` when none is
    given."""

    @staticmethod
    def forward(ctx, a, idx, order, lengths):
        ctx.save_for_backward(idx, order, lengths)
        ctx.rows = a.shape[0]
        return a[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        idx, order, lengths = ctx.saved_tensors
        if order.numel() == 0:
            order, lengths = index_inverse(idx, ctx.rows)
        tail = g.shape[idx.dim():]
        src = g.reshape(idx.numel(), -1)[order]
        out = torch.segment_reduce(src, "sum", lengths=lengths, axis=0)
        return out.reshape(ctx.rows, *tail), None, None, None


def gather(a: torch.Tensor, idx: torch.Tensor, inverse=None) -> torch.Tensor:
    """Row gather a (N, ...) -> (*idx.shape, ...), with a fixed-order
    backward.  ``inverse`` = (order, lengths) of ``idx`` when known (the
    topology's ``inv_order`` / ``inv_lengths``); else the backward derives
    it on the device."""
    if inverse is None:
        none = idx.new_empty(0)
        inverse = (none, none)
    return _Gather.apply(a, idx, *inverse)


def gather_topo(a: torch.Tensor, topo: Topology) -> torch.Tensor:
    """Row gather over the rest table: a (N, ...) -> (N, K, ...)."""
    return gather(a, topo.idx, (topo.inv_order, topo.inv_lengths))


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def deformation(pos: torch.Tensor, topo: Topology, cfg: SimConfig, source=None):
    """A_pq, R, F (each (N, 3, 3)) from current positions: one (N, K, 3)
    position gather, from ``source`` when given (the rows' neighbours on a
    shard, ``parallel/``), else from ``pos``."""
    _no_tf32()
    pj = gather_topo(pos if source is None else source, topo)   # (N, K, 3)
    pji = pj - pos[:, None, :]
    # A_pq_i = sum_j c_ij p_ji (x) X_ji   (sim.py:170-183)
    A = torch.einsum("ij,ija,ijb->iab", topo.c, pji, topo.xji)
    # Y_i = sum_j V_j p_ji (x) nW_ij ;   nabla_u = R^T Y - rest_corr
    Y = torch.einsum("ij,ija,ijb->iab", topo.vj, pji, topo.nw)
    if cfg.corotated:
        R = mat3.polar3(A.permute(1, 2, 0)).permute(2, 0, 1)
        nabla_u = torch.einsum("iba,ibc->iac", R, Y) - topo.rest_corr
    else:                                    # sim_taichi.py:129 (R_i <- I)
        R = _eye(A).expand(A.shape)
        nabla_u = Y - topo.rest_corr
    F = _eye(pos) + nabla_u.transpose(-1, -2)              # sim.py:209
    return A, R, F


def stvk_stress(F, mu, lam, scale):
    """S = (2 mu E + lam tr(E) I) * inflation scale, E = 0.5 (F^T F - I)
    (compute_sigma, sim.py:212-216)."""
    E = 0.5 * (torch.einsum("iba,ibc->iac", F, F) - _eye(F))
    tr = E.diagonal(dim1=-2, dim2=-1).sum(-1)
    S = (2.0 * mu[:, None, None] * E
         + lam[:, None, None] * tr[:, None, None] * _eye(F))
    return S * scale[:, None, None]


def elastic_forces(pos, ratio, mats: Materials, topo: Topology, cfg: SimConfig,
                   exchange=None):
    """Pairwise antisymmetrized elastic forces (compute_elastic_forces,
    sim.py:218-235 / sim_taichi.py:147-158).  Returns (forces (N, 3),
    (R, F, S)).

    force_i = 0.5 sum_j (R_j f_ij - R_i f_ji); the local term sums to
    V_i M_i sum_j V_j nW_ij with M = R F S.  With F_pair = F_j (Taichi,
    ``pair_def_grad="j"``) the pair term separates: one gather of G = V M.
    With F_pair = F_i (Warp, sim.py:233) it mixes i and j: gathers of
    V_j S_j and R_j.

    ``exchange(a)`` maps a per-row array (rows, k) to the array the table
    ``topo.idx`` indexes: on a shard of the particle mesh the rows are the
    rank's and the neighbours come from an all-gather or a halo exchange
    (``parallel/``), two per evaluation (positions, then the pair
    operands); None on one device."""
    src = (lambda a: a) if exchange is None else exchange
    _, R, F = deformation(pos, topo, cfg, None if exchange is None else src(pos))
    scale = cfg.stiffness_scale(ratio)
    S = stvk_stress(F, mats.mu, mats.lam, scale)
    M = R @ F @ S                                          # R_i F_i S_i
    term_i = torch.einsum("iab,ib->ia", M, topo.sum_v_nw)
    n, K = topo.idx.shape
    if cfg.pair_def_grad == "j":
        G = (mats.volume[:, None, None] * M).reshape(n, 9)
        Gj = gather_topo(src(G), topo).reshape(n, K, 3, 3)      # (N, K, 3, 3)
        term_j = torch.einsum("ijab,ijb->ia", Gj, topo.nw)
    else:
        rec = torch.cat([(mats.volume[:, None, None] * S).reshape(n, 9),
                         R.reshape(n, 9)], dim=1)
        rj = gather_topo(src(rec), topo)
        VSj, Rj = rj[..., :9].reshape(n, K, 3, 3), rj[..., 9:].reshape(n, K, 3, 3)
        y = torch.einsum("iab,ijbc,ijc->ija", F, VSj, topo.nw)   # F_i (V_j S_j) nW
        term_j = torch.einsum("ijab,ijb->ia", Rj, y)             # R_j y
    return 0.5 * mats.volume[:, None] * (term_j + term_i), (R, F, S)
