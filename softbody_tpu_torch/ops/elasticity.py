"""Corotated meshless StVK elasticity over the (N, K) rest tables: the
gather backend (counterpart of ``softbody_tpu/ops/elasticity.py``).

The reference's three gather-reduce kernels per step (compute_A_pq,
compute_nabla_u, compute_elastic_forces, sim.py:170-235) run over the
static ``(N, K)`` rest table (``core/types.Topology``), with the JAX
package's two restructurings: ``nabla_u_i = R_i^T Y_i - C_i`` with ``C_i``
the rest-space constant ``Topology.rest_corr``, and the per-particle
products (``V S`` and ``R``, or ``V M``) formed once and gathered, not
recomputed per pair.

The JAX package computes this path with XLA ops and no Pallas kernel; XLA
fuses its gathers, einsums and polar into a few programs.  Here
:func:`elastic_forces` is the chain of the kernels of
``ops/gather_kernels`` and ``ops/mid_kernels``:

  pos -> [gather_moments] -> ayT (18, N) = A | Y
      -> [mid_records: the polar, F, the StVK stress S, M = R F S]
         -> fmT (19, N) = [F | M | V], srT (15, N) = [S_6 | R^T_9]
      -> [gather_forces, the Warp or the Taichi pairing] -> forces (N, 3)

one launch each on the card, their VJPs one call each backward, through a
``pair_kernels.PairOps`` (``PLAIN``: the plain versions of
``gather_kernels`` and ``mid_kernels``, through the same autograd
Functions, whose plain VJPs run their forwards again).  On CPU tensors
through ``KERNELS`` autograd goes straight through :func:`deformation`,
:func:`stvk_stress` and ``gather_kernels.pair_forces`` on (N, 3, 3)
batches, the JAX package's formulation (fewer than half the ops of the
chain of plain versions, whose mid-section works per component).
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..core.types import Materials, Topology
from . import gather_kernels as gk
from . import mat3
from .gather_kernels import gather, gather_topo, index_inverse  # noqa: F401
from .mid_kernels import gather_row_static, mid_records_all
from .pair_common import SYM6
from .pair_kernels import KERNELS, PairOps


def compute_ratio(x: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """ratio = 0.5 tanh(gain * x) + 0.5 (sim.py:107-110)."""
    return 0.5 * torch.tanh(cfg.tanh_gain * x) + 0.5


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def deformation(pos: torch.Tensor, topo: Topology, cfg: SimConfig, source=None):
    """A_pq, R, F (each (N, 3, 3)) from current positions: A_pq_i = sum_j
    c_ij p_ji (x) X_ji (sim.py:170-183) and Y_i = sum_j V_j p_ji (x) nW_ij
    from ``gather_kernels.moments_batched`` (the neighbours from ``source``
    when given, else from ``pos``), nabla_u = R^T Y - rest_corr."""
    A, Y = gk.moments_batched(pos, source, topo)
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


def _forces_batched(pos, src, scale, mats: Materials, topo: Topology, cfg: SimConfig,
                    exchange):
    """:func:`forces_and_records` on (N, 3, 3) batches: :func:`deformation`,
    :func:`stvk_stress` and ``gather_kernels.pair_forces``, the source's
    record [V_j S_j | R_j] or V_j M_j exchanged on a shard."""
    n = pos.shape[0]
    _, R, F = deformation(pos, topo, cfg, src)
    S = stvk_stress(F, mats.mu, mats.lam, scale)
    M = R @ F @ S                                          # R_i F_i S_i
    V = mats.volume
    if cfg.pair_def_grad == "j":
        own = (V[:, None, None] * M).reshape(n, 9)
    else:
        own = torch.cat([(V[:, None, None] * S).reshape(n, 9), R.reshape(n, 9)], dim=1)
    f = gk.pair_forces(F, M, V, own if exchange is None else exchange(own), topo,
                       cfg.pair_def_grad == "j")
    fmT = torch.cat([F.reshape(n, 9), M.reshape(n, 9), V[:, None]], dim=1).T
    S6 = S.reshape(n, 9)[:, [0, 1, 2, 4, 5, 8]]
    return f, fmT, torch.cat([S6, R.transpose(1, 2).reshape(n, 9)], dim=1).T


def forces_and_records(pos, ratio, mats: Materials, topo: Topology, cfg: SimConfig,
                       exchange=None, pair_ops: PairOps = KERNELS):
    """The gather backend's force evaluation (compute_elastic_forces,
    sim.py:218-235 / sim_taichi.py:147-158): (forces (N, 3), fmT (19, N),
    srT (15, N)), differentiable wrt positions and ratio.

    force_i = 0.5 sum_j (R_j f_ij - R_i f_ji); the local term sums to
    V_i M_i sum_j V_j nW_ij with M = R F S.  With F_pair = F_j (Taichi,
    ``pair_def_grad="j"``) the pair term separates: it reads V_j M_j.  With
    F_pair = F_i (Warp, sim.py:233) it mixes i and j: it reads V_j S_j and
    R_j.

    ``exchange(a)`` maps a per-row array (rows, k) to the array the table
    ``topo.idx`` indexes: on a shard of the particle mesh the rows are the
    rank's and the neighbours come from an all-gather or a halo exchange
    (``parallel/``), two per evaluation (positions, then the pair records:
    the kernels' packed record [S_6 | R^T_9 | V] or [M_9 | V | 0 | 0] as
    ``mid_records`` writes it, the batched ops' [V S | R] or V M); None on
    one device."""
    n = pos.shape[0]
    src = None if exchange is None else exchange(pos)
    scale = cfg.stiffness_scale(ratio)
    if pair_ops is KERNELS and pos.device.type == "cpu":
        return _forces_batched(pos, src, scale, mats, topo, cfg, exchange)
    sep = cfg.pair_def_grad == "j"
    ayT = gk.moments_all(pos, src, topo, pair_ops)
    fmT, srT, rec = mid_records_all(ayT, scale, gather_row_static(mats, topo),
                                    cfg.corotated, n, pair_ops, rec=gk.REC_W[sep])
    if exchange is not None:
        rec = exchange(rec)
    return gk.forces_all(fmT, rec, topo, sep, pair_ops), fmT, srT


def elastic_forces(pos, ratio, mats: Materials, topo: Topology, cfg: SimConfig,
                   exchange=None, pair_ops: PairOps = KERNELS):
    """Pairwise antisymmetrized elastic forces (:func:`forces_and_records`).
    Returns (forces (N, 3), (R, F, S)), each of R, F, S (N, 3, 3) from the
    mid-section's records."""
    f, fmT, srT = forces_and_records(pos, ratio, mats, topo, cfg, exchange, pair_ops)
    n = pos.shape[0]
    F = fmT[:9].T.reshape(n, 3, 3)
    R = srT[6:15].T.reshape(n, 3, 3).transpose(1, 2)
    S = srT[list(SYM6)].T.reshape(n, 3, 3)
    return f, (R, F, S)
