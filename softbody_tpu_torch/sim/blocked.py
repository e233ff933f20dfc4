"""The per-slot mid-section between the two pair stages (counterpart of
``stvk_stress_m3`` and ``_mid_section`` in ``softbody_tpu/sim/blocked.py``).

Plain eager torch on component lists of (m,) tensors: polar rotation,
deformation gradient, StVK stress and M = R F S.  It is a long chain of
small elementwise kernels (the Jacobi polar alone is ~2000), so on the card
it is launch-bound, not a pair kernel.
"""

from __future__ import annotations

from ..config import SimConfig
from ..core.types import Materials, Scene
from ..ops import mat3


def stvk_stress_m3(F, mu, lam, scale):
    """StVK stress S = (2 mu E + lam tr(E) I) * scale, E = 0.5 (F^T F - I),
    on components; mu/lam/scale (m,)."""
    FtF = mat3._mtm(F, F)
    E = [[0.5 * (FtF[i][j] - 1.0) if i == j else 0.5 * FtF[i][j]
          for j in range(3)] for i in range(3)]
    tr = E[0][0] + E[1][1] + E[2][2]
    two_mu = 2.0 * mu
    lam_tr = lam * tr
    return [[(two_mu * E[i][j] + lam_tr if i == j else two_mu * E[i][j]) * scale
             for j in range(3)] for i in range(3)]


def mid_rows(A, Y, rc, mu, lam, scale, corotated: bool):
    """The mid-section on component lists of (k,) tensors: A, Y the K1
    moments, rc[i, j] the static rest correction, mu / lam / scale (k,).
    Returns component lists R, F, S, M: the polar rotation of A (identity
    when not corotated), F = I + (R^T Y - rc)^T, the StVK stress S and
    M = R F S.  The fused kernel's epilogue computes the same, row by row."""
    if corotated:
        R = mat3.polar3_components(A)
        RtY = mat3._mtm(R, Y)
        nab = [[RtY[i][j] - rc[i, j] for j in range(3)] for i in range(3)]
    else:
        R = mat3.eye3(A[0][0])
        nab = [[Y[i][j] - rc[i, j] for j in range(3)] for i in range(3)]
    F = [[1.0 + nab[j][i] if i == j else nab[j][i] for j in range(3)]
         for i in range(3)]
    S = stvk_stress_m3(F, mu, lam, scale)
    M = mat3._mm(R, mat3._mm(F, S))
    return R, F, S, M


def mid_section(A, Y, ratio_slots, mats: Materials, scene: Scene,
                cfg: SimConfig, m: int):
    """A, Y: component lists of (m,) tensors (the K1 moments).  Returns
    component lists R, F, S, M and vol_m (m,).  (The JAX mid-section also
    forms G = V M, which only the pair_def_grad="j" forces read.)"""
    scale = cfg.stiffness_scale(ratio_slots[:m])
    R, F, S, M = mid_rows(A, Y, scene.rest_corr, mats.mu[:m], mats.lam[:m],
                          scale, cfg.corotated)
    return R, F, S, M, mats.volume[:m]
