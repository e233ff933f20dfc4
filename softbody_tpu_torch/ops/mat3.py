"""Batched 3x3 linear algebra on component lists (counterpart of
``softbody_tpu/ops/mat3.py``).

A matrix is a 3x3 nested list of (*batch,) tensors; every op is written out
as explicit scalar formulas on the components (elementwise torch ops), so no
op ever contracts over a size-3 axis and the batch axis stays dense.
``pack``/``unpack`` convert to and from the (3, 3, *batch) leading-axis
layout of the public functions.

Includes the cyclic-Jacobi eigensolver, the SVD built on it, and the polar
rotation R = U V^T with the JAX package's clamped analytic VJP
(``softbody_tpu/ops/mat3.py:245-272``) as a ``torch.autograd.Function``:
autograd never runs through the Jacobi sweeps, whose ``where`` branches and
sort network are a different function of the input (and give NaN at
degenerate singular values).
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

_PAIRS = ((0, 1), (0, 2), (1, 2))


def unpack(A: torch.Tensor):
    """(3, 3, *batch) -> 3x3 nested list of (*batch,) components."""
    return [[A[i, j] for j in range(3)] for i in range(3)]


def pack(m) -> torch.Tensor:
    """3x3 nested list -> (3, 3, *batch)."""
    return torch.stack([torch.stack(row) for row in m])


def pack_vec(v) -> torch.Tensor:
    return torch.stack(v)


# ----------------------------------------------------------- component helpers
def _mm(a, b):
    """a @ b on components."""
    return [[sum(a[i][k] * b[k][j] for k in range(3)) for j in range(3)] for i in range(3)]


def _mtm(a, b):
    """a^T @ b on components."""
    return [[sum(a[k][i] * b[k][j] for k in range(3)) for j in range(3)] for i in range(3)]


def _mmt(a, b):
    """a @ b^T on components."""
    return [[sum(a[i][k] * b[j][k] for k in range(3)) for j in range(3)] for i in range(3)]


def eye3(like: torch.Tensor):
    """Identity components with the batch shape of the component ``like``."""
    one = torch.ones_like(like)
    zero = torch.zeros_like(like)
    return [[one if i == j else zero for j in range(3)] for i in range(3)]


# --------------------------------------------------------------------- Jacobi SVD
def _givens(app, aqq, apq):
    small = torch.abs(apq) < 1e-30
    apq_safe = torch.where(small, 1.0, apq)
    theta = (aqq - app) / (2.0 * apq_safe)
    t = torch.sign(theta) / (torch.abs(theta) + torch.sqrt(1.0 + theta * theta))
    t = torch.where(theta == 0.0, 1.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(small, 1.0, c)
    s = torch.where(small, 0.0, s)
    return c, s


def _rotate(S, V, p, q):
    """S <- J^T S J, V <- V J on component lists (no tensor updates)."""
    c, s = _givens(S[p][p], S[q][q], S[p][q])
    # column update S J
    for i in range(3):
        sp, sq = S[i][p], S[i][q]
        S[i][p] = c * sp - s * sq
        S[i][q] = s * sp + c * sq
    # row update J^T S
    for j in range(3):
        rp, rq = S[p][j], S[q][j]
        S[p][j] = c * rp - s * rq
        S[q][j] = s * rp + c * rq
    for i in range(3):
        vp, vq = V[i][p], V[i][q]
        V[i][p] = c * vp - s * vq
        V[i][q] = s * vp + c * vq
    return S, V


def _eigh3_components(S, sweeps):
    S = [list(row) for row in S]
    V = eye3(S[0][0])
    for _ in range(sweeps):
        for (p, q) in _PAIRS:
            S, V = _rotate(S, V, p, q)
    evals = [S[0][0], S[1][1], S[2][2]]

    # descending 3-sort network on (evals, V columns)
    def swap(e, V, a, b):
        cond = e[a] < e[b]
        ea = torch.where(cond, e[b], e[a])
        eb = torch.where(cond, e[a], e[b])
        e[a], e[b] = ea, eb
        for i in range(3):
            va, vb = V[i][a], V[i][b]
            V[i][a] = torch.where(cond, vb, va)
            V[i][b] = torch.where(cond, va, vb)
        return e, V

    for (a, b) in ((0, 1), (1, 2), (0, 1)):
        evals, V = swap(evals, V, a, b)
    return evals, V


def eigh3(S: torch.Tensor, sweeps: int = 8):
    """Eigendecomposition of symmetric (3,3,*): (evals (3,*) desc, evecs (3,3,*))."""
    evals, V = _eigh3_components(unpack(S), sweeps)
    return pack_vec(evals), pack(V)


def _svd3_components(a, sweeps):
    """Component-level SVD; a is a 3x3 nested list.  Returns (U, sigma, V) lists."""
    AtA = _mtm(a, a)
    evals, V = _eigh3_components(AtA, sweeps)
    sigma = [torch.sqrt(torch.clamp(e, min=0.0)) for e in evals]
    B = _mm(a, V)                       # = U diag(sigma); columns B[:][k]
    eps = 1e-12

    def col(M, k):
        return [M[0][k], M[1][k], M[2][k]]

    def norm(v):
        return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])

    def normalize(v, fallback):
        n = norm(v)
        ok = n > eps
        n_safe = torch.where(ok, n, 1.0)
        return [torch.where(ok, v[i] / n_safe, fallback[i]) for i in range(3)]

    def cross(u, v):
        return [
            u[1] * v[2] - u[2] * v[1],
            u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0],
        ]

    def dot(u, v):
        return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]

    one = torch.ones_like(a[0][0])
    zero = torch.zeros_like(a[0][0])
    e0 = [one, zero, zero]
    e1 = [zero, one, zero]
    b0, b1, b2 = col(B, 0), col(B, 1), col(B, 2)
    u0 = normalize(b0, e0)
    # fallback direction orthogonal-ish to u0 (only used at rank 0/degenerate)
    rolled = [u0[2] + 0.5, u0[0], u0[1]]
    alt = normalize(cross(u0, rolled), e1)
    d01 = dot(u0, b1)
    u1 = normalize([b1[i] - d01 * u0[i] for i in range(3)], alt)
    d20 = dot(u0, b2)
    u2b = [b2[i] - d20 * u0[i] for i in range(3)]
    d21 = dot(u1, u2b)
    u2b = [u2b[i] - d21 * u1[i] for i in range(3)]
    c01 = cross(u0, u1)
    sgn = dot(u2b, c01)
    sgn = torch.where(torch.abs(sgn) > eps, torch.sign(sgn), 1.0)
    u2 = normalize(u2b, [sgn * c01[i] for i in range(3)])
    U = [[u0[i], u1[i], u2[i]] for i in range(3)]   # columns u0, u1, u2
    return U, sigma, V


def svd3(A: torch.Tensor, sweeps: int = 8):
    """SVD of (3,3,*): (U (3,3,*), sigma (3,*) desc >= 0, V (3,3,*))."""
    U, sigma, V = _svd3_components(unpack(A), sweeps)
    return pack(U), pack_vec(sigma), pack(V)


class _Polar3(torch.autograd.Function):
    """R = U V^T; backward G -> U H V^T with G' = U^T G V and
    H_ij = (G'_ij - G'_ji) / max(sigma_i + sigma_j, 1e-6)."""

    @staticmethod
    def forward(ctx, A, sweeps):
        U, sigma, V = _svd3_components(unpack(A), sweeps)
        if ctx.needs_input_grad[0]:
            ctx.save_for_backward(pack(U), pack_vec(sigma), pack(V))
        return pack(_mmt(U, V))

    @staticmethod
    @once_differentiable
    def backward(ctx, G):
        U, sigma, V = ctx.saved_tensors
        Uu, Vu, su = unpack(U), unpack(V), list(sigma)
        Gp = _mm(_mtm(Uu, unpack(G)), Vu)
        H = [[(Gp[i][j] - Gp[j][i]) / torch.clamp(su[i] + su[j], min=1e-6)
              for j in range(3)] for i in range(3)]
        return pack(_mmt(_mm(Uu, H), Vu)), None


def polar3(A: torch.Tensor, sweeps: int = 8) -> torch.Tensor:
    """Rotation part of the polar decomposition; leading-axis layout (3,3,*).
    Differentiable through the clamped analytic VJP."""
    return _Polar3.apply(A, sweeps)


def polar3_components(a, sweeps: int = 8):
    """:func:`polar3` on components (the mid-section's form)."""
    return unpack(polar3(pack(a), sweeps))
