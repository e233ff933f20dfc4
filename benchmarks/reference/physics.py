"""Plain PyTorch reference of the episode the benchmark times.

A corotated meshless StVK body (the upstream ``sim.py`` / ``sim_taichi.py``
model): particles X with mass m, cubic-spline kernel W of support 2h over
every neighbour pair within the support, and per particle

    rho_i = sum_j m_j W_ij (+ m_i W(0) with self_density),  V_i = m_i / rho_i
    A_i   = sum_j w_ij m_j (p_j - p_i) (x) (X_j - X_i)
    Y_i   = sum_j V_j (p_j - p_i) (x) grad W(X_i - X_j)
    C_i   = sum_j V_j (X_j - X_i) (x) grad W(X_i - X_j)    (Y at rest)
    R_i   = polar(A_i) (identity when not corotated)
    F_i   = I + (R_i^T Y_i - C_i)^T,  E = (F^T F - I) / 2
    S_i   = (2 mu E + lam tr(E) I) (scale_a - scale_b ratio_i),
            ratio = tanh(gain x) / 2 + 1 / 2
    f_i   = V_i / 2 (sum_j V_j R_j F_i S_j grad W_ij + R_i F_i S_i sum_j V_j grad W_ij)

(with ``pair_def_grad = "j"`` the pair term is sum_j V_j R_j F_j S_j grad
W_ij), then a symplectic or trapezoidal step and the sampled or final-frame
loss.  The neighbour sets, densities, volumes and rest terms are worked out
here from the particles alone; the gradient is reverse mode through every
step (autograd, the polar rotation through its analytic derivative), from
states kept by a forward pass.

Nothing here imports the program under test.  ``control=True`` rounds
every operand of every contraction to TF32 (10 mantissa bits, round to
nearest even) and accumulates in the working precision: the control
precision of an f32 configuration.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import torch

OFFSETS = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1)]


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32: 10 mantissa bits, nearest even.  The
    rounding passes gradients through unchanged, as a TF32 product's
    operands do."""
    if t.dtype != torch.float32:
        raise ValueError("TF32 rounding takes float32")
    b = t.detach().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return t + (b.view(torch.float32) - t).detach()


class Arith:
    """The contractions of one evaluation: exact in the working precision,
    or (``control``) on TF32-rounded operands."""

    def __init__(self, control: bool = False):
        self.control = control

    def _r(self, t):
        return tf32(t) if self.control else t

    def mul_sum(self, a, b, dim):
        """sum(a * b, dim): a contraction written elementwise (no batched
        GEMM of tiny matrices)."""
        return (self._r(a) * self._r(b)).sum(dim)

    def mm(self, a, b):
        return mm(self._r(a), self._r(b))

    def spmm(self, pair, x):
        """W @ x; in the control the matrix's values are TF32 too."""
        if self.control:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                pair = tuple(torch.sparse_csr_tensor(w.crow_indices(), w.col_indices(),
                                                     tf32(w.values()), w.shape) for w in pair)
        return spmm(pair, self._r(x))


# ------------------------------------------------------------------ kernel W
def kernel_w(r: torch.Tensor, h: float) -> torch.Tensor:
    """Cubic spline W(r) of support 2h."""
    q = r / h
    c0 = 1.0 / (math.pi * h ** 3)
    near = c0 * (1.0 - 1.5 * q * q + 0.75 * q * q * q)
    far = 0.25 * c0 * (2.0 - q).clamp(min=0.0) ** 3
    return torch.where(q < 1.0, near, far)


def kernel_gfac(r: torch.Tensor, h: float) -> torch.Tensor:
    """g(r) with grad W(x) = g(|x|) x."""
    q = r / h
    c0 = 1.0 / (math.pi * h ** 3)
    near = c0 * (-3.0 + 2.25 * q) / (h * h)
    far = -0.75 * c0 * (2.0 - q).clamp(min=0.0) ** 2 / (q.clamp(min=1e-30) * h * h)
    return torch.where(q < 1.0, near, far)


# --------------------------------------------------------------- neighbours
def neighbor_pairs(X: torch.Tensor, radius: float, block: int = 1 << 20):
    """Directed pairs (i, j), j != i, |X_i - X_j| < radius, sorted by (i, j):
    a uniform grid of cells of side ``radius``, the 27 cells around each
    particle's searched.  X float64 (n, 3).  Returns (row, col) int64."""
    n = X.shape[0]
    dev = X.device
    lo = X.min(0).values
    cell = torch.floor((X - lo) / radius).long() + 1
    dims = cell.max(0).values + 2
    key = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    order = torch.argsort(key)
    skey = key[order]
    r2 = radius * radius
    rows, cols = [], []
    for dx, dy, dz in OFFSETS:
        nk = key + (dx * dims[1] + dy) * dims[2] + dz
        start = torch.searchsorted(skey, nk)
        cnt = torch.searchsorted(skey, nk, right=True) - start
        for i0 in range(0, n, block):
            c = cnt[i0:i0 + block]
            tot = int(c.sum())
            if tot == 0:
                continue
            i = torch.repeat_interleave(torch.arange(i0, i0 + len(c), device=dev), c)
            first = torch.repeat_interleave(torch.cumsum(c, 0) - c, c)
            j = order[torch.repeat_interleave(start[i0:i0 + block], c)
                      + torch.arange(tot, device=dev) - first]
            d = X[i] - X[j]
            keep = ((d * d).sum(1) < r2) & (i != j)
            rows.append(i[keep])
            cols.append(j[keep])
    row, col = torch.cat(rows), torch.cat(cols)
    perm = torch.argsort(row * n + col)
    return row[perm], col[perm]


class Statics(NamedTuple):
    """The rest-space terms.  Pair sums are products with sparse matrices
    over the real pairs, each kept with its transpose: W_b of ``wc`` holds
    w_ij m_j (X_j - X_i)_b and W_d of ``wn`` grad W(X_i - X_j)_d."""
    wc: tuple                # (V, V^T) of the three W_b (see :func:`stacked`)
    wn: tuple                # the same of the three grad W matrices
    rest_moment: torch.Tensor  # (n, 3, 3) sum_j w_ij m_j X_ji (x) X_ji: A at rest
    scx: torch.Tensor        # (n, 3) sum_j w_ij m_j X_ji
    corr: torch.Tensor       # (n, 3, 3) C_i
    svnw: torch.Tensor       # (n, 3) sum_j V_j grad W_ij
    volume: torch.Tensor     # (n,)
    rest: torch.Tensor       # (n, 3) X
    n_pairs: int             # directed pairs within the support


def statics(X: torch.Tensor, mass: torch.Tensor, h: float, self_density: bool,
            dtype, block: int = 1 << 24) -> Statics:
    """Neighbours, density, volume and the rest terms of the particles X
    (float64, on the device the reference runs on), worked out in float64
    in blocks of pairs and kept in ``dtype``."""
    n = X.shape[0]
    dev = X.device
    X = X.double()
    mass = mass.double()
    row, col = neighbor_pairs(X, 2.0 * h)
    p = len(row)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    # the position of pair (j, i) for each pair (i, j): the transpose's order
    flip = torch.searchsorted(row * n + col, col * n + row)

    def blocks():
        for s0 in range(0, p, block):
            s = slice(s0, min(s0 + block, p))
            xij = X[row[s]] - X[col[s]]                     # X_i - X_j
            yield s, xij, torch.sqrt((xij * xij).sum(1))

    rho = torch.zeros(n, dtype=torch.float64, device=dev)
    for s, _, r in blocks():
        rho.index_add_(0, row[s], kernel_w(r, h) * mass[col[s]])
    if self_density:
        rho = rho + mass / (math.pi * h ** 3)
    volume = torch.where(rho > 0, mass / rho.clamp(min=1e-300), torch.zeros_like(rho))

    wc = torch.empty((3, p), dtype=dtype, device=dev)
    wn = torch.empty((3, p), dtype=dtype, device=dev)
    moment = torch.zeros((n, 9), dtype=torch.float64, device=dev)
    corr = torch.zeros((n, 9), dtype=torch.float64, device=dev)
    scx = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    svnw = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    for s, xij, r in blocks():
        c = (kernel_w(r, h) * mass[col[s]])[:, None]
        g = kernel_gfac(r, h)[:, None] * xij                   # grad W(X_i - X_j)
        v = volume[col[s]][:, None]
        wc[:, s] = (-c * xij).T.to(dtype)
        wn[:, s] = g.T.to(dtype)
        moment.index_add_(0, row[s], (c[:, :, None] * xij[:, :, None] * xij[:, None, :]).reshape(-1, 9))
        corr.index_add_(0, row[s], (-v[:, :, None] * xij[:, :, None] * g[:, None, :]).reshape(-1, 9))
        scx.index_add_(0, row[s], -c * xij)
        svnw.index_add_(0, row[s], v * g)

    return Statics(stacked(wc, crow, col, flip, n), stacked(wn, crow, col, flip, n),
                   moment.reshape(n, 3, 3).to(dtype), scx.to(dtype),
                   corr.reshape(n, 3, 3).to(dtype), svnw.to(dtype), volume.to(dtype),
                   X.to(dtype), p)


def stacked(values, crow, col, flip, n):
    """(V, V^T) of the three pair matrices W_b whose values over the pairs
    (CSR order ``crow`` / ``col``) are ``values[b]``: V = [W_0; W_1; W_2]
    (3n, n) and V^T = [W_0^T | W_1^T | W_2^T] (n, 3n), CSR with int32
    indices.  ``flip`` maps each pair (i, j) to the position of (j, i)."""
    p = len(col)
    dev = col.device
    cnt = crow[1:] - crow[:-1]
    crow_v = torch.cat([crow[:-1] + b * p for b in range(3)] + [crow[-1:] * 3])
    row = torch.repeat_interleave(torch.arange(n, device=dev), cnt)
    local = torch.arange(p, device=dev) - crow[row]
    col_t = torch.empty(3 * p, dtype=torch.int32, device=dev)
    val_t = torch.empty(3 * p, dtype=values.dtype, device=dev)
    for b in range(3):
        pos = 3 * crow[row] + b * cnt[row] + local
        col_t[pos] = (b * n + col).int()
        val_t[pos] = values[b][flip]
    with warnings.catch_warnings():     # CSR support is marked beta
        warnings.simplefilter("ignore")
        v = torch.sparse_csr_tensor(crow_v.int(), col.int().repeat(3), values.reshape(-1),
                                    (3 * n, n))
        vt = torch.sparse_csr_tensor((3 * crow).int(), col_t, val_t, (n, 3 * n))
    return v, vt


# ------------------------------------------------------------------ physics
class Physics(NamedTuple):
    """What the episode needs besides the statics (see :func:`physics`)."""
    dt: float
    damping: float
    mu: float
    lam: float
    scale_a: float
    scale_b: float
    tanh_gain: float
    corotated: bool
    pair_j: bool
    integrator: str
    loss_final: bool
    collision: bool
    collision_stiffness: float
    collision_range: float
    collision_damping: float
    mass: torch.Tensor       # (n,)
    free: torch.Tensor       # (n, 3)
    external: torch.Tensor   # (n, 3)
    v0: torch.Tensor         # (3,)


def physics(sim: dict, free, dtype, device, loss_final: bool) -> Physics:
    """The episode's constants from the configuration's ``sim`` fields;
    ``free`` (n, 3) is the Dirichlet mask (1 free, 0 clamped)."""
    E, nu = sim["youngs_modulus"], sim["poisson_ratio"]
    n = free.shape[0]

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return Physics(
        dt=sim["dt"], damping=sim["damping"],
        mu=E / (2.0 * (1.0 + nu)), lam=E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu)),
        scale_a=sim["scale_a"], scale_b=sim["scale_b"], tanh_gain=sim["tanh_gain"],
        corotated=sim["corotated"], pair_j=sim["pair_def_grad"] == "j",
        integrator=sim["integrator"], loss_final=loss_final,
        collision=sim["collision"], collision_stiffness=sim["collision_stiffness"],
        collision_range=sim["collision_range"],
        collision_damping=sim["collision_damping"],
        mass=t([sim["mass"]] * n), free=t(free),
        external=t(sim["external_force"]).expand(n, 3).contiguous(),
        v0=t(sim["initial_velocity"]))


def stiffness(x, ph: Physics):
    """The stress multiplier of the inflation field x."""
    return ph.scale_a - ph.scale_b * (0.5 * torch.tanh(ph.tanh_gain * x) + 0.5)


class _SpMM(torch.autograd.Function):
    """W @ x for a sparse W kept with its transpose; backward W^T @ g."""

    @staticmethod
    def forward(ctx, x, w, wt):
        ctx.wt = wt
        return torch.sparse.mm(w, x)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.wt, g.contiguous()), None, None


def spmm(pair, x):
    return _SpMM.apply(x.contiguous(), *pair)


def cofactor(X):
    """Cofactor matrices of X (..., 3, 3): rows r1 x r2, r2 x r0, r0 x r1."""
    return torch.linalg.cross(X.roll(-1, -2), X.roll(-2, -2), dim=-1)


def det3(X, C=None):
    C = cofactor(X) if C is None else C
    return (X[..., 0, :] * C[..., 0, :]).sum(-1)


def mm(a, b):
    """a @ b of (..., 3, 3) batches, elementwise (no batched GEMM of tiny
    matrices)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


POLAR_ITERATIONS = 8
POLAR_SVD_BELOW = 1e-6     # |det| of A / |A|_F under which a row takes the SVD


class _Polar(torch.autograd.Function):
    """R of A = R P (R orthogonal, P symmetric positive semi-definite): by
    Newton's iteration X <- (z X + X^-T / z) / 2 with Frobenius-norm
    scaling z, in closed-form 3x3 algebra, from X = A / |A|_F; rows near
    singular (a sheet of particles whose A turns over) take U V^T of an
    SVD instead.  Backward: dA = R [q]_x with (tr(P) I - P) q = w,
    [w]_x = R^T G - G^T R, the derivative of the polar rotation
    (P Z + Z P = R^T G - G^T R for the skew Z = [q]_x)."""

    @staticmethod
    def forward(ctx, A):
        X = A / torch.linalg.vector_norm(A, dim=(-2, -1), keepdim=True)
        near = (det3(X).abs() < POLAR_SVD_BELOW).nonzero()[:, 0]
        for _ in range(POLAR_ITERATIONS):
            Xit = cofactor(X) / det3(X)[..., None, None]          # X^-T
            z = (torch.linalg.vector_norm(Xit, dim=(-2, -1))
                 / torch.linalg.vector_norm(X, dim=(-2, -1))).sqrt()[..., None, None]
            X = 0.5 * (z * X + Xit / z)
        if len(near):
            U, _, Vh = torch.linalg.svd(A[near])
            X[near] = U @ Vh
        ctx.save_for_backward(A, X)
        return X

    @staticmethod
    def backward(ctx, G):
        A, R = ctx.saved_tensors
        Rt = R.transpose(-1, -2)
        P = mm(Rt, A)
        P = 0.5 * (P + P.transpose(-1, -2))
        K = mm(Rt, G) - mm(G.transpose(-1, -2), R)
        w = torch.stack([K[..., 2, 1], K[..., 0, 2], K[..., 1, 0]], -1)
        eye = torch.eye(3, dtype=A.dtype, device=A.device)
        M = P.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None] * eye - P
        C = cofactor(M)                    # M symmetric: M^-1 = C / det M
        q = (C * w[..., None, :]).sum(-1) / det3(M, C)[..., None]
        zero = torch.zeros_like(q[..., 0])
        Z = torch.stack([torch.stack([zero, -q[..., 2], q[..., 1]], -1),
                         torch.stack([q[..., 2], zero, -q[..., 0]], -1),
                         torch.stack([-q[..., 1], q[..., 0], zero], -1)], -2)
        return mm(R, Z)


def polar(A):
    return _Polar.apply(A)


def elastic_forces(pos, scale, st: Statics, ph: Physics, ar: Arith):
    """Elastic forces (n, 3) at positions ``pos`` with stress multiplier
    ``scale`` (n,).  The moments are taken on the displacement u = pos -
    rest (A = A_rest + sum_j c_ij (u_j - u_i) (x) X_ji, and Y - C likewise),
    so no sum cancels positions against each other."""
    n = pos.shape[0]
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    u = pos - st.rest
    V = st.volume
    A = st.rest_moment + ar.spmm(st.wc, u).reshape(3, n, 3).permute(1, 2, 0) \
        - u[:, :, None] * st.scx[:, None, :]
    D = ar.spmm(st.wn, V[:, None] * u).reshape(3, n, 3).permute(1, 2, 0) \
        - u[:, :, None] * st.svnw[:, None, :]                           # Y - C
    # grad W is odd, so each W_d is antisymmetric and [W_0 | W_1 | W_2] = -V^T
    wn_t = (st.wn[1], st.wn[0])
    R = polar(A) if ph.corotated else eye.expand(n, 3, 3)
    F = eye + (ar.mm(R.transpose(1, 2), st.corr + D) - st.corr).transpose(1, 2)
    E = 0.5 * (ar.mm(F.transpose(1, 2), F) - eye)
    tr = E.diagonal(dim1=-2, dim2=-1).sum(-1)
    S = (2.0 * ph.mu * E + ph.lam * tr[:, None, None] * eye) * scale[:, None, None]
    M = ar.mm(R, ar.mm(F, S))
    if ph.pair_j:
        # term_i = sum_j V_j M_j grad W_ij: sum_d W_d @ (V M)[:, :, d]
        VM = V[:, None, None] * M
        term = -ar.spmm(wn_t, VM.permute(2, 0, 1).reshape(3 * n, 3))
    else:
        # term_i[a] = sum_bc F_i[b, c] Q_i[a, b, c],
        # Q_i[a, b, c] = sum_d sum_j gradW_ij[d] R_j[a, b] V_j S_j[c, d]
        T = V[:, None, None] * S
        G = R[:, :, :, None, None] * T[:, None, None, :, :]            # (n, a, b, c, d)
        Q = -ar.spmm(wn_t, G.permute(4, 0, 1, 2, 3).reshape(3 * n, 27))
        term = ar.mul_sum(Q.reshape(n, 3, 9), F.reshape(n, 1, 9), -1)
    own = ar.mul_sum(M, st.svnw[:, None, :], -1)
    return 0.5 * V[:, None] * (term + own)


def total_force(pos, vel, f_el, ph: Physics):
    f = ph.external + f_el - ph.damping * vel
    if ph.collision:
        delta = (ph.collision_range - pos[:, 1]).clamp(min=0.0)
        fy = delta * delta * ph.collision_stiffness
        if ph.collision_damping:
            fy = fy - ph.collision_damping * delta * vel[:, 1]
        f = f + torch.stack([torch.zeros_like(fy), fy, torch.zeros_like(fy)], 1)
    return f


def step(state, scale, st: Statics, ph: Physics, ar: Arith):
    """One step: (pos, vel, f_el) -> the next."""
    pos, vel, f_el = state
    m = ph.mass[:, None]
    dt = ph.dt
    if ph.integrator == "trapezoidal":
        f1 = total_force(pos, vel, f_el, ph)
        pos_n = pos + (dt * vel + 0.5 * dt * dt * f1 / m) * ph.free
        f_el_n = elastic_forces(pos_n, scale, st, ph, ar)
        f2 = total_force(pos_n, vel, f_el_n, ph)
        return pos_n, vel + dt * (f1 + f2) / (2.0 * m) * ph.free, f_el_n
    f_el_n = elastic_forces(pos, scale, st, ph, ar)
    vel_n = vel + dt * total_force(pos, vel, f_el_n, ph) / m * ph.free
    return pos + dt * vel_n * ph.free, vel_n, f_el_n


def initial_state(rest, scale, st: Statics, ph: Physics, ar: Arith):
    vel = ph.v0.expand_as(rest).contiguous()
    if ph.integrator == "trapezoidal":
        return rest, vel, elastic_forces(rest, scale, st, ph, ar)
    return rest, vel, torch.zeros_like(rest)


def frame_index(frame: int, n_steps: int, n_targets: int, final: bool):
    """The target index that frame ``frame`` (1-based) is scored against,
    or None."""
    if final:
        return n_targets - 1 if frame == n_steps else None
    interval = max(n_steps // n_targets, 1)
    if frame % interval == 0 and frame // interval <= n_targets:
        return min(max(frame // interval - 1, 0), n_targets - 1)
    return None


def frame_loss(state, tp, tv, ph: Physics, dtype=None):
    """|p - p*|^2 + w |v - v*|^2, w = dt (sampled) or 1 (final), summed in
    ``dtype`` (the state's when None)."""
    dp = (state[0] - tp).to(dtype or tp.dtype)
    dv = (state[1] - tv).to(dtype or tp.dtype)
    w = 1.0 if ph.loss_final else ph.dt
    return (dp * dp).sum() + w * (dv * dv).sum()


def forward(x, rest, st: Statics, ph: Physics, n_steps: int, ar: Arith,
            record_every: int = 0):
    """The episode without gradients: (final state, [positions], [velocities]
    every ``record_every`` steps)."""
    rec_p, rec_v = [], []
    with torch.no_grad():
        scale = stiffness(x, ph)
        state = initial_state(rest, scale, st, ph, ar)
        for k in range(n_steps):
            state = step(state, scale, st, ph, ar)
            if record_every and (k + 1) % record_every == 0:
                rec_p.append(state[0])
                rec_v.append(state[1])
    return state, rec_p, rec_v


def value_and_grad(x, rest, tp, tv, st: Statics, ph: Physics, n_steps: int,
                   ar: Arith):
    """(loss as a float64 host number, dloss/dx) of the episode against
    targets tp / tv (n_targets, n, 3): a forward pass keeping every state,
    then each step again under autograd, last first."""
    x = x.detach()
    n_targets = tp.shape[0]
    keep_f = ph.integrator == "trapezoidal"   # the symplectic step ignores f_el
    states, loss = [], 0.0
    with torch.no_grad():
        scale = stiffness(x, ph)
        state = initial_state(rest, scale, st, ph, ar)
        zero = torch.zeros_like(rest)
        for k in range(n_steps):
            states.append(state if keep_f else (state[0], state[1], zero))
            state = step(state, scale, st, ph, ar)
            t = frame_index(k + 1, n_steps, n_targets, ph.loss_final)
            if t is not None:
                loss += float(frame_loss(state, tp[t], tv[t], ph, torch.float64))
    cot = [torch.zeros_like(a) for a in state]
    grad = torch.zeros_like(x)
    for k in reversed(range(n_steps)):
        leaves = [a.detach().requires_grad_() for a in states[k]]
        states[k] = None
        xl = x.detach().requires_grad_()
        with torch.enable_grad():
            out = step(leaves, stiffness(xl, ph), st, ph, ar)
            outs, cots = list(out), list(cot)
            t = frame_index(k + 1, n_steps, n_targets, ph.loss_final)
            if t is not None:
                outs.append(frame_loss(out, tp[t], tv[t], ph))
                cots.append(torch.ones((), dtype=x.dtype, device=x.device))
            pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
            g = torch.autograd.grad([o for o, _ in pairs], leaves + [xl],
                                    [c for _, c in pairs], allow_unused=True)
        cot = [torch.zeros_like(a) if d is None else d for a, d in zip(leaves, g[:3])]
        if g[3] is not None:
            grad = grad + g[3]
    if ph.integrator == "trapezoidal":       # the first force evaluation sees x
        xl = x.detach().requires_grad_()
        with torch.enable_grad():
            s0 = initial_state(rest, stiffness(xl, ph), st, ph, ar)
            (d,) = torch.autograd.grad(s0[2], xl, cot[2])
        grad = grad + d
    return loss, grad
