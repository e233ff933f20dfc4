"""Differentiable episode runner (counterpart of ``softbody_tpu/sim/rollout.py``).

The JAX ``lax.scan`` becomes a plain Python loop over steps; the loss
sampling follows ``_episode_body`` exactly: at frame f (1-based) the target
index is clip(f // interval - 1, 0, n_targets - 1), and the term is added to
a Neumaier (hi, lo) accumulator when f % interval == 0 and
f // interval <= n_targets (or only at the last frame for ``loss_mode
"final"``).  The JAX body adds ``where(hit, term, 0)`` every step; adding 0
leaves (hi, lo) unchanged, so the loop evaluates the term on hit frames only.

Gradients.  With ``cfg.remat`` each step runs under
``torch.utils.checkpoint`` (``use_reentrant=False``) whenever autograd is
recording, as ``jax.checkpoint`` wraps the JAX step: the backward recomputes
each step's internals from its (pos, vel, f_el) input.  Every gradient
entry point (:func:`value_and_grad_fn`, :func:`episode_value_and_grad_chunked`)
goes through one mechanism, :func:`_value_and_grad`: a no-grad forward that
keeps the state at each chunk boundary, then per chunk in reverse a
recompute under autograd and ``torch.autograd.grad`` seeded with the next
chunk's state cotangent and 1 on the chunk loss's ``hi`` term (the ``lo``
compensation is a rounding residual, not part of the loss).  The losses of
the chunks are added on the host in f64.  ``value_and_grad_fn`` cuts the
episode as ``cfg.remat_chunk`` says (sqrt-nested remat: chunks of c steps
and a tail; one chunk for linear remat), so peak memory holds O(T/c)
boundary states plus one chunk's per-step inputs.

Contact overflow.  With ``cfg.contact_check`` and a contact grid on the
scene, every step ORs the grid's overflow flag into a device-side
:class:`ContactCheck`; the runners read it on the host once per episode
(:func:`rollout`) or per chunk (the no-grad forward of
:func:`_value_and_grad`, :func:`forward_chunked`) and warn once per
process, so no step waits for the device.
"""

from __future__ import annotations

import warnings

import torch
from torch.utils.checkpoint import checkpoint

from ..config import SimConfig, resolve_device
from ..core.types import Blocked, Materials, ParticleState, Scene
from ..ops.collision import ground_penalty
from ..ops.contact import contact_forces
from ..ops.elasticity import compute_ratio
from ..ops.elasticity import elastic_forces as gather_elastic_forces
from ..ops.obstacles import penalty_force
from ..ops.pair_kernels import KERNELS, PairOps
from .blocked import elastic_forces_blocked, elastic_forces_pallas


def elastic_forces(pos, ratio, scene: Scene, cfg: SimConfig,
                   pair_ops: PairOps = KERNELS):
    """Backend dispatch of the elastic-force evaluation
    (``softbody_tpu/sim/rollout.py:29-42``): ``"gather"`` runs the (N, K)
    table forces of ``ops/elasticity`` on a ``build_scene`` scene,
    ``"pallas"`` the pair kernels on a sparse or a blocked scene,
    ``"blocked"`` the plain torch reference on a blocked scene (``pair_ops``
    unused but by ``"pallas"``)."""
    if cfg.backend == "pallas":
        return elastic_forces_pallas(pos, ratio, scene.materials, scene, cfg,
                                     pair_ops)
    if cfg.backend == "blocked":
        if not isinstance(scene.blocked, Blocked):
            raise ValueError('backend="blocked" needs a scene from build_blocked_scene')
        return elastic_forces_blocked(pos, ratio, scene.materials, scene, cfg)
    if cfg.backend == "gather":
        if scene.topology is None:
            raise ValueError('backend="gather" needs a scene from build_scene')
        return gather_elastic_forces(pos, ratio, scene.materials, scene.topology,
                                     cfg)[0]
    raise ValueError(f"unknown backend {cfg.backend!r}")


class ContactCheck:
    """The contact-overflow flag of one episode or chunk, kept on the device
    (``cfg.contact_check``): each step ORs in its flag, and the runner reads
    it on the host once, with :meth:`report`, so no step waits for the
    device."""

    def __init__(self, cap: int):
        self.cap = cap
        self.flag = None

    def add(self, overflow: torch.Tensor):
        self.flag = overflow if self.flag is None else self.flag | overflow

    def report(self):
        """Warn (once per process) when any step of the run overflowed."""
        if self.flag is not None and bool(self.flag):
            _warn_contact_overflow(self.cap)


def _warn_contact_overflow(cap: int):
    """An overfull contact cell means candidates were DROPPED (the cap
    contract of ``ops/contact.py``): warn once per process instead of
    letting the episode go on silently with incomplete forces."""
    global _overflow_warned
    if not _overflow_warned:
        _overflow_warned = True
        warnings.warn(
            f"dynamic contact cell occupancy exceeded cap={cap}: candidates "
            "were dropped and contact forces are incomplete; rebuild the "
            "contact grid with a larger cap or smaller cell_scale",
            RuntimeWarning, stacklevel=3)


_overflow_warned = False


def contact_check(scene: Scene, cfg: SimConfig) -> ContactCheck | None:
    """A fresh :class:`ContactCheck` when the scene's contact is checked."""
    if scene.contact is None or not cfg.contact_check:
        return None
    return ContactCheck(scene.contact.cap)


def _report(check: ContactCheck | None):
    if check is not None:
        check.report()


def total_force(pos, vel, f_el, mats: Materials, cfg: SimConfig,
                scene: Scene = None, check: ContactCheck | None = None):
    """external + elastic - damping*v + ground collision (part_1/part_2,
    sim.py:246-258), plus the scene's obstacle penalty (``ops/obstacles``)
    and dynamic contact (``ops/contact``) when it has them.  With ``check``
    the contact's overflow flag is added to it (read later, on the host)."""
    f = mats.external + f_el - cfg.damping * vel
    if cfg.collision:
        f = f + ground_penalty(pos, cfg, vel)
    if scene is not None and scene.obstacles is not None:
        f = f + penalty_force(scene.obstacles, pos)
    if scene is not None and scene.contact is not None:
        if check is not None:
            f_c, overflow = contact_forces(pos, scene.contact, with_overflow=True)
            check.add(overflow)
        else:
            f_c = contact_forces(pos, scene.contact)
        f = f + f_c
    return f


def step(state: ParticleState, ratio, scene: Scene, cfg: SimConfig,
         pair_ops: PairOps = KERNELS, check: ContactCheck | None = None
         ) -> ParticleState:
    """One physics step.

    trapezoidal (Warp, sim.py:246-258): part_1 advances positions with the
    carried forces, forces are recomputed at the new positions, part_2
    averages.  symplectic (Taichi, sim_taichi.py:167-172): forces at the
    current state, then semi-implicit Euler.  ``check`` collects the
    contact-overflow flag (:class:`ContactCheck`)."""
    mats = scene.materials
    dt = cfg.dt
    m = mats.mass[:, None]
    pos, vel, f_el = state

    def el(p):
        return elastic_forces(p, ratio, scene, cfg, pair_ops)

    if cfg.integrator == "trapezoidal":
        force1 = total_force(pos, vel, f_el, mats, cfg, scene, check)
        pos_n = pos + (dt * vel + 0.5 * dt * dt * force1 / m) * mats.free
        f_el_n = el(pos_n)
        # the velocity-damping term reuses v_t in both halves (sim.py:256-257)
        force2 = total_force(pos_n, vel, f_el_n, mats, cfg, scene, check)
        vel_n = vel + dt * (force1 + force2) / (2.0 * m) * mats.free
        return ParticleState(pos_n, vel_n, f_el_n)

    f_el_now = el(pos)
    force = total_force(pos, vel, f_el_now, mats, cfg, scene, check)
    vel_n = vel + dt * force / m * mats.free
    pos_n = pos + dt * vel_n * mats.free
    return ParticleState(pos_n, vel_n, f_el_now)


def initial_state(scene: Scene, ratio, cfg: SimConfig,
                  pair_ops: PairOps = KERNELS) -> ParticleState:
    """startup kernel + initial force evaluation (sim.py:342,349-351,261-266)."""
    pos = scene.rest_position
    vel = torch.tensor(cfg.initial_velocity, dtype=pos.dtype,
                       device=pos.device).expand_as(pos).contiguous()
    if cfg.integrator == "trapezoidal":
        f_el = elastic_forces(pos, ratio, scene, cfg, pair_ops)
    else:
        f_el = torch.zeros_like(pos)
    return ParticleState(pos, vel, f_el)


def frame_loss(state: ParticleState, tp, tv, cfg: SimConfig):
    """Per-frame loss term |p - p*|^2 + dt |v - v*|^2 (sim.py:269-273); the
    "final" (Taichi) variant drops the dt weight (sim_taichi.py:210-214)."""
    dp = state.position - tp
    dv = state.velocity - tv
    w = cfg.dt if cfg.loss_mode == "sampled" else 1.0
    return torch.sum(dp * dp) + w * torch.sum(dv * dv)


# ---- compensated loss accumulation -------------------------------------------
# The episode loss is a sum of ~100 f32 frame terms; a naive f32 sum has a
# quantum of ~4e-6 at loss ~46, below which scipy's L-BFGS-B line search sees
# bit-identical f.  A Neumaier two-float carry keeps the rounding residual.

def acc_init(dtype, device):
    z = torch.zeros((), dtype=dtype, device=device)
    return (z, z)


def acc_add(acc, term):
    hi, lo = acc
    t = hi + term
    lo = lo + torch.where(torch.abs(hi) >= torch.abs(term),
                          (hi - t) + term, (term - t) + hi)
    return (t, lo)


def acc_scalar(acc):
    """Collapse the (hi, lo) pair to a device scalar (plain dtype resolution)."""
    return acc[0] + acc[1]


def acc_float(acc) -> float:
    """Collapse the (hi, lo) pair on the host in f64 — full compensated
    precision."""
    return float(acc[0]) + float(acc[1])


def _step_fn(scene: Scene, cfg: SimConfig, pair_ops: PairOps,
             check: ContactCheck | None = None):
    """``step`` as the episode runs it: under a per-step checkpoint when
    ``cfg.remat`` is set and autograd is recording."""

    def plain(state, ratio):
        return step(state, ratio, scene, cfg, pair_ops, check)

    if not cfg.remat:
        return plain

    def fn(pos, vel, f_el, ratio):
        return tuple(plain(ParticleState(pos, vel, f_el), ratio))

    def remat(state, ratio):
        if not torch.is_grad_enabled():
            return plain(state, ratio)
        return ParticleState(*checkpoint(fn, *state, ratio, use_reentrant=False,
                                         preserve_rng_state=False))

    return remat


def _run_steps(state, acc, ratio, step_fn, k0: int, length: int, tp, tv,
               cfg: SimConfig, n_steps: int, on_frame=None):
    """``length`` steps from global step ``k0`` (the JAX ``_episode_body``),
    adding each sampled frame's loss term to ``acc`` when targets are given.
    ``on_frame(frame, state)`` runs after every step."""
    n_targets = 1 if tp is None else tp.shape[0]
    interval = max(n_steps // n_targets, 1)
    for f in range(k0, k0 + length):
        state = step_fn(state, ratio)
        frame = f + 1
        if tp is not None:
            if cfg.loss_mode == "final":
                hit = frame == n_steps
            else:
                hit = frame % interval == 0 and frame // interval <= n_targets
            if hit:
                t_idx = min(max(frame // interval - 1, 0), n_targets - 1)
                acc = acc_add(acc, frame_loss(state, tp[t_idx], tv[t_idx], cfg))
        if on_frame is not None:
            on_frame(frame, state)
    return state, acc


def _to_scene(scene: Scene, a):
    return torch.as_tensor(a).to(device=scene.device, dtype=scene.dtype)


def rollout(x, scene: Scene, cfg: SimConfig, target_p=None, target_v=None,
            n_steps=None, record_every: int | None = None, acc_pair=False,
            device=None, pair_ops: PairOps = KERNELS):
    """Run an episode.  Differentiable wrt ``x`` (per-step checkpoint under
    ``cfg.remat``).

    Returns (loss, final_state, recorded): ``recorded`` is (positions,
    velocities) stacked every ``record_every`` steps, (n_rec, n_slots, 3)
    each, or None.  Without targets the loss is 0.  ``acc_pair=True``
    returns the loss as the Neumaier (hi, lo) pair instead of a collapsed
    scalar.  ``device=None`` means CUDA (raises when there is none); the
    scene must live on the device the episode runs on."""
    device = resolve_device(device)
    if scene.device != device:
        raise ValueError(f"the scene lives on {scene.device}, the episode "
                         f"was asked to run on {device}")
    n_steps = cfg.frames if n_steps is None else n_steps
    x = _to_scene(scene, x)
    ratio = compute_ratio(x, cfg)
    state = initial_state(scene, ratio, cfg, pair_ops)
    if target_p is not None:
        target_p = _to_scene(scene, target_p)
        target_v = _to_scene(scene, target_v)
    if record_every and n_steps % record_every:
        raise ValueError(f"n_steps={n_steps} is not a multiple of "
                         f"record_every={record_every}")
    rec_p, rec_v = [], []

    def record(frame, st):
        if record_every and frame % record_every == 0:
            rec_p.append(st.position)
            rec_v.append(st.velocity)

    check = contact_check(scene, cfg)
    state, acc = _run_steps(state, acc_init(scene.dtype, device), ratio,
                            _step_fn(scene, cfg, pair_ops, check), 0, n_steps,
                            target_p, target_v, cfg, n_steps, record)
    _report(check)
    recorded = (torch.stack(rec_p), torch.stack(rec_v)) if record_every else None
    return (acc if acc_pair else acc_scalar(acc)), state, recorded


def _chunk_primal(state, x, k0: int, tp, tv, scene: Scene, cfg: SimConfig,
                  length: int, n_steps: int, pair_ops: PairOps = KERNELS,
                  check: ContactCheck | None = None):
    """One episode chunk: ``length`` steps from global step ``k0``.  Returns
    (state_out, chunk loss (hi, lo) pair).  Differentiable wrt (state, x)."""
    ratio = compute_ratio(x, cfg)
    return _run_steps(state, acc_init(scene.dtype, scene.device), ratio,
                      _step_fn(scene, cfg, pair_ops, check), k0, length, tp, tv,
                      cfg, n_steps)


def _grad_of(outputs, cotangents, inputs):
    """``torch.autograd.grad`` over the outputs that depend on the inputs;
    an input nothing depends on gets a zero gradient."""
    pairs = [(o, c) for o, c in zip(outputs, cotangents) if o.requires_grad]
    if not pairs:
        return [torch.zeros_like(i) for i in inputs]
    grads = torch.autograd.grad([o for o, _ in pairs], inputs,
                                [c for _, c in pairs], allow_unused=True)
    return [torch.zeros_like(i) if g is None else g
            for g, i in zip(grads, inputs)]


def _value_and_grad(x, tp, tv, scene: Scene, cfg: SimConfig, sizes,
                    n_steps: int, pair_ops: PairOps):
    """(loss as a host f64 float, dloss/dx) of an episode cut into chunks of
    ``sizes`` steps (see the module docstring)."""
    x = _to_scene(scene, x).detach()
    tp, tv = _to_scene(scene, tp), _to_scene(scene, tv)
    k0s = [sum(sizes[:i]) for i in range(len(sizes))]
    with torch.no_grad():
        state = initial_state(scene, compute_ratio(x, cfg), cfg, pair_ops)
        states, loss = [], 0.0       # host f64 keeps the compensated precision
        for k0, length in zip(k0s, sizes):
            states.append(state)
            check = contact_check(scene, cfg)
            state, acc = _chunk_primal(state, x, k0, tp, tv, scene, cfg,
                                       length, n_steps, pair_ops, check)
            _report(check)
            loss = loss + acc_float(acc)
    cot = [torch.zeros_like(t) for t in state]
    grad = torch.zeros_like(x)
    for k0, length, s_in in reversed(list(zip(k0s, sizes, states))):
        leaves = [t.detach().requires_grad_() for t in s_in]
        x_leaf = x.detach().requires_grad_()
        with torch.enable_grad():
            out, (hi, _) = _chunk_primal(ParticleState(*leaves), x_leaf, k0,
                                         tp, tv, scene, cfg, length, n_steps,
                                         pair_ops)
            *cot, dx = _grad_of(list(out) + [hi], cot + [torch.ones_like(hi)],
                                leaves + [x_leaf])
        grad = grad + dx
    x_leaf = x.detach().requires_grad_()
    with torch.enable_grad():
        state0 = initial_state(scene, compute_ratio(x_leaf, cfg), cfg, pair_ops)
        (dx,) = _grad_of(list(state0), cot, [x_leaf])
    return loss, grad + dx


def episode_value_and_grad_chunked(scene: Scene, cfg: SimConfig,
                                   n_chunks: int, n_steps=None,
                                   pair_ops: PairOps = KERNELS):
    """The episode's (loss, dloss/dx) in ``n_chunks`` chunks of near-equal
    length (the first n_steps % n_chunks one step longer), each recomputed
    and differentiated on its own; only the chunk-boundary states are kept.
    Mathematically ``value_and_grad_fn``; the loss is a host f64 float.
    Returns ``f(x, target_p, target_v) -> (loss, grad)``."""
    n_steps = cfg.frames if n_steps is None else n_steps
    n_chunks = max(1, min(int(n_chunks), n_steps))
    base = n_steps // n_chunks
    sizes = [base + (1 if i < n_steps % n_chunks else 0) for i in range(n_chunks)]

    def f(x, target_p, target_v):
        return _value_and_grad(x, target_p, target_v, scene, cfg, sizes,
                               n_steps, pair_ops)

    return f


def forward_chunked(x, scene: Scene, cfg: SimConfig, n_steps, chunk_len,
                    record_every=None):
    """Forward episode in chunks of ``chunk_len`` steps, without autograd.
    Returns (final_state, the positions at every ``record_every`` boundary
    and at the end; record_every must be a chunk_len multiple)."""
    n_steps = cfg.frames if n_steps is None else n_steps
    chunk_len = max(1, min(int(chunk_len), n_steps))
    if record_every and record_every % chunk_len:
        raise ValueError(f"record_every={record_every} is not a multiple of "
                         f"chunk_len={chunk_len}")
    x = _to_scene(scene, x)
    recorded = []
    with torch.no_grad():
        ratio = compute_ratio(x, cfg)
        state = initial_state(scene, ratio, cfg)
        done = 0
        while done < n_steps:
            length = min(chunk_len, n_steps - done)
            check = contact_check(scene, cfg)
            state, _ = _run_steps(state, None, ratio,
                                  _step_fn(scene, cfg, KERNELS, check), done,
                                  length, None, None, cfg, n_steps)
            _report(check)
            done += length
            if record_every and (done % record_every == 0 or done == n_steps):
                recorded.append(state.position)
    return state, recorded


def _remat_chunk(cfg: SimConfig, n_steps: int) -> int:
    """Resolve cfg.remat_chunk: 0 = linear remat, >0 = explicit chunk length,
    -1 = auto (~sqrt(T) once the episode is long enough for the linear-remat
    residuals to threaten device memory)."""
    if not cfg.remat or cfg.remat_chunk == 0:
        return 0
    if cfg.remat_chunk > 0:
        return min(cfg.remat_chunk, n_steps)
    return round(n_steps ** 0.5) if n_steps >= 2048 else 0


def loss_fn(x, scene: Scene, cfg: SimConfig, target_p, target_v, n_steps=None):
    """Scalar episode loss — the quantity L-BFGS minimizes (sim.py:379-396).
    Runs on the scene's device."""
    loss, _, _ = rollout(x, scene, cfg, target_p, target_v, n_steps=n_steps,
                         device=scene.device)
    return loss


def value_and_grad_fn(scene: Scene, cfg: SimConfig, n_steps=None,
                      pair_ops: PairOps = KERNELS):
    """(loss, dloss/dx) closure — replaces diff_sim + tape.backward
    (sim.py:341-372).  The loss is a host float combining the compensated
    (hi, lo) accumulators in f64; the episode is cut as ``cfg.remat_chunk``
    says (see :func:`_remat_chunk`)."""
    n_steps = cfg.frames if n_steps is None else n_steps
    c = _remat_chunk(cfg, n_steps)
    sizes = [c] * (n_steps // c) if c else []
    if n_steps - sum(sizes):
        sizes.append(n_steps - sum(sizes))

    def g(x, target_p, target_v):
        return _value_and_grad(x, target_p, target_v, scene, cfg, sizes,
                               n_steps, pair_ops)

    return g
