"""Forward episode runner (counterpart of ``softbody_tpu/sim/rollout.py``).

The JAX ``lax.scan`` becomes a plain Python loop over steps; the loss
sampling follows ``_episode_body`` exactly: at frame f (1-based) the target
index is clip(f // interval - 1, 0, n_targets - 1), and the term is added to
a Neumaier (hi, lo) accumulator when f % interval == 0 and
f // interval <= n_targets (or only at the last frame for ``loss_mode
"final"``).  The JAX body adds ``where(hit, term, 0)`` every step; adding 0
leaves (hi, lo) unchanged, so the loop evaluates the term on hit frames only.

Forward only: no checkpointing or remat (the gradient path is ROADMAP queue
1, item 4).
"""

from __future__ import annotations

import torch

from ..config import SimConfig, resolve_device
from ..core.types import Materials, ParticleState, Scene
from ..ops.collision import ground_penalty
from ..ops.elasticity import compute_ratio
from ..ops.pair_kernels import KERNELS, PairOps
from .sparse import elastic_forces_sparse


def total_force(pos, vel, f_el, mats: Materials, cfg: SimConfig,
                scene: Scene = None):
    """external + elastic - damping*v + collision (sim.py:246-258)."""
    if scene is not None and (scene.obstacles is not None
                              or scene.contact is not None):
        raise NotImplementedError(
            "obstacle and particle-contact forces are not ported yet: "
            "ROADMAP queue 1, item 7")
    f = mats.external + f_el - cfg.damping * vel
    if cfg.collision:
        f = f + ground_penalty(pos, cfg, vel)
    return f


def step(state: ParticleState, ratio, scene: Scene, cfg: SimConfig,
         pair_ops: PairOps = KERNELS) -> ParticleState:
    """One physics step.

    trapezoidal (Warp, sim.py:246-258): part_1 advances positions with the
    carried forces, forces are recomputed at the new positions, part_2
    averages.  symplectic (Taichi, sim_taichi.py:167-172): forces at the
    current state, then semi-implicit Euler."""
    mats = scene.materials
    dt = cfg.dt
    m = mats.mass[:, None]
    pos, vel, f_el = state

    def el(p):
        return elastic_forces_sparse(p, ratio, mats, scene, cfg, pair_ops)

    if cfg.integrator == "trapezoidal":
        force1 = total_force(pos, vel, f_el, mats, cfg, scene)
        pos_n = pos + (dt * vel + 0.5 * dt * dt * force1 / m) * mats.free
        f_el_n = el(pos_n)
        # the velocity-damping term reuses v_t in both halves (sim.py:256-257)
        force2 = total_force(pos_n, vel, f_el_n, mats, cfg, scene)
        vel_n = vel + dt * (force1 + force2) / (2.0 * m) * mats.free
        return ParticleState(pos_n, vel_n, f_el_n)

    f_el_now = el(pos)
    force = total_force(pos, vel, f_el_now, mats, cfg, scene)
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
        f_el = elastic_forces_sparse(pos, ratio, scene.materials, scene, cfg,
                                     pair_ops)
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


def rollout(x, scene: Scene, cfg: SimConfig, target_p=None, target_v=None,
            n_steps=None, record_every: int | None = None, acc_pair=False,
            device=None, pair_ops: PairOps = KERNELS):
    """Run an episode.

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
    dtype = scene.dtype
    x = torch.as_tensor(x).to(device=device, dtype=dtype)
    ratio = compute_ratio(x, cfg)
    state = initial_state(scene, ratio, cfg, pair_ops)

    have_targets = target_p is not None
    if have_targets:
        target_p = torch.as_tensor(target_p).to(device=device, dtype=dtype)
        target_v = torch.as_tensor(target_v).to(device=device, dtype=dtype)
        n_targets = target_p.shape[0]
    else:
        n_targets = 1
    interval = max(n_steps // n_targets, 1)
    if record_every and n_steps % record_every:
        raise ValueError(f"n_steps={n_steps} is not a multiple of "
                         f"record_every={record_every}")

    acc = acc_init(dtype, device)
    rec_p, rec_v = [], []
    for f in range(n_steps):
        state = step(state, ratio, scene, cfg, pair_ops)
        frame = f + 1
        if have_targets:
            if cfg.loss_mode == "final":
                hit = frame == n_steps
            else:
                hit = frame % interval == 0 and frame // interval <= n_targets
            if hit:
                t_idx = min(max(frame // interval - 1, 0), n_targets - 1)
                acc = acc_add(acc, frame_loss(state, target_p[t_idx],
                                              target_v[t_idx], cfg))
        if record_every and frame % record_every == 0:
            rec_p.append(state.position)
            rec_v.append(state.velocity)
    recorded = (torch.stack(rec_p), torch.stack(rec_v)) if record_every else None
    return (acc if acc_pair else acc_scalar(acc)), state, recorded
