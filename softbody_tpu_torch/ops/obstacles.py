"""Implicit obstacles: analytic SDF primitives and DeepSDF shapes (counterpart
of ``softbody_tpu/ops/obstacles.py``).

The reference's only contact is the ground-plane penalty (sim.py:238-244).
An obstacle set adds the penalty

    f = stiffness * max(margin - sdf(p), 0)^2 * normalize(grad sdf)

for sphere, plane, box and DeepSDF obstacles (``ops/collision.sdf_penalty``).
The normal comes from autograd of the SDF, so the force works inside
``torch.no_grad()`` forwards, inside ``torch.utils.checkpoint`` recomputes
(without triggering one), and under the episode gradient, which then
differentiates the normal itself (the SDF's second derivative).

Primitive parameters are stored as f32, as the JAX package stores them, so
an f64 run sees the same obstacle in both packages.

One deliberate difference: JAX's box SDF takes ``norm(max(q, 0))``, whose
gradient at 0 — every point inside the box — is NaN there, so a particle
entering a box poisons the episode.  Here that norm is written so its
derivative at 0 is 0: inside a box the normal is the face normal of the
``min(max(q), 0)`` term, and the force is finite.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.deepsdf import DeepSDFParams, forward as deepsdf_forward
from .collision import sdf_penalty


@dataclasses.dataclass(frozen=True)
class Obstacles:
    """A set of implicit obstacles.

    kinds:  tuple of "sphere" | "plane" | "box" | "deepsdf"
    params: tuple of per-obstacle parameters:
      sphere:  (center (3,), radius ())
      plane:   (normal (3,), offset ())        sdf = n.p - offset
      box:     (center (3,), half (3,))
      deepsdf: (DeepSDFParams, scale (), offset (3,))
    """

    kinds: tuple
    params: tuple
    stiffness: float = 3e5
    margin: float = 1e-4

    def to(self, device) -> "Obstacles":
        """The same obstacles with every tensor on ``device``."""
        def move(p):
            if isinstance(p, torch.Tensor):
                return p.to(device)
            if isinstance(p, DeepSDFParams):
                return DeepSDFParams(*(tuple(t.to(device) for t in part) for part in p))
            return tuple(move(q) for q in p)

        return dataclasses.replace(self, params=tuple(move(p) for p in self.params))


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def sphere(center, radius):
    return ("sphere", (_f32(center), _f32(radius)))


def plane(normal, offset):
    n = np.asarray(normal, np.float32)
    n = n / np.sqrt(np.sum(n * n))        # normalized in f32, as JAX does
    return ("plane", (_f32(n), _f32(offset)))


def box(center, half):
    return ("box", (_f32(center), _f32(half)))


def deepsdf(params: DeepSDFParams, scale=1.0, offset=(0.0, 0.0, 0.0)):
    return ("deepsdf", (params, _f32(scale), _f32(offset)))


def make(*primitives, stiffness=3e5, margin=1e-4) -> Obstacles:
    return Obstacles(kinds=tuple(p[0] for p in primitives),
                     params=tuple(p[1] for p in primitives),
                     stiffness=stiffness, margin=margin)


def _norm0(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis, with derivative 0 (of every order) at v = 0."""
    s = torch.sum(v * v, dim=-1)
    pos = s > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, torch.ones_like(s))),
                       torch.zeros_like(s))


def _sdf_one(kind: str, param, pos: torch.Tensor) -> torch.Tensor:
    """Signed distance of (N, 3) positions to one obstacle (negative inside)."""
    if kind == "sphere":
        center, radius = param
        return torch.linalg.vector_norm(pos - center.to(pos), dim=-1) - radius.to(pos)
    if kind == "plane":
        normal, offset = param
        return pos @ normal.to(pos) - offset.to(pos)
    if kind == "box":
        center, half = param
        q = torch.abs(pos - center.to(pos)) - half.to(pos)
        outside = _norm0(torch.clamp(q, min=0.0))
        inside = torch.clamp(torch.max(q, dim=-1).values, max=0.0)
        return outside + inside
    if kind == "deepsdf":
        params, scale, offset = param
        scale = scale.to(pos)
        return deepsdf_forward(params, (pos - offset.to(pos)) / scale).squeeze(-1) * scale
    raise ValueError(kind)


def sdf(obstacles: Obstacles, pos: torch.Tensor) -> torch.Tensor:
    """min over obstacles of the signed distance; (N, 3) -> (N,)."""
    out = None
    for kind, param in zip(obstacles.kinds, obstacles.params):
        v = _sdf_one(kind, param, pos)
        out = v if out is None else torch.minimum(out, v)
    return out


def penalty_force(obstacles: Obstacles, pos: torch.Tensor) -> torch.Tensor:
    """Quadratic penalty pushing particles out of obstacles; (N, 3) -> (N, 3)."""
    return sdf_penalty(pos, lambda p: sdf(obstacles, p), obstacles.stiffness,
                       obstacles.margin)
