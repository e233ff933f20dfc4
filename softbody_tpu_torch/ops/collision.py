"""Collision penalties (counterpart of ``softbody_tpu/ops/collision.py``):
the ground plane (sim.py:238-244) and the penalty of any differentiable
signed-distance function, which the reference lacks."""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..config import SimConfig


def ground_penalty(pos: torch.Tensor, cfg: SimConfig, vel=None) -> torch.Tensor:
    """Quadratic penalty pushing +y when y < collision_range (sim.py:238-244).

    With ``cfg.collision_damping > 0`` and ``vel`` given, a Kelvin-Voigt
    normal damper ``-c * delta * v_y`` acts inside the contact zone (smooth:
    the delta factor vanishes at the contact boundary)."""
    delta = torch.clamp(cfg.collision_range - pos[..., 1], min=0.0)
    fy = delta * delta * cfg.collision_stiffness
    if vel is not None and cfg.collision_damping:
        fy = fy - cfg.collision_damping * delta * vel[..., 1]
    out = torch.zeros_like(pos)
    out[..., 1] = fy
    return out


def _own_saved_tensors():
    """Keep the saved tensors of the short-lived graphs below in memory:
    inside a ``torch.utils.checkpoint`` region the checkpoint's own hooks
    would stand in for them, and unpacking one there (as the inner
    ``autograd.grad`` does) would recompute the whole checkpointed step."""
    return torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t)


def _penalty(p, sdf_fn, stiffness, margin, create_graph: bool):
    val = sdf_fn(p)
    (grad,) = torch.autograd.grad(val.sum(), p, create_graph=create_graph)
    n = grad / torch.clamp(torch.linalg.vector_norm(grad, dim=-1, keepdim=True),
                           min=1e-9)
    depth = torch.clamp(margin - val, min=0.0)
    return stiffness * (depth * depth)[:, None] * n


class _SDFPenalty(torch.autograd.Function):
    """The penalty as one autograd node: the forward takes the normal from
    autograd on a detached copy of the positions and keeps only the
    positions; the backward rebuilds the force with its graph
    (create_graph) and returns its VJP, which holds the SDF's second
    derivative.  Differentiable with respect to the positions only."""

    @staticmethod
    def forward(ctx, pos, sdf_fn, stiffness, margin):
        ctx.save_for_backward(pos)
        ctx.args = (sdf_fn, stiffness, margin)
        with torch.enable_grad(), _own_saved_tensors():
            return _penalty(pos.detach().requires_grad_(), sdf_fn, stiffness,
                            margin, create_graph=False).detach()

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        with torch.enable_grad(), _own_saved_tensors():
            p = pos.detach().requires_grad_()
            f = _penalty(p, *ctx.args, create_graph=True)
            (dp,) = torch.autograd.grad(f, p, g)
        return dp, None, None, None


def sdf_penalty(pos: torch.Tensor, sdf_fn, stiffness, margin=0.0) -> torch.Tensor:
    """Penalty force pushing out of an implicit obstacle:
    f = stiffness * max(margin - sdf, 0)^2 * normalize(grad sdf), with
    ``sdf_fn`` (N, 3) -> (N,) row-wise (negative inside).  The normal is
    autograd's; the force is differentiable with respect to ``pos`` (its
    VJP holds the SDF's second derivative), also under
    ``torch.utils.checkpoint``, and costs no graph under ``torch.no_grad()``."""
    return _SDFPenalty.apply(pos, sdf_fn, stiffness, margin)
