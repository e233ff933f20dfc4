"""Ground-plane collision penalty (counterpart of ``softbody_tpu/ops/collision.py``;
the SDF obstacle penalty is not ported)."""

from __future__ import annotations

import torch

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
