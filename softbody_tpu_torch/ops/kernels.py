"""SPH cubic-spline kernel W and its gradient, in torch (counterpart of
``softbody_tpu/ops/kernels.py``; math from the reference sim.py:133-151).
Branch-free: both pieces are evaluated and selected with ``where``."""

from __future__ import annotations

import math

import torch


def W(xij: torch.Tensor, h: float) -> torch.Tensor:
    """Cubic-spline kernel; xij: (..., 3) -> (...,)."""
    q = torch.linalg.vector_norm(xij, dim=-1) / h
    c = 1.0 / (math.pi * h**3)
    near = c * (1.0 - 1.5 * q**2 + 0.75 * q**3)
    far = 0.25 * c * (2.0 - q) ** 3
    return torch.where(q < 1.0, near, torch.where(q < 2.0, far, 0.0))


def nabla_W(xij: torch.Tensor, h: float) -> torch.Tensor:
    """Gradient of W wrt xij; xij: (..., 3) -> (..., 3)."""
    q = torch.linalg.vector_norm(xij, dim=-1, keepdim=True) / h
    c = 1.0 / (math.pi * h**3)
    near = c * (-3.0 * xij / h**2 + 2.25 * q * xij / h**2)
    q_safe = torch.where(q > 0, q, 1.0)
    far = 0.25 * c * (-3.0) * (2.0 - q) ** 2 * xij / (q_safe * h * h)
    return torch.where(q < 1.0, near, torch.where(q < 2.0, far, 0.0))
