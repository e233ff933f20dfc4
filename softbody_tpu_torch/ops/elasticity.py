"""Inflation parameterization (counterpart of ``softbody_tpu/ops/elasticity.py``;
the gather-backend forces there are not ported)."""

from __future__ import annotations

import torch

from ..config import SimConfig


def compute_ratio(x: torch.Tensor, cfg: SimConfig) -> torch.Tensor:
    """ratio = 0.5 tanh(gain * x) + 0.5 (sim.py:107-110)."""
    return 0.5 * torch.tanh(cfg.tanh_gain * x) + 0.5
