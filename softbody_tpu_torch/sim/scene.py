"""Material helpers (counterpart of ``softbody_tpu/sim/scene.py``; the
gather-backend scene builder there is not ported)."""

from __future__ import annotations


def lame_parameters(E, nu):
    """Young's modulus / Poisson ratio -> (mu, lambda) (sim.py:288-300)."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam
