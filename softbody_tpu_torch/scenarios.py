"""Named scenarios (numpy): the port's own copy of ``softbody_tpu/scenarios.py``.

"stretch" is the flagship inverse-design scenario: the Taichi reference's own
setup (sim_taichi.py:329-334) — clamp the top 15% of the body, load the rest,
let it stretch — symplectic at dt=1e-5, no contact.  "drop" is the Warp
reference's workload (body dropped onto the ground plane) at the same
CFL-consistent constants, with the Kelvin-Voigt contact damper.  The constants
and their stability history are documented at the JAX counterpart.
"""

from __future__ import annotations

import numpy as np

from .geometry.shapes import inflatable_sphere

DROP = dict(dt=1e-5, youngs_modulus=1e3, collision=True,
            collision_stiffness=2e4, collision_damping=50.0,
            integrator="symplectic", damping=2e-4,
            initial_velocity=(0.0, -0.25, 0.0),
            external_force=(0.0, -2e-4, 0.0))

# Particle count the DROP constants were validated at (fit_body(20000)).
DROP_REF_N = 21441

STRETCH = dict(dt=1e-5, youngs_modulus=1e3, collision=False,
               integrator="symplectic", damping=2e-4,
               initial_velocity=(0.0, 0.0, 0.0),
               external_force=(0.0, -2.4e-3, 0.0))

SCENARIOS = {"drop": DROP, "stretch": STRETCH}


def scale_mass_for_resolution(cfg, n: int, scenario="drop"):
    """Drop scenario: hold BODY mass constant across resolutions (per-particle
    mass 1e-4 * DROP_REF_N / n, external force scaled alike), so density and
    every wave speed match the validated 20k body.  Other scenarios: no-op."""
    if scenario != "drop":
        return cfg
    m = 1e-4 * DROP_REF_N / n
    fx, fy, fz = cfg.external_force
    scale = m / 1e-4
    return cfg.replace(mass=m,
                       external_force=(fx * scale, fy * scale, fz * scale))


def drop_gap(pts: np.ndarray, scenario, gap: float = 0.002) -> np.ndarray:
    """'drop': shift the body so its lowest particle sits ``gap`` above the
    ground plane (y = 0).  Other scenarios: no-op."""
    if scenario != "drop":
        return pts
    return pts - np.array([0.0, float(pts[:, 1].min()) - gap, 0.0])


def dirichlet_mask(pts: np.ndarray, scenario) -> np.ndarray | None:
    """'stretch' clamps the top 15% of the body (the Taichi reference's
    z>0.85 clamp, mapped to the +y-up body).  Other scenarios: None."""
    if scenario != "stretch":
        return None
    mask = np.ones((len(pts), 3))
    mask[pts[:, 1] > np.quantile(pts[:, 1], 0.85)] = 0.0
    return mask


def fit_body(n_particles: int, radius: float = 0.05):
    """Procedural inflatable body sized to ~n_particles."""
    probe, _ = inflatable_sphere(n_outer=1000, radius=radius)
    a = (len(probe) - 1000) / 1000**1.5
    n_outer = 1000
    for _ in range(40):
        n_outer = max((max(n_particles - n_outer, 8.0) / a) ** (2 / 3), 8.0)
    return inflatable_sphere(n_outer=max(int(n_outer), 8), radius=radius)


def x_star_bands(pts: np.ndarray, n_slots: int, sop) -> np.ndarray:
    """Ground-truth inflation field: 1.5 radial bands in [-1, 1], slot space."""
    r = np.linalg.norm(pts - pts.mean(0), axis=1)
    xp = np.sin(r / r.max() * 3.0 * np.pi)
    x = np.zeros(n_slots)
    x[sop] = xp
    return x
