"""Gather-backend scene assembly and the material setters (counterpart of
``softbody_tpu/sim/scene.py``).

``build_scene`` folds the reference's import-time setup (asset, material
setters set_youngs_modulus / set_poisson_ratio / set_mass, density and
volume, the one-time neighbour build; sim.py:41-127, 288-308) into one host
builder whose output is a :class:`~softbody_tpu_torch.core.types.Scene`
with a ``Topology`` and no slot layout: its particle axis is the particles.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, resolve_device, torch_dtype
from ..core.types import Materials, Scene
from ..topology.neighbors import build_topology, topology_to_torch


def lame_parameters(E, nu):
    """Young's modulus / Poisson ratio -> (mu, lambda) (sim.py:288-300)."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def build_scene(
    points: np.ndarray,
    cfg: SimConfig,
    out_num: int | None = None,
    mass: float | np.ndarray | None = None,
    youngs_modulus: float | np.ndarray | None = None,
    poisson_ratio: float | np.ndarray | None = None,
    dirichlet_mask: np.ndarray | None = None,
    external_force: np.ndarray | None = None,
    obstacles=None,
    device=None,
) -> Scene:
    """A gather-backend Scene.  Inputs are host numpy; scalars broadcast
    per particle (the reference's all-particle setters, sim.py:302-308).
    The tables are built in f64 on the host, then every array moves to
    ``device`` in ``cfg.dtype`` (``obstacles`` too).  ``device=None`` means
    CUDA, and raises when there is none."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg)
    rest = np.asarray(points, dtype=np.float64)
    n = rest.shape[0]

    def per_particle(value, default):
        return np.broadcast_to(np.asarray(default if value is None else value,
                                          np.float64), (n,))

    m = per_particle(mass, cfg.mass)
    mu, lam = lame_parameters(per_particle(youngs_modulus, cfg.youngs_modulus),
                              per_particle(poisson_ratio, cfg.poisson_ratio))
    topo_np, _rho, volume = build_topology(rest, m, cfg)
    free = (np.ones((n, 3)) if dirichlet_mask is None
            else np.asarray(dirichlet_mask, np.float64))
    ext = (np.tile(np.asarray(cfg.external_force, np.float64), (n, 1))
           if external_force is None else np.asarray(external_force, np.float64))

    def dev(a):
        return torch.from_numpy(np.array(a, np.float64)).to(device=device, dtype=dtype)

    return Scene(
        rest_position=dev(rest),
        materials=Materials(mass=dev(m), volume=dev(volume), mu=dev(mu),
                            lam=dev(lam), free=dev(free), external=dev(ext)),
        out_num=int(out_num if out_num is not None else n),
        obstacles=None if obstacles is None else obstacles.to(device),
        topology=topology_to_torch(topo_np, dtype, device),
    )


def update_materials(
    scene: Scene,
    cfg: SimConfig,
    youngs_modulus=None,
    poisson_ratio=None,
    mass=None,
    dirichlet=None,
    external_force=None,
    index=None,
) -> Scene:
    """Setter-style material updates (set_youngs_modulus / set_poisson_ratio
    / set_mass / set_dirichlet / set_external_force, sim.py:279-308).

    Values apply to all particles, or to ``index`` when given (the
    reference's per-index variants, sim_taichi.py:241-288).  (E, nu) are
    recovered from the current (mu, lam), so either can change alone.  A
    mass update re-runs the density and volume computation (sim.py:308) by
    rebuilding the topology tables, on gather scenes only.  Returns a new
    Scene."""
    m = scene.materials
    device, dtype = scene.device, scene.dtype

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    def dev(a):
        return torch.from_numpy(np.asarray(a, np.float64)).to(device=device, dtype=dtype)

    def place(current, value):
        arr = np.array(current, np.float64)
        if index is None:
            arr[:] = np.asarray(value, np.float64)
        else:
            arr[np.asarray(index)] = np.asarray(value, np.float64)
        return arr

    mu_cur, lam_cur = host(m.mu), host(m.lam)
    with np.errstate(divide="ignore", invalid="ignore"):
        nu_cur = np.nan_to_num(lam_cur / (2.0 * (lam_cur + mu_cur)),
                               nan=cfg.poisson_ratio)
        E_cur = 2.0 * mu_cur * (1.0 + nu_cur)
    E = place(E_cur, youngs_modulus) if youngs_modulus is not None else E_cur
    nu = place(nu_cur, poisson_ratio) if poisson_ratio is not None else nu_cur
    mu_new, lam_new = lame_parameters(E, nu)
    mats = m._replace(mu=dev(mu_new), lam=dev(lam_new))
    if dirichlet is not None:
        mats = mats._replace(free=dev(place(host(m.free), dirichlet)))
    if external_force is not None:
        mats = mats._replace(external=dev(place(host(m.external), external_force)))
    scene = scene._replace(materials=mats)
    if mass is not None:
        if scene.topology is None:
            raise NotImplementedError(
                "mass updates on slot scenes: rebuild with build_sparse_scene "
                "or build_blocked_scene")
        mass_arr = place(host(m.mass), mass)
        topo_np, _rho, volume = build_topology(host(scene.rest_position),
                                               mass_arr, cfg)
        scene = scene._replace(
            materials=scene.materials._replace(mass=dev(mass_arr),
                                               volume=dev(volume)),
            topology=topology_to_torch(topo_np, dtype, device))
    return scene
