"""PyTorch port: dynamic particle-particle contact (``ops/contact``) against
the JAX package and against the all-pairs law.

Tolerances, f64: forces 1e-10 of max |f| (plus 1e-12 absolute, as
``tests/test_contact.py``) against JAX's ``contact_forces`` and against
the O(N^2) law; their gradient 1e-10 relative to JAX's; contact episodes
and their gradient 1e-9 relative.  Out-of-grid particles stay inert, the
exclude table is honoured, the overflow flag rises on an overfull cell,
and an episode warns once per process, from a flag it reads once."""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import build_scene as jbuild_scene
from softbody_tpu import warp_parity
from softbody_tpu.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu.ops import contact as jct
from softbody_tpu.sim import rollout as jro
from softbody_tpu_torch.convert import contact_from_numpy
from softbody_tpu_torch.ops import contact as tct
from softbody_tpu_torch.sim import rollout as tro
from softbody_tpu_torch.sim.blocked import build_blocked_scene
from softbody_tpu_torch.sim.scene import build_scene
from softbody_tpu_torch.sim.sparse import build_sparse_scene
from softbody_tpu_torch.topology.neighbors import build_topology

from tests.test_torch_helpers import small_body

TOL = 1e-10
EPISODE_TOL = 1e-9


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _cloud(n=400, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, 3))


def _grids(lo, hi, r_c, cap, **kw):
    """The same grid in both packages (the port's from JAX's fields)."""
    g_j = jct.build_contact_grid(lo, hi, r_c=r_c, cap=cap, **kw)
    g_t = contact_from_numpy(np.asarray(g_j.lo), g_j.cell, g_j.dims, g_j.cap, g_j.r_c,
                             g_j.stiffness, None if g_j.exclude is None
                             else np.asarray(g_j.exclude))
    own = tct.build_contact_grid(lo, hi, r_c=r_c, cap=cap, **kw)
    assert own.dims == g_t.dims and torch.equal(own.lo, g_t.lo)
    return g_j, g_t


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=TOL, atol=1e-12)


def test_contact_forces_match_jax_and_allpairs():
    pos = _cloud()
    g_j, g_t = _grids([-0.1] * 3, [1.1] * 3, 0.12, 32)
    assert tct.max_occupancy(_t(pos), g_t) == int(jct.max_occupancy(jnp.asarray(pos), g_j)) <= 32
    f_t = tct.contact_forces(_t(pos), g_t)
    f_j = jct.contact_forces(jnp.asarray(pos), g_j)
    assert np.abs(np.asarray(f_j)).max() > 0
    _close(f_t, f_j)
    _close(f_t, tct.contact_forces_allpairs(_t(pos), g_t))
    _close(tct.contact_forces_allpairs(_t(pos), g_t, chunk=37),
           jct.contact_forces_allpairs(jnp.asarray(pos), g_j))
    # a query subset against every particle
    f_q = tct.contact_forces_query(_t(pos), _t(pos[100:180]), 100, g_t)
    _close(f_q, f_t[100:180])


def test_out_of_grid_particles_are_inert():
    pos = _cloud(200)
    pos[:10] += 100.0
    g_j, g_t = _grids([-0.1] * 3, [1.1] * 3, 0.12, 32)
    f = tct.contact_forces(_t(pos), g_t)
    assert (f[:10] == 0).all()
    _close(f, tct.contact_forces_allpairs(_t(pos), g_t))
    _close(f, jct.contact_forces(jnp.asarray(pos), g_j))


def test_exclude_table_is_honoured():
    pos = _cloud(100)
    g_j, g_t = _grids([-0.1] * 3, [1.1] * 3, 0.3, 64)
    everything = torch.arange(100).repeat(100, 1)
    assert (tct.contact_forces(_t(pos), g_t, exclude=everything) == 0).all()
    excl = np.random.default_rng(1).integers(0, 100, (100, 12))
    f_t = tct.contact_forces(_t(pos), g_t, exclude=torch.as_tensor(excl))
    f_j = jct.contact_forces(jnp.asarray(pos), g_j, exclude=jnp.asarray(excl, jnp.int32))
    _close(f_t, f_j)
    _close(f_t, tct.contact_forces_allpairs(_t(pos), g_t, exclude=torch.as_tensor(excl)))
    assert not np.allclose(f_t.numpy(), tct.contact_forces(_t(pos), g_t).numpy())


def test_overflow_flag_rises():
    pos = _cloud(64)
    g_j, g_t = _grids([-0.1] * 3, [1.1] * 3, 2.0, 4)
    assert tct.max_occupancy(_t(pos), g_t) > 4
    f, ovf = tct.contact_forces(_t(pos), g_t, with_overflow=True)
    assert bool(ovf) and bool(jct.contact_forces(jnp.asarray(pos), g_j,
                                                  with_overflow=True)[1])
    _close(f, jct.contact_forces(jnp.asarray(pos), g_j))   # the same dropped pairs
    _, g_ok = _grids([-0.1] * 3, [1.1] * 3, 0.12, 32)
    f2, ovf2 = tct.contact_forces(_t(pos), g_ok, with_overflow=True)
    assert not bool(ovf2) and torch.equal(f2, tct.contact_forces(_t(pos), g_ok))


def test_overflow_warns_once_per_process():
    pts, out_num = inflatable_sphere(n_outer=24, radius=0.02)
    h = suggest_h(pts, 12)
    cfg = warp_parity().replace(h=h, dtype="float64", dt=1e-6)
    scene = build_scene(pts, cfg, out_num=out_num, device="cpu")
    grid = tct.build_contact_grid(pts.min(0) - 0.01, pts.max(0) + 0.01, r_c=4.0 * h, cap=1)
    scene_c = scene._replace(contact=grid)
    tro._overflow_warned = False
    try:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            with torch.no_grad():
                tro.rollout(np.zeros(len(pts)), scene_c, cfg, n_steps=2, device="cpu")
                tro.rollout(np.zeros(len(pts)), scene_c, cfg, n_steps=2, device="cpu")
        hits = [w for w in rec if "cap=1" in str(w.message)]
        assert len(hits) == 1 and hits[0].category is RuntimeWarning
        # without the check nothing is read and nothing warns
        tro._overflow_warned = False
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            with torch.no_grad():
                tro.rollout(np.zeros(len(pts)), scene_c, cfg.replace(contact_check=False),
                            n_steps=2, device="cpu")
        assert not [w for w in rec if "cap=1" in str(w.message)]
    finally:
        tro._overflow_warned = False


def test_contact_gradient_matches_jax():
    pos = _cloud(64)
    g_j, g_t = _grids([-0.1] * 3, [1.1] * 3, 0.25, 64)
    g_jax = jax.grad(lambda p: jnp.sum(jct.contact_forces(p, g_j) ** 2))(jnp.asarray(pos))
    p = _t(pos).requires_grad_()
    (g,) = torch.autograd.grad(torch.sum(tct.contact_forces(p, g_t) ** 2), p)
    assert np.abs(np.asarray(g_jax)).max() > 0
    assert np.abs(g.numpy() - np.asarray(g_jax)).max() <= TOL * np.abs(np.asarray(g_jax)).max()


def _contact_case():
    """The small body with the rest neighbours within h excluded: pairs
    between h and r_c = 1.2 h are in contact from the start."""
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", dt=2e-6, collision=False,
                                integrator="symplectic", frames=12, target_frames=4)
    topo, _, _ = build_topology(pts, np.full(len(pts), cfg.mass),
                                cfg.replace(h=0.5 * h, max_neighbors=0))
    return pts, out_num, h, cfg, np.asarray(topo.idx), pts


def test_contact_episode_and_gradient_match_jax():
    pts, out_num, h, cfg, idx, start = _contact_case()
    g_j, g_t = _grids(pts.min(0) - 0.01, pts.max(0) + 0.01, 1.2 * h, 16,
                      stiffness=1e4, exclude=idx)
    assert (tct.contact_forces(_t(start), g_t).abs().sum(1) > 0).sum() > 10
    scene_j = jbuild_scene(start, cfg, out_num=out_num)._replace(contact=g_j)
    scene_t = build_scene(start, cfg, out_num=out_num, device="cpu")._replace(contact=g_t)
    x = np.random.default_rng(2).normal(scale=0.5, size=len(pts))
    _, fin_j, (tp, tv) = jro.rollout(jnp.asarray(x), scene_j, cfg, n_steps=12,
                                     record_every=3)
    _, fin_t, (tp_t, _) = tro.rollout(x, scene_t, cfg, n_steps=12, record_every=3,
                                      device="cpu")
    disp = np.abs(np.asarray(fin_j.position) - start).max()
    assert np.abs(tp_t.numpy() - np.asarray(tp)).max() <= EPISODE_TOL * disp
    x0 = np.zeros(len(pts))
    loss_j, gr_j = jro.value_and_grad_fn(scene_j, cfg, 12)(jnp.asarray(x0), tp, tv)
    loss_t, gr_t = tro.value_and_grad_fn(scene_t, cfg, 12)(x0, np.asarray(tp),
                                                           np.asarray(tv))
    gr_j = np.asarray(gr_j)
    assert abs(loss_t - loss_j) <= EPISODE_TOL * loss_j
    assert np.abs(gr_t.numpy() - gr_j).max() <= EPISODE_TOL * np.abs(gr_j).max()


@pytest.mark.parametrize("layout", ["sparse", "blocked"])
def test_contact_on_slot_scenes_matches_gather(layout):
    pts, out_num, h, cfg, idx, start = _contact_case()
    kw = dict(stiffness=1e4)
    lo, hi = pts.min(0) - 0.01, pts.max(0) + 0.01
    scene_g = build_scene(start, cfg, out_num=out_num, device="cpu")._replace(
        contact=tct.build_contact_grid(lo, hi, 1.2 * h, 16, exclude=idx, **kw))
    backend = "pallas" if layout == "sparse" else "blocked"
    build = build_sparse_scene if layout == "sparse" else build_blocked_scene
    scene_s, sop = build(start, cfg.replace(backend=backend), out_num=out_num,
                         device="cpu")
    excl = tct.slot_exclude(idx, sop, len(scene_s.rest_position))
    scene_s = scene_s._replace(
        contact=tct.build_contact_grid(lo, hi, 1.2 * h, 16, exclude=excl, **kw))
    # the padding slots lie outside the grid: no contact force there
    f_s = tct.contact_forces(scene_s.rest_position, scene_s.contact)
    f_g = tct.contact_forces(scene_g.rest_position, scene_g.contact)
    pad = np.setdiff1d(np.arange(len(f_s)), sop)
    assert (f_s[pad] == 0).all()
    np.testing.assert_allclose(f_s[sop].numpy(), f_g.numpy(), rtol=TOL, atol=1e-12)
    with torch.no_grad():
        _, fin_g, _ = tro.rollout(np.zeros(len(pts)), scene_g, cfg, n_steps=8,
                                  device="cpu")
        _, fin_s, _ = tro.rollout(np.zeros(len(scene_s.rest_position)), scene_s,
                                  cfg.replace(backend=backend), n_steps=8, device="cpu")
    np.testing.assert_allclose(fin_s.position.numpy()[sop], fin_g.position.numpy(),
                               atol=1e-11)
