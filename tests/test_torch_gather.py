"""PyTorch port: the gather backend (``backend="gather"``: ``build_scene``'s
(N, K) neighbour tables and ``ops/elasticity``) against the JAX package.

Tolerances, all f64: the neighbour tables bit-identical (also under the
K-nearest truncation of ``cfg.max_neighbors``); ``deformation``,
``stvk_stress`` and ``elastic_forces`` 1e-12 of max |JAX|; the gather path
against the port's own sparse path 1e-10 of max |f|; rollouts and the
episode gradient 1e-9 relative.  The gradient case clamps the top of the
body, so that it strains (ROADMAP §3's design note).  The oracle cases
(``softbody_tpu/oracle/sim.py``, O(N^2) numpy) keep the bars of
``tests/test_elasticity.py``, and the setter cases those of
``tests/test_scene_setters.py``."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import build_scene as jbuild_scene
from softbody_tpu import taichi_parity, warp_parity
from softbody_tpu.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu.ops import elasticity as jel
from softbody_tpu.oracle import sim as oracle
from softbody_tpu.scenarios import STRETCH, dirichlet_mask
from softbody_tpu.sim import rollout as jro
from softbody_tpu.topology import neighbors as jnb
from softbody_tpu_torch.convert import scene_from_numpy, scene_to_numpy
from softbody_tpu_torch.opt import driver
from softbody_tpu_torch.ops import elasticity as tel
from softbody_tpu_torch.sim import rollout as tro
from softbody_tpu_torch.sim.scene import build_scene, lame_parameters, update_materials
from softbody_tpu_torch.sim.sparse import build_sparse_scene
from softbody_tpu_torch.topology import neighbors as tnb

from tests.test_torch_helpers import small_body

OPS_TOL = 1e-12
PATH_TOL = 1e-10
EPISODE_TOL = 1e-9


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _stretched(pts, seed, amp=0.05):
    rng = np.random.default_rng(seed)
    F = np.eye(3) + amp * rng.normal(size=(3, 3))
    c = pts.mean(0)
    return (pts - c) @ F.T + c + 1e-4 * rng.normal(size=pts.shape)


@pytest.mark.parametrize("max_neighbors", [64, 16])
def test_neighbor_tables_bit_identical(max_neighbors):
    pts, _, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", max_neighbors=max_neighbors)
    mass = np.random.default_rng(0).uniform(0.5e-4, 2e-4, len(pts))
    topo_t, rho_t, vol_t = tnb.build_topology(pts, mass, cfg)
    topo_j, rho_j, vol_j = jnb.build_topology(pts, mass, cfg)
    assert topo_t.idx.shape[1] == min(48, max_neighbors)
    for f in topo_j._fields:
        assert np.array_equal(getattr(topo_t, f), getattr(topo_j, f)), f
    assert np.array_equal(rho_t, rho_j) and np.array_equal(vol_t, vol_j)
    for a, b in zip(tnb.neighbor_lists_numpy(pts, 2 * h),
                    jnb.neighbor_lists_numpy(pts, 2 * h)):
        assert np.array_equal(a, b)


CASES = {
    "warp": (warp_parity, {}),
    "warp_j": (warp_parity, {"pair_def_grad": "j"}),
    "warp_not_corotated": (warp_parity, {"corotated": False}),
    "taichi": (taichi_parity, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gather_ops_match_jax(case):
    preset, kw = CASES[case]
    pts, out_num, h = small_body()
    cfg = preset(**kw).replace(h=h, dtype="float64")
    scene_j = jbuild_scene(pts, cfg, out_num=out_num)
    scene_t = build_scene(pts, cfg, out_num=out_num, device="cpu")
    pos = _stretched(pts, seed=1)
    x = np.random.default_rng(2).normal(size=len(pts))
    A_j, R_j, F_j = jel.deformation(jnp.asarray(pos), scene_j.topology, cfg)
    A_t, R_t, F_t = tel.deformation(_t(pos), scene_t.topology, cfg)
    for a, b in ((A_t, A_j), (R_t, R_j), (F_t, F_j)):
        assert _rel(a, b) <= OPS_TOL
    ratio = jel.compute_ratio(jnp.asarray(x), cfg)
    scale = cfg.stiffness_scale(ratio)
    S_j = jel.stvk_stress(F_j, scene_j.materials.mu, scene_j.materials.lam, scale)
    S_t = tel.stvk_stress(_t(F_j), scene_t.materials.mu, scene_t.materials.lam,
                          _t(scale))
    assert _rel(S_t, S_j) <= OPS_TOL
    f_j, _ = jel.elastic_forces(jnp.asarray(pos), ratio, scene_j.materials,
                                scene_j.topology, cfg)
    f_t, _ = tel.elastic_forces(_t(pos), _t(ratio), scene_t.materials,
                                scene_t.topology, cfg)
    assert _rel(f_t, f_j) <= OPS_TOL


def test_gather_backward_is_the_fixed_order_row_sum():
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64")
    topo = build_scene(pts, cfg, out_num=out_num, device="cpu").topology
    a = _t(np.random.default_rng(3).normal(size=(len(pts), 3, 3))).requires_grad_()
    ct = _t(np.random.default_rng(4).normal(size=(*topo.idx.shape, 3, 3)))
    (g_ref,) = torch.autograd.grad(a[topo.idx], a, ct)
    grads = [torch.autograd.grad(tel.gather_topo(a, topo), a, ct)[0],
             torch.autograd.grad(tel.gather_topo(a, topo), a, ct)[0],
             torch.autograd.grad(tel.gather(a, topo.idx), a, ct)[0]]
    assert torch.equal(tel.gather_topo(a, topo), a[topo.idx])
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])
    assert _rel(grads[0], g_ref) <= 1e-15
    order, ptr = tel.index_inverse(topo.idx, len(pts))
    assert torch.equal(order, topo.inv_order) and torch.equal(ptr, topo.inv_ptr)
    assert torch.equal(ptr.diff(), torch.bincount(topo.idx.reshape(-1), minlength=len(pts)))


@pytest.mark.parametrize("pairing", ["i", "j"])
def test_gather_path_matches_the_sparse_path(pairing):
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", pair_def_grad=pairing,
                                max_neighbors=0)
    scene_g = build_scene(pts, cfg, out_num=out_num, device="cpu")
    scene_s, sop = build_sparse_scene(pts, cfg, out_num=out_num, device="cpu")
    pos = _stretched(pts, seed=5)
    x = np.random.default_rng(6).normal(size=len(pts))
    pos_s = scene_s.rest_position.clone()
    pos_s[sop] = _t(pos)
    x_s = torch.zeros(len(pos_s), dtype=torch.float64)
    x_s[sop] = _t(x)
    f_g = tro.elastic_forces(_t(pos), tel.compute_ratio(_t(x), cfg), scene_g, cfg)
    f_s = tro.elastic_forces(pos_s, tel.compute_ratio(x_s, cfg), scene_s,
                             cfg.replace(backend="pallas"))
    assert _rel(f_g, f_s[sop]) <= PATH_TOL


def _x_star(pts):
    r = np.linalg.norm(pts - pts.mean(0), axis=1)
    return np.sin(r / r.max() * 3.0 * np.pi)


@pytest.mark.parametrize("case", ["stretch", "warp_parity"])
def test_rollout_matches_jax(case):
    pts, out_num, h = small_body()
    if case == "stretch":
        cfg = warp_parity().replace(h=h, dtype="float64", **STRETCH)
        kw = dict(dirichlet_mask=dirichlet_mask(pts, "stretch"))
    else:   # the CLI's configuration: trapezoidal, the ground with its damper
        pts = pts - np.array([0.0, pts[:, 1].min() - 5e-5, 0.0])
        cfg = warp_parity().replace(h=h, dtype="float64", dt=2e-6,
                                    collision_damping=50.0)
        kw = {}
    scene_j = jbuild_scene(pts, cfg, out_num=out_num, **kw)
    scene_t = build_scene(pts, cfg, out_num=out_num, device="cpu", **kw)
    x = _x_star(pts)
    _, fin_j, rec_j = jro.rollout(jnp.asarray(x), scene_j, cfg, n_steps=24,
                                  record_every=8)
    _, fin_t, rec_t = tro.rollout(x, scene_t, cfg, n_steps=24, record_every=8,
                                  device="cpu")
    disp = np.abs(np.asarray(fin_j.position) - pts).max()
    assert disp > 0
    assert np.abs(rec_t[0].numpy() - np.asarray(rec_j[0])).max() <= EPISODE_TOL * disp
    assert _rel(fin_t.velocity, fin_j.velocity) <= EPISODE_TOL


def test_episode_gradient_matches_jax():
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", frames=30, target_frames=10,
                                **STRETCH)
    mask = dirichlet_mask(pts, "stretch")
    scene_j = jbuild_scene(pts, cfg, out_num=out_num, dirichlet_mask=mask)
    scene_t = build_scene(pts, cfg, out_num=out_num, dirichlet_mask=mask,
                          device="cpu")
    _, _, (tp, tv) = jro.rollout(jnp.asarray(_x_star(pts)), scene_j, cfg,
                                 n_steps=30, record_every=3)
    x0 = np.zeros(len(pts))
    loss_j, g_j = jro.value_and_grad_fn(scene_j, cfg, 30)(jnp.asarray(x0), tp, tv)
    loss_t, g_t = tro.value_and_grad_fn(scene_t, cfg, 30)(x0, np.asarray(tp),
                                                          np.asarray(tv))
    assert loss_j > 0 and abs(loss_t - loss_j) <= EPISODE_TOL * loss_j
    assert _rel(g_t, g_j) <= EPISODE_TOL
    # two chunks give the same gradient
    loss_c, g_c = tro.episode_value_and_grad_chunked(scene_t, cfg, 2, 30)(
        x0, np.asarray(tp), np.asarray(tv))
    assert abs(loss_c - loss_t) <= 1e-12 * loss_t and _rel(g_c, g_t) <= 1e-12


def test_gather_scene_runs_the_driver_and_converts(tmp_path):
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", dt=2e-6, frames=6,
                                target_frames=3, collision=False)
    mask = dirichlet_mask(pts, "stretch")
    scene_j = jbuild_scene(pts, cfg, out_num=out_num, dirichlet_mask=mask)
    d = {"rest_position": np.asarray(scene_j.rest_position), "out_num": out_num}
    d.update({f"topology.{f}": np.asarray(getattr(scene_j.topology, f))
              for f in scene_j.topology._fields})
    d.update({k: np.asarray(getattr(scene_j.materials, k))
              for k in scene_j.materials._fields})
    scene_t, _ = scene_from_numpy(d, "cpu")
    back = scene_to_numpy(scene_t)
    assert set(back) == set(d) and all(np.array_equal(back[k], d[k]) for k in d)
    own = build_scene(pts, cfg, out_num=out_num, dirichlet_mask=mask, device="cpu")
    for a, b in zip(scene_t.topology, own.topology):
        assert torch.equal(a, b)
    x_star = _x_star(pts)
    tp, tv = driver.generate_targets(x_star, scene_t, cfg, tmp_path / "target",
                                     device="cpu")
    assert tp.shape == (3, len(pts), 3) and (tmp_path / "target/position_3.npy").exists()
    res, hist = driver.optimize_lbfgs(scene_t, cfg, np.zeros(len(pts)), tp, tv,
                                      opt_dir=tmp_path / "opt", x_target=x_star,
                                      maxiter=1, verbose=False, plot=False,
                                      eval_chunks=2)
    assert len(hist["losses"]) == 1 and np.isfinite(hist["losses"][0])
    assert json.loads((tmp_path / "opt/distances.json").read_text())
    assert (tmp_path / "opt/x.npy").exists()


# ---- the setter cases of tests/test_scene_setters.py -------------------------

def _setter_scene():
    pts, out_num = inflatable_sphere(n_outer=48, radius=0.05)
    cfg = warp_parity().replace(h=suggest_h(pts, 14), dtype="float64")
    return pts, cfg, build_scene(pts, cfg, out_num=out_num, device="cpu")


def test_setter_youngs_modulus_recomputes_lame():
    _, cfg, scene = _setter_scene()
    s2 = update_materials(scene, cfg, youngs_modulus=3e5)
    mu, lam = lame_parameters(3e5, cfg.poisson_ratio)
    np.testing.assert_allclose(s2.materials.mu.numpy(), mu, rtol=1e-9)
    np.testing.assert_allclose(s2.materials.lam.numpy(), lam, rtol=1e-9)


def test_setter_poisson_keeps_youngs():
    _, cfg, scene = _setter_scene()
    s2 = update_materials(scene, cfg, poisson_ratio=0.3)
    mu, lam = lame_parameters(cfg.youngs_modulus, 0.3)
    np.testing.assert_allclose(s2.materials.mu.numpy(), mu, rtol=1e-6)
    np.testing.assert_allclose(s2.materials.lam.numpy(), lam, rtol=1e-6)


def test_setter_per_index_updates():
    pts, cfg, scene = _setter_scene()
    idx = [0, 3, 7]
    free = update_materials(scene, cfg, dirichlet=(0.0, 0.0, 0.0),
                            index=idx).materials.free.numpy()
    assert (free[idx] == 0).all() and free.sum() == 3 * (len(pts) - 3)
    ext = update_materials(scene, cfg, external_force=(0.0, 0.0, -0.5),
                           index=idx).materials.external.numpy()
    np.testing.assert_allclose(ext[idx], np.tile([0.0, 0.0, -0.5], (3, 1)))
    np.testing.assert_allclose(ext[1], cfg.external_force)


def test_setter_mass_update_retriggers_volume():
    pts, cfg, scene = _setter_scene()
    s2 = update_materials(scene, cfg, mass=2.0 * cfg.mass)
    np.testing.assert_allclose(s2.materials.volume.numpy(),
                               scene.materials.volume.numpy(), rtol=1e-9)
    np.testing.assert_allclose(s2.materials.mass.numpy(), 2.0 * cfg.mass)
    np.testing.assert_allclose(s2.topology.c.numpy(), 2.0 * scene.topology.c.numpy(),
                               rtol=1e-9)
    # the same update through the JAX package
    from softbody_tpu.sim.scene import update_materials as jupdate

    j2 = jupdate(jbuild_scene(pts, cfg, out_num=len(pts)), cfg, mass=2.0 * cfg.mass,
                 youngs_modulus=2e5, index=None)
    t2 = update_materials(scene, cfg, mass=2.0 * cfg.mass, youngs_modulus=2e5)
    for f in ("mass", "volume", "mu", "lam"):
        assert _rel(getattr(t2.materials, f), getattr(j2.materials, f)) <= 1e-14


# ---- the oracle cases of tests/test_elasticity.py ----------------------------

def _oracle_case(preset):
    pts, out_num = inflatable_sphere(n_outer=96, radius=0.05, seed=0)
    cfg = preset().replace(h=suggest_h(pts, 16), dtype="float64")
    osim = oracle.OracleSim(pts, cfg.mass, cfg)
    return pts, cfg, osim, build_scene(pts, cfg, out_num=out_num, device="cpu")


@pytest.mark.parametrize("preset", [warp_parity, taichi_parity])
def test_oracle_volume(preset):
    _, _, osim, scene = _oracle_case(preset)
    np.testing.assert_allclose(scene.materials.volume.numpy(), osim.volume, rtol=1e-10)


@pytest.mark.parametrize("preset", [warp_parity, taichi_parity])
def test_oracle_deformation(preset):
    pts, cfg, osim, scene = _oracle_case(preset)
    pos = _stretched(pts, seed=1, amp=0.08)
    A, R, F = tel.deformation(_t(pos), scene.topology, cfg)
    A_o = oracle.compute_A_pq(pos, pts, osim.mass, cfg)
    np.testing.assert_allclose(A.numpy(), A_o, rtol=1e-8, atol=1e-12)
    R_o = (oracle.polar_rotation(A_o) if cfg.corotated
           else np.tile(np.eye(3), (len(pts), 1, 1)))
    np.testing.assert_allclose(R.numpy(), R_o, atol=1e-7)
    _, F_o = oracle.compute_nabla_u(pos, pts, osim.volume, R_o, cfg)
    np.testing.assert_allclose(F.numpy(), F_o, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("preset", [warp_parity, taichi_parity])
def test_oracle_elastic_forces(preset):
    pts, cfg, osim, scene = _oracle_case(preset)
    pos = _stretched(pts, seed=2, amp=0.08)
    ratio = oracle.ratio_of(np.random.default_rng(3).normal(size=len(pts)), cfg)
    f, _ = tel.elastic_forces(_t(pos), _t(ratio), scene.materials, scene.topology, cfg)
    f_o, _ = oracle.compute_elastic_forces(pos, pts, osim.volume, osim.mass, osim.mu,
                                           osim.lam, ratio, cfg)
    np.testing.assert_allclose(f.numpy(), f_o, atol=1e-7 * np.abs(f_o).max())


def test_oracle_forces_vanish_at_rest():
    pts, cfg, _, scene = _oracle_case(warp_parity)
    ratio = torch.full((len(pts),), 0.3, dtype=torch.float64)
    f, (R, F, S) = tel.elastic_forces(_t(pts), ratio, scene.materials,
                                      scene.topology, cfg)
    assert S.abs().max() < 1e-6 and f.abs().max() < 1e-6
    np.testing.assert_allclose(R.numpy(), np.tile(np.eye(3), (len(pts), 1, 1)),
                               atol=1e-6)


def test_oracle_momentum_conservation_taichi_mode():
    pts, cfg, _, scene = _oracle_case(taichi_parity)
    pos = _stretched(pts, seed=4, amp=0.08)
    ratio = torch.full((len(pts),), 0.2, dtype=torch.float64)
    f, _ = tel.elastic_forces(_t(pos), ratio, scene.materials, scene.topology, cfg)
    scale = f.abs().max().item()
    np.testing.assert_allclose(f.sum(0).numpy(), 0.0,
                               atol=1e-9 * max(scale, 1.0) * len(pts))
