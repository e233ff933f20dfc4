"""PyTorch port: implicit obstacles (``ops/obstacles``, ``ops/collision.
sdf_penalty``), the DeepSDF model (``models/deepsdf``) and multi-body
composition (``geometry/compose``) against the JAX package.

Tolerances, f64 positions (the obstacles' parameters are f32 in both
packages): ``sdf`` 1e-12 and ``penalty_force`` 1e-10 of max |JAX| wherever
JAX is finite, and its VJP 1e-9; a DeepSDF network carried across from JAX
(``convert.deepsdf_from_numpy``) the same; ``load_pth`` against the torch
module that wrote the file 2e-5 (f32, as ``tests/test_deepsdf.py``), and
``init_x_from_sdf`` against JAX's 1e-6 (f32);
obstacle rollouts and their episode gradient 1e-9 relative.  Inside a box
JAX's normal is NaN (the gradient of ``norm(max(q, 0))`` at 0); the port's
force there is the closed-form face normal times k depth^2, and the test
asserts both, so that the reference's fault stays documented.  The
multi-body and slot-backend cases keep the bars of
``tests/test_obstacles_multibody.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import build_scene as jbuild_scene
from softbody_tpu import warp_parity
from softbody_tpu.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu.models import deepsdf as jdsdf
from softbody_tpu.ops import collision as jcol
from softbody_tpu.ops import obstacles as jobs
from softbody_tpu.sim import rollout as jro
from softbody_tpu_torch.convert import deepsdf_from_numpy, obstacles_from_numpy
from softbody_tpu_torch.geometry.compose import Body, compose, translated
from softbody_tpu_torch.models import deepsdf as tdsdf
from softbody_tpu_torch.ops import collision as tcol
from softbody_tpu_torch.ops import obstacles as tobs
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.sim import rollout as tro
from softbody_tpu_torch.sim.blocked import build_blocked_scene
from softbody_tpu_torch.sim.scene import build_scene
from softbody_tpu_torch.sim.sparse import build_sparse_scene
from softbody_tpu_torch.utils import checkpoint as ckpt

from tests.test_deepsdf import make_torch_model
from tests.test_torch_helpers import small_body

SDF_TOL = 1e-12
FORCE_TOL = 1e-10
EPISODE_TOL = 1e-9


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


PRIMS = {
    "sphere": ((0.0, -0.5, 0.0), 0.52),
    "plane": ((0.3, 1.0, -0.2), 0.01),
    "box": ((0.02, 0.0, -0.01), (0.03, 0.02, 0.04)),
}


def _both(kind, *args, **kw):
    return (jobs.make(getattr(jobs, kind)(*args), **kw),
            tobs.make(getattr(tobs, kind)(*args), **kw))


def _points(n=300, seed=0):
    return np.random.default_rng(seed).uniform(-0.08, 0.08, (n, 3))


@pytest.mark.parametrize("kind", list(PRIMS))
def test_primitive_sdf_and_penalty_match_jax(kind):
    o_j, o_t = _both(kind, *PRIMS[kind], stiffness=1e4, margin=0.02)
    pts = _points()
    d_j = np.asarray(jobs.sdf(o_j, jnp.asarray(pts)))
    d_t = tobs.sdf(o_t, _t(pts)).numpy()
    assert _rel(d_t, d_j) <= SDF_TOL
    f_j = np.asarray(jobs.penalty_force(o_j, jnp.asarray(pts)))
    f_t = tobs.penalty_force(o_t, _t(pts)).numpy()
    finite = np.isfinite(f_j).all(axis=1)
    assert finite.sum() > 50 and np.abs(f_j[finite]).max() > 0
    assert _rel(f_t[finite], f_j[finite]) <= FORCE_TOL
    assert np.isfinite(f_t).all()


def test_box_interior_is_finite_where_jax_is_nan():
    center, half = np.array([0.0, 0.0, 0.0]), np.array([0.1, 0.1, 0.1])
    o_j, o_t = _both("box", center, half, stiffness=1e3, margin=1e-4)
    p = np.array([[0.0, 0.095, 0.0]])
    assert np.isclose(float(jobs.sdf(o_j, jnp.asarray(p))[0]), -5e-3)
    assert np.isnan(np.asarray(jobs.penalty_force(o_j, jnp.asarray(p)))).all()
    f = tobs.penalty_force(o_t, _t(p)).numpy()[0]
    depth = 1e-4 + 5e-3        # margin - sdf
    np.testing.assert_allclose(f, [0.0, 1e3 * depth * depth, 0.0], rtol=1e-6, atol=0)


def test_sdf_penalty_of_a_function_matches_jax():
    pts = _points(seed=1)

    def sdf_j(p):
        return jnp.sum(p * p) ** 0.5 - 0.05

    f_j = np.asarray(jcol.sdf_penalty(jnp.asarray(pts), sdf_j, 2e4, margin=1e-3))
    f_t = tcol.sdf_penalty(_t(pts), lambda p: torch.linalg.vector_norm(p, dim=-1)
                           - 0.05, 2e4, margin=1e-3).numpy()
    assert np.abs(f_j).max() > 0 and _rel(f_t, f_j) <= FORCE_TOL


def _narrow_deepsdf():
    """A 3 -> 32 x 3 -> 1 DeepSDF of the JAX package, carried into the port."""
    params_j = jdsdf.init_params(jax.random.key(3), sizes=[3, 32, 32, 32, 1])
    params_t = deepsdf_from_numpy([np.asarray(w) for w in params_j.weights],
                                  [np.asarray(b) for b in params_j.biases])
    return params_j, params_t


def test_deepsdf_obstacle_and_its_vjp_match_jax():
    params_j, params_t = _narrow_deepsdf()
    offset, scale = (0.01, -0.02, 0.0), 2.0
    o_j = jobs.make(jobs.sphere((0, -1, 0), 0.9), jobs.deepsdf(params_j, scale, offset),
                    stiffness=1e3, margin=0.05)
    kinds = o_j.kinds
    params = jax.tree.map(np.asarray, o_j.params)
    o_t = obstacles_from_numpy(kinds, params, o_j.stiffness, o_j.margin)
    pts = _points(seed=2)
    assert _rel(tobs.sdf(o_t, _t(pts)), jobs.sdf(o_j, jnp.asarray(pts))) <= SDF_TOL
    f_j, vjp = jax.vjp(lambda p: jobs.penalty_force(o_j, p), jnp.asarray(pts))
    ct = np.random.default_rng(4).normal(size=pts.shape)
    (g_j,) = vjp(jnp.asarray(ct))
    p = _t(pts).requires_grad_()
    f_t = tobs.penalty_force(o_t, p)
    (g_t,) = torch.autograd.grad(f_t, p, _t(ct))
    assert np.abs(np.asarray(f_j)).max() > 0
    assert _rel(f_t.detach(), f_j) <= FORCE_TOL
    assert _rel(g_t, g_j) <= EPISODE_TOL
    # inside no_grad: the same force, detached
    with torch.no_grad():
        f_ng = tobs.penalty_force(o_t, _t(pts))
    assert not f_ng.requires_grad and torch.equal(f_ng, f_t.detach())


def test_deepsdf_model_matches_jax_and_loads_pth(tmp_path):
    model = make_torch_model(network_size=32, seed=4)
    path = tmp_path / "model_10000.pth"
    torch.save(model.state_dict(), path)
    params_t = tdsdf.load_pth(path)
    params_j = jdsdf.load_pth(path)
    for a, b in zip(params_t.weights + params_t.biases, params_j.weights + params_j.biases):
        assert np.array_equal(a.numpy(), np.asarray(b))
    pts = np.random.default_rng(5).normal(size=(33, 3)).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(pts)).numpy()
        out = tdsdf.sdf(params_t, torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)
    full = tdsdf.init_params(torch.Generator().manual_seed(0))
    assert full.weights[0].shape == (3, 1024) and full.weights[-1].shape == (1024, 1)
    assert len(full.weights) == tdsdf.N_LAYERS
    assert tdsdf.forward(full, torch.zeros(5, 3)).shape == (5, 1)


def test_init_x_from_sdf_matches_jax():
    params_j, params_t = _narrow_deepsdf()
    pts = np.random.default_rng(3).normal(size=(50, 3))
    x0 = tdsdf.init_x_from_sdf(params_t, pts, out_num=20, set_target=False)
    assert x0.shape == (50,) and (x0 == -1.0).all()
    x1_t = tdsdf.init_x_from_sdf(params_t, pts, out_num=20, set_target=True).numpy()
    x1_j = np.asarray(jdsdf.init_x_from_sdf(params_j, pts, out_num=20, set_target=True))
    assert (x1_t[:20] >= 1.0).all()
    np.testing.assert_allclose(x1_t, x1_j, rtol=1e-6, atol=1e-6)   # f32 products


def _obstacle_set(mod, y0):
    """A sphere the body's base sinks into, and a plane and a box whose
    surfaces sit within the margin below it (outside both)."""
    return mod.make(mod.sphere((0.0, y0 - 0.5, 0.0), 0.503),
                    mod.plane((0.0, 1.0, 0.0), y0 - 6e-4),
                    mod.box((0.0, y0 - 0.0505, 0.0), (0.2, 0.05, 0.2)),
                    stiffness=3e4, margin=3e-3)


def test_obstacle_episode_and_gradient_match_jax():
    pts, out_num, h = small_body()
    pts = pts - np.array([0.0, pts[:, 1].min(), 0.0])
    cfg = warp_parity().replace(h=h, dtype="float64", dt=2e-6, collision=False,
                                frames=20, target_frames=5)
    scene_j = jbuild_scene(pts, cfg, out_num=out_num,
                           obstacles=_obstacle_set(jobs, 0.0))
    scene_t = build_scene(pts, cfg, out_num=out_num, device="cpu",
                          obstacles=_obstacle_set(tobs, 0.0))
    x_star = np.random.default_rng(8).normal(scale=0.8, size=len(pts))
    _, fin_j, (tp, tv) = jro.rollout(jnp.asarray(x_star), scene_j, cfg, n_steps=20,
                                     record_every=4)
    _, fin_t, (tp_t, _) = tro.rollout(x_star, scene_t, cfg, n_steps=20,
                                      record_every=4, device="cpu")
    disp = np.abs(np.asarray(fin_j.position) - pts).max()
    f0 = tobs.penalty_force(scene_t.obstacles, _t(pts))
    assert (f0.abs().sum(1) > 0).sum() >= 10           # the obstacles act
    assert np.abs(tp_t.numpy() - np.asarray(tp)).max() <= EPISODE_TOL * disp
    x0 = np.zeros(len(pts))
    loss_j, g_j = jro.value_and_grad_fn(scene_j, cfg, 20)(jnp.asarray(x0), tp, tv)
    loss_t, g_t = tro.value_and_grad_fn(scene_t, cfg, 20)(x0, np.asarray(tp),
                                                          np.asarray(tv))
    assert np.isfinite(np.asarray(g_j)).all() and np.abs(np.asarray(g_j)).max() > 0
    assert abs(loss_t - loss_j) <= EPISODE_TOL * loss_j
    assert _rel(g_t, g_j) <= EPISODE_TOL


# ---- the cases of tests/test_obstacles_multibody.py --------------------------

def test_sdf_primitives():
    o = tobs.make(tobs.sphere([0, 0, 0], 1.0), tobs.plane([0, 1, 0], 0.0),
                  tobs.box([5, 0, 0], [1, 1, 1]))
    pts = _t([[0.0, 2.0, 0.0], [0.0, 0.5, 0.0], [5.0, 3.0, 0.0]])
    np.testing.assert_allclose(tobs.sdf(o, pts).numpy(), [1.0, -0.5, 2.0], atol=1e-6)


def test_sdf_gradients_and_penalty_direction():
    o = tobs.make(tobs.sphere([0.0, 0.0, 0.0], 1.0), stiffness=1e3, margin=0.0)
    f = tobs.penalty_force(o, _t([[0.0, 0.5, 0.0]])).numpy()
    np.testing.assert_allclose(f[0], [0.0, 1e3 * 0.25, 0.0], atol=1e-3)
    assert np.allclose(tobs.penalty_force(o, _t([[0.0, 2.0, 0.0]])).numpy(), 0.0)


def _falling_case():
    pts, out_num = inflatable_sphere(n_outer=48, radius=0.02, center=(0, 0.05, 0))
    cfg = warp_parity().replace(h=suggest_h(pts, 14), dtype="float64", dt=2e-6,
                                collision=False, initial_velocity=(0.0, -2.0, 0.0))
    sph = tobs.make(tobs.sphere([0.0, -0.5, 0.0], 0.5295), stiffness=3e9, margin=1e-4)
    return pts, out_num, cfg, sph


def test_obstacle_deflects_falling_body():
    pts, out_num, cfg, sph = _falling_case()
    x = np.zeros(len(pts))
    scene = build_scene(pts, cfg, out_num=out_num, obstacles=sph, device="cpu")
    with torch.no_grad():
        _, final, _ = tro.rollout(x, scene, cfg, n_steps=300, device="cpu")
        free = build_scene(pts, cfg, out_num=out_num, device="cpu")
        _, final_free, _ = tro.rollout(x, free, cfg, n_steps=300, device="cpu")
    assert torch.isfinite(final.position).all()
    assert tobs.sdf(sph, final.position).min() > -2e-4
    assert tobs.sdf(sph, final_free.position).min() < -2e-4


@pytest.mark.parametrize("backend", ["blocked", "pallas"])
def test_obstacles_on_slot_backends_match_gather(backend):
    pts, out_num, cfg, sph = _falling_case()
    scene_g = build_scene(pts, cfg, out_num=out_num, obstacles=sph, device="cpu")
    with torch.no_grad():
        _, fin_g, _ = tro.rollout(np.zeros(len(pts)), scene_g, cfg, n_steps=50,
                                  device="cpu")
        cfg_b = cfg.replace(backend=backend)
        build = build_blocked_scene if backend == "blocked" else build_sparse_scene
        scene_b, sop = build(pts, cfg_b, out_num=out_num, obstacles=sph, device="cpu")
        _, fin_b, _ = tro.rollout(np.zeros(len(scene_b.rest_position)), scene_b,
                                  cfg_b, n_steps=50, device="cpu")
    np.testing.assert_allclose(fin_b.position.numpy()[sop], fin_g.position.numpy(),
                               atol=1e-11)


def test_multibody_compose_and_sim():
    b1_pts, n1 = inflatable_sphere(n_outer=40, radius=0.02, center=(0, 0.03, 0))
    b1 = Body(points=b1_pts, out_num=n1, name="a")
    comp = compose([b1, translated(b1, [0.08, 0.0, 0.0])])
    assert comp.points.shape[0] == 2 * len(b1_pts)
    assert comp.body_slice(1).start == len(b1_pts)
    cfg = warp_parity().replace(h=suggest_h(comp.points, 14), dtype="float64", dt=2e-6)
    scene = build_scene(comp.points, cfg, device="cpu")
    with torch.no_grad():
        _, final, _ = tro.rollout(np.zeros(len(comp.points)), scene, cfg, n_steps=20,
                                  device="cpu")
    parts = comp.split(final.position.numpy())
    assert len(parts) == 2 and all(np.isfinite(p).all() for p in parts)
    np.testing.assert_allclose(parts[1] - [0.08, 0, 0], parts[0], atol=1e-9)


def test_midepisode_checkpoint_resume(tmp_path):
    pts, out_num = inflatable_sphere(n_outer=48, radius=0.05)
    cfg = warp_parity().replace(h=suggest_h(pts, 14), dtype="float64", dt=2e-6)
    scene = build_scene(pts, cfg, out_num=out_num, device="cpu")
    ratio = compute_ratio(torch.zeros(len(pts), dtype=torch.float64), cfg)
    with torch.no_grad():
        st = tro.initial_state(scene, ratio, cfg)
        for _ in range(5):
            st = tro.step(st, ratio, scene, cfg)
        ckpt.save_sim_state(tmp_path, st, frame=5)
        for _ in range(5):
            st = tro.step(st, ratio, scene, cfg)
        st2 = ckpt.load_sim_state(tmp_path, 5, dtype=torch.float64)
        for _ in range(5):
            st2 = tro.step(st2, ratio, scene, cfg)
    assert torch.equal(st2.position, st.position)
