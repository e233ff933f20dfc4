"""PyTorch port, Taichi pairing (``pair_def_grad="j"``) on the sparse
scene through the episode, against the JAX package (Pallas kernels in
interpret mode), f64, 1e-9 relative: a 10-step stretch rollout and the
loss and dloss/dx of a 40-step episode on the clamped body
(tests/test_torch_grad_episode.py says why it is clamped); then one L-BFGS
iteration through ``optimize_lbfgs`` on the CPU, which lowers the loss."""

import numpy as np
import jax
import pytest

from softbody_tpu import warp_parity
from softbody_tpu.scenarios import STRETCH, dirichlet_mask
from softbody_tpu.sim.rollout import rollout as jrollout
from softbody_tpu.sim.rollout import value_and_grad_fn as jvalue_and_grad_fn
from softbody_tpu_torch.opt import driver
from softbody_tpu_torch.sim.rollout import rollout, value_and_grad_fn

from tests.test_torch_helpers import both_scenes, small_body, to_jax

TOL = 1e-9
FRAMES = 4


@pytest.fixture(scope="module")
def body():
    pts, out_num, h = small_body()
    return pts, out_num, h, dirichlet_mask(pts, "stretch")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_taichi_rollout_matches_jax(body):
    pts, out_num, h, mask = body
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas", frames=10,
                                target_frames=5, pair_def_grad="j", **STRETCH)
    scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num, dirichlet_mask=mask)
    x = np.zeros(scene_j.blocked.n_slots)
    x[sop] = np.random.default_rng(60).normal(scale=0.5, size=len(sop))
    run = jax.jit(lambda xv, sc: jrollout(xv, sc, cfg, n_steps=10, record_every=2))
    _, fin_j, rec_j = run(to_jax(x, "float64"), scene_j)
    _, fin_t, rec_t = rollout(x, scene_t, cfg, n_steps=10, record_every=2, device="cpu")
    rest = np.asarray(scene_j.rest_position)
    disp = np.asarray(fin_j.position) - rest
    assert np.abs(disp).max() > 0
    assert _rel(fin_t.position.numpy() - rest, disp) < TOL
    assert _rel(fin_t.velocity.numpy(), fin_j.velocity) < TOL
    assert _rel(rec_t[0].numpy() - rest, np.asarray(rec_j[0]) - rest) < TOL


def test_taichi_episode_gradient_matches_jax(body):
    pts, out_num, h, mask = body
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas", frames=40,
                                target_frames=FRAMES, pair_def_grad="j", **STRETCH)
    scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num, dirichlet_mask=mask)
    rng = np.random.default_rng(61)
    x = np.zeros(scene_j.blocked.n_slots)
    x[sop] = rng.normal(scale=0.5, size=len(sop))
    tp = np.tile(np.asarray(scene_j.rest_position, np.float64), (FRAMES, 1, 1))
    tv = np.zeros_like(tp) + np.asarray(cfg.initial_velocity)
    tp[:, sop] += rng.normal(scale=1e-4, size=(FRAMES, len(sop), 3))
    tv[:, sop] += rng.normal(scale=1e-2, size=(FRAMES, len(sop), 3))
    loss_j, grad_j = jvalue_and_grad_fn(scene_j, cfg, n_steps=cfg.frames)(
        to_jax(x, "float64"), to_jax(tp, "float64"), to_jax(tv, "float64"))
    loss_t, grad_t = value_and_grad_fn(scene_t, cfg, n_steps=cfg.frames)(x, tp, tv)
    grad_j = np.asarray(grad_j)
    assert loss_j > 0 and np.abs(grad_j).max() > 0
    assert abs(loss_t - loss_j) <= TOL * loss_j, (loss_t, loss_j)
    assert _rel(grad_t.numpy(), grad_j) <= TOL


def test_taichi_lbfgs_iteration_lowers_the_loss(body):
    """One L-BFGS iteration with the Taichi pairing (the setting of
    tests/test_torch_driver.py: top clamped, no ground, 12 steps of 2e-6 s,
    targets from a random x*)."""
    pts, out_num, h, mask = body
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas", dt=2e-6,
                                frames=12, target_frames=4, collision=False,
                                pair_def_grad="j")
    _, scene_t, sop = both_scenes(pts, cfg, out_num=out_num, dirichlet_mask=mask)
    x_true = np.zeros(scene_t.blocked.n_slots)
    x_true[sop] = np.random.default_rng(62).normal(scale=0.8, size=len(sop))
    _, _, (tp, tv) = rollout(x_true, scene_t, cfg, n_steps=12, record_every=3,
                             device="cpu")
    x0 = np.zeros_like(x_true)
    loss0, _ = value_and_grad_fn(scene_t, cfg)(x0, tp, tv)
    res, hist = driver.optimize_lbfgs(scene_t, cfg, x0, tp.numpy(), tv.numpy(),
                                      x_target=x_true, maxiter=1, verbose=False,
                                      plot=False)
    assert res.nit == 1 and len(hist["losses"]) == 1
    assert hist["losses"][0] < loss0
