"""PyTorch port, fused path (``cfg.fused_mid``) through the episode: the loss
and dloss/dx of a 40-step stretch episode on the clamped body against the
JAX package's fused ``value_and_grad_fn`` (Pallas kernels in interpret
mode), f64, 1e-9 relative (the pattern of tests/test_torch_grad_episode.py,
whose docstring says why the body is clamped); and one L-BFGS iteration
through ``optimize_lbfgs`` on the fused config, on the CPU, which lowers
the loss and accepts the same iterate as the unfused path."""

import numpy as np
import pytest

from softbody_tpu import warp_parity
from softbody_tpu.scenarios import STRETCH, dirichlet_mask
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


def test_fused_stretch_episode_gradient_matches_jax(body):
    pts, out_num, h, mask = body
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                frames=40, target_frames=FRAMES, fused_mid=True,
                                **STRETCH)
    scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num,
                                        dirichlet_mask=mask)
    rng = np.random.default_rng(30)
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
    assert np.abs(grad_t.numpy() - grad_j).max() <= TOL * np.abs(grad_j).max()
    # the port's own unfused gradient, to rounding
    loss_u, grad_u = value_and_grad_fn(scene_t, cfg.replace(fused_mid=False),
                                       n_steps=cfg.frames)(x, tp, tv)
    assert abs(loss_u - loss_t) <= 1e-12 * loss_t
    assert (grad_u - grad_t).abs().max() <= 1e-11 * grad_t.abs().max()


def test_fused_lbfgs_iteration_lowers_the_loss(body):
    """One L-BFGS iteration on the fused config (the setting of
    tests/test_torch_driver.py: top clamped, no ground, 12 steps of 2e-6 s,
    targets from a random x*)."""
    pts, out_num, h, mask = body
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas", dt=2e-6,
                                frames=12, target_frames=4, collision=False,
                                fused_mid=True)
    _, scene_t, sop = both_scenes(pts, cfg, out_num=out_num, dirichlet_mask=mask)
    x_true = np.zeros(scene_t.blocked.n_slots)
    x_true[sop] = np.random.default_rng(1).normal(scale=0.8, size=len(sop))
    _, _, (tp, tv) = rollout(x_true, scene_t, cfg, n_steps=12, record_every=3,
                             device="cpu")
    x0 = np.zeros_like(x_true)
    loss0, _ = value_and_grad_fn(scene_t, cfg)(x0, tp, tv)
    runs = {}
    for fused in (True, False):
        runs[fused] = driver.optimize_lbfgs(
            scene_t, cfg.replace(fused_mid=fused), x0, tp.numpy(), tv.numpy(),
            x_target=x_true, maxiter=1, verbose=False, plot=False)
    res, hist = runs[True]
    assert res.nit == 1 and len(hist["losses"]) == 1
    assert hist["losses"][0] < loss0
    _, hist_u = runs[False]
    assert abs(hist["losses"][0] - hist_u["losses"][0]) <= 1e-9 * loss0
    step = np.abs(hist_u["xk"][0] - x0).max()
    assert step > 0
    assert np.abs(hist["xk"][0] - hist_u["xk"][0]).max() <= 1e-9 * step
