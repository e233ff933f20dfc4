"""PyTorch port: the loss and dloss/dx of a short episode against the JAX
package's ``value_and_grad_fn`` (Pallas kernels in interpret mode), f64,
1e-9 relative — on the stretch scenario (symplectic, clamp) and on
``warp_parity`` (trapezoidal, ground collision with the damper), the two
integrators and force paths ``tests/test_torch_rollout.py`` holds forward.

Both cases clamp the top of the body so that it strains from the first
step.  A body in free fall with one particle on the ground barely strains:
there F = I + O(1e-10), E = (F^T F - I) / 2 keeps only a few digits, and
the gradient wrt x away from the contact is rounding (measured: JAX and the
port then differ by 1e-7 of max |g| at 40 steps, while with the clamp they
agree to 2e-11).  The stretch load strains slowly, so that case runs 40
steps."""

import numpy as np
import pytest

from softbody_tpu import warp_parity
from softbody_tpu.scenarios import STRETCH, dirichlet_mask
from softbody_tpu.sim.rollout import value_and_grad_fn as jvalue_and_grad_fn
from softbody_tpu_torch.sim.rollout import value_and_grad_fn

from tests.test_torch_helpers import both_scenes, small_body, to_jax

TOL = 1e-9
FRAMES = 4


def _compare(cfg, pts, seed, **build_kw):
    n_steps = cfg.frames
    scene_j, scene_t, sop = both_scenes(pts, cfg, **build_kw)
    rng = np.random.default_rng(seed)
    x = np.zeros(scene_j.blocked.n_slots)
    x[sop] = rng.normal(scale=0.5, size=len(sop))
    # jittered rest targets (padding slots at rest with the initial velocity)
    tp = np.tile(np.asarray(scene_j.rest_position, np.float64), (FRAMES, 1, 1))
    tv = np.zeros_like(tp) + np.asarray(cfg.initial_velocity)
    tp[:, sop] += rng.normal(scale=1e-4, size=(FRAMES, len(sop), 3))
    tv[:, sop] += rng.normal(scale=1e-2, size=(FRAMES, len(sop), 3))
    loss_j, grad_j = jvalue_and_grad_fn(scene_j, cfg, n_steps=n_steps)(
        to_jax(x, "float64"), to_jax(tp, "float64"), to_jax(tv, "float64"))
    loss_t, grad_t = value_and_grad_fn(scene_t, cfg, n_steps=n_steps)(x, tp, tv)
    grad_j = np.asarray(grad_j)
    assert loss_j > 0 and np.abs(grad_j).max() > 0
    assert abs(loss_t - loss_j) <= TOL * loss_j, (loss_t, loss_j)
    err = np.abs(grad_t.numpy() - grad_j).max() / np.abs(grad_j).max()
    assert err <= TOL, err


def test_stretch_episode_gradient_matches_jax():
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                frames=40, target_frames=FRAMES, **STRETCH)
    _compare(cfg, pts, seed=20, out_num=out_num,
             dirichlet_mask=dirichlet_mask(pts, "stretch"))


def test_warp_parity_collision_episode_gradient_matches_jax():
    pts, out_num, h = small_body()
    pts = pts - np.array([0.0, pts[:, 1].min() - 5e-5, 0.0])  # base in contact
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                dt=1e-6, collision_damping=50.0,
                                frames=8, target_frames=FRAMES)
    assert cfg.integrator == "trapezoidal" and cfg.collision
    _compare(cfg, pts, seed=21, out_num=out_num,
             dirichlet_mask=dirichlet_mask(pts, "stretch"))
