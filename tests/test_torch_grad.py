"""PyTorch port: gradients against the JAX package and against themselves,
f64 on the small parity body.

* the polar rotation's clamped analytic VJP vs JAX ``mat3.polar3``'s, 1e-12,
  including singular values whose pair sums reach the 1e-6 clamp;
* the VJP of ``elastic_forces_sparse`` wrt (positions, x) vs ``jax.vjp`` of
  the JAX function (Pallas kernels in interpret mode), 1e-10 — the JAX suite
  holds its own VJP to 1e-11 (tests/test_sparse.py:77-118);
* the episode gradient's cuts: chunked (uneven), sqrt-nested remat and no
  remat against linear per-step remat, 1e-9 (as tests/test_chunked_vjp.py
  and tests/test_rollout.py:132-151 hold the JAX runner);
* central finite differences at the largest |g|, 2e-4 relative
  (tests/test_rollout.py:108-115).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops import mat3 as jmat3
from softbody_tpu.ops.elasticity import compute_ratio as jratio
from softbody_tpu.scenarios import STRETCH, dirichlet_mask
from softbody_tpu.sim.sparse import elastic_forces_sparse as jforces
from softbody_tpu_torch.ops import mat3
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.sim.rollout import (episode_value_and_grad_chunked,
                                            forward_chunked, loss_fn, rollout,
                                            value_and_grad_fn)
from softbody_tpu_torch.sim.sparse import elastic_forces_sparse

from tests.test_torch_helpers import both_scenes, perturbed, small_body, to_jax

N_STEPS = 8


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _polar_cases():
    rng = np.random.default_rng(11)
    rand = rng.normal(size=(32, 3, 3))
    q, _ = np.linalg.qr(rng.normal(size=(8, 3, 3)))
    # sigma pairs below the clamp: sigma_2 + sigma_3 = 4e-8 < 1e-6
    near = q @ np.diag([1.0, 1e-8, 3e-8]) @ np.swapaxes(q, 1, 2)
    flat = np.array([np.diag([1.0, 0.0, 0.0]), np.diag([2.0, 1.0, 0.0]),
                     np.diag([1.0, 1.0, -1.0]), np.eye(3) * 1e-9])
    return {"random": rand, "near_degenerate": near, "degenerate": flat}


@pytest.mark.parametrize("case", ["random", "near_degenerate", "degenerate"])
def test_polar_vjp_matches_jax(case):
    A = np.ascontiguousarray(np.moveaxis(_polar_cases()[case], 0, -1))
    G = np.random.default_rng(12).normal(size=A.shape)
    _, vjp = jax.vjp(lambda a: jmat3.polar3(a), jnp.asarray(A))
    (want,) = vjp(jnp.asarray(G))
    a = torch.as_tensor(A).requires_grad_()
    (got,) = torch.autograd.grad(mat3.polar3(a), a, torch.as_tensor(G))
    got, want = got.numpy(), np.asarray(want)
    assert np.isfinite(got).all()
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= 1e-12 * scale
    if case == "near_degenerate":
        assert np.abs(want).max() > 1e4        # the clamped 1/(sigma_i + sigma_j)
    # the mid-section's component form goes through the same VJP
    comps = mat3.unpack(a)
    (got_c,) = torch.autograd.grad(mat3.pack(mat3.polar3_components(comps)), a,
                                   torch.as_tensor(G))
    assert torch.equal(got_c, torch.as_tensor(got))


@pytest.fixture(scope="module")
def force_vjp():
    """jax.vjp of the JAX elastic_forces_sparse wrt (pos, x), computed once."""
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", dt=1e-6, backend="pallas")
    scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num)
    rng = np.random.default_rng(13)
    pos = perturbed(scene_j, sop, 1e-2 * h, seed=13)
    x = np.zeros(scene_j.blocked.n_slots)
    x[sop] = rng.normal(scale=0.5, size=len(sop))
    ct = np.zeros_like(pos)
    ct[sop] = rng.normal(size=(len(sop), 3))

    def f(p, xv):
        return jforces(p, jratio(xv, cfg), scene_j.materials, scene_j, cfg,
                       interpret=True)

    _, vjp = jax.vjp(f, to_jax(pos, "float64"), to_jax(x, "float64"))
    want = [np.asarray(g) for g in vjp(to_jax(ct, "float64"))]
    return cfg, scene_t, pos, x, ct, want


def test_force_vjp_matches_jax(force_vjp):
    cfg, scene_t, pos, x, ct, (dpos_j, dx_j) = force_vjp
    p = torch.as_tensor(pos).requires_grad_()
    xv = torch.as_tensor(x).requires_grad_()
    f = elastic_forces_sparse(p, compute_ratio(xv, cfg), scene_t.materials,
                              scene_t, cfg)
    dpos, dx = torch.autograd.grad(f, (p, xv), torch.as_tensor(ct))
    assert np.abs(dpos_j).max() > 0 and np.abs(dx_j).max() > 0
    assert _rel(dpos, dpos_j) < 1e-10, _rel(dpos, dpos_j)
    assert _rel(dx, dx_j) < 1e-10, _rel(dx, dx_j)


@pytest.fixture(scope="module")
def episode():
    """The stretch scene (port-built, f64), x, and jittered-rest targets:
    every frame term pulls the same way, so the gradient is well above its
    roundings."""
    from softbody_tpu_torch.sim.sparse import build_sparse_scene

    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                frames=N_STEPS, target_frames=N_STEPS // 2,
                                **STRETCH)
    scene, sop = build_sparse_scene(pts, cfg, out_num=out_num, device="cpu",
                                    dirichlet_mask=dirichlet_mask(pts, "stretch"))
    rng = np.random.default_rng(14)
    x = np.zeros(scene.blocked.n_slots)
    x[sop] = rng.normal(scale=0.5, size=len(sop))
    tp = np.tile(scene.rest_position.numpy(), (N_STEPS // 2, 1, 1))
    tp[:, sop] += rng.normal(scale=1e-4, size=(N_STEPS // 2, len(sop), 3))
    tv = np.zeros_like(tp)
    loss, grad = value_and_grad_fn(scene, cfg.replace(remat_chunk=0))(x, tp, tv)
    return cfg, scene, x, tp, tv, loss, grad.numpy()


@pytest.mark.parametrize("cut", ["chunked_uneven", "nested_remat", "no_remat"])
def test_gradient_cuts_match_linear_remat(episode, cut):
    cfg, scene, x, tp, tv, loss, grad = episode
    if cut == "chunked_uneven":      # 8 = 3 + 3 + 2
        vg = episode_value_and_grad_chunked(scene, cfg, 3)
    elif cut == "nested_remat":      # chunks of 3 and a 2-step tail
        vg = value_and_grad_fn(scene, cfg.replace(remat_chunk=3))
    else:
        vg = value_and_grad_fn(scene, cfg.replace(remat=False))
    loss_c, grad_c = vg(x, tp, tv)
    assert loss > 0 and np.abs(grad).max() > 0
    assert abs(loss_c - loss) <= 1e-9 * loss
    assert _rel(grad_c, grad) <= 1e-9


def test_rollout_autograd_matches_value_and_grad(episode):
    cfg, scene, x, tp, tv, loss, grad = episode
    xv = torch.as_tensor(x).requires_grad_()
    (g,) = torch.autograd.grad(loss_fn(xv, scene, cfg, tp, tv), xv)
    assert _rel(g, grad) <= 1e-9


def test_gradient_matches_central_differences(episode):
    cfg, scene, x, tp, tv, loss, grad = episode
    i = int(np.argmax(np.abs(grad)))
    for eps in (1e-4, 1e-5):
        xp, xm = x.copy(), x.copy()
        xp[i] += eps
        xm[i] -= eps
        with torch.no_grad():
            num = (float(loss_fn(xp, scene, cfg, tp, tv))
                   - float(loss_fn(xm, scene, cfg, tp, tv))) / (2 * eps)
        assert abs(grad[i] - num) < 2e-4 * max(abs(num), abs(grad[i])), (eps, grad[i], num)


def test_forward_chunked_matches_rollout(episode):
    cfg, scene, x, *_ = episode
    _, final, rec = rollout(x, scene, cfg, n_steps=N_STEPS, record_every=4,
                            device="cpu")
    state, recorded = forward_chunked(x, scene, cfg, N_STEPS, chunk_len=2,
                                      record_every=4)
    assert torch.equal(state.position, final.position)
    assert len(recorded) == 2 and torch.equal(recorded[0], rec[0][0])
    with pytest.raises(ValueError, match="multiple"):
        forward_chunked(x, scene, cfg, N_STEPS, chunk_len=3, record_every=4)
