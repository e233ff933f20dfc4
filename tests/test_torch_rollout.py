"""PyTorch port: short episodes against the JAX package in f64 — final
state, recorded frames and the Neumaier (hi, lo) loss at 1e-9 relative —
on the stretch scenario (symplectic, clamp, targets + record_every) and on
``warp_parity`` (trapezoidal, ground collision with the damper); plus the
reference layout of ``generate_targets``."""

import numpy as np
import jax
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.scenarios import STRETCH, dirichlet_mask
from softbody_tpu.sim.rollout import rollout as jrollout
from softbody_tpu_torch.opt.driver import generate_targets, load_targets
from softbody_tpu_torch.sim.rollout import acc_float, rollout
from softbody_tpu_torch.sim.sparse import build_sparse_scene

from tests.test_torch_helpers import both_scenes, small_body, to_jax

TOL = 1e-9
N_STEPS = 8
RECORD = 2


def _targets(scene_j, sop, n, seed):
    """n target frames: the rest body shifted and jittered (padding slots at
    rest with the initial velocity, so they add nothing)."""
    rng = np.random.default_rng(seed)
    rest = np.asarray(scene_j.rest_position, np.float64)
    tp = np.tile(rest, (n, 1, 1))
    tv = np.zeros_like(tp)
    tp[:, sop] += rng.normal(scale=1e-4, size=(n, len(sop), 3))
    tv[:, sop] += rng.normal(scale=1e-2, size=(n, len(sop), 3))
    return tp, tv


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _compare(cfg, pts, seed, **build_kw):
    scene_j, scene_t, sop = both_scenes(pts, cfg, **build_kw)
    ns = scene_j.blocked.n_slots
    x = np.zeros(ns)
    x[sop] = np.random.default_rng(seed).normal(scale=0.5, size=len(sop))
    tp, tv = _targets(scene_j, sop, N_STEPS // RECORD, seed + 1)
    run = jax.jit(lambda xv, sc, p, v: jrollout(
        xv, sc, cfg, p, v, n_steps=N_STEPS, record_every=RECORD, acc_pair=True))
    acc_j, fin_j, rec_j = run(to_jax(x, "float64"), scene_j,
                              to_jax(tp, "float64"), to_jax(tv, "float64"))
    acc_t, fin_t, rec_t = rollout(x, scene_t, cfg, tp, tv, n_steps=N_STEPS,
                                  record_every=RECORD, acc_pair=True,
                                  device="cpu")
    disp = np.asarray(fin_j.position) - np.asarray(scene_j.rest_position)
    assert np.abs(disp).max() > 0
    # displacement-relative: the absolute positions would hide the motion
    assert _rel(fin_t.position.numpy() - np.asarray(scene_j.rest_position),
                disp) < TOL
    assert _rel(fin_t.velocity.numpy(), fin_j.velocity) < TOL
    assert rec_t[0].shape == (N_STEPS // RECORD, ns, 3)
    assert _rel(rec_t[0].numpy() - np.asarray(scene_j.rest_position),
                np.asarray(rec_j[0]) - np.asarray(scene_j.rest_position)) < TOL
    assert _rel(rec_t[1].numpy(), rec_j[1]) < TOL
    loss_j, loss_t = acc_float(acc_j), acc_float(acc_t)
    assert loss_j > 0
    assert abs(loss_t - loss_j) <= TOL * loss_j, (loss_t, loss_j)


def test_stretch_episode_matches_jax():
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                frames=N_STEPS, target_frames=N_STEPS // RECORD,
                                **STRETCH)
    _compare(cfg, pts, seed=0, out_num=out_num,
             dirichlet_mask=dirichlet_mask(pts, "stretch"))


def test_warp_parity_trapezoidal_collision_matches_jax():
    pts, out_num, h = small_body()
    pts = pts - np.array([0.0, pts[:, 1].min() - 5e-5, 0.0])  # base in contact
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                dt=1e-6, collision_damping=50.0,
                                frames=N_STEPS, target_frames=N_STEPS // RECORD)
    assert cfg.integrator == "trapezoidal" and cfg.collision
    _compare(cfg, pts, seed=2, out_num=out_num)


def test_generate_targets_reference_layout(tmp_path):
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                frames=4, target_frames=2, **STRETCH)
    scene, sop = build_sparse_scene(pts, cfg, out_num=out_num,
                                    dirichlet_mask=dirichlet_mask(pts, "stretch"),
                                    device="cpu")
    x = np.zeros(scene.blocked.n_slots)
    x[sop] = 0.3
    pos, vel = generate_targets(x, scene, cfg, tmp_path, particle_index=sop,
                                device="cpu")
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["position_1.npy", "position_2.npy",
                     "velocity_1.npy", "velocity_2.npy"]
    assert pos.shape == vel.shape == (2, len(pts), 3)
    _, fin, rec = rollout(x, scene, cfg, n_steps=4, record_every=2, device="cpu")
    np.testing.assert_array_equal(pos, rec[0].numpy()[:, sop])
    np.testing.assert_array_equal(pos[-1], fin.position.numpy()[sop])
    tp, tv = load_targets(tmp_path, 2)
    np.testing.assert_array_equal(tp, pos)
    np.testing.assert_array_equal(tv, vel)
    with pytest.raises(ValueError, match="multiple"):
        generate_targets(x, scene, cfg, tmp_path, n_steps=5, device="cpu")


@pytest.mark.parametrize("preset", ["stretch", "warp_parity"])
def test_elastic_fn_hook_reproduces_step(preset):
    """``elastic_fn`` given as the default force evaluation reproduces
    ``initial_state`` and ``step`` bit for bit, symplectic (stretch) and
    trapezoidal (warp_parity), as the SPMD paths rely on."""
    from softbody_tpu_torch import warp_parity as twarp
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.sim.rollout import elastic_forces, initial_state, step

    pts, out_num, h = small_body()
    extra = STRETCH if preset == "stretch" else {}
    cfg = twarp().replace(h=h, dtype="float64", backend="pallas", **extra)
    scene, sop = build_sparse_scene(pts, cfg, out_num=out_num, device="cpu")
    x = np.zeros(scene.blocked.n_slots)
    x[sop] = np.random.default_rng(4).normal(scale=0.5, size=len(sop))
    ratio = compute_ratio(torch.as_tensor(x), cfg)
    hook = lambda p: elastic_forces(p, ratio, scene, cfg)  # noqa: E731
    a = initial_state(scene, ratio, cfg)
    b = initial_state(scene, ratio, cfg, elastic_fn=hook)
    for _ in range(3):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        a, b = step(a, ratio, scene, cfg), step(b, ratio, scene, cfg, elastic_fn=hook)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert float((a.position - scene.rest_position).abs().max()) > 0
