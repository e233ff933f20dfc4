"""PyTorch port: the gather backend's halo exchange (``parallel/halo.py``)
on 2 gloo ranks spawned on the CPU, against the JAX package's on a 2-device
mesh and against the dense single-device path, on a Morton-sorted body
(``topology/sort.morton_sort``, as tests/test_halo.py sorts it).

Tolerances, f64: the halo plans bit-identical to JAX's (2, 4 and 8
shards); the elastic forces 1e-10 of max |f| against JAX's halo forces and
the port's dense forces (JAX's own halo test holds them to 1e-9 of the
dense ones); the halo rollout's loss 1e-9 relative and final positions
1e-12 against JAX's halo rollout and the port's dense rollout (the bars of
tests/test_halo.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import build_scene as jbuild_scene
from softbody_tpu import taichi_parity, warp_parity
from softbody_tpu.ops.elasticity import compute_ratio as jratio
from softbody_tpu.parallel import halo as jhalo
from softbody_tpu.parallel.sharding import make_mesh, particle_sharding
from softbody_tpu_torch.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu_torch.ops.elasticity import compute_ratio, elastic_forces
from softbody_tpu_torch.parallel import halo
from softbody_tpu_torch.parallel.sharding import spawn
from softbody_tpu_torch.sim.rollout import loss_fn, rollout
from softbody_tpu_torch.sim.scene import build_scene
from softbody_tpu_torch.topology.sort import morton_sort

WORLD = 2


def sorted_body(n_outer=96, d=WORLD):
    pts, _ = inflatable_sphere(n_outer=n_outer, radius=0.05)
    return pts[: len(pts) - (len(pts) % d)]


def _scenes(cfg, pts):
    pts = pts[morton_sort(pts, 2 * cfg.h)]
    return pts, build_scene(pts, cfg, device="cpu"), jbuild_scene(pts, cfg)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_halo_plan_bit_identical_to_jax(d):
    pts = sorted_body(d=8)
    cfg = warp_parity().replace(h=suggest_h(pts, 14), dtype="float64")
    _, scene, _ = _scenes(cfg, pts)
    idx = scene.topology.idx.numpy()
    got, want = halo.build_halo_plan(idx, d), jhalo.build_halo_plan(idx, d)
    assert (got.n_devices, got.shard, got.halo, got.hops, got.ext) == (
        want.n_devices, want.shard, want.halo, want.hops, want.ext)
    for a, b in ((got.send_idx, want.send_idx), (got.local_idx, want.local_idx)):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))
    assert got.hops < d or d == 2
    assert int(got.local_idx.max()) < got.ext


@pytest.mark.parametrize("preset", [warp_parity, taichi_parity])
def test_halo_forces_match_jax_and_dense(preset):
    pts = sorted_body()
    cfg = preset().replace(h=suggest_h(pts, 14), dtype="float64")
    pts, scene, scene_j = _scenes(cfg, pts)
    rng = np.random.default_rng(3)
    F = np.eye(3) + 0.05 * rng.normal(size=(3, 3))
    pos = (pts - pts.mean(0)) @ F.T + pts.mean(0)
    x = rng.normal(size=len(pts)) * 0.4
    res = spawn(halo.rank_halo, WORLD, scene, cfg, x, None, None, None,
                torch.as_tensor(pos))
    f = torch.cat([r[0] for r in res]).numpy()
    dense = elastic_forces(torch.as_tensor(pos), compute_ratio(torch.as_tensor(x), cfg),
                           scene.materials, scene.topology, cfg)[0].numpy()
    scale = np.abs(dense).max()
    assert np.abs(f - dense).max() <= 1e-10 * scale

    plan = jhalo.build_halo_plan(scene.topology.idx.numpy(), WORLD)
    mesh = make_mesh(WORLD)
    f_j = jax.jit(lambda p, r: jhalo.elastic_forces_halo(p, r, scene_j, plan, mesh, cfg))(
        jax.device_put(jnp.asarray(pos), particle_sharding(mesh, 2)),
        jax.device_put(jratio(jnp.asarray(x), cfg), particle_sharding(mesh, 1)))
    assert np.abs(f - np.asarray(f_j)).max() <= 1e-10 * scale


def test_halo_rollout_matches_jax_and_dense():
    pts = sorted_body()
    cfg = warp_parity().replace(
        h=suggest_h(pts, 14), dtype="float64", dt=1e-6, target_frames=2,
        initial_velocity=(0.0, -0.4, 0.0), external_force=(0.0, -1e-3, 0.0))
    pts, scene, scene_j = _scenes(cfg, pts)
    x = np.random.default_rng(7).normal(size=len(pts)) * 0.3
    tp = np.stack([pts * 1.1, pts * 1.2])
    tv = np.zeros_like(tp)
    res = spawn(halo.rank_halo, WORLD, scene, cfg, x, tp, tv, 10)
    loss = res[0][0][0]
    assert all(r[0][0] == loss for r in res)
    pos = torch.cat([r[0][1] for r in res]).numpy()

    l_ref = float(loss_fn(x, scene, cfg, tp, tv, n_steps=10))
    _, fin, _ = rollout(x, scene, cfg, n_steps=10, device="cpu")
    assert abs(loss - l_ref) <= 1e-9 * l_ref
    assert np.abs(pos - fin.position.numpy()).max() <= 1e-12

    plan = jhalo.build_halo_plan(scene.topology.idx.numpy(), WORLD)
    mesh = make_mesh(WORLD)
    x_sh = jax.device_put(jnp.asarray(x), particle_sharding(mesh, 1))
    l_j, fin_j = jax.jit(lambda q: jhalo.halo_rollout(
        q, scene_j, plan, mesh, cfg, jnp.asarray(tp), jnp.asarray(tv), n_steps=10))(x_sh)
    assert abs(loss - float(l_j)) <= 1e-9 * float(l_j)
    assert np.abs(pos - np.asarray(fin_j.position)).max() <= 1e-12
