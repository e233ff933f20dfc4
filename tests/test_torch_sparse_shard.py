"""PyTorch port: the sparse SPMD episode (``parallel/sparse_shard.py``) on 2
gloo ranks spawned on the CPU (the kernels' plain versions), against the
JAX package's ``sparse_sharded_episode`` on a 2-device mesh (Pallas in
interpret mode) and the port's single-device path, on the same 2-shard
layout (``build_sparse_scene(..., n_shards=2)``), f64.

Tolerances: the stacked buckets and the halo plan's tables bit-identical
to JAX's; trajectories 1e-13 of the coordinates and the loss 1e-12
relative (JAX's own bars for its sharded episode, tests/test_sparse_shard.py:
another summation order of the ranks' losses); the gradient 1e-9 of max
|g| against JAX's sharded gradient and the port's single-device one, for
the all-gather and the halo source alike.  The body straddles the shard
boundary: the halo moves groups both ways, and the gradient of the slots
other ranks read, whose cotangents come home through the exchange's
backward, matches.  The obstacle and contact case (JAX runs its own as a
slow test, ~130 s) is held against the port's single-device path, which
tests/test_torch_obstacles.py and tests/test_torch_contact.py hold
against JAX."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import warp_parity as jwarp
from softbody_tpu.parallel import sparse_shard as jss
from softbody_tpu.parallel.sharding import make_mesh
from softbody_tpu.scenarios import STRETCH, dirichlet_mask
from softbody_tpu.sim.sparse import build_sparse_scene as jbuild
from softbody_tpu_torch import warp_parity
from softbody_tpu_torch.convert import scene_from_numpy
from softbody_tpu_torch.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu_torch.ops import obstacles as obs
from softbody_tpu_torch.ops.contact import build_contact_grid, slot_exclude
from softbody_tpu_torch.parallel import sparse_shard as ss
from softbody_tpu_torch.parallel.sharding import spawn
from softbody_tpu_torch.sim.rollout import rollout, value_and_grad_fn
from softbody_tpu_torch.sim.sparse import build_sparse_scene

from tests.test_torch_helpers import jax_scene_dict

N_STEPS = 10
WORLD = 2


def _targets(scene_rest, sop, ns, cfg):
    base = np.asarray(scene_rest, np.float64)
    tp = np.stack([base * 1.02, base * 1.04])
    tv = np.zeros_like(tp)
    pad = np.ones(ns, bool)
    pad[sop] = False
    tp[:, pad] = base[pad]                 # padding slots' terms exactly zero
    tv[:, pad] = np.asarray(cfg.initial_velocity, np.float64)
    return tp, tv


@pytest.fixture(scope="module")
def case():
    pts, out_num = inflatable_sphere(n_outer=64, radius=0.05)
    cfg = jwarp().replace(h=suggest_h(pts, 16), dtype="float64", target_frames=2,
                          backend="pallas", **STRETCH)
    scene_j, sop = jbuild(pts, cfg, out_num=out_num, rows=32, n_shards=WORLD,
                          dirichlet_mask=dirichlet_mask(pts, "stretch"))
    sop = np.asarray(sop)
    scene_t, _ = scene_from_numpy(jax_scene_dict(scene_j) | {"n_shards": WORLD}, "cpu")
    ns = scene_j.blocked.n_slots
    x = np.zeros(ns)
    x[sop] = np.random.default_rng(0).normal(size=len(pts)) * 0.3
    tp, tv = _targets(scene_j.rest_position, sop, ns, cfg)
    return {"pts": pts, "cfg": cfg, "j": scene_j, "t": scene_t, "sop": sop, "x": x,
            "tp": tp, "tv": tv, "m": scene_j.blocked.n_tiles * scene_j.blocked.rows}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_layout_tables_bit_identical_to_jax(case):
    sbt, sbj = case["t"].blocked, case["j"].blocked
    assert sbt.n_shards == sbj.n_shards == WORLD
    got, meta = ss.stack_shard_buckets(sbt)
    want, jmeta = jss.stack_shard_buckets(sbj)
    assert meta == jmeta and len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("gidx8", "restT_rows", "static_slab"):
            assert np.array_equal(g[key].numpy(), np.asarray(w[key])), key
    plan, hstack, hmeta = ss.build_halo_plan(sbt)
    jplan, jstack, jhmeta = jss.build_halo_plan(sbj)
    assert (plan.halo_rows, plan.n_local_groups, plan.rounds, plan.n_shards) == (
        jplan.halo_rows, jplan.n_local_groups, jplan.rounds, jplan.n_shards)
    assert 0 < plan.halo_rows < case["m"] // 8           # strictly less than all of it
    for a, b in zip(plan.send_idx, jplan.send_idx):
        assert a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))
    for g, w in zip(hstack, jstack):
        assert np.array_equal(g["gidx8"].numpy(), np.asarray(w["gidx8"]))
    assert hmeta == jhmeta


@pytest.fixture(scope="module")
def jax_episode(case):
    mesh = make_mesh(WORLD)
    args = (case["j"], case["cfg"], jnp.asarray(case["tp"]), jnp.asarray(case["tv"]), mesh)
    loss, (pos, vel) = jax.jit(lambda xv: jss.sparse_sharded_episode(
        xv, *args, n_steps=N_STEPS))(jnp.asarray(case["x"]))
    _, g = jss.sparse_sharded_value_and_grad(case["j"], case["cfg"], mesh,
                                             n_steps=N_STEPS)(
        jnp.asarray(case["x"]), jnp.asarray(case["tp"]), jnp.asarray(case["tv"]))
    return float(loss), np.asarray(pos), np.asarray(vel), np.asarray(g)


@pytest.mark.parametrize("halo", [False, True], ids=["all_gather", "halo"])
def test_episode_matches_jax_and_one_device(case, jax_episode, halo):
    cfg, scene = case["cfg"], case["t"]
    args = (scene, cfg, case["x"], case["tp"], case["tv"], N_STEPS, halo)
    fwd = spawn(ss.rank_sparse, WORLD, *args)
    loss, pos, vel = fwd[0]
    assert all(r[0] == loss and torch.equal(r[1], pos) for r in fwd)
    l_j, pos_j, vel_j, g_j = jax_episode
    assert abs(loss - l_j) <= 1e-12 * l_j
    np.testing.assert_allclose(pos.numpy(), pos_j, rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(vel.numpy(), vel_j, rtol=1e-10, atol=1e-10)

    m = case["m"]
    l_one, fin, _ = rollout(case["x"], scene, cfg, case["tp"], case["tv"],
                            n_steps=N_STEPS, device="cpu")
    assert abs(loss - float(l_one)) <= 1e-12 * float(l_one)
    np.testing.assert_allclose(pos.numpy(), fin.position[:m].numpy(), rtol=1e-10,
                               atol=1e-13)

    grads = spawn(ss.rank_sparse, WORLD, *args, True)
    g = grads[0][1]
    assert torch.equal(g, grads[1][1]) and not g[m:].any()
    _, g_one = value_and_grad_fn(scene, cfg, n_steps=N_STEPS)(case["x"], case["tp"],
                                                               case["tv"])
    assert _rel(g, g_j) <= 1e-9
    assert _rel(g, g_one) <= 1e-9
    # the slots another rank reads: their cotangents come home through the
    # exchange's backward
    plan, _, _ = ss.build_halo_plan(scene.blocked)
    gpl = plan.n_local_groups
    sent = np.concatenate([s * gpl + idx[s] for idx in plan.send_idx
                           for s in range(WORLD)])
    slots = (sent[:, None] * 8 + np.arange(8)).ravel()
    slots = slots[np.isin(slots, case["sop"])]
    assert len(slots) and np.abs(g_one[slots].numpy()).max() > 0
    assert np.abs(g[slots].numpy() - g_one[slots].numpy()).max() <= (
        1e-9 * np.abs(g_one.numpy()).max())


def test_bf16_slab_matches_one_device(case):
    """The bf16 K2 slab, cast before the exchange: the single-device bf16
    path's loss and gradient (f64 arithmetic)."""
    cfg = case["cfg"].replace(pair_dtype="bfloat16")
    scene = case["t"]
    for halo in (False, True):
        loss, g = spawn(ss.rank_sparse, WORLD, scene, cfg, case["x"], case["tp"],
                        case["tv"], N_STEPS, halo, True)[0]
        l_one, g_one = value_and_grad_fn(scene, cfg, n_steps=N_STEPS)(
            case["x"], case["tp"], case["tv"])
        assert abs(loss - l_one) <= 1e-12 * l_one
        assert _rel(g, g_one) <= 1e-9


def test_obstacles_and_contact_match_one_device():
    """A plane cutting into the body and a contact grid with r_c above the
    rest spacing (as tests/test_sparse_shard.py sets them), each particle's
    first 4 rest neighbours excluded (the exclude table sharded by rows):
    the all-gather and the halo episode against the port's single-device
    rollout."""
    pts, out_num = inflatable_sphere(n_outer=64, radius=0.05)
    h = suggest_h(pts, 16)
    cfg = warp_parity().replace(h=h, dtype="float64", dt=1e-6, target_frames=2,
                                backend="pallas")
    obstacles = obs.make(obs.plane([0.0, 1.0, 0.0], float(pts[:, 1].min()) + 0.01),
                         stiffness=1e4, margin=1e-3)
    scene, sop = build_sparse_scene(pts, cfg, out_num=out_num, n_shards=WORLD,
                                    obstacles=obstacles, device="cpu")
    from softbody_tpu_torch.topology.neighbors import build_topology

    topo, _, _ = build_topology(pts, np.full(len(pts), cfg.mass), cfg)
    grid = build_contact_grid(pts.min(0) - 0.02, pts.max(0) + 0.02, r_c=1.2 * h, cap=64,
                              stiffness=1e4,
                              exclude=slot_exclude(topo.idx[:, :4], sop,
                                                   scene.blocked.n_slots))
    scene = scene._replace(contact=grid)
    ns = scene.blocked.n_slots
    m = scene.blocked.n_tiles * scene.blocked.rows
    x = np.zeros(ns)
    x[sop] = np.random.default_rng(1).normal(size=len(pts)) * 0.3
    tp, tv = _targets(scene.rest_position, sop, ns, cfg)
    l_one, fin, _ = rollout(x, scene, cfg, tp, tv, n_steps=N_STEPS, device="cpu")
    from softbody_tpu_torch.ops.contact import contact_forces
    from softbody_tpu_torch.ops.obstacles import penalty_force

    assert float(contact_forces(fin.position, grid).abs().max()) > 0
    assert float(penalty_force(obstacles, fin.position[:m]).abs().max()) > 0
    for halo in (False, True):
        loss, pos, _ = spawn(ss.rank_sparse, WORLD, scene, cfg, x, tp, tv, N_STEPS,
                             halo)[0]
        np.testing.assert_allclose(pos.numpy(), fin.position[:m].numpy(), rtol=1e-10,
                                   atol=1e-13)
        assert abs(loss - float(l_one)) <= 1e-12 * float(l_one)
