"""PyTorch port: particle sharding of the gather backend
(``parallel/sharding.py``) on 2 gloo ranks spawned on the CPU, against the
JAX package's 2-device mesh (the virtual CPU devices of tests/conftest.py)
and against the port's single-device path.

Tolerances, f64: padded scenes equal to JAX's exactly (the tables are
bit-identical since the gather backend's port); the padded loss equal to the
unpadded one to 1e-12 relative; the sharded loss 1e-10 relative and its
gradient 1e-9 of max |g| against JAX's sharded step and the port's single
device (the ranks sum their losses in another order, and JAX's sharded
gradient stands 1e-9 from the port's single-device one, the bar of
``tests/test_torch_gather.py``).  The body's top is clamped so that it
strains (a free-falling body's gradient wrt x is rounding).  The dry run
runs the tiny training step of ``__graft_entry__.dryrun_multichip`` on 2
CPU ranks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import build_scene as jbuild_scene
from softbody_tpu import warp_parity
from softbody_tpu.parallel import sharding as jsh
from softbody_tpu.scenarios import STRETCH, dirichlet_mask
from softbody_tpu.sim.rollout import loss_fn as jloss_fn
from softbody_tpu_torch.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu_torch.parallel import dryrun_multichip
from softbody_tpu_torch.parallel import sharding as sh
from softbody_tpu_torch.sim.rollout import loss_fn, value_and_grad_fn
from softbody_tpu_torch.sim.scene import build_scene
from softbody_tpu_torch.sim.sparse import build_sparse_scene

N_STEPS = 12
WORLD = 2


@pytest.fixture(scope="module")
def case():
    pts, out_num = inflatable_sphere(n_outer=64, radius=0.05)
    pts = pts[:len(pts) - 1 + len(pts) % 2]              # N odd: padding is needed
    cfg = warp_parity().replace(h=suggest_h(pts, 16), dtype="float64", target_frames=2,
                                **STRETCH)
    mask = dirichlet_mask(pts, "stretch")
    rng = np.random.default_rng(0)
    x = rng.normal(size=len(pts)) * 0.3
    tp = np.stack([pts * 1.01, pts * 1.02])
    tv = np.zeros_like(tp)
    return {"pts": pts, "cfg": cfg, "x": x, "tp": tp, "tv": tv,
            "t": build_scene(pts, cfg, out_num=out_num, dirichlet_mask=mask, device="cpu"),
            "j": jbuild_scene(pts, cfg, out_num=out_num, dirichlet_mask=mask)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def test_padding_matches_jax_and_keeps_the_loss(case):
    cfg, scene = case["cfg"], case["t"]
    padded, n0 = sh.pad_scene(scene, 8, cfg)
    jpadded, jn0 = jsh.pad_scene(case["j"], 8, cfg)
    assert n0 == jn0 == len(case["pts"]) and padded.rest_position.shape[0] % 8 == 0
    assert np.array_equal(padded.rest_position.numpy(), np.asarray(jpadded.rest_position))
    for a, b in zip(padded.materials, jpadded.materials):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for name in jpadded.topology._fields:
        assert np.array_equal(getattr(padded.topology, name).numpy(),
                              np.asarray(getattr(jpadded.topology, name))), name
    tp_p, tv_p = sh.pad_targets(case["tp"], case["tv"], padded, n0, cfg)
    jtp, jtv = jsh.pad_targets(jnp.asarray(case["tp"]), jnp.asarray(case["tv"]),
                               jpadded, n0, cfg)
    assert np.array_equal(tp_p.numpy(), np.asarray(jtp))
    assert np.array_equal(tv_p.numpy(), np.asarray(jtv))
    x_p = sh.pad_x(case["x"], padded, n0)
    assert np.array_equal(x_p.numpy(), np.asarray(jsh.pad_x(jnp.asarray(case["x"]),
                                                           jpadded, n0)))
    l0 = float(loss_fn(torch.as_tensor(case["x"]), scene, cfg, case["tp"], case["tv"],
                       n_steps=N_STEPS))
    l1 = float(loss_fn(x_p, padded, cfg, tp_p, tv_p, n_steps=N_STEPS))
    assert abs(l1 - l0) <= 1e-12 * l0


def test_slot_scenes_are_refused(case):
    """As JAX's ``sharding.py:50-66``: a sparse scene shards by slot groups."""
    cfg = case["cfg"].replace(backend="pallas")
    scene, _ = build_sparse_scene(case["pts"], cfg, device="cpu")
    group = sh.Group(0, WORLD, "cpu", "gloo")
    for fn in (lambda: sh.pad_scene(scene, WORLD, cfg),
               lambda: sh.shard_scene(scene, group)):
        with pytest.raises(NotImplementedError, match="gather-backend"):
            fn()


def test_shard_scene_keeps_global_neighbours(case):
    padded, _ = sh.pad_scene(case["t"], WORLD, case["cfg"])
    n = padded.rest_position.shape[0]
    for rank in range(WORLD):
        loc = sh.shard_scene(padded, sh.Group(rank, WORLD, "cpu", "gloo"))
        rows = slice(rank * n // WORLD, (rank + 1) * n // WORLD)
        assert torch.equal(loc.rest_position, padded.rest_position[rows])
        assert torch.equal(loc.topology.idx, padded.topology.idx[rows])
        assert loc.topology.inv_ptr.shape == (n + 1,)
        assert int(loc.topology.inv_ptr[-1]) == loc.topology.idx.numel()
    with pytest.raises(ValueError, match="pad_scene first"):
        sh.shard_scene(case["t"], sh.Group(0, WORLD, "cpu", "gloo"))


def test_sharded_loss_and_gradient_match_jax_and_one_device(case):
    cfg, scene = case["cfg"], case["t"]
    padded, n0 = sh.pad_scene(scene, WORLD, cfg)
    tp_p, tv_p = sh.pad_targets(case["tp"], case["tv"], padded, n0, cfg)
    x_p = sh.pad_x(case["x"], padded, n0)
    res = sh.spawn(sh.rank_episode, WORLD, padded, cfg, x_p, tp_p, tv_p, N_STEPS, True)
    loss = res[0][0]
    assert all(r[0] == loss for r in res)                # the same sum on every rank
    g = torch.cat([r[1] for r in res]).numpy()
    assert not g[n0:].any()                              # inert padding

    l_one, g_one = value_and_grad_fn(scene, cfg, n_steps=N_STEPS)(
        case["x"], case["tp"], case["tv"])
    assert abs(loss - l_one) <= 1e-10 * l_one
    assert _rel(g[:n0], g_one) <= 1e-9

    mesh = jsh.make_mesh(WORLD)
    jpadded, _ = jsh.pad_scene(case["j"], WORLD, cfg)
    sharded = jsh.shard_scene(jpadded, mesh)
    jtp, jtv = jsh.pad_targets(jnp.asarray(case["tp"]), jnp.asarray(case["tv"]),
                               jpadded, n0, cfg)
    jx = jax.device_put(jsh.pad_x(jnp.asarray(case["x"]), jpadded, n0),
                        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("p")))
    l_j, g_j = jax.jit(jax.value_and_grad(
        lambda xv, sc: jloss_fn(xv, sc, cfg, jtp, jtv, n_steps=N_STEPS)))(jx, sharded)
    assert abs(loss - float(l_j)) <= 1e-10 * float(l_j)
    assert _rel(g, np.asarray(g_j)) <= 1e-9


def test_sharded_forward_state_matches_one_device(case):
    cfg, scene = case["cfg"], case["t"]
    padded, n0 = sh.pad_scene(scene, WORLD, cfg)
    tp_p, tv_p = sh.pad_targets(case["tp"], case["tv"], padded, n0, cfg)
    res = sh.spawn(sh.rank_episode, WORLD, padded, cfg, sh.pad_x(case["x"], padded, n0),
                   tp_p, tv_p, N_STEPS)
    from softbody_tpu_torch.sim.rollout import rollout

    _, fin, _ = rollout(case["x"], scene, cfg, n_steps=N_STEPS, device="cpu")
    pos = torch.cat([r[1] for r in res])
    disp = float((fin.position - scene.rest_position).abs().max())
    assert float((pos[:n0] - fin.position).abs().max()) <= 1e-12 * disp
    assert torch.equal(pos[n0:], padded.rest_position[n0:])   # frozen padding


def test_dryrun_multichip_on_cpu_ranks():
    out = dryrun_multichip(WORLD, device="cpu", backend="gloo")
    assert len(out) == WORLD
    for r in out:
        assert set(r) == {"gather", "sparse", "halo", "launches"}
        assert not any(r.pop("launches").values())       # the plain versions ran
        for loss, grad in r.values():
            assert np.isfinite(loss) and bool(torch.isfinite(grad).all())
    assert out[0]["sparse"][0] == out[1]["sparse"][0]
