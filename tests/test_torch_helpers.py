"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py).

One small procedural body (``inflatable_sphere(n_outer=200)``, as
tests/test_sparse.py uses) built by both packages, the flattening of a JAX
sparse ``Scene`` into the dict ``softbody_tpu_torch.convert.scene_from_numpy``
reads, and seeded numpy inputs.  The tests here hold the helpers themselves.
"""

import numpy as np
import jax.numpy as jnp
import torch

from softbody_tpu.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu.sim.sparse import build_sparse_scene as jax_build_sparse_scene
from softbody_tpu_torch.convert import scene_from_numpy

_MATERIALS = ("mass", "volume", "mu", "lam", "free", "external")

# The port's tests run thousands of small eager ops.  Under pytest-xdist each
# worker shares the cores with the others, and torch's intra-op thread pool
# then spends its time waiting for them (the same four gradient tests took
# 195 s instead of 12 s beside five busy processes), so every process that
# imports this harness runs torch on one thread.
torch.set_num_threads(1)


def small_body():
    """(points, out_num, h) of the small parity body."""
    pts, out_num = inflatable_sphere(n_outer=200)
    return pts, out_num, suggest_h(pts, 32)


def jax_scene_dict(scene, x=None) -> dict:
    """Every leaf of a JAX sparse Scene as numpy, plus the bucket metadata,
    in the layout ``scene_from_numpy`` reads."""
    sb = scene.blocked
    d = {
        "rest_position": np.asarray(scene.rest_position),
        "rest_corr": np.asarray(scene.rest_corr),
        "slot_of_particle": np.asarray(scene.slot_of_particle),
        "rs6T": np.asarray(sb.rs6T),
        "out_num": int(scene.out_num),
        "rows": int(sb.rows),
        "n_tiles": int(sb.n_tiles),
        "n_slots": int(sb.n_slots),
        "group": int(sb.group),
        "n_buckets": len(sb.buckets),
    }
    for k, name in enumerate(_MATERIALS):
        d[name] = np.asarray(scene.materials[k])
    for k, b in enumerate(sb.buckets):
        d[f"bucket{k}.gidx8"] = np.asarray(b.gidx8)
        d[f"bucket{k}.restT_rows"] = np.asarray(b.restT_rows)
        d[f"bucket{k}.static_slab"] = np.asarray(b.static_slab)
        d[f"bucket{k}.tile_start"] = int(b.tile_start)
    if x is not None:
        d["x"] = np.asarray(x)
    return d


def both_scenes(pts, cfg, **kw):
    """The JAX sparse scene and the same scene carried into the port (CPU)."""
    scene_j, sop = jax_build_sparse_scene(pts, cfg, **kw)
    scene_t, _ = scene_from_numpy(jax_scene_dict(scene_j), "cpu")
    return scene_j, scene_t, np.asarray(sop)


def perturbed(scene_j, sop, scale, seed):
    """Slot-space rest positions with seeded noise on the particle slots."""
    rng = np.random.default_rng(seed)
    pos = np.asarray(scene_j.rest_position, np.float64).copy()
    pos[sop] += rng.normal(scale=scale, size=(len(sop), 3))
    return pos


def to_torch(a, dtype):
    return torch.as_tensor(np.array(a, np.float64)).to(
        {"float32": torch.float32, "float64": torch.float64}[dtype])


def to_jax(a, dtype):
    return jnp.asarray(np.asarray(a, np.float64), dtype)


def test_jax_scene_dict_holds_every_bucket_leaf():
    from softbody_tpu import warp_parity

    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas")
    scene_j, sop = jax_build_sparse_scene(pts, cfg, out_num=out_num)
    d = jax_scene_dict(scene_j, x=np.zeros(scene_j.blocked.n_slots))
    assert d["n_buckets"] == len(scene_j.blocked.buckets) >= 2
    for k in range(d["n_buckets"]):
        assert d[f"bucket{k}.static_slab"].shape[1] == 5
        assert d[f"bucket{k}.gidx8"].dtype == np.int32
    assert d["x"].shape == (d["n_slots"],)
    assert d["rest_corr"].shape == (3, 3, d["n_tiles"] * d["rows"])


def test_perturbed_moves_only_particle_slots():
    from softbody_tpu import warp_parity

    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas")
    scene_j, sop = jax_build_sparse_scene(pts, cfg, out_num=out_num)
    pos = perturbed(scene_j, np.asarray(sop), 1e-3 * h, seed=0)
    rest = np.asarray(scene_j.rest_position)
    moved = np.any(pos != rest, axis=1)
    assert moved[np.asarray(sop)].all()
    assert moved.sum() == len(pts)
