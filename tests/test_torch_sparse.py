"""PyTorch port: ``elastic_forces_sparse`` (K1 -> mid-section -> K2 ->
term_i epilogue, Warp pairing) against the JAX package's, f64, 1e-10
relative to max |force|, on the same scene carried across with
``convert.scene_from_numpy``."""

import numpy as np
import jax
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops.elasticity import compute_ratio as jratio
from softbody_tpu.sim.sparse import elastic_forces_sparse as jforces
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.sim.rollout import elastic_forces
from softbody_tpu_torch.sim.sparse import build_sparse_scene, elastic_forces_sparse

from tests.test_torch_helpers import both_scenes, perturbed, small_body, to_jax

TOL = 1e-10


@pytest.fixture(scope="module")
def setup():
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", dt=1e-6, backend="pallas")
    scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num)
    fn = jax.jit(lambda p, x, sc: jforces(p, jratio(x, cfg), sc.materials, sc,
                                          cfg, interpret=True))
    return pts, out_num, cfg, scene_j, scene_t, sop, fn


def _case(setup, dp_scale, x_scale, seed):
    pts, _, cfg, scene_j, scene_t, sop, fn = setup
    pos = perturbed(scene_j, sop, dp_scale * cfg.h, seed)
    x = np.zeros(scene_j.blocked.n_slots)
    x[sop] = np.random.default_rng(seed + 10).normal(scale=x_scale, size=len(sop))
    want = np.asarray(fn(to_jax(pos, "float64"), to_jax(x, "float64"), scene_j))
    got = elastic_forces_sparse(torch.as_tensor(pos), compute_ratio(
        torch.as_tensor(x), cfg), scene_t.materials, scene_t, cfg).numpy()
    return got, want


@pytest.mark.parametrize("dp_scale,x_scale", [(1e-3, 0.0), (3e-2, 0.5)],
                         ids=["perturbed", "perturbed_random_x"])
def test_forces_match_jax(setup, dp_scale, x_scale):
    got, want = _case(setup, dp_scale, x_scale, seed=0)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL, err
    # padding slots carry exactly zero force
    sop = setup[5]
    pad = np.ones(len(got), bool)
    pad[sop] = False
    assert not got[pad].any()


def test_own_scene_build_gives_the_same_forces(setup):
    """The port's own build_sparse_scene and the converted JAX scene give
    bitwise-identical forces."""
    pts, out_num, cfg, scene_j, scene_t, sop, _ = setup
    own, _ = build_sparse_scene(pts, cfg, out_num=out_num, device="cpu")
    pos = torch.as_tensor(perturbed(scene_j, sop, 1e-2 * cfg.h, 4))
    ratio = compute_ratio(torch.zeros(scene_t.blocked.n_slots, dtype=torch.float64), cfg)
    a = elastic_forces_sparse(pos, ratio, own.materials, own, cfg)
    b = elastic_forces_sparse(pos, ratio, scene_t.materials, scene_t, cfg)
    assert torch.equal(a, b)


@pytest.mark.parametrize("override,error,match", [
    ({"backend": "gather"}, ValueError, "build_scene"),
    ({"backend": "gather", "pair_def_grad": "j"}, ValueError, "build_scene"),
    ({"pair_dtype": "bfloat16"}, NotImplementedError, "item 8"),
])
def test_unported_options_raise(setup, override, error, match):
    """What the port does not run yet raises, naming its ROADMAP item, at
    the rollout's force dispatch (the Taichi pairing runs since slice 4:
    tests/test_torch_separable.py); the gather backend runs since slice 10
    (tests/test_torch_gather.py), on a ``build_scene`` scene only."""
    _, _, cfg, _, scene_t, _, _ = setup
    ratio = torch.full((scene_t.blocked.n_slots,), 0.5, dtype=torch.float64)
    with pytest.raises(error, match=match):
        elastic_forces(scene_t.rest_position, ratio, scene_t, cfg.replace(**override))
