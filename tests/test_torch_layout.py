"""PyTorch port: the sparse layout and the static scene arrays are the JAX
package's, bit for bit, and ``convert.scene_from_numpy`` round-trips."""

import numpy as np
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.scenarios import dirichlet_mask
from softbody_tpu.sim.sparse import build_sparse_scene as jax_build
from softbody_tpu.topology.sparse import build_sparse_layout as jax_layout
from softbody_tpu_torch.convert import scene_from_numpy, scene_to_numpy
from softbody_tpu_torch.sim.sparse import build_sparse_scene
from softbody_tpu_torch.topology.sparse import (build_sparse_layout,
                                                validate_sparse_layout)

from tests.test_torch_helpers import jax_scene_dict, small_body


@pytest.mark.parametrize("group", [8, 16])
def test_layout_integers_identical(group):
    pts, _, h = small_body()
    a = jax_layout(pts, 2 * h, rows=32, group=group)
    b = build_sparse_layout(pts, 2 * h, rows=32, group=group)
    for f in ("rows", "n_slots", "n_tiles", "group", "n_shards"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.slot_of_particle, b.slot_of_particle)
    np.testing.assert_array_equal(a.particle_of_slot, b.particle_of_slot)
    assert len(a.buckets) == len(b.buckets)
    for ba, bb in zip(a.buckets, b.buckets):
        np.testing.assert_array_equal(ba.tile_ids, bb.tile_ids)
        np.testing.assert_array_equal(ba.group_ids, bb.group_ids)
    assert a.stats == b.stats
    validate_sparse_layout(b, pts, 2 * h)      # raises on a missed pair


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_static_scene_identical(dtype):
    """The port's own scene build equals the JAX build leaf for leaf."""
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype=dtype, backend="pallas")
    mask = dirichlet_mask(pts, "stretch")
    scene_j, sop_j = jax_build(pts, cfg, out_num=out_num, dirichlet_mask=mask)
    scene_t, sop_t = build_sparse_scene(pts, cfg, out_num=out_num,
                                        dirichlet_mask=mask, device="cpu")
    np.testing.assert_array_equal(np.asarray(sop_j), sop_t)
    want = jax_scene_dict(scene_j)
    got = scene_to_numpy(scene_t)
    assert set(want) == set(got)
    for k, v in want.items():
        if isinstance(v, int):
            assert got[k] == v, k
            continue
        # the port indexes with int64 where the JAX package stores int32
        if k != "slot_of_particle":
            assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_scene_from_numpy_round_trips():
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas")
    scene_j, _ = jax_build(pts, cfg, out_num=out_num)
    x = np.random.default_rng(3).normal(size=scene_j.blocked.n_slots)
    d = jax_scene_dict(scene_j, x=x)
    scene_t, x_t = scene_from_numpy(d, "cpu")
    assert x_t.dtype == torch.float64
    np.testing.assert_array_equal(x_t.numpy(), x)
    back = scene_to_numpy(scene_t)
    d.pop("x")
    assert set(back) == set(d)
    for k, v in d.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), err_msg=k)
    sb = scene_t.blocked
    assert sb.n_slots == scene_t.rest_position.shape[0]
    assert [b.slab_len for b in sb.buckets] == [
        b.slab_len for b in scene_j.blocked.buckets]
