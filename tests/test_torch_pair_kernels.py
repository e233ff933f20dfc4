"""PyTorch port: the plain K1 (moments_v4) and K2 (forces_warp_v4) against
the JAX Pallas kernels (interpret mode), bucket by bucket and over the whole
scene: 1e-12 in f64, 1e-5 in f32 (another summation order over <= 384 slab
entries here); the ragged kernels' tile schedule, and the whole-scene plain
composition against the per-bucket plain versions, bit for bit.  The
hand-written CUDA kernels against the plain versions run on the card only:
tests/test_torch_cuda.py, and at full width chip_smoke.py phase 3."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops.pallas.packed import (forces_warp_packed_v4,
                                            moments_packed_v4, pack_components)
from softbody_tpu.sim.sparse import build_sparse_scene as jax_build
from softbody_tpu_torch import warp_parity as torch_warp_parity
from softbody_tpu_torch.convert import scene_from_numpy
from softbody_tpu_torch.geometry.shapes import suggest_h
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops.pair_common import pair_coeffs
from softbody_tpu_torch.scenarios import fit_body
from softbody_tpu_torch.sim.sparse import build_sparse_scene

from tests.test_torch_helpers import (jax_scene_dict, perturbed, small_body,
                                      to_jax, to_torch)

TOL = {"float64": 1e-12, "float32": 1e-5}


def _inputs(dtype, seed=0):
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype=dtype, backend="pallas")
    scene_j, sop = jax_build(pts, cfg, out_num=out_num)
    sb = scene_j.blocked
    m = sb.n_tiles * sb.rows
    pos = perturbed(scene_j, np.asarray(sop), 1e-2 * h, seed)
    rng = np.random.default_rng(seed + 1)
    f9 = np.eye(3).reshape(9, 1) + 0.1 * rng.normal(size=(9, m))
    sr = rng.normal(size=(15, sb.n_slots))
    sr[:, m:] = 0.0                       # the trailing empty group
    return cfg, scene_j, pos, f9, sr


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_kernels_match_jax_per_bucket(dtype):
    cfg, scene_j, pos, f9, sr = _inputs(dtype)
    sb = scene_j.blocked
    pos_j = to_jax(pos, dtype)
    packed = pack_components([pos_j[:, 0], pos_j[:, 1], pos_j[:, 2]], 8, 8)
    sr_packed = pack_components([to_jax(sr[k], dtype) for k in range(15)],
                                16, 8, n_total=sb.n_slots)
    posT = to_torch(pos.T, dtype)
    f9_t, sr_t = to_torch(f9, dtype), to_torch(sr, dtype)
    assert len(sb.buckets) >= 2
    for b in sb.buckets:
        r0, mb = b.tile_start * sb.rows, b.n_tiles * sb.rows
        want1 = moments_packed_v4(b.restT_rows, b.static_slab, packed,
                                  pos_j.T[:, r0:r0 + mb], sb.rs6T[:, r0:r0 + mb],
                                  b.gidx8, cfg.h, True)
        want2 = forces_warp_packed_v4(b.restT_rows, b.static_slab,
                                      to_jax(f9[:, r0:r0 + mb], dtype), sr_packed,
                                      b.gidx8, cfg.h, True)
        rr, st = to_torch(b.restT_rows, dtype), to_torch(b.static_slab, dtype)
        gi = torch.as_tensor(np.array(b.gidx8))
        rs6 = to_torch(np.asarray(sb.rs6T)[:, r0:r0 + mb], dtype)
        got1 = pk.moments_v4_plain(rr, st, posT, posT[:, r0:r0 + mb], rs6, gi, cfg.h)
        got2 = pk.forces_warp_v4_plain(rr, st, f9_t[:, r0:r0 + mb], sr_t, gi, cfg.h)
        assert got1.shape == (18, mb) and got2.shape == (3, mb)
        assert got1.dtype == got2.dtype == to_torch(0.0, dtype).dtype
        assert _rel(got1, want1) < TOL[dtype], (b.slab_len, _rel(got1, want1))
        assert _rel(got2, want2) < TOL[dtype], (b.slab_len, _rel(got2, want2))


def test_self_pair_and_far_grid_vanish():
    """rsqrt form: zero gradient factor at r = 0 without a mask, and zero
    coefficients beyond 2h (where the far-grid padding slots sit)."""
    h = 0.01
    rows = torch.tensor([[[0.0, 0.0]], [[0.0, 0.0]], [[0.0, 0.0]]],
                        dtype=torch.float32).reshape(3, 2)
    slab = torch.tensor([[0.0, 2.5 * h, 0.5 * h]] + [[0.0, 0.0, 0.0]] * 2,
                        dtype=torch.float32)
    dx, w, gfac = pair_coeffs(rows, slab, h)
    assert torch.isfinite(gfac).all() and torch.isfinite(w).all()
    assert gfac[0, 0] == 0.0 and gfac[0, 1] == 0.0 and w[0, 1] == 0.0
    assert gfac[0, 2] != 0.0 and w[0, 0] > w[0, 2] > 0.0


def _torch_scene(scene_j):
    return scene_from_numpy(jax_scene_dict(scene_j), "cpu")[0]


def test_wrappers_refuse_other_devices_and_count_nothing_on_cpu():
    cfg, scene_j, pos, f9, sr = _inputs("float32")
    sb = _torch_scene(scene_j).blocked
    m = sb.n_tiles * sb.rows
    posT = to_torch(pos.T, "float32")
    f9_t, sr_t = to_torch(f9, "float32"), to_torch(sr, "float32")
    pk.reset_launch_counts()
    pk.moments_v4(sb, posT, posT[:, :m], cfg.h)
    pk.forces_warp_v4(sb, f9_t, sr_t, cfg.h)
    assert pk.moments_v4.launches == pk.forces_warp_v4.launches == 0  # plain
    with pytest.raises(ValueError, match="cpu or cuda"):
        pk.moments_v4(sb, posT.to("meta"), posT[:, :m].to("meta"), cfg.h)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pk.forces_warp_v4(sb, f9_t.to("meta"), sr_t.to("meta"), cfg.h)


def _scene_20k():
    pts, out_num = fit_body(20_000)
    cfg = torch_warp_parity().replace(h=suggest_h(pts, 32), dtype="float32",
                                      backend="pallas")
    return build_sparse_scene(pts, cfg, out_num=out_num, device="cpu")[0].blocked


@pytest.mark.parametrize("source", ["built_20k", "converted"])
def test_tile_schedule_covers_every_tile_once_longest_slab_first(source):
    if source == "built_20k":
        sb = _scene_20k()
    else:
        sb = _torch_scene(_inputs("float64")[1]).blocked
    sched = sb.schedule.numpy()
    assert sched.dtype == np.int64 and sched.shape == (sb.n_tiles, 4)
    np.testing.assert_array_equal(np.sort(sched[:, 0]), np.arange(sb.n_tiles))
    assert (np.diff(sched[:, 1]) <= 0).all()               # longest slab first
    assert len({b.slab_len for b in sb.buckets}) >= 2
    by_tile = {int(r[0]): r for r in sched}
    for b in sb.buckets:
        for k in range(b.n_tiles):
            tile, slab, st_off, gi_off = by_tile[b.tile_start + k]
            assert slab == b.slab_len
            # the offsets name this tile's static block and gidx row, its
            # rest rows sit at its tile index (the output column tile * rows)
            assert torch.equal(sb.static_all[st_off:st_off + 5 * slab].view(5, slab),
                               b.static_slab[k])
            g = slab // sb.group
            assert torch.equal(sb.gidx_all[gi_off:gi_off + g], b.gidx8[k])
            assert torch.equal(sb.rest_rows[tile], b.restT_rows[k])
    # the buckets' arrays are views of the scene-wide ones
    for b in sb.buckets:
        assert b.static_slab.untyped_storage().data_ptr() == \
            sb.static_all.untyped_storage().data_ptr()
        assert b.gidx8.untyped_storage().data_ptr() == \
            sb.gidx_all.untyped_storage().data_ptr()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_scene_plain_equals_per_bucket_concatenation(dtype):
    """The whole-scene plain ops (what the wrappers and PLAIN run on the
    CPU) against the per-bucket plain versions concatenated, and against
    the per-tile plain versions placed by the schedule's offsets: bit for
    bit."""
    cfg, scene_j, pos, f9, sr = _inputs(dtype)
    sb = _torch_scene(scene_j).blocked
    m = sb.n_tiles * sb.rows
    posT = to_torch(pos.T, dtype)
    f9_t, sr_t = to_torch(f9, dtype), to_torch(sr, dtype)
    k1 = pk.moments_v4(sb, posT, posT[:, :m], cfg.h)
    k2 = pk.forces_warp_v4(sb, f9_t, sr_t, cfg.h)
    assert torch.equal(k1, pk.PLAIN.moments(sb, posT, posT[:, :m], cfg.h))
    assert torch.equal(k2, pk.PLAIN.forces(sb, f9_t, sr_t, cfg.h))
    cat1, cat2 = [], []
    for b in sb.buckets:
        c = pk.bucket_cols(b, sb.rows)
        cat1.append(pk.moments_v4_plain(b.restT_rows, b.static_slab, posT, posT[:, c],
                                        sb.rs6T[:, c], b.gidx8, cfg.h))
        cat2.append(pk.forces_warp_v4_plain(b.restT_rows, b.static_slab, f9_t[:, c],
                                            sr_t, b.gidx8, cfg.h))
    assert torch.equal(k1, torch.cat(cat1, dim=1))
    assert torch.equal(k2, torch.cat(cat2, dim=1))
    # per tile through the schedule: the same columns (the plain arithmetic
    # is per tile; only the batch differs), to rounding
    t1, t2 = torch.full_like(k1, float("nan")), torch.full_like(k2, float("nan"))
    for tile, slab, st_off, gi_off in sb.schedule.tolist():
        rr = sb.rest_rows[tile:tile + 1]
        st = sb.static_all[st_off:st_off + 5 * slab].view(1, 5, slab)
        gi = sb.gidx_all[gi_off:gi_off + slab // sb.group].view(1, -1)
        c = slice(tile * sb.rows, (tile + 1) * sb.rows)
        t1[:, c] = pk.moments_v4_plain(rr, st, posT, posT[:, c], sb.rs6T[:, c], gi, cfg.h)
        t2[:, c] = pk.forces_warp_v4_plain(rr, st, f9_t[:, c], sr_t, gi, cfg.h)
    assert _rel(t1, k1) < TOL[dtype] and _rel(t2, k2) < TOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_scene_ops_match_jax_v4(dtype):
    """moments_all / forces_all over the whole scene (the CPU dispatch)
    against JAX's v4 path, bucket by bucket concatenated."""
    cfg, scene_j, pos, f9, sr = _inputs(dtype)
    sbj = scene_j.blocked
    sb = _torch_scene(scene_j).blocked
    m = sbj.n_tiles * sbj.rows
    pos_j = to_jax(pos, dtype)
    packed = pack_components([pos_j[:, 0], pos_j[:, 1], pos_j[:, 2]], 8, 8)
    sr_packed = pack_components([to_jax(sr[k], dtype) for k in range(15)],
                                16, 8, n_total=sbj.n_slots)
    want1 = np.concatenate([np.asarray(moments_packed_v4(
        b.restT_rows, b.static_slab, packed,
        pos_j.T[:, b.tile_start * sbj.rows:(b.tile_start + b.n_tiles) * sbj.rows],
        sbj.rs6T[:, b.tile_start * sbj.rows:(b.tile_start + b.n_tiles) * sbj.rows],
        b.gidx8, cfg.h, True)) for b in sbj.buckets], axis=1)
    want2 = np.concatenate([np.asarray(forces_warp_packed_v4(
        b.restT_rows, b.static_slab,
        to_jax(f9[:, b.tile_start * sbj.rows:(b.tile_start + b.n_tiles) * sbj.rows], dtype),
        sr_packed, b.gidx8, cfg.h, True)) for b in sbj.buckets], axis=1)
    posT = to_torch(pos.T, dtype)
    got1 = pk.moments_all(posT, posT[:, :m], sb, cfg.h)
    got2 = pk.forces_all(to_torch(f9, dtype), to_torch(sr, dtype), sb, cfg.h)
    assert got1.shape == (18, m) and got2.shape == (3, m)
    assert _rel(got1, want1) < TOL[dtype], _rel(got1, want1)
    assert _rel(got2, want2) < TOL[dtype], _rel(got2, want2)
