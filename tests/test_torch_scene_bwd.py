"""PyTorch port: the whole-scene backward of K1 (moments_v4_bwd) and K2
(forces_warp_v4_bwd_rows / _slab) on the CPU, where the wrappers run their
scene plain versions: bit for bit the per-bucket plain backwards placed
into the whole-scene buffers (a tile's slab entry s at column
gi_off * group + s); the backward's chunk schedule; and the autograd ops'
VJPs (moments_all / forces_all) against the JAX package's v4 VJP
(``packed._moments_v4_vjp_bwd``, and the K2 backward kernel
``_forces_warp_bwd_v4_impl`` with its scatter into the slots; Pallas
interpret mode) at 1e-11 relative in f64 (another summation order over
<= 384 slab entries, 32 rows and a slot's readers).  The CUDA kernels run
on the card only: tests/test_torch_cuda.py, and at full width chip_smoke.py
phase 9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops.pallas import pair_kernels as jpk
from softbody_tpu.ops.pallas.packed import (gather_packed_T, moments_packed_v4,
                                            pack_components)
from softbody_tpu.sim.sparse import build_sparse_scene as jax_build
from softbody_tpu_torch import warp_parity as torch_warp_parity
from softbody_tpu_torch.convert import scene_from_numpy
from softbody_tpu_torch.geometry.shapes import suggest_h
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops.pair_common import flat_entries, slab_slots
from softbody_tpu_torch.scenarios import fit_body
from softbody_tpu_torch.sim.sparse import build_sparse_scene

from tests.test_torch_helpers import jax_scene_dict, perturbed, small_body

TOL_JAX = 1e-11


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _scene(source, dtype):
    """(SparseBlocked, h): the 20k body built by the port, or the small
    parity body built by the JAX package and converted."""
    if source == "built_20k":
        pts, out_num = fit_body(20_000)
        cfg = torch_warp_parity().replace(h=suggest_h(pts, 32), dtype=dtype,
                                          backend="pallas")
        return build_sparse_scene(pts, cfg, out_num=out_num, device="cpu")[0].blocked, cfg.h
    pts, out_num, h = small_body()
    scene_j, _ = jax_build(pts, warp_parity().replace(h=h, dtype=dtype, backend="pallas"),
                           out_num=out_num)
    return scene_from_numpy(jax_scene_dict(scene_j), "cpu")[0].blocked, h


def _placed(parts, sb, k):
    """Per-bucket (t_b, k, slab_b) outputs placed into a (k, n_entries)
    buffer by the tile schedule: tile entry s at column gi_off * group + s
    (NaN wherever nothing is placed)."""
    gi_off = dict(zip(sb.schedule[:, 0].tolist(), sb.schedule[:, 3].tolist()))
    buf = torch.full((k, pk.n_entries(sb)), float("nan"), dtype=parts[0].dtype)
    for p, b in zip(parts, sb.buckets):
        for j in range(b.n_tiles):
            c0 = gi_off[b.tile_start + j] * sb.group
            buf[:, c0:c0 + b.slab_len] = p[j]
    return buf


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("source", ["built_20k", "converted"])
def test_scene_plain_backward_equals_per_bucket_placed(source, dtype):
    """What the wrappers run on the CPU (and PLAIN on any device) against
    the per-bucket plain backwards, placed by the schedule: bit for bit."""
    sb, h = _scene(source, dtype)
    m = sb.n_tiles * sb.rows
    dt = sb.rs6T.dtype
    rng = np.random.default_rng(11)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=dt)

    dayT, dfT = rand(18, m), rand(3, m)
    f9T = torch.eye(3, dtype=dt).reshape(9, 1) + 0.1 * rand(9, m)
    srT = rand(15, sb.n_slots)
    srT[:, m:] = 0
    pk.reset_launch_counts()
    dps, dprow = pk.moments_v4_bwd(sb, dayT, h)
    df9, dsr = pk.forces_warp_v4_bwd(sb, f9T, srT, dfT, h)
    assert not any(pk.launch_counts().values())          # plain on the CPU
    assert pk.PLAIN.moments_bwd is pk.moments_v4_bwd_scene_plain
    assert pk.PLAIN.forces_bwd is pk.forces_warp_v4_bwd_scene_plain
    k1, k2 = [], []
    for b in sb.buckets:
        c = pk.bucket_cols(b, sb.rows)
        k1.append(pk.moments_v4_bwd_plain(b.restT_rows, b.static_slab, dayT[:, c],
                                          sb.rs6T[:, c], h))
        k2.append(pk.forces_warp_v4_bwd_plain(b.restT_rows, b.static_slab, f9T[:, c],
                                              srT, b.gidx8, dfT[:, c], h))
    assert dps.shape == (3, pk.n_entries(sb)) and dsr.shape == (15, pk.n_entries(sb))
    assert torch.equal(dps, _placed([p[0] for p in k1], sb, 3))
    assert torch.equal(dprow, torch.cat([p[1] for p in k1], dim=1))
    assert torch.equal(df9, torch.cat([p[0] for p in k2], dim=1))
    assert torch.equal(dsr, _placed([p[1] for p in k2], sb, 15))
    if source == "converted":       # the two passes' wrappers, one output each
        assert torch.equal(df9, pk.forces_warp_v4_bwd_rows(sb, f9T, srT, dfT, h))
        assert torch.equal(dsr, pk.forces_warp_v4_bwd_slab(sb, f9T, srT, dfT, h))


@pytest.mark.parametrize("source", ["built_20k", "converted"])
def test_chunk_schedule_covers_every_chunk_once_in_flat_entries_order(source):
    sb, _ = _scene(source, "float64")
    ch, sched = sb.chunks.numpy(), sb.schedule.numpy()
    n = pk.n_entries(sb)
    assert ch.dtype == np.int64 and ch.shape == (n // pk.BWD_CHUNK, 5)
    assert len({b.slab_len for b in sb.buckets}) >= 2
    # every (tile, chunk) once, tile order then entry order, each row
    # carrying its tile's schedule row
    by_tile = {int(r[0]): r for r in sched}
    assert [tuple(r) for r in ch[:, [0, 4]].tolist()] == [
        (t, e0) for t in range(sb.n_tiles)
        for e0 in range(0, int(by_tile[t][1]), pk.BWD_CHUNK)]
    np.testing.assert_array_equal(ch[:, :4], np.stack([by_tile[int(t)] for t in ch[:, 0]]))
    # the chunks' entry columns cover [0, n_entries) once, and each holds the
    # entry flat_entries puts there
    cols = (ch[:, 3] * sb.group + ch[:, 4])[:, None] + np.arange(pk.BWD_CHUNK)
    np.testing.assert_array_equal(np.sort(cols.ravel()), np.arange(n))
    ids = flat_entries([((b.tile_start + torch.arange(b.n_tiles)) * 4096)[:, None, None]
                        + torch.arange(b.slab_len) for b in sb.buckets], 1)[0].numpy()
    np.testing.assert_array_equal(ids[cols], (ch[:, 0] * 4096 + ch[:, 4])[:, None]
                                  + np.arange(pk.BWD_CHUNK))


def test_chunk_schedule_refuses_slabs_not_multiples_of_the_chunk():
    ch = pk.chunk_schedule(pk.tile_schedule([2, 1], [128, 256], [0, 2], 8))
    np.testing.assert_array_equal(ch[:, [0, 1, 4]],
                                  [[0, 128, 0], [1, 128, 0], [2, 256, 0], [2, 256, 128]])
    with pytest.raises(ValueError, match="96"):
        pk.chunk_schedule(pk.tile_schedule([2, 1], [128, 96], [0, 2], 8))


@pytest.fixture(scope="module")
def case():
    """The small parity body in f64: the JAX scene, its conversion, seeded
    positions, K2 operands and cotangents."""
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas")
    scene_j, sop = jax_build(pts, cfg, out_num=out_num)
    sb = scene_from_numpy(jax_scene_dict(scene_j), "cpu")[0].blocked
    m = sb.n_tiles * sb.rows
    rng = np.random.default_rng(12)
    pos = perturbed(scene_j, np.asarray(sop), 1e-2 * h, 12)
    f9 = np.eye(3).reshape(9, 1) + 0.1 * rng.normal(size=(9, m))
    sr = rng.normal(size=(15, sb.n_slots))
    sr[:, m:] = 0.0
    return cfg.h, scene_j.blocked, sb, pos, f9, sr, rng


def _cols(b, rows):
    return slice(b.tile_start * rows, (b.tile_start + b.n_tiles) * rows)


def test_moments_all_vjp_matches_jax_v4(case):
    h, sbj, sb, pos, _, _, rng = case
    m = sb.n_tiles * sb.rows
    day = rng.normal(size=(18, m))

    def k1(posT):                   # JAX's v4 K1 over every bucket
        packed = pack_components([posT[0], posT[1], posT[2]], 8, 8)
        return jnp.concatenate([moments_packed_v4(
            b.restT_rows, b.static_slab, packed, posT[:, _cols(b, sbj.rows)],
            sbj.rs6T[:, _cols(b, sbj.rows)], b.gidx8, h, True) for b in sbj.buckets], axis=1)

    _, vjp = jax.vjp(k1, jnp.asarray(pos.T))
    (want,) = vjp(jnp.asarray(day))
    x = torch.as_tensor(pos.T.copy()).requires_grad_()
    (got,) = torch.autograd.grad(pk.moments_all(x, x[:, :m], sb, h), x,
                                 torch.as_tensor(day))
    assert _rel(got, want) < TOL_JAX, _rel(got, want)


def test_forces_all_vjp_matches_jax_v4(case):
    """forces_all's VJP against JAX's v4 K2 backward kernel
    (``_forces_warp_bwd_v4_impl``) per bucket on the gathered slab records,
    its per-entry [dS_6 | dR^T_9] added into the slots (the JAX path's
    ``scatter_packed_raw_T``, here ``np.add.at``)."""
    h, sbj, sb, _, f9, sr, rng = case
    m = sb.n_tiles * sb.rows
    df = rng.normal(size=(3, m))
    sr_packed = pack_components([jnp.asarray(sr[k]) for k in range(15)], 16, sbj.group,
                                n_total=sbj.n_slots)
    tb = 128 // sbj.rows
    want9, want_sr = [], np.zeros((15, sbj.n_slots))
    for b in sbj.buckets:
        c, t = _cols(b, sbj.rows), b.n_tiles
        extra = (-t) % tb          # the kernel takes a tb multiple of tiles:

        def pad(a, axis):          # pad with inert (all-zero) tiles, drop them after
            widths = [(0, 0)] * a.ndim
            widths[axis] = (0, extra * (sbj.rows if axis == 1 and a.ndim == 2 else 1))
            return jnp.pad(jnp.asarray(a), widths)

        sr_slab = gather_packed_T(sr_packed, b.gidx8, b.slab_len, 16)
        df9, dsr = jpk._forces_warp_bwd_v4_impl(
            pad(b.restT_rows, 0), pad(b.static_slab, 0), pad(f9[:, c], 1),
            pad(sr_slab, 0), pad(df[:, c], 1), h, True, 1)
        want9.append(np.asarray(df9)[:, :t * sbj.rows])
        slots = slab_slots(torch.as_tensor(np.array(b.gidx8)), b.slab_len).numpy()
        np.add.at(want_sr, (slice(None), slots.reshape(-1)),
                  np.asarray(dsr)[:t].transpose(1, 0, 2).reshape(15, -1))
    a = torch.as_tensor(f9).requires_grad_()
    s = torch.as_tensor(sr).requires_grad_()
    g9, g_sr = torch.autograd.grad(pk.forces_all(a, s, sb, h), (a, s), torch.as_tensor(df))
    assert _rel(g9, np.concatenate(want9, axis=1)) < TOL_JAX
    assert _rel(g_sr, want_sr) < TOL_JAX, _rel(g_sr, want_sr)
