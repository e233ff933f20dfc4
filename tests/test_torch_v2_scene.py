"""PyTorch port: K2 v2 (``forces_warp_v2``) and its backward passes
(``forces_warp_v2_bwd_rows`` / ``_slab``) over a whole scene, on the CPU,
where the wrappers run their scene plain versions:

* the ragged schedules take a slab that is a multiple of the slot group (8)
  but not of the kernels' 32- or 128-entry pieces (the blocked varcol
  layout's 9 L, L = 24 here and 216 at the ~112k stretch scene), and give
  today's schedule for slabs of whole 128-entry chunks;
* the whole-scene plain versions equal the per-bucket plain versions
  concatenated (the per-entry buffer placed by the tile schedule), bit for
  bit, on a sparse scene and on a varcol scene whose slab has such a tail;
* the kernels' epilogue reads svnw_b = sum_j gfac V_j dx_b from the scene's
  static row sums rs6T[3:6] instead of summing it over the slab: that form,
  written plainly, against the plain versions' in-kernel sum at 1e-12 in
  f64 (another summation order; on the sparse scene rs6T is the host's f64
  sum over the true pairs, on the blocked one the raw K1 on an all-ones
  RHS);
* path B (``elastic_forces_pallas``) on the varcol scene with the tail, its
  forces and VJP against the JAX package's (Pallas interpret mode) at 1e-10
  in f64, as tests/test_torch_blocked.py holds the 288-entry slab.

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py phases 14 and 25."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu.ops.elasticity import compute_ratio as jratio
from softbody_tpu.scenarios import STRETCH
from softbody_tpu.sim.blocked import build_blocked_scene as jbuild
from softbody_tpu.sim.blocked import elastic_forces_pallas as jpallas
from softbody_tpu_torch.convert import scene_from_numpy
from softbody_tpu_torch.ops import fused_kernels as fk
from softbody_tpu_torch.ops import pair_common as pc
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.sim.blocked import build_blocked_scene, elastic_forces_pallas
from softbody_tpu_torch.sim.sparse import build_sparse_scene

from tests.test_torch_blocked import jax_blocked_dict
from tests.test_torch_helpers import small_body, to_jax

TOL_FORCES = 1e-10
TOL_RS6 = 1e-12


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def tail_body():
    """(points, out_num, h): 107 particles whose varcol layout has 9 tiles
    and run length 24, so a slab of 216 entries: 6 x 32 + 24, 128 + 88."""
    pts, out_num = inflatable_sphere(n_outer=80)
    return pts, out_num, suggest_h(pts, 32)


def _scene(kind, dtype):
    if kind == "sparse":
        pts, out_num, h = small_body()
        build = build_sparse_scene
    else:
        pts, out_num, h = tail_body()
        build = build_blocked_scene
    cfg = warp_parity().replace(h=h, dtype=dtype, backend="pallas", **STRETCH)
    return build(pts, cfg, out_num=out_num, device="cpu")[0], cfg


def _operands(scene, seed):
    """fmT (19, m) with the scene's volumes in row 18, srT (15, n_slots)
    zero past the tile rows, dfT (3, m): seeded."""
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    dt = scene.dtype
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=dt)

    fmT = rand(19, m)
    fmT[18] = scene.materials.volume[:m]
    srT = rand(15, sb.n_slots)
    srT[:, m:] = 0
    return fmT, srT, rand(3, m)


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


def _old_chunk_schedule(sched, chunk=128):
    """The chunk schedule as it was for slabs of whole chunks."""
    sched = np.asarray(sched, np.int64)
    sched = sched[np.argsort(sched[:, 0], kind="stable")]
    n = sched[:, 1] // chunk
    first = np.repeat(np.cumsum(n) - n, n)
    e0 = (np.arange(int(n.sum()), dtype=np.int64) - first) * chunk
    return np.concatenate([np.repeat(sched, n, axis=0), e0[:, None]], axis=1)


def test_schedules_take_slabs_with_a_tail():
    """Every entry of every tile in exactly one chunk, the tail chunk
    partial; slabs of whole chunks give today's schedule; a slab that is
    not a multiple of the slot group is refused."""
    counts, slabs, starts = [3, 2, 4], [216, 1944, 1024], [0, 3, 5]
    sched = pk.tile_schedule(counts, slabs, starts, 8)
    assert sorted(sched[:, 0].tolist()) == list(range(9))
    assert (np.diff(sched[:, 1]) <= 0).all()                 # longest slab first
    ch = pk.chunk_schedule(sched, 8)
    slab_of = dict(zip(sched[:, 0].tolist(), sched[:, 1].tolist()))
    covered = {}
    for tile, slab, _, gi_off, e0 in ch.tolist():
        assert slab == slab_of[tile] and e0 % pk.BWD_CHUNK == 0
        for e in range(e0, min(e0 + pk.BWD_CHUNK, slab)):
            covered[tile, e] = covered.get((tile, e), 0) + 1
    assert covered == {(t, e): 1 for t in range(9) for e in range(slab_of[t])}
    last = {t: max(r[4] for r in ch.tolist() if r[0] == t) for t in range(9)}
    assert [slab_of[t] - last[t] for t in range(9)] == [88] * 3 + [24] * 2 + [128] * 4
    whole = pk.tile_schedule([104, 176, 8], [128, 256, 1024], [0, 104, 280], 8)
    np.testing.assert_array_equal(pk.chunk_schedule(whole, 8), _old_chunk_schedule(whole))
    with pytest.raises(ValueError, match="212"):
        pk.tile_schedule([1], [212], [0], 8)
    with pytest.raises(ValueError, match="212"):
        pk.chunk_schedule(np.array([[0, 212, 0, 0]], np.int64), 8)


def test_blocked_scene_carries_its_ragged_view():
    """A Blocked scene is one bucket to the whole-scene kernels: its flat
    arrays are views of the bucket's, its schedules those of
    ``pk.schedules``, the same from the port's build and from a converted
    JAX scene; a slab that is not a multiple of the slot group is refused
    by the launch checks."""
    scene, cfg = _scene("varcol", "float64")
    blk = scene.blocked
    b = blk.bucket
    assert blk.slab_len == 216 and blk.slab_len % pc.RAGGED_CHUNK
    assert blk.rest_rows is b.restT_rows
    assert blk.static_all.data_ptr() == b.static_slab.data_ptr()
    assert torch.equal(blk.gidx_all, b.gidx8.reshape(-1))
    sched, chunks = pk.schedules([blk.n_tiles], [blk.slab_len], [0], blk.group, "cpu")
    assert torch.equal(blk.schedule, sched) and torch.equal(blk.chunks, chunks)
    assert chunks.shape == (blk.n_tiles * 2, 5) == (pc.n_chunks(blk), 5)
    pts, out_num, _ = tail_body()
    scene_j, _ = jbuild(pts, cfg, out_num=out_num)
    conv = scene_from_numpy(jax_blocked_dict(scene_j), "cpu")[0].blocked
    assert torch.equal(conv.schedule, blk.schedule) and torch.equal(conv.chunks, blk.chunks)
    pc.check_scene(blk, torch.float64, torch.device("cpu"), chunks=True)
    odd = dataclasses.replace(blk, bucket=dataclasses.replace(b, slab_len=212))
    with pytest.raises(ValueError, match="212"):
        pc.check_scene(odd, torch.float64, torch.device("cpu"))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["sparse", "varcol"])
def test_scene_plain_equals_per_bucket_plain(kind, dtype):
    """What the wrappers run on the CPU (and PLAIN on any device) against
    the per-bucket plain versions, concatenated and placed: bit for bit."""
    scene, cfg = _scene(kind, dtype)
    sb = scene.blocked
    fmT, srT, dfT = _operands(scene, 7)
    pk.reset_launch_counts()
    f = fk.forces_warp_v2(sb, fmT, srT, cfg.h)
    dfm, dsr = fk.forces_warp_v2_bwd(sb, fmT, srT, dfT, cfg.h)
    assert torch.equal(dfm, fk.forces_warp_v2_bwd_rows(sb, fmT, srT, dfT, cfg.h))
    assert torch.equal(dsr, fk.forces_warp_v2_bwd_slab(sb, fmT, srT, dfT, cfg.h))
    assert not any(pk.launch_counts().values())          # plain on the CPU
    assert pk.PLAIN.forces_v2 is fk.forces_warp_v2_scene_plain
    assert pk.PLAIN.forces_v2_bwd is fk.forces_warp_v2_bwd_scene_plain
    per_f, per_b = [], []
    for b in sb.buckets:
        c = pk.bucket_cols(b, sb.rows)
        a = (b.restT_rows, b.static_slab, fmT[:, c], srT, b.gidx8)
        per_f.append(fk.forces_warp_v2_plain(*a, cfg.h))
        per_b.append(fk.forces_warp_v2_bwd_plain(*a, dfT[:, c], cfg.h))
    m = sb.n_tiles * sb.rows
    assert f.shape == (3, m) and dfm.shape == (19, m)
    assert dsr.shape == (15, pk.n_entries(sb))
    assert torch.equal(f, torch.cat(per_f, dim=1))
    assert torch.equal(dfm, torch.cat([p[0] for p in per_b], dim=1))
    assert torch.equal(dsr, _placed([p[1] for p in per_b], sb, 15))


@pytest.mark.parametrize("kind", ["sparse", "varcol"])
def test_rs6_epilogue_equals_the_in_kernel_sum(kind):
    """The kernels' form, f = 0.5 V (termj + M rs6T[3:6]) and dM = (df 0.5 V)
    rs6T[3:6] with termj and dF / dsr the v4 K2's, against the plain
    versions that sum svnw over the slab, f64."""
    scene, cfg = _scene(kind, "float64")
    sb = scene.blocked
    fmT, srT, dfT = _operands(scene, 8)
    half_v = 0.5 * fmT[18]
    sv = sb.rs6T[3:6]
    termj = pk.forces_warp_v4_scene_plain(sb, fmT[:9], srT, cfg.h)
    f = torch.stack([half_v * (termj[a] + sum(fmT[9 + 3 * a + b] * sv[b]
                                              for b in range(3)))
                     for a in range(3)])
    assert _rel(f, fk.forces_warp_v2_scene_plain(sb, fmT, srT, cfg.h)) <= TOL_RS6
    dfs = dfT * half_v
    df9, dsr = pk.forces_warp_v4_bwd_scene_plain(sb, fmT[:9], srT, dfs, cfg.h)
    dM = torch.stack([dfs[a] * sv[b] for a in range(3) for b in range(3)])
    dfm_p, dsr_p = fk.forces_warp_v2_bwd_scene_plain(sb, fmT, srT, dfT, cfg.h)
    assert not dfm_p[18].any()
    assert _rel(df9, dfm_p[:9]) <= TOL_RS6
    assert _rel(dM, dfm_p[9:18]) <= TOL_RS6
    assert _rel(dsr, dsr_p) <= TOL_RS6


@pytest.fixture(scope="module")
def tail_case():
    pts, out_num, h = tail_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas", **STRETCH)
    scene_j, sop = jbuild(pts, cfg, out_num=out_num)
    sop = np.asarray(sop)
    rng = np.random.default_rng(46)
    pos = np.asarray(scene_j.rest_position, np.float64).copy()
    pos[sop] += rng.normal(scale=3e-2 * h, size=(len(sop), 3))
    x = np.zeros(scene_j.blocked.n_slots)
    x[sop] = rng.normal(scale=0.5, size=len(sop))
    ct = np.zeros_like(pos)
    ct[sop] = rng.normal(size=(len(sop), 3))

    def f(p, xv):
        return jpallas(p, jratio(xv, cfg), scene_j.materials, scene_j, cfg,
                       interpret=True)

    want_f, vjp = jax.vjp(f, to_jax(pos, "float64"), to_jax(x, "float64"))
    want_g = vjp(to_jax(ct, "float64"))
    conv = scene_from_numpy(jax_blocked_dict(scene_j), "cpu")[0]
    own = build_blocked_scene(pts, cfg, out_num=out_num, device="cpu")[0]
    return cfg, conv, own, pos, x, ct, np.asarray(want_f), [np.asarray(g) for g in want_g]


@pytest.mark.parametrize("which", ["converted", "own_build"])
def test_tail_varcol_path_b_matches_jax(tail_case, which):
    """Path B's forces and their VJP wrt (positions, x) through the
    whole-scene K2 v2 ops on the 216-entry slab, against JAX's."""
    cfg, conv, own, pos, x, ct, want_f, want_g = tail_case
    scene = conv if which == "converted" else own
    assert scene.blocked.slab_len == 216
    p = torch.as_tensor(pos).requires_grad_()
    xv = torch.as_tensor(x).requires_grad_()
    f = elastic_forces_pallas(p, compute_ratio(xv, cfg), scene.materials, scene, cfg)
    assert _rel(f.detach(), want_f) < TOL_FORCES
    got = torch.autograd.grad(f, (p, xv), torch.as_tensor(ct))
    for g, w in zip(got, want_g):
        assert np.abs(w).max() > 0
        assert _rel(g, w) < TOL_FORCES
