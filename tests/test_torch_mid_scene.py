"""PyTorch port: the fused K1 + mid-section (``moments_mid``) and the raw K1
backward (``moments_raw_bwd``) over a whole scene, on the CPU, where the
wrappers run their scene plain versions:

* ``moments_raw_bwd_scene_plain``, with and without the row term, equals
  the per-bucket plain versions placed by the chunk schedule (a tile's
  entry s at column gi_off * group + s) bit for bit, on a sparse scene of
  three buckets and on a varcol scene whose slab (9 L, L = 24: 216 = 128 +
  88) ends inside a 128-entry chunk; its row term is the fused path's old
  eager -sum_blk ct_blk * rs6T_blk (1e-13 in f64), and on the sparse scene
  the whole K1 v4 backward's outputs bit for bit (one body serves both on
  the card);
* ``moments_mid_scene_plain`` equals the per-bucket plain versions
  concatenated bit for bit, srT's padding columns exactly zero;
* the fused path's force VJP wrt (positions, x) on the sparse scene of
  the varcol body (two buckets), and path B's on its varcol scene, through
  the whole-scene ops, against the JAX package's (Pallas interpret mode)
  at 1e-10 in f64.

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py phases 14 and 25."""

import jax
import numpy as np
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops.elasticity import compute_ratio as jratio
from softbody_tpu.scenarios import STRETCH
from softbody_tpu.sim.blocked import build_blocked_scene as jbuild_blocked
from softbody_tpu.sim.blocked import elastic_forces_pallas as jpallas
from softbody_tpu.sim.sparse import elastic_forces_sparse as jsparse
from softbody_tpu_torch.convert import scene_from_numpy
from softbody_tpu_torch.ops import fused_kernels as fk
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.sim.blocked import elastic_forces_pallas
from softbody_tpu_torch.sim.sparse import elastic_forces_sparse

from tests.test_torch_blocked import jax_blocked_dict
from tests.test_torch_helpers import both_scenes, perturbed, to_jax
from tests.test_torch_v2_scene import _placed, _scene, tail_body

TOL_ROWS = 1e-13
TOL_JAX = 1e-10


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _rand(scene, seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=shape), dtype=scene.dtype)


@pytest.mark.parametrize("rows", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["sparse", "varcol"])
def test_raw_bwd_scene_plain_equals_per_bucket_placed(kind, dtype, rows):
    """What the wrapper runs on the CPU (and PLAIN on any device) against
    the per-bucket plain backwards placed by the schedule: bit for bit."""
    scene, cfg = _scene(kind, dtype)
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    if kind == "sparse":
        assert len(sb.buckets) >= 2
    else:
        assert sb.slab_len == 216 and sb.slab_len % pk.BWD_CHUNK
    dayT = _rand(scene, 3, 18, m)
    pk.reset_launch_counts()
    dps, dprow = fk.moments_raw_bwd(sb, dayT, cfg.h, rows)
    assert not any(pk.launch_counts().values())          # plain on the CPU
    assert pk.PLAIN.moments_raw_bwd is fk.moments_raw_bwd_scene_plain
    want_dps, want_dprow = fk.moments_raw_bwd_scene_plain(sb, dayT, cfg.h, rows)
    assert torch.equal(dps, want_dps)
    parts = [fk.moments_raw_bwd_plain(b.restT_rows, b.static_slab,
                                      dayT[:, pk.bucket_cols(b, sb.rows)], cfg.h)
             for b in sb.buckets]
    assert dps.shape == (3, pk.n_entries(sb))
    assert torch.equal(dps, _placed(parts, sb, 3))
    if not rows:
        assert dprow is None and want_dprow is None
        return
    assert dprow.shape == (3, m) and torch.equal(dprow, want_dprow)
    if kind == "sparse":    # the K1 v4 backward's function: one body on the card
        v4_dps, v4_dprow = pk.moments_v4_bwd_scene_plain(sb, dayT, cfg.h)
        assert torch.equal(dps, v4_dps) and torch.equal(dprow, v4_dprow)


@pytest.mark.parametrize("kind", ["sparse", "varcol"])
def test_raw_bwd_rows_are_the_old_eager_row_term(kind):
    """dprow against the fused path's former eager row side, written
    plainly in f64: -sum_blk ct[blk] * rs6T[blk], ct the (6, 3, m) view of
    the cotangent."""
    scene, cfg = _scene(kind, "float64")
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    dayT = _rand(scene, 4, 18, m)
    _, dprow = fk.moments_raw_bwd(sb, dayT, cfg.h, True)
    ct = dayT.numpy().reshape(6, 3, m)
    rs6 = sb.rs6T.numpy()
    want = np.zeros((3, m))
    for a in range(3):
        for blk in range(6):
            want[a] -= ct[blk, a] * rs6[blk]
    assert np.abs(want).max() > 0
    assert _rel(dprow, want) <= TOL_ROWS


@pytest.mark.parametrize("emit_ay", [True, False])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mid_scene_plain_equals_per_bucket_concatenated(dtype, emit_ay):
    """fmT, srT and the A | Y rows of the whole-scene plain version (what
    the wrapper runs on the CPU) against the per-bucket plain versions
    concatenated: bit for bit; srT's n_slots - m padding columns zero."""
    scene, cfg = _scene("sparse", dtype)
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    assert len(sb.buckets) >= 2 and sb.n_slots > m
    pos = scene.rest_position + 0.03 * cfg.h * _rand(scene, 5, sb.n_slots, 3)
    posT = pos.T.contiguous()
    rs = fk.row_static(sb, scene.materials, scene.rest_corr)
    scale = 1.0 + _rand(scene, 6, m).abs()
    pk.reset_launch_counts()
    fmT, srT, ayT = fk.moments_mid(sb, posT, posT[:, :m], rs, scale, cfg.h,
                                   cfg.corotated, emit_ay)
    assert not any(pk.launch_counts().values())
    assert pk.PLAIN.moments_mid is fk.moments_mid_scene_plain
    parts = []
    for b in sb.buckets:
        c = pk.bucket_cols(b, sb.rows)
        parts.append(fk.moments_mid_plain(b.restT_rows, b.static_slab, posT, posT[:, c],
                                          rs.cols(c), scale[c], b.gidx8, cfg.h,
                                          cfg.corotated, emit_ay))
    assert fmT.shape == (19, m) and srT.shape == (15, sb.n_slots)
    assert torch.equal(fmT, torch.cat([p[0] for p in parts], dim=1))
    assert torch.equal(srT[:, :m], torch.cat([p[1] for p in parts], dim=1))
    assert torch.equal(srT[:, m:], torch.zeros_like(srT[:, m:]))
    if emit_ay:
        assert torch.equal(ayT, torch.cat([p[2] for p in parts], dim=1))
    else:
        assert ayT is None


def _inputs(scene_j, sop, h, seed):
    rng = np.random.default_rng(seed)
    pos = perturbed(scene_j, sop, 3e-2 * h, seed=seed)
    x = np.zeros(scene_j.blocked.n_slots)
    x[sop] = rng.normal(scale=0.5, size=len(sop))
    ct = np.zeros_like(pos)
    ct[sop] = rng.normal(size=(len(sop), 3))
    return pos, x, ct


@pytest.mark.parametrize("path", ["fused", "path_b"])
def test_force_vjp_through_the_scene_ops_matches_jax(path):
    """The fused path's forces and VJP wrt (positions, x) on the sparse
    scene, and path B's on the varcol scene with the tail, against JAX's;
    the backward runs the whole-scene moments_raw_bwd (with and without
    its row term) once per evaluation."""
    pts, out_num, h = tail_body()
    if path == "fused":     # two buckets (JAX's interpret mode compiles each)
        cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                    fused_mid=True, **STRETCH)
        scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num)
        assert len(scene_t.blocked.buckets) == 2
        jforces, forces = jsparse, elastic_forces_sparse
    else:
        cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas", **STRETCH)
        scene_j, sop = jbuild_blocked(pts, cfg, out_num=out_num)
        sop = np.asarray(sop)
        scene_t = scene_from_numpy(jax_blocked_dict(scene_j), "cpu")[0]
        assert scene_t.blocked.slab_len == 216
        jforces, forces = jpallas, elastic_forces_pallas
    pos, x, ct = _inputs(scene_j, sop, h, 47)

    def f(p, xv):
        return jforces(p, jratio(xv, cfg), scene_j.materials, scene_j, cfg,
                       interpret=True)

    def f_and_vjp(p, xv, c):
        out, vjp = jax.vjp(f, p, xv)
        return out, vjp(c)

    want_f, want_g = jax.jit(f_and_vjp)(to_jax(pos, "float64"), to_jax(x, "float64"),
                                        to_jax(ct, "float64"))
    seen = []
    ops = pk.PLAIN._replace(moments_raw_bwd=lambda *a: seen.append(a[3]) or
                            fk.moments_raw_bwd(*a))
    p = torch.as_tensor(pos).requires_grad_()
    xv = torch.as_tensor(x).requires_grad_()
    got_f = forces(p, compute_ratio(xv, cfg), scene_t.materials, scene_t, cfg, ops)
    assert _rel(got_f.detach(), want_f) < TOL_JAX
    got_g = torch.autograd.grad(got_f, (p, xv), torch.as_tensor(ct))
    assert seen == [path == "fused"]              # one launch, rows on the fused path
    for g, w in zip(got_g, want_g):
        assert np.abs(np.asarray(w)).max() > 0
        assert _rel(g, w) < TOL_JAX
