"""PyTorch port: the plain backward versions of K1 (moments_v4_bwd_plain) and
K2 (forces_warp_v4_bwd_plain) against the JAX Pallas backward kernels
(interpret mode) bucket by bucket, and against torch.autograd of the plain
forward; the fixed-order CSR scatter against numpy's ``np.add.at``; and the
two autograd ops (moments_all / forces_all) on the CPU, whose backward wiring
is the card's.  All f64: 1e-10 relative for the kernels (another summation
order over <= 384 slab entries and 32 rows), 1e-13 for the scatter.  The
hand-written CUDA backward kernels run on the card only:
tests/test_torch_cuda.py, and at full width chip_smoke.py phase 9."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops.pallas import packed
from softbody_tpu.ops.pallas import pair_kernels as jpk
from softbody_tpu.sim.sparse import build_sparse_scene as jax_build
from softbody_tpu_torch.convert import scene_from_numpy
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops.pair_common import slab_slots

from tests.test_torch_helpers import jax_scene_dict, perturbed, small_body

TOL = 1e-10


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _t(a):
    return torch.as_tensor(np.array(a, np.float64))


@pytest.fixture(scope="module")
def case():
    """The small parity body in f64, seeded cotangents and K2 operands, and
    the JAX backward kernels' outputs per bucket (computed once)."""
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas")
    scene_j, sop = jax_build(pts, cfg, out_num=out_num)
    scene_t, _ = scene_from_numpy(jax_scene_dict(scene_j), "cpu")
    sb = scene_j.blocked
    m = sb.n_tiles * sb.rows
    rng = np.random.default_rng(7)
    pos = perturbed(scene_j, np.asarray(sop), 1e-2 * h, seed=7)
    f9 = np.eye(3).reshape(9, 1) + 0.1 * rng.normal(size=(9, m))
    sr = rng.normal(size=(15, sb.n_slots))
    sr[:, m:] = 0.0
    day = rng.normal(size=(18, m))
    df = rng.normal(size=(3, m))
    sr_packed = packed.pack_components([jnp.asarray(sr[k]) for k in range(15)],
                                       16, sb.group, n_total=sb.n_slots)
    tb = 128 // sb.rows
    refs = []
    for b in sb.buckets:
        r0, mb, t = b.tile_start * sb.rows, b.n_tiles * sb.rows, b.n_tiles
        dps, dprow = packed._moments_v4_bwd_impl(
            b.restT_rows, b.static_slab, jnp.asarray(day[:, r0:r0 + mb]),
            sb.rs6T[:, r0:r0 + mb], cfg.h, True)
        # the v4 K2 backward takes a tb multiple of tiles: pad with inert
        # (all-zero) tiles and drop them after
        extra = (-t) % tb

        def pad(a, axis):
            widths = [(0, 0)] * a.ndim
            widths[axis] = (0, extra * (sb.rows if axis == 1 and a.ndim == 2 else 1))
            return jnp.pad(jnp.asarray(a), widths)

        sr_slab = packed.gather_packed_T(sr_packed, b.gidx8, b.slab_len, 16)
        df9, dsr = jpk._forces_warp_bwd_v4_impl(
            pad(b.restT_rows, 0), pad(b.static_slab, 0),
            pad(f9[:, r0:r0 + mb], 1), pad(sr_slab, 0), pad(df[:, r0:r0 + mb], 1),
            cfg.h, True, 1)
        refs.append((np.asarray(dps), np.asarray(dprow),
                     np.asarray(df9)[:, :mb], np.asarray(dsr)[:t]))
    return cfg, scene_t, pos, f9, sr, day, df, refs


def _bucket_args(scene_t, b, arrays):
    cols = slice(b.row_start, b.row_start + b.n_tiles * scene_t.blocked.rows)
    return cols, [_t(a)[:, cols] for a in arrays]


def test_plain_backward_matches_jax_per_bucket(case):
    cfg, scene_t, pos, f9, sr, day, df, refs = case
    sb = scene_t.blocked
    assert len(sb.buckets) >= 2
    for b, (dps_j, dprow_j, df9_j, dsr_j) in zip(sb.buckets, refs):
        cols, (day_b, df_b, f9_b) = _bucket_args(scene_t, b, (day, df, f9))
        dps, dprow = pk.moments_v4_bwd_plain(b.restT_rows, b.static_slab, day_b,
                                             sb.rs6T[:, cols], cfg.h)
        df9, dsr = pk.forces_warp_v4_bwd_plain(b.restT_rows, b.static_slab, f9_b,
                                               _t(sr), b.gidx8, df_b, cfg.h)
        assert dps.shape == (b.n_tiles, 3, b.slab_len)
        assert dsr.shape == (b.n_tiles, 15, b.slab_len)
        for got, want in ((dps, dps_j), (dprow, dprow_j), (df9, df9_j),
                          (dsr, dsr_j)):
            assert got.shape == want.shape
            assert _rel(got, want) < TOL, (b.slab_len, _rel(got, want))


def test_plain_backward_matches_autograd_of_plain_forward(case):
    """The explicit backward formulas are the plain forward's gradient.  K1's
    row term uses the static row sums, which in f64 equal the forward's
    coefficient sums to rounding."""
    cfg, scene_t, pos, f9, sr, day, df, refs = case
    sb = scene_t.blocked
    for b in sb.buckets:
        cols, (day_b, df_b, f9_b) = _bucket_args(scene_t, b, (day, df, f9))
        inv = [torch.as_tensor(a) for a in
               pk.slab_inverse([b.gidx8.numpy()], sb.n_slots, sb.group,
                               np.arange(sb.n_slots) < sb.n_slots - sb.group)]
        posT = _t(pos.T).requires_grad_()
        prow = _t(pos.T)[:, cols].requires_grad_()
        ay = pk.moments_v4_plain(b.restT_rows, b.static_slab, posT, prow,
                                 sb.rs6T[:, cols], b.gidx8, cfg.h)
        g_pos, g_row = torch.autograd.grad(ay, (posT, prow), day_b)
        dps, dprow = pk.moments_v4_bwd_plain(b.restT_rows, b.static_slab, day_b,
                                             sb.rs6T[:, cols], cfg.h)
        dpos = pk.slab_to_slots_plain(dps.permute(1, 0, 2).reshape(3, -1),
                                      *inv, sb.n_slots, sb.group)
        assert _rel(dpos, g_pos) < TOL
        assert _rel(dprow, g_row) < TOL

        f9_l = f9_b.clone().requires_grad_()
        sr_l = _t(sr).requires_grad_()
        out = pk.forces_warp_v4_plain(b.restT_rows, b.static_slab, f9_l, sr_l,
                                      b.gidx8, cfg.h)
        g_f9, g_sr = torch.autograd.grad(out, (f9_l, sr_l), df_b)
        df9, dsr = pk.forces_warp_v4_bwd_plain(b.restT_rows, b.static_slab, f9_b,
                                               _t(sr), b.gidx8, df_b, cfg.h)
        dsr_slots = pk.slab_to_slots_plain(dsr.permute(1, 0, 2).reshape(15, -1),
                                           *inv, sb.n_slots, sb.group)
        assert _rel(df9, g_f9) < TOL
        assert _rel(dsr_slots, g_sr) < TOL


def test_csr_scatter_matches_numpy_add_at(case):
    cfg, scene_t, *_ = case
    sb = scene_t.blocked
    ptr, idx = sb.slab_ptr.numpy(), sb.slab_idx.numpy()
    for k in range(sb.n_slots // sb.group):         # ascending reader lists
        assert np.all(np.diff(idx[ptr[k]:ptr[k + 1]]) > 0)
    n_entries = sum(b.n_tiles * b.slab_len for b in sb.buckets)
    pad = sb.n_slots - sb.group                     # the all-empty group
    n_pad = sum(int((b.gidx8 == pad // sb.group).sum()) for b in sb.buckets)
    assert n_pad > 0 and (idx.shape[0] + n_pad) * sb.group == n_entries
    buf = np.random.default_rng(8).normal(size=(15, n_entries))
    want = np.zeros((15, sb.n_slots))
    e0 = 0
    for b in sb.buckets:
        slots = slab_slots(b.gidx8, b.slab_len).numpy().reshape(-1)
        np.add.at(want, (slice(None), slots), buf[:, e0:e0 + slots.size])
        e0 += slots.size
    got = pk.slab_to_slots_plain(_t(buf), sb.slab_ptr, sb.slab_idx,
                                 sb.n_slots, sb.group).numpy()
    # the padding group's readers are left out: its cotangent is exactly 0
    assert not got[:, pad:].any()
    assert np.abs(got[:, :pad] - want[:, :pad]).max() <= 1e-13 * np.abs(want).max()
    # the CPU dispatch is the plain version and counts no launch
    pk.reset_launch_counts()
    np.testing.assert_array_equal(
        pk.slab_to_slots(_t(buf), sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group),
        got)
    assert pk.launch_counts()["slab_to_slots"] == 0


def test_slab_inverse_refuses_bad_layouts():
    g = np.array([[0, 3, 2], [1, 2, 3]], np.int32)   # group 3: the padding
    ptr, idx = pk.slab_inverse([g], 32, 8, np.arange(32) < 24)
    np.testing.assert_array_equal(ptr, [0, 1, 2, 4, 4])
    np.testing.assert_array_equal(idx, [0, 3, 2, 4])
    with pytest.raises(ValueError, match="multiple"):
        pk.slab_inverse([g], 20, 8, np.ones(20, bool))
    with pytest.raises(ValueError, match="outside"):
        pk.slab_inverse([g], 24, 8, np.ones(24, bool))


@pytest.mark.parametrize("op", ["moments_all", "forces_all"])
def test_autograd_ops_on_cpu_match_autograd_of_plain_forward(case, op):
    """moments_all / forces_all: one autograd.Function over every bucket,
    whose CPU backward runs the plain backward versions and the CSR scatter
    (the card runs the kernels through the same wiring)."""
    cfg, scene_t, pos, f9, sr, day, df, refs = case
    sb = scene_t.blocked
    m = sb.n_tiles * sb.rows
    if op == "moments_all":
        x = _t(pos.T).requires_grad_()
        got = pk.moments_all(x, x[:, :m], sb, cfg.h)
        want = torch.cat([pk.moments_v4_plain(
            b.restT_rows, b.static_slab, x, x[:, b.row_start:b.row_start + b.n_tiles * 32],
            sb.rs6T[:, b.row_start:b.row_start + b.n_tiles * 32], b.gidx8, cfg.h)
            for b in sb.buckets], dim=1)
        inputs, ct = (x,), _t(day)
    else:
        a, s = _t(f9).requires_grad_(), _t(sr).requires_grad_()
        got = pk.forces_all(a, s, sb, cfg.h)
        want = torch.cat([pk.forces_warp_v4_plain(
            b.restT_rows, b.static_slab, a[:, b.row_start:b.row_start + b.n_tiles * 32],
            s, b.gidx8, cfg.h) for b in sb.buckets], dim=1)
        inputs, ct = (a, s), _t(df)
    assert torch.equal(got, want)
    for g, w in zip(torch.autograd.grad(got, inputs, ct),
                    torch.autograd.grad(want, inputs, ct)):
        assert _rel(g, w) < TOL
