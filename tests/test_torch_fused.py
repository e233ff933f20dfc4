"""PyTorch port, fused K1 + mid-section path (``cfg.fused_mid``): the plain
versions of its four kernels against the JAX package's launches of the
Pallas kernels (interpret mode), bucket by bucket, on the small parity body
carried across with ``convert.scene_from_numpy``:

* ``fk.moments_mid_plain`` vs ``packed._fused_call`` (``emit_ay``);
* ``fk.forces_warp_v2_plain`` vs ``packed.forces_warp_packed``;
* ``fk.moments_raw_bwd_plain`` vs ``pair_kernels._moments_vjp_bwd``;
* ``fk.forces_warp_v2_bwd_plain`` vs ``pair_kernels._forces_warp_bwd_impl``;
* the whole-scene ``fk.moments_mid`` and ``fk.moments_raw_bwd`` (with its
  row term) per bucket against the same launches.

Tolerances, relative to max |JAX|: 1e-12 in f64 (another summation order
over <= 384 slab entries and 32 rows) and 1e-5 in f32, except the fused
kernel's fm / sr / A | Y in f32, held at 2e-4: the port centers its
moments in the kernel, where the TPU kernel contracted absolute positions
and subtracted pos_i * rs6 (its raw-dots cancellation moves f32 forces by
~5e-5 of their maximum; csrc/fused_kernels.cu).  K2 and the backward
kernels get identical inputs on both sides (JAX's fm / sr).  The whole
fused force, its VJP and the episode gradient are held against JAX in
tests/test_torch_fused_forces.py and tests/test_torch_fused_episode.py; the
CUDA kernels against these plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py phases 14-20."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops.pallas import packed
from softbody_tpu.ops.pallas import pair_kernels as jpk
from softbody_tpu.sim.sparse import _chunks_for
from softbody_tpu_torch.ops import fused_kernels as fk

from tests.test_torch_helpers import both_scenes, perturbed, small_body

TOL = {"float64": 1e-12, "float32": 1e-5}
TOL_MID_F32 = 2e-4


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module", params=["float64", "float32"])
def case(request):
    """Both scenes in one dtype, perturbed positions, a random stiffness
    scale and cotangents, and JAX's four kernel launches per bucket
    (computed once)."""
    dtype = request.param
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype=dtype, backend="pallas", fused_mid=True)
    scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num)
    sb = scene_j.blocked
    t, rows, gsz = sb.n_tiles, sb.rows, sb.group
    m = t * rows
    rng = np.random.default_rng(11)
    pos = perturbed(scene_j, sop, 3e-2 * h, seed=11)
    scale = 200.0 - 199.0 * rng.uniform(size=m)
    day = rng.normal(size=(m, 18))
    df = rng.normal(size=(m, 3))

    def jx(a):
        return jnp.asarray(a, dtype)

    pos_j = jx(pos)
    pos_packed = packed.pack_components([pos_j[:, 0], pos_j[:, 1], pos_j[:, 2]], 8, gsz)
    dyn = packed.rows_from_components(
        [pos_j[:m, 0], pos_j[:m, 1], pos_j[:m, 2], jx(scale)], t, rows)
    mid = [packed._fused_call(b.restT_rows, b.static_slab, pos_packed, b.gidx8,
                              b.rows_of(sb.stat_rows), b.rows_of(dyn), cfg.h,
                              True, 8, True, True)
           for b in sb.buckets]
    fm = jnp.concatenate([o[0] for o in mid], axis=0)            # (t, rows, 19)
    sr16 = jnp.concatenate([o[1] for o in mid], axis=0).reshape(m, 16)
    sr_pad = jnp.concatenate([sr16, jnp.zeros((sb.n_slots - m, 16), sr16.dtype)])
    sr_packed = packed.pack_components([sr_pad[:, k] for k in range(16)], 16, gsz)
    refs = []
    for b, (fm_b, sr_b, ay_b) in zip(sb.buckets, mid):
        chunks = _chunks_for(b.slab_len)
        f_b = packed.forces_warp_packed(b.restT_rows, b.static_slab, fm_b, sr_packed,
                                        b.gidx8, cfg.h, True, chunks)
        r0 = b.tile_start * rows
        day_b = jx(day[r0:r0 + b.n_tiles * rows]).reshape(b.n_tiles, rows, 18)
        dps_b = jpk._moments_vjp_bwd(cfg.h, True, (b.restT_rows, b.static_slab, 3),
                                     day_b)[2]
        df_b = jx(df[r0:r0 + b.n_tiles * rows]).reshape(b.n_tiles, rows, 3)
        srT_slab = packed.gather_packed_T(sr_packed, b.gidx8, b.slab_len, 16)
        dfm_b, ds6_b, drT_b = jpk._forces_warp_bwd_impl(
            b.restT_rows, b.static_slab, fm_b, srT_slab, df_b, cfg.h, True, chunks)
        refs.append({k: np.asarray(v, np.float64) for k, v in dict(
            fm=fm_b, sr=sr_b, ay=ay_b, f=f_b, dps=dps_b, dfm=dfm_b, ds6=ds6_b,
            drT=drT_b).items()})
    srT = np.zeros((15, sb.n_slots))
    srT[:, :m] = np.asarray(sr16, np.float64)[:, :15].T
    return dict(dtype=dtype, cfg=cfg, scene_j=scene_j, scene_t=scene_t, pos=pos,
                scale=scale, day=day, df=df, refs=refs, srT=srT,
                fmT=np.asarray(fm, np.float64).reshape(m, 19).T,
                stat=np.asarray(sb.stat_rows, np.float64).reshape(m, 18))


def _t(a, dtype):
    return torch.as_tensor(np.array(a, np.float64)).to(
        {"float32": torch.float32, "float64": torch.float64}[dtype])


def _bucket_cols(scene_t):
    sb = scene_t.blocked
    return [slice(b.row_start, b.row_start + b.n_tiles * sb.rows) for b in sb.buckets]


def test_row_static_is_the_jax_stat_record(case):
    """RowStatic reads the scene's own arrays; stacked after the scene's
    static row sums, they are JAX's stat_rows record [rs6 | mu | lam | vol |
    rest_corr_9], bit for bit."""
    sc = case["scene_t"]
    rs = fk.row_static(sc.blocked, sc.materials, sc.rest_corr)
    stacked = torch.cat([sc.blocked.rs6T, rs.mu[None], rs.lam[None], rs.vol[None],
                         rs.rcT])
    np.testing.assert_array_equal(stacked.double().numpy().T, case["stat"])


def test_moments_mid_plain_matches_jax_per_bucket(case):
    dtype, cfg, sc = case["dtype"], case["cfg"], case["scene_t"]
    sb = sc.blocked
    posT = _t(case["pos"].T, dtype).contiguous()
    rs = fk.row_static(sb, sc.materials, sc.rest_corr)
    scale = _t(case["scale"], dtype)
    tol = TOL["float64"] if dtype == "float64" else TOL_MID_F32
    for b, c, ref in zip(sb.buckets, _bucket_cols(sc), case["refs"]):
        mb = b.n_tiles * sb.rows
        fmT, srT, ayT = fk.moments_mid_plain(b.restT_rows, b.static_slab, posT,
                                             posT[:, c], rs.cols(c), scale[c],
                                             b.gidx8, cfg.h, True, emit_ay=True)
        assert fmT.shape == (19, mb) and srT.shape == (15, mb)
        assert _rel(fmT.T, ref["fm"].reshape(mb, 19)) <= tol
        assert _rel(srT.T, ref["sr"].reshape(mb, 16)[:, :15]) <= tol
        # JAX's raw dots, centered against the static row sums: A | Y
        stat = case["stat"][c]
        pos_i = case["pos"][c]
        ay = ref["ay"].reshape(mb, 18).copy()
        for blk in range(6):
            for a in range(3):
                ay[:, 3 * blk + a] -= pos_i[:, a] * stat[:, blk]
        assert _rel(ayT.T, ay) <= tol


def test_forces_warp_v2_plain_matches_jax_per_bucket(case):
    dtype, cfg, sc = case["dtype"], case["cfg"], case["scene_t"]
    sb = sc.blocked
    fmT, srT = _t(case["fmT"], dtype), _t(case["srT"], dtype)
    for b, c, ref in zip(sb.buckets, _bucket_cols(sc), case["refs"]):
        f = fk.forces_warp_v2_plain(b.restT_rows, b.static_slab, fmT[:, c], srT,
                                    b.gidx8, cfg.h)
        assert _rel(f.T, ref["f"].reshape(-1, 3)) <= TOL[dtype]


def test_backward_plain_versions_match_jax_per_bucket(case):
    dtype, cfg, sc = case["dtype"], case["cfg"], case["scene_t"]
    sb = sc.blocked
    fmT, srT = _t(case["fmT"], dtype), _t(case["srT"], dtype)
    dayT, dfT = _t(case["day"].T, dtype), _t(case["df"].T, dtype)
    for b, c, ref in zip(sb.buckets, _bucket_cols(sc), case["refs"]):
        mb = b.n_tiles * sb.rows
        dps = fk.moments_raw_bwd_plain(b.restT_rows, b.static_slab, dayT[:, c], cfg.h)
        assert dps.shape == (b.n_tiles, 3, b.slab_len)
        assert _rel(dps, ref["dps"]) <= TOL[dtype]
        dfm, dsr = fk.forces_warp_v2_bwd_plain(b.restT_rows, b.static_slab,
                                               fmT[:, c], srT, b.gidx8, dfT[:, c],
                                               cfg.h)
        assert dfm.shape == (19, mb) and dsr.shape == (b.n_tiles, 15, b.slab_len)
        assert not dfm[18].any()
        assert _rel(dfm[:18].T, ref["dfm"].reshape(mb, 19)[:, :18]) <= TOL[dtype]
        assert _rel(dsr[:, :6], ref["ds6"]) <= TOL[dtype]
        assert _rel(dsr[:, 6:], ref["drT"]) <= TOL[dtype]


def test_scene_wrappers_match_jax_per_bucket(case):
    """The whole-scene wrappers (one launch each on the card, their scene
    plain versions here) hold each bucket's columns to JAX's per-bucket
    launches: moments_mid's fm / sr / A | Y, and moments_raw_bwd's slab
    side (placed at gi_off * group + s) with JAX's row side
    -pos_i-cotangent . rs6 as its row term."""
    dtype, cfg, sc = case["dtype"], case["cfg"], case["scene_t"]
    sb = sc.blocked
    m = sb.n_tiles * sb.rows
    posT = _t(case["pos"].T, dtype).contiguous()
    rs = fk.row_static(sb, sc.materials, sc.rest_corr)
    dayT = _t(case["day"].T, dtype).contiguous()
    fmT, srT, ayT = fk.moments_mid(sb, posT, posT[:, :m], rs, _t(case["scale"], dtype),
                                   cfg.h, True, True)
    dps, dprow = fk.moments_raw_bwd(sb, dayT, cfg.h, True)
    tol = TOL["float64"] if dtype == "float64" else TOL_MID_F32
    assert srT.shape == (15, sb.n_slots) and not srT[:, m:].any()
    e0 = 0
    for b, c, ref in zip(sb.buckets, _bucket_cols(sc), case["refs"]):
        mb, n = b.n_tiles * sb.rows, b.n_tiles * b.slab_len
        assert _rel(fmT[:, c].T, ref["fm"].reshape(mb, 19)) <= tol
        assert _rel(srT[:, c].T, ref["sr"].reshape(mb, 16)[:, :15]) <= tol
        stat, pos_i = case["stat"][c], case["pos"][c]
        ay = ref["ay"].reshape(mb, 18).copy()
        for blk in range(6):
            for a in range(3):
                ay[:, 3 * blk + a] -= pos_i[:, a] * stat[:, blk]
        assert _rel(ayT[:, c].T, ay) <= tol
        got = dps[:, e0:e0 + n].reshape(3, b.n_tiles, b.slab_len).permute(1, 0, 2)
        assert _rel(got, ref["dps"]) <= TOL[dtype]
        e0 += n
    assert e0 == dps.shape[1]
    ct = case["day"].reshape(m, 6, 3)
    want = -np.einsum("rka,rk->ar", ct, case["stat"][:, :6])
    assert _rel(dprow, want) <= TOL[dtype]


def test_cpu_dispatch_is_the_plain_version_and_counts_nothing(case):
    """On CPU tensors every wrapper returns its plain version's result and
    launches nothing (K2 v2 and its backward over the whole scene)."""
    dtype, cfg, sc = case["dtype"], case["cfg"], case["scene_t"]
    sb = sc.blocked
    fmT, srT = _t(case["fmT"], dtype), _t(case["srT"], dtype)
    dfT = _t(case["df"].T, dtype)
    fk_counts = {fn.__name__ for fn in fk.COUNTED}
    for fn in fk.COUNTED:
        fn.launches = 0
    a = (sb, fmT, srT)
    assert torch.equal(fk.forces_warp_v2(*a, cfg.h),
                       fk.forces_warp_v2_scene_plain(*a, cfg.h))
    for got, want in zip(fk.forces_warp_v2_bwd(*a, dfT, cfg.h),
                         fk.forces_warp_v2_bwd_scene_plain(*a, dfT, cfg.h)):
        assert torch.equal(got, want)
    assert fk_counts == {"moments_mid", "forces_warp_v2", "moments_raw_bwd",
                         "forces_warp_v2_bwd_rows", "forces_warp_v2_bwd_slab",
                         "moments_raw"}
    assert all(fn.launches == 0 for fn in fk.COUNTED)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fk.forces_warp_v2(sb, fmT, srT.to("meta"), cfg.h)
