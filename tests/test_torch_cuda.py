"""PyTorch port on the card: the hand-written CUDA kernels against their
plain versions (marker ``cuda``; they skip without a card — the kernels have
no CPU mode).  This file imports nothing of JAX, so it runs on a machine
with only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets up JAX.)  The same comparisons at
full width are chip_smoke.py phases 3-4 (forward), 9-11 (backward),
14-19 (the fused path, ``cfg.fused_mid``), 21-24 (the Taichi pairing's
separable K2) and 25-28 (the blocked layout's raw K1, K2 v2 and the
separable K2), 38-41 (the K2 kernels on a bf16 slab, ``cfg.pair_dtype``),
44 (the mid-section kernels ``mid_records`` / ``mid_records_bwd``), 45
(the gather backend's kernels, ``ops/gather_kernels``); the gather
backend's paths are phases 30-32, the contact forces, which have no
hand-written kernel, phase 33."""

import dataclasses

import numpy as np
import pytest
import torch

from softbody_tpu_torch import warp_parity
from softbody_tpu_torch.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu_torch.ops import fused_kernels as fk
from softbody_tpu_torch.ops import gather_kernels as gk
from softbody_tpu_torch.ops import mid_kernels as mk
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops import separable_kernels as sk
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.scenarios import STRETCH, dirichlet_mask
from softbody_tpu_torch.sim.blocked import build_blocked_scene, elastic_forces_pallas
from softbody_tpu_torch.sim.rollout import rollout, value_and_grad_fn
from softbody_tpu_torch.sim.sparse import build_sparse_scene, elastic_forces_sparse

pytestmark = pytest.mark.cuda

TOL = {"float32": 1e-4, "float64": 1e-12}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _scene(dtype, dev, blocked=False):
    pts, out_num = inflatable_sphere(n_outer=600)
    cfg = warp_parity().replace(h=suggest_h(pts, 32), dtype=dtype, backend="pallas",
                                frames=20, target_frames=2, **STRETCH)
    build = build_blocked_scene if blocked else build_sparse_scene
    scene, sop = build(pts, cfg, out_num=out_num,
                       dirichlet_mask=dirichlet_mask(pts, "stretch"), device=dev)
    rng = np.random.default_rng(0)
    pos = scene.rest_position.clone()
    noise = rng.normal(scale=0.05 * cfg.h, size=(len(pts), 3))
    pos[scene.slot_of_particle] += torch.as_tensor(noise, dtype=pos.dtype, device=dev)
    x = torch.as_tensor(rng.normal(scale=0.5, size=scene.blocked.n_slots),
                        dtype=pos.dtype, device=dev)
    return cfg, scene, pos, compute_ratio(x, cfg)


def _rel(a, b):
    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kernels_match_plain_per_bucket(dtype):
    """K1 and K2 launch once over the whole scene; each bucket's columns
    match that bucket's plain version, and a second launch repeats the
    first bit for bit."""
    dev = _card()
    cfg, scene, pos, _ = _scene(dtype, dev)
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    rng = np.random.default_rng(1)
    f9T = torch.as_tensor(rng.normal(size=(9, m)), dtype=pos.dtype, device=dev)
    srT = torch.as_tensor(rng.normal(size=(15, sb.n_slots)), dtype=pos.dtype, device=dev)
    srT[:, m:] = 0
    posT = pos.T.contiguous()
    pk.reset_launch_counts()
    k1 = pk.moments_v4(sb, posT, posT[:, :m], cfg.h)
    k2 = pk.forces_warp_v4(sb, f9T, srT, cfg.h)
    assert pk.moments_v4.launches == pk.forces_warp_v4.launches == 1
    assert len(sb.buckets) >= 2
    for b in sb.buckets:
        c = slice(b.row_start, b.row_start + b.n_tiles * sb.rows)
        p1 = pk.moments_v4_plain(b.restT_rows, b.static_slab, posT, posT[:, c],
                                 sb.rs6T[:, c], b.gidx8, cfg.h)
        p2 = pk.forces_warp_v4_plain(b.restT_rows, b.static_slab, f9T[:, c], srT,
                                     b.gidx8, cfg.h)
        assert _rel(k1[:, c], p1) <= TOL[dtype], b.slab_len
        assert _rel(k2[:, c], p2) <= TOL[dtype], b.slab_len
    assert torch.equal(k1, pk.moments_v4(sb, posT, posT[:, :m], cfg.h))
    assert torch.equal(k2, pk.forces_warp_v4(sb, f9T, srT, cfg.h))


def test_one_launch_of_each_ragged_kernel_per_force_evaluation():
    dev = _card()
    cfg, scene, pos, ratio = _scene("float32", dev)
    for c in (cfg, cfg.replace(pair_def_grad="j")):
        pk.reset_launch_counts()
        elastic_forces_sparse(pos, ratio, scene.materials, scene, c)
        counts = pk.launch_counts()
        assert counts["moments_v4"] == 1, counts
        assert counts["forces_warp_v4"] == (1 if c.pair_def_grad == "i" else 0), counts


def test_forces_kernel_path_matches_plain_and_is_deterministic():
    dev = _card()
    cfg, scene, pos, ratio = _scene("float32", dev)
    f1 = elastic_forces_sparse(pos, ratio, scene.materials, scene, cfg)
    f2 = elastic_forces_sparse(pos, ratio, scene.materials, scene, cfg)
    fp = elastic_forces_sparse(pos, ratio, scene.materials, scene, cfg,
                               pair_ops=pk.PLAIN)
    assert torch.equal(f1, f2)              # fixed-order sums, no atomics
    assert _rel(f1, fp) <= TOL["float32"]


def test_short_episode_kernel_path_tracks_plain():
    # 300 steps, as chip_smoke.py phase 6: after fewer the displacement is
    # within a few f32 roundings of the positions themselves
    dev = _card()
    cfg, scene, _, ratio = _scene("float32", dev)
    x = torch.zeros(scene.blocked.n_slots, device=dev)
    _, fin_k, _ = rollout(x, scene, cfg, n_steps=300)
    _, fin_p, _ = rollout(x, scene, cfg, n_steps=300, pair_ops=pk.PLAIN)
    disp = torch.max(torch.abs(fin_p.position - scene.rest_position))
    assert torch.max(torch.abs(fin_k.position - fin_p.position)) <= 1e-3 * disp


def test_kernels_refuse_bad_operands():
    dev = _card()
    cfg, scene, pos, _ = _scene("float32", dev)
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    posT = pos.T.contiguous()
    srT = torch.zeros((15, sb.n_slots), device=dev)
    f9T = torch.zeros((9, m), device=dev)
    with pytest.raises(TypeError, match="dtype"):
        pk.moments_v4(sb, posT.double(), posT[:, :m].double(), cfg.h)
    with pytest.raises(ValueError, match="lanes"):
        pk.moments_v4(sb, pos.T, posT[:, :m], cfg.h)
    # the kernels copy 16-byte pieces: a misaligned base or row stride raises
    shifted = torch.empty(3 * sb.n_slots + 1, device=dev)[1:].view(3, sb.n_slots)
    shifted.copy_(posT)
    with pytest.raises(ValueError, match="16-byte"):
        pk.moments_v4(sb, shifted, posT[:, :m], cfg.h)
    wide = torch.zeros((15, sb.n_slots + 2), device=dev)[:, :sb.n_slots]
    with pytest.raises(ValueError, match="multiple of 4"):
        pk.forces_warp_v4(sb, f9T, wide, cfg.h)
    with pytest.raises(TypeError, match="dtype"):
        pk.forces_warp_v4(sb, f9T, srT.to(torch.int32), cfg.h)


def _bwd_inputs(cfg, scene, pos, seed):
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=pos.dtype,
                               device=pos.device)

    f9T = rand(9, m)
    srT = rand(15, sb.n_slots)
    srT[:, m:] = 0
    return f9T, srT, rand(18, m), rand(3, m)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_backward_kernels_match_plain_per_bucket(dtype):
    """The K1 backward and the two K2 backward passes launch once over the
    whole scene; each bucket's columns (its tile rows, and its slab entries
    in the per-entry buffers) match that bucket's plain version, and a
    second launch repeats the first bit for bit."""
    dev = _card()
    cfg, scene, pos, _ = _scene(dtype, dev)
    sb = scene.blocked
    f9T, srT, dayT, dfT = _bwd_inputs(cfg, scene, pos, 2)
    pk.reset_launch_counts()
    dps, dprow = pk.moments_v4_bwd(sb, dayT, cfg.h)
    df9 = pk.forces_warp_v4_bwd_rows(sb, f9T, srT, dfT, cfg.h)
    dsr = pk.forces_warp_v4_bwd_slab(sb, f9T, srT, dfT, cfg.h)
    counts = pk.launch_counts()
    assert counts == dict.fromkeys(counts, 0) | {
        "moments_v4_bwd": 1, "forces_warp_v4_bwd_rows": 1,
        "forces_warp_v4_bwd_slab": 1}
    assert len(sb.buckets) >= 2
    e0 = 0
    for b in sb.buckets:
        t, slab = b.n_tiles, b.slab_len
        c = slice(b.row_start, b.row_start + t * sb.rows)
        seg = slice(e0, e0 + t * slab)
        e0 += t * slab
        p1 = pk.moments_v4_bwd_plain(b.restT_rows, b.static_slab, dayT[:, c],
                                     sb.rs6T[:, c], cfg.h)
        p2 = pk.forces_warp_v4_bwd_plain(b.restT_rows, b.static_slab, f9T[:, c],
                                         srT, b.gidx8, dfT[:, c], cfg.h)
        got = (dps[:, seg].view(3, t, slab).permute(1, 0, 2), dprow[:, c],
               df9[:, c], dsr[:, seg].view(15, t, slab).permute(1, 0, 2))
        for g, want in zip(got, p1 + p2):
            assert g.shape == want.shape
            assert _rel(g, want) <= TOL[dtype], b.slab_len
    assert e0 == dps.shape[1] == dsr.shape[1]
    again = pk.moments_v4_bwd(sb, dayT, cfg.h) + (
        pk.forces_warp_v4_bwd_rows(sb, f9T, srT, dfT, cfg.h),
        pk.forces_warp_v4_bwd_slab(sb, f9T, srT, dfT, cfg.h))
    assert all(torch.equal(x, y) for x, y in zip((dps, dprow, df9, dsr), again))
    buf = torch.as_tensor(np.random.default_rng(3).normal(size=(15, e0)),
                          dtype=pos.dtype, device=dev)
    args = (buf, sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
    pk.reset_launch_counts()
    assert _rel(pk.slab_to_slots(*args), pk.slab_to_slots_plain(*args)) <= TOL[dtype]
    assert pk.launch_counts()["slab_to_slots"] == 1


def test_one_launch_of_each_backward_kernel_per_backward_evaluation():
    dev = _card()
    cfg, scene, pos, ratio = _scene("float32", dev)
    ct = torch.as_tensor(np.random.default_rng(6).normal(size=tuple(pos.shape)),
                         dtype=pos.dtype, device=dev)
    for c in (cfg, cfg.replace(pair_def_grad="j")):
        p = pos.clone().requires_grad_()
        f = elastic_forces_sparse(p, ratio, scene.materials, scene, c)
        pk.reset_launch_counts()
        torch.autograd.grad(f, p, ct)
        counts = pk.launch_counts()
        k2 = 1 if c.pair_def_grad == "i" else 0
        assert counts["moments_v4_bwd"] == 1, counts
        assert counts["forces_warp_v4_bwd_rows"] == k2, counts
        assert counts["forces_warp_v4_bwd_slab"] == k2, counts
        assert counts["slab_to_slots"] == 2, counts


def _episode_grad(dtype, dev, pair_ops, fused=False, pair_def_grad="i",
                  blocked=False):
    # targets: the rest body jittered; 40 steps, so that the clamped body
    # strains enough for x to move the loss well above its roundings (after
    # 8 steps F - I ~ 1e-9 and two summation orders differ by ~2e-9 of g)
    cfg, scene, pos, _ = _scene(dtype, dev, blocked)
    cfg = cfg.replace(fused_mid=fused, pair_def_grad=pair_def_grad)
    sop = scene.slot_of_particle
    rng = np.random.default_rng(4)
    tp = scene.rest_position.repeat(2, 1, 1)
    tp[:, sop] += torch.as_tensor(rng.normal(scale=1e-4, size=(2, len(sop), 3)),
                                  dtype=pos.dtype, device=dev)
    tv = torch.zeros_like(tp)
    x0 = torch.as_tensor(rng.normal(scale=0.5, size=scene.blocked.n_slots),
                         dtype=pos.dtype, device=dev)
    return value_and_grad_fn(scene, cfg, n_steps=40, pair_ops=pair_ops)(x0, tp, tv)


def test_episode_gradient_kernel_path_matches_plain_f64():
    dev = _card()
    loss_k, g_k = _episode_grad("float64", dev, pk.KERNELS)
    loss_p, g_p = _episode_grad("float64", dev, pk.PLAIN)
    assert loss_p > 0 and float(torch.max(torch.abs(g_p))) > 0
    assert abs(loss_k - loss_p) <= 1e-10 * loss_p
    assert _rel(g_k, g_p) <= 1e-10


def test_episode_gradient_is_bitwise_repeatable():
    dev = _card()
    pk.reset_launch_counts()
    loss1, g1 = _episode_grad("float32", dev, pk.KERNELS)
    counts = pk.launch_counts()
    loss2, g2 = _episode_grad("float32", dev, pk.KERNELS)
    assert loss1 == loss2 and torch.equal(g1, g2)   # fixed-order sums only
    others = {fn.__name__
              for fn in fk.COUNTED + sk.COUNTED + gk.COUNTED + pk.BF16_COUNTED}
    assert all(v > 0 for k, v in counts.items() if k not in others), counts
    assert all(counts[k] == 0 for k in others), counts


def test_backward_kernels_refuse_bad_operands():
    dev = _card()
    cfg, scene, pos, _ = _scene("float32", dev)
    sb = scene.blocked
    f9T, srT, dayT, dfT = _bwd_inputs(cfg, scene, pos, 5)
    with pytest.raises(ValueError, match="18"):
        pk.moments_v4_bwd(sb, dayT[:17], cfg.h)
    with pytest.raises(TypeError, match="dtype"):
        pk.forces_warp_v4_bwd(sb, f9T, srT, dfT.double(), cfg.h)
    # the row pass copies 16-byte pieces of srT
    shifted = torch.empty(15 * sb.n_slots + 1, device=dev)[1:].view(15, sb.n_slots)
    shifted.copy_(srT)
    with pytest.raises(ValueError, match="16-byte"):
        pk.forces_warp_v4_bwd_rows(sb, f9T, shifted, dfT, cfg.h)
    # the slab side walks every 128-entry chunk of the scene
    short = dataclasses.replace(sb, chunks=sb.chunks[:-1])
    with pytest.raises(ValueError, match="chunks"):
        pk.moments_v4_bwd(short, dayT, cfg.h)
    with pytest.raises(ValueError, match="chunks"):
        pk.forces_warp_v4_bwd_slab(short, f9T, srT, dfT, cfg.h)
    with pytest.raises(ValueError, match="entries"):
        pk.slab_to_slots(srT, sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
    # the v4 kernels serve the sparse scene's slabs of whole 128-entry
    # chunks; a blocked slab ends in a partial one
    blk = _scene("float32", dev, blocked=True)[1].blocked
    assert blk.slab_len % 32
    with pytest.raises(ValueError, match="whole 128"):
        pk.moments_v4_bwd(blk, torch.zeros((18, blk.n_tiles * blk.rows), device=dev), cfg.h)
    with pytest.raises(ValueError, match="whole 32"):
        pk.forces_warp_v4(blk, f9T[:, :1], srT[:, :1], cfg.h)


# ------------------------------------------------------------ the fused path
def _fused_inputs(scene, cfg, pos, ratio, seed):
    """Operands of the four fused kernels, and random
    cotangents."""
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=pos.dtype,
                               device=pos.device)

    posT = pos.T.contiguous()
    rs = fk.row_static(sb, scene.materials, scene.rest_corr)
    scale = cfg.stiffness_scale(ratio[:m])
    fmT, srT = fk.moments_mid_all(posT, posT[:, :m], scale, sb, rs, cfg.h,
                                  cfg.corotated, pk.PLAIN)
    return posT, rs, scale, fmT, srT, rand(18, m), rand(3, m)


def _v2_launches(sb, fmT, srT, dfT, h):
    """The three whole-scene K2 v2 launches: (fT, dfmT, dsr)."""
    return (fk.forces_warp_v2(sb, fmT, srT, h),
            fk.forces_warp_v2_bwd_rows(sb, fmT, srT, dfT, h),
            fk.forces_warp_v2_bwd_slab(sb, fmT, srT, dfT, h))


def _hold_v2_per_bucket(sb, fmT, srT, dfT, h, got, tol):
    """Each bucket's columns of the three K2 v2 launches (its tile rows,
    and its slab entries in the per-entry buffer) against that bucket's
    plain version."""
    f, dfm, dsr = got
    e0 = 0
    for b in sb.buckets:
        t, slab = b.n_tiles, b.slab_len
        c = slice(b.row_start, b.row_start + t * sb.rows)
        seg = slice(e0, e0 + t * slab)
        e0 += t * slab
        a = (b.restT_rows, b.static_slab, fmT[:, c], srT, b.gidx8)
        p_dfm, p_dsr = fk.forces_warp_v2_bwd_plain(*a, dfT[:, c], h)
        pairs = ((f[:, c], fk.forces_warp_v2_plain(*a, h)), (dfm[:, c], p_dfm),
                 (dsr[:, seg].view(15, t, slab).permute(1, 0, 2), p_dsr))
        for g, want in pairs:
            assert g.shape == want.shape
            assert _rel(g, want) <= tol, (slab, _rel(g, want))
        assert not dfm[18, c].any()
    assert e0 == dsr.shape[1]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("corotated", [True, False])
def test_fused_kernels_match_plain_per_bucket(dtype, corotated):
    """The fused K1 + mid-section, the raw K1 backward with its row term,
    K2 v2 and its two backward passes, one launch each over the whole
    scene, each bucket's columns held against that bucket's plain version;
    srT's padding columns zero; a second launch bit for bit the first."""
    dev = _card()
    cfg, scene, pos, ratio = _scene(dtype, dev)
    cfg = cfg.replace(corotated=corotated)
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    posT, rs, scale, fmT, srT, dayT, dfT = _fused_inputs(scene, cfg, pos, ratio, 6)

    def launch():
        return (fk.moments_mid(sb, posT, posT[:, :m], rs, scale, cfg.h, corotated, True),
                fk.moments_raw_bwd(sb, dayT, cfg.h, True))

    pk.reset_launch_counts()
    (k_fm, k_sr, k_ay), (k_dps, k_dprow) = got = launch()
    assert k_sr.shape == (15, sb.n_slots) and not k_sr[:, m:].any()
    p_dprow = -sum(dayT.view(6, 3, m)[k] * sb.rs6T[k] for k in range(6))
    e0 = 0
    for b in sb.buckets:
        t, slab = b.n_tiles, b.slab_len
        c = slice(b.row_start, b.row_start + t * sb.rows)
        seg = slice(e0, e0 + t * slab)
        e0 += t * slab
        p_mid = fk.moments_mid_plain(b.restT_rows, b.static_slab, posT, posT[:, c],
                                     rs.cols(c), scale[c], b.gidx8, cfg.h, corotated, True)
        p_dps = fk.moments_raw_bwd_plain(b.restT_rows, b.static_slab, dayT[:, c], cfg.h)
        pairs = list(zip((k_fm[:, c], k_sr[:, c], k_ay[:, c]), p_mid)) + [
            (k_dps[:, seg].view(3, t, slab).permute(1, 0, 2), p_dps),
            (k_dprow[:, c], p_dprow[:, c])]
        for g, want in pairs:
            assert g.shape == want.shape
            assert _rel(g, want) <= TOL[dtype], (slab, _rel(g, want))
    assert e0 == k_dps.shape[1]
    again = launch()
    assert all(torch.equal(x, y) for x, y in zip(got[0] + got[1], again[0] + again[1]))
    pk.reset_launch_counts()
    _hold_v2_per_bucket(sb, fmT, srT, dfT, cfg.h, _v2_launches(sb, fmT, srT, dfT, cfg.h),
                        TOL[dtype])
    counts = pk.launch_counts()
    assert counts == dict.fromkeys(counts, 0) | {
        "forces_warp_v2": 1, "forces_warp_v2_bwd_rows": 1, "forces_warp_v2_bwd_slab": 1}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_raw_bwd_on_a_varcol_slab_with_a_tail(dtype):
    """The raw K1 backward on a blocked varcol scene whose slab (936
    entries: 7 x 128 + 40) ends inside a 128-entry chunk, with and without
    its row term: one launch over the scene against the per-bucket plain
    version, and a second launch bit for bit the first."""
    dev = _card()
    cfg, scene, pos, _ = _scene(dtype, dev, blocked=True)
    blk = scene.blocked
    assert blk.slab_len % 128
    m = blk.n_tiles * blk.rows
    dayT = torch.as_tensor(np.random.default_rng(11).normal(size=(18, m)),
                           dtype=pos.dtype, device=dev)
    b = blk.bucket
    p_dps = fk.moments_raw_bwd_plain(b.restT_rows, b.static_slab, dayT, cfg.h)
    for rows in (False, True):
        pk.reset_launch_counts()
        dps, dprow = fk.moments_raw_bwd(blk, dayT, cfg.h, rows)
        counts = pk.launch_counts()
        assert counts == dict.fromkeys(counts, 0) | {"moments_raw_bwd": 1}
        got = dps.view(3, blk.n_tiles, blk.slab_len).permute(1, 0, 2)
        assert _rel(got, p_dps) <= TOL[dtype]
        if rows:
            want = -sum(dayT.view(6, 3, m)[k] * blk.rs6T[k] for k in range(6))
            assert _rel(dprow, want) <= TOL[dtype]
        else:
            assert dprow is None
        again = fk.moments_raw_bwd(blk, dayT, cfg.h, rows)
        assert torch.equal(dps, again[0])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_v2_kernels_on_a_varcol_slab_with_a_tail(dtype):
    """K2 v2 and its two backward passes on a blocked varcol scene whose
    slab (936 entries: 29 x 32 + 8, 7 x 128 + 40) ends in a partial chunk
    on both sides: one launch each against the plain version, and a second
    launch bit for bit the first."""
    dev = _card()
    cfg, scene, pos, ratio = _scene(dtype, dev, blocked=True)
    blk = scene.blocked
    assert blk.slab_len % 32 and blk.slab_len % 128
    m = blk.n_tiles * blk.rows
    rng = np.random.default_rng(10)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=pos.dtype, device=dev)

    fmT = rand(19, m)
    fmT[18] = scene.materials.volume[:m]
    srT = rand(15, blk.n_slots)
    srT[:, m:] = 0
    dfT = rand(3, m)
    pk.reset_launch_counts()
    got = _v2_launches(blk, fmT, srT, dfT, cfg.h)
    counts = pk.launch_counts()
    assert counts == dict.fromkeys(counts, 0) | {
        "forces_warp_v2": 1, "forces_warp_v2_bwd_rows": 1, "forces_warp_v2_bwd_slab": 1}
    _hold_v2_per_bucket(blk, fmT, srT, dfT, cfg.h, got, TOL[dtype])
    assert all(torch.equal(x, y)
               for x, y in zip(got, _v2_launches(blk, fmT, srT, dfT, cfg.h)))


def test_one_launch_of_each_v2_kernel_per_force_evaluation():
    """The fused path and path B: one K2 v2 launch (and on the fused path
    one K1 + mid-section launch) per force evaluation, one launch of each
    backward pass and of the raw K1 backward per backward evaluation."""
    dev = _card()
    for blocked in (False, True):
        cfg, scene, pos, ratio = _scene("float32", dev, blocked)
        c = cfg if blocked else cfg.replace(fused_mid=True)
        p = pos.clone().requires_grad_()
        pk.reset_launch_counts()
        f = (elastic_forces_pallas if blocked else elastic_forces_sparse)(
            p, ratio, scene.materials, scene, c)
        counts = pk.launch_counts()
        assert counts["forces_warp_v2"] == 1
        assert counts["moments_mid"] == (0 if blocked else 1), counts
        pk.reset_launch_counts()
        torch.autograd.grad(f, p, torch.ones_like(f))
        counts = pk.launch_counts()
        assert counts["forces_warp_v2_bwd_rows"] == counts["forces_warp_v2_bwd_slab"] == 1
        assert counts["moments_raw_bwd"] == 1, counts
        assert counts["forces_warp_v2"] == 0 and counts["slab_to_slots"] == 2, counts


def test_fused_forces_match_unfused_and_plain():
    dev = _card()
    cfg, scene, pos, ratio = _scene("float32", dev)
    fused = cfg.replace(fused_mid=True)
    f1 = elastic_forces_sparse(pos, ratio, scene.materials, scene, fused)
    f2 = elastic_forces_sparse(pos, ratio, scene.materials, scene, fused)
    fp = elastic_forces_sparse(pos, ratio, scene.materials, scene, fused,
                               pair_ops=pk.PLAIN)
    fu = elastic_forces_sparse(pos, ratio, scene.materials, scene, cfg)
    assert torch.equal(f1, f2)
    assert _rel(f1, fp) <= TOL["float32"]
    assert _rel(f1, fu) <= TOL["float32"]


def test_fused_kernels_refuse_bad_operands():
    dev = _card()
    cfg, scene, pos, ratio = _scene("float32", dev)
    sb = scene.blocked
    b = sb.buckets[0]
    posT, rs, scale, fmT, srT, dayT, dfT = _fused_inputs(scene, cfg, pos, ratio, 7)
    m = sb.n_tiles * sb.rows
    with pytest.raises(ValueError, match="contiguous"):
        fk.moments_mid(sb, posT, posT[:, :m], rs,
                       torch.stack([scale, scale], dim=1)[:, 0], cfg.h, True)
    # moments_mid serves the sparse scene, whose slabs are whole 32-entry stages
    blk = _scene("float32", dev, blocked=True)[1].blocked
    with pytest.raises(ValueError, match="whole 32"):
        fk.moments_mid(blk, posT, posT[:, :m], rs, scale, cfg.h, True)
    with pytest.raises(TypeError, match="dtype"):
        fk.forces_warp_v2(sb, fmT.double(), srT, cfg.h)
    with pytest.raises(ValueError, match="19"):
        fk.forces_warp_v2_bwd(sb, fmT[:18], srT, dfT, cfg.h)
    with pytest.raises(ValueError, match="18"):
        fk.moments_raw_bwd(sb, dayT[:17], cfg.h, True)
    # the ring copies 16-byte pieces of srT; the slab pass walks every chunk
    shifted = torch.empty(15 * sb.n_slots + 1, device=dev)[1:].view(15, sb.n_slots)
    shifted.copy_(srT)
    with pytest.raises(ValueError, match="16-byte"):
        fk.forces_warp_v2(sb, fmT, shifted, cfg.h)
    short = dataclasses.replace(sb, chunks=sb.chunks[:-1])
    with pytest.raises(ValueError, match="chunks"):
        fk.forces_warp_v2_bwd_slab(short, fmT, srT, dfT, cfg.h)
    with pytest.raises(ValueError, match="chunks"):
        fk.moments_raw_bwd(short, dayT, cfg.h)
    # a slab need only be a multiple of the slot group (8), no other
    odd = dataclasses.replace(sb, buckets=(dataclasses.replace(b, slab_len=b.slab_len - 4),)
                              + sb.buckets[1:])
    with pytest.raises(ValueError, match="slot group"):
        fk.forces_warp_v2(odd, fmT, srT, cfg.h)
    with pytest.raises(ValueError, match="slot group"):
        pk.forces_warp_v4(odd, fmT[:9], srT, cfg.h)


def test_fused_episode_gradient_matches_plain_f64_and_repeats():
    dev = _card()
    loss_k, g_k = _episode_grad("float64", dev, pk.KERNELS, fused=True)
    loss_p, g_p = _episode_grad("float64", dev, pk.PLAIN, fused=True)
    assert loss_p > 0 and float(torch.max(torch.abs(g_p))) > 0
    assert abs(loss_k - loss_p) <= 1e-10 * loss_p
    assert _rel(g_k, g_p) <= 1e-10
    pk.reset_launch_counts()
    loss1, g1 = _episode_grad("float32", dev, pk.KERNELS, fused=True)
    counts = pk.launch_counts()
    loss2, g2 = _episode_grad("float32", dev, pk.KERNELS, fused=True)
    assert loss1 == loss2 and torch.equal(g1, g2)   # fixed-order sums only
    fused = [fn for fn in fk.COUNTED if fn is not fk.moments_raw] + [mk.mid_records_bwd]
    assert all(counts[fn.__name__] > 0 for fn in fused), counts
    assert counts["moments_v4"] == counts["forces_warp_v4"] == counts["moments_raw"] == 0
    assert counts["mid_records"] == 0, counts


# ------------------------------------------------ Taichi pairing, blocked layout
def _sep_operands(scene, seed):
    """gT (9, n_slots) = V M with random M, zero past the tile rows; the
    rows' volumes; a random dfT (3, m)."""
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    dev, dt = scene.rest_position.device, scene.rest_position.dtype
    rng = np.random.default_rng(seed)
    vol = scene.materials.volume[:m].contiguous()
    gT = torch.zeros((9, sb.n_slots), dtype=dt, device=dev)
    gT[:, :m] = torch.as_tensor(rng.normal(size=(9, m)), dtype=dt, device=dev) * vol
    return gT, vol, torch.as_tensor(rng.normal(size=(3, m)), dtype=dt, device=dev)


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_separable_kernels_match_plain_per_bucket(dtype, blocked):
    """The separable K2 and its backward, one launch each over the sparse
    scene or a varcol one (slab 936 = 29 x 32 + 8 = 7 x 128 + 40): every
    bucket's columns against that bucket's plain version, and a second
    launch bit for bit the first."""
    dev = _card()
    cfg, scene, _, _ = _scene(dtype, dev, blocked)
    sb = scene.blocked
    gT, vol, dfT = _sep_operands(scene, 8)
    pk.reset_launch_counts()
    f = sk.forces_sep(sb, gT, vol, cfg.h)
    dgs, dgr = sk.forces_sep_bwd(sb, vol, dfT, cfg.h)
    counts = pk.launch_counts()
    assert counts == dict.fromkeys(counts, 0) | {"forces_sep": 1, "forces_sep_bwd": 1}
    e0 = 0
    for b in sb.buckets:
        t, slab = b.n_tiles, b.slab_len
        c = slice(b.row_start, b.row_start + t * sb.rows)
        seg = slice(e0, e0 + t * slab)
        e0 += t * slab
        want = sk.forces_sep_plain(b.restT_rows, b.static_slab, gT[:, c], gT, vol[c],
                                   b.gidx8, cfg.h)
        p_dgr, p_dgs = sk.forces_sep_bwd_plain(b.restT_rows, b.static_slab, vol[c],
                                               dfT[:, c], cfg.h)
        assert _rel(f[:, c], want) <= TOL[dtype]
        assert _rel(dgr[:, c], p_dgr) <= TOL[dtype]
        assert _rel(dgs[:, seg].view(9, t, slab).permute(1, 0, 2), p_dgs) <= TOL[dtype]
    assert e0 == dgs.shape[1]
    assert torch.equal(f, sk.forces_sep(sb, gT, vol, cfg.h))
    again = sk.forces_sep_bwd(sb, vol, dfT, cfg.h)
    assert torch.equal(again[0], dgs) and torch.equal(again[1], dgr)


def test_one_launch_of_each_separable_kernel_per_evaluation():
    """Path A and path B with the Taichi pairing: one separable K2 launch
    per force evaluation, one backward launch per backward evaluation."""
    dev = _card()
    for blocked in (False, True):
        cfg, scene, pos, ratio = _scene("float32", dev, blocked)
        c = cfg.replace(pair_def_grad="j")
        p = pos.clone().requires_grad_()
        pk.reset_launch_counts()
        f = (elastic_forces_pallas if blocked else elastic_forces_sparse)(
            p, ratio, scene.materials, scene, c)
        assert pk.launch_counts()["forces_sep"] == 1
        pk.reset_launch_counts()
        torch.autograd.grad(f, p, torch.ones_like(f))
        counts = pk.launch_counts()
        assert counts["forces_sep_bwd"] == 1 and counts["forces_sep"] == 0, counts


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_moments_raw_and_blocked_forces_match_plain(dtype):
    """The raw K1 per launch on a blocked scene, then one path-B force
    evaluation and its VJP for both pairings, kernel path vs plain path;
    bitwise repeatable."""
    dev = _card()
    cfg, scene, pos, ratio = _scene(dtype, dev, blocked=True)
    blk = scene.blocked
    b = blk.bucket
    posT = pos.T.contiguous()
    pk.reset_launch_counts()
    raw = fk.moments_raw(b.restT_rows, b.static_slab, posT, b.gidx8, cfg.h)
    assert _rel(raw, fk.moments_raw_plain(b.restT_rows, b.static_slab, posT, b.gidx8,
                                          cfg.h)) <= TOL[dtype]
    assert pk.launch_counts()["moments_raw"] == 1
    tol = {"float32": 1e-4, "float64": 1e-10}[dtype]
    ct = torch.as_tensor(np.random.default_rng(9).normal(size=tuple(pos.shape)),
                         dtype=pos.dtype, device=dev)
    for pdg in ("i", "j"):
        c = cfg.replace(pair_def_grad=pdg)

        def run(ops):
            p = pos.clone().requires_grad_()
            f = elastic_forces_pallas(p, ratio, scene.materials, scene, c, ops)
            return f, torch.autograd.grad(f, p, ct)[0]

        (f1, g1), (f2, g2), (fp, gp) = [
            (f.detach(), g) for f, g in (run(pk.KERNELS), run(pk.KERNELS), run(pk.PLAIN))]
        assert torch.equal(f1, f2) and torch.equal(g1, g2)
        assert _rel(f1, fp) <= tol and _rel(g1, gp) <= tol


def test_separable_and_raw_kernels_refuse_bad_operands():
    dev = _card()
    cfg, scene, pos, _ = _scene("float32", dev)
    sb = scene.blocked
    b = sb.buckets[0]
    m = sb.n_tiles * sb.rows
    gT = torch.zeros((9, sb.n_slots), device=dev)
    vol = scene.materials.volume[:m].contiguous()
    with pytest.raises(ValueError, match="9"):
        sk.forces_sep(sb, gT[:8], vol, cfg.h)
    with pytest.raises(ValueError, match="vol_m"):
        sk.forces_sep_bwd(sb, vol[:-1], torch.zeros((3, m), device=dev), cfg.h)
    shifted = torch.zeros((9, sb.n_slots + 1), device=dev)[:, 1:]
    with pytest.raises(ValueError, match="16-byte"):
        sk.forces_sep(sb, shifted, vol, cfg.h)
    with pytest.raises(TypeError, match="dtype"):
        fk.moments_raw(b.restT_rows, b.static_slab, pos.T.contiguous().double(),
                       b.gidx8, cfg.h)


@pytest.mark.parametrize("path", ["taichi_sparse", "blocked_warp", "blocked_taichi"])
def test_new_paths_episode_gradient_matches_plain_f64_and_repeats(path):
    dev = _card()
    kw = {"taichi_sparse": dict(pair_def_grad="j"),
          "blocked_warp": dict(blocked=True),
          "blocked_taichi": dict(blocked=True, pair_def_grad="j")}[path]
    loss_k, g_k = _episode_grad("float64", dev, pk.KERNELS, **kw)
    loss_p, g_p = _episode_grad("float64", dev, pk.PLAIN, **kw)
    assert loss_p > 0 and float(torch.max(torch.abs(g_p))) > 0
    assert abs(loss_k - loss_p) <= 1e-10 * loss_p
    assert _rel(g_k, g_p) <= 1e-10
    loss1, g1 = _episode_grad("float32", dev, pk.KERNELS, **kw)
    loss2, g2 = _episode_grad("float32", dev, pk.KERNELS, **kw)
    assert loss1 == loss2 and torch.equal(g1, g2)


def test_gather_backward_repeats_bitwise_on_the_card():
    """The gather backend's backward kernels add each source row's readers
    in the CSR order of its table (ops/gather_kernels), so a gradient
    through the gather forces repeats bit for bit on the card, and matches
    the CPU."""
    from softbody_tpu_torch.sim.scene import build_scene
    from softbody_tpu_torch.sim.rollout import elastic_forces

    dev = _card()
    pts, out_num = inflatable_sphere(n_outer=600)
    cfg = warp_parity().replace(h=suggest_h(pts, 32), dtype="float32", backend="gather",
                                max_neighbors=0)
    rng = np.random.default_rng(11)
    pos_np = pts + rng.normal(scale=0.05 * cfg.h, size=pts.shape)
    x_np = rng.normal(scale=0.5, size=len(pts))
    ct_np = rng.normal(size=pts.shape)

    def vjp(device):
        scene = build_scene(pts, cfg, out_num=out_num, device=device)
        p = torch.as_tensor(pos_np, dtype=torch.float32, device=device).requires_grad_()
        x = torch.as_tensor(x_np, dtype=torch.float32, device=device).requires_grad_()
        f = elastic_forces(p, compute_ratio(x, cfg), scene, cfg)
        return (f,) + torch.autograd.grad(f, (p, x), torch.as_tensor(
            ct_np, dtype=torch.float32, device=device))

    a, b, cpu = vjp(dev), vjp(dev), vjp("cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    for u, v in zip(a, cpu):
        assert _rel(u.cpu(), v) <= 1e-4


def test_contact_forces_on_the_card_match_the_cpu():
    """Dynamic contact re-binned on the card (f32) against the same call on
    the CPU, 1e-5 of max |f|, its overflow flag alike, and its gradient
    bitwise repeatable (the position gather's fixed-order backward)."""
    from softbody_tpu_torch.ops.contact import build_contact_grid, contact_forces

    dev = _card()
    pos_np = np.random.default_rng(12).uniform(0.0, 1.0, (4000, 3))
    exclude = np.random.default_rng(13).integers(0, 4000, (4000, 8))
    grid = build_contact_grid([-0.1] * 3, [1.1] * 3, r_c=0.05, cap=16, stiffness=1e4,
                              exclude=exclude)
    out = {}
    for device in ("cpu", dev):
        p = torch.as_tensor(pos_np, dtype=torch.float32, device=device).requires_grad_()
        f, ovf = contact_forces(p, grid.to(device), with_overflow=True)
        g = [torch.autograd.grad(torch.sum(contact_forces(p, grid.to(device)) ** 2), p)[0]
             for _ in range(2)]
        out[str(device)] = (f.detach().cpu(), bool(ovf), g[0].cpu(), g[1].cpu())
    f_c, o_c, g_c, _ = out["cpu"]
    f_d, o_d, g_d, g_d2 = out[str(dev)]
    assert float(torch.abs(f_c).max()) > 0 and o_c == o_d
    assert _rel(f_d, f_c) <= 1e-5
    assert torch.equal(g_d, g_d2) and _rel(g_d, g_c) <= 1e-4


@pytest.mark.parametrize("blocked", [False, True])
def test_bf16_slab_kernels_match_plain(blocked):
    """The K2 kernels on a bf16 slab (``cfg.pair_dtype``; f32 arithmetic):
    v4 and its two backward passes on the sparse scene, v2 and its two on
    the varcol scene (slab ending inside a stage and a chunk), each one
    launch counted on its ``_bf16`` counter, against the plain version on
    the same bf16 slab (1e-4 of max |plain|), a second launch bit for bit
    the first; the cotangent scatter against its plain version (bf16 both:
    equal but where another f32 order tips a rounding, by at most 2^-7 of
    the largest value)."""
    dev = _card()
    cfg, scene, pos, _ = _scene("float32", dev, blocked)
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    rng = np.random.default_rng(14)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    srT = rand(15, sb.n_slots)
    srT[:, m:] = 0
    srT = srT.to(torch.bfloat16)
    dfT = rand(3, m)
    pk.reset_launch_counts()
    if blocked:
        fmT = rand(19, m)
        fmT[18] = scene.materials.volume[:m]
        got = _v2_launches(sb, fmT, srT, dfT, cfg.h)
        names = ("forces_warp_v2", "forces_warp_v2_bwd_rows", "forces_warp_v2_bwd_slab")
        counts = pk.launch_counts()
        _hold_v2_per_bucket(sb, fmT, srT, dfT, cfg.h, got, TOL["float32"])
        again = _v2_launches(sb, fmT, srT, dfT, cfg.h)
    else:
        f9T = rand(9, m)
        launch = lambda: (pk.forces_warp_v4(sb, f9T, srT, cfg.h),
                          pk.forces_warp_v4_bwd_rows(sb, f9T, srT, dfT, cfg.h),
                          pk.forces_warp_v4_bwd_slab(sb, f9T, srT, dfT, cfg.h))
        got = launch()
        counts = pk.launch_counts()
        names = ("forces_warp_v4", "forces_warp_v4_bwd_rows", "forces_warp_v4_bwd_slab")
        want = (pk.forces_warp_v4_scene_plain(sb, f9T, srT, cfg.h),
                *pk.forces_warp_v4_bwd_scene_plain(sb, f9T, srT, dfT, cfg.h))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and _rel(g, w) <= TOL["float32"]
        again = launch()
    assert counts == dict.fromkeys(counts, 0) | {f"{n}_bf16": 1 for n in names}
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    args = (got[2], sb.slab_ptr, sb.slab_idx, sb.bucket_starts, sb.n_slots, sb.group)
    _hold_bf16_scatter(args)


def _hold_bf16_scatter(args):
    """The bf16 cotangent scatter on ``args`` against its plain version (bf16
    both: equal but where another f32 order tips a rounding, at most 1 in
    200 values, by at most 2^-7 of the largest), one launch counted, a
    second launch bit for bit the first, and every slot of a group without
    readers exactly 0.  The kernel adds each bucket's readers in the CSR
    order, as the plain version does on the CPU: bit for bit that too."""
    pk.reset_launch_counts()
    out = pk.slab_to_slots_bf16(*args)
    assert pk.launch_counts()["slab_to_slots_bf16"] == 1
    k, p = out.float(), pk.slab_to_slots_bf16_plain(*args).float()
    assert (k != p).float().mean() < 5e-3
    assert float(torch.abs(k - p).max()) <= 2.0 ** -7 * float(torch.abs(p).max())
    on_cpu = pk.slab_to_slots_bf16_plain(*(a.cpu() if torch.is_tensor(a) else a
                                           for a in args))
    assert torch.equal(out.cpu().view(torch.int16), on_cpu.view(torch.int16))
    assert torch.equal(out.view(torch.int16), pk.slab_to_slots_bf16(*args).view(torch.int16))
    buf, slab_ptr, _, _, n_slots, group = args
    empty = out.view(buf.shape[0], n_slots // group, group)[:, torch.diff(slab_ptr) == 0]
    assert empty.numel() and not empty.contiguous().view(torch.int16).any()


@pytest.mark.parametrize("group", [4, 8, 12, 16])
def test_bf16_scatter_edge_lists(group):
    """The bf16 cotangent scatter on a synthetic CSR inverse over 8 buckets
    (``tests/test_torch_scatter_bf16.py``): lists of 0, 1, 31, 32, 33 and
    100 readers crossing every bucket boundary, a bucket without readers
    inside a list, a group read only by the last bucket; slot groups of 4
    to 16 (a warp per 8 slots)."""
    from tests.test_torch_scatter_bf16 import synthetic_csr

    dev = _card()
    args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in synthetic_csr(group))
    _hold_bf16_scatter(args)


def test_bf16_scatter_group16_scene():
    """The scatter on a sparse scene built with slot groups of 16."""
    dev = _card()
    pts, out_num = inflatable_sphere(n_outer=600)
    cfg = warp_parity().replace(h=suggest_h(pts, 32), dtype="float32", backend="pallas")
    scene, _ = build_sparse_scene(pts, cfg, out_num=out_num, device=dev, group=16)
    sb = scene.blocked
    assert sb.group == 16 and len(sb.buckets) > 1
    buf = torch.as_tensor(np.random.default_rng(16).normal(size=(15, pk.n_entries(sb))),
                          dtype=torch.float32, device=dev)
    _hold_bf16_scatter((buf, sb.slab_ptr, sb.slab_idx, sb.bucket_starts, sb.n_slots, 16))


def test_bf16_scatter_refuses_what_it_does_not_take():
    """Slot groups not a multiple of 4, more than 16 fields or 32 buckets, a
    buffer not 16-byte aligned: the wrapper raises (no fallback on the
    card)."""
    from tests.test_torch_scatter_bf16 import synthetic_csr

    dev = _card()
    buf, ptr, idx, bst, n_slots, group = (a.to(dev) if torch.is_tensor(a) else a
                                          for a in synthetic_csr(8))
    with pytest.raises(ValueError, match="multiple of 4"):
        pk.slab_to_slots_bf16(buf[:, :buf.shape[1] // 8 * 6], ptr, idx // 2, bst // 2,
                              n_slots // 8 * 6, 6)
    with pytest.raises(ValueError, match="at most 16 fields"):
        pk.slab_to_slots_bf16(torch.zeros((17, buf.shape[1]), device=dev), ptr, idx, bst,
                              n_slots, group)
    with pytest.raises(ValueError, match="32 buckets"):
        pk.slab_to_slots_bf16(buf, ptr, idx, torch.arange(33, dtype=torch.int32, device=dev),
                              n_slots, group)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pk.slab_to_slots_bf16(buf[:, 1:1 - group], ptr, idx, bst, n_slots, group)


def test_bf16_path_launches_its_kernels():
    """One force evaluation and its VJP with ``pair_dtype="bfloat16"``: the
    default path and path B launch the bf16 K2 kernels once each and the
    bf16 cotangent scatter once, the f32 K2 kernels never; the fused path
    with bf16 runs the unfused one."""
    dev = _card()
    for blocked, fused in ((False, False), (False, True), (True, False)):
        cfg, scene, pos, ratio = _scene("float32", dev, blocked)
        c = cfg.replace(pair_dtype="bfloat16", fused_mid=fused)
        p = pos.clone().requires_grad_()
        pk.reset_launch_counts()
        f = (elastic_forces_pallas if blocked else elastic_forces_sparse)(
            p, ratio, scene.materials, scene, c)
        torch.autograd.grad(f, p, torch.ones_like(f))
        counts = pk.launch_counts()
        k2 = "forces_warp_v2" if blocked else "forces_warp_v4"
        for n in (k2, f"{k2}_bwd_rows", f"{k2}_bwd_slab"):
            assert counts[n] == 0 and counts[f"{n}_bf16"] == 1, (n, counts)
        assert counts["slab_to_slots_bf16"] == 1 and counts["slab_to_slots"] == 1
        assert counts["moments_mid"] == 0, counts


# ------------------------------------------------------- the mid-section kernels
def _mid_operands(scene, cfg, pos, ratio, blocked, seed):
    """The mid-section's operands at ``pos``: K1's A | Y rows (the blocked
    layout's raw dots, with their correction operands), the rows' statics
    and stiffness scale, and random cotangents dfmT (19, m), dsrT (15, m)."""
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    posT = pos.T.contiguous()
    if blocked:
        ayT, corr = fk.moments_raw_all(posT, sb, cfg.h, pk.PLAIN), (posT[:, :m], sb.rs6T)
    else:
        ayT, corr = pk.moments_all(posT, posT[:, :m], sb, cfg.h, pk.PLAIN), (None, None)
    rng = np.random.default_rng(seed)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=pos.dtype, device=pos.device)

    return (ayT, mk.row_static(sb, scene.materials, scene.rest_corr),
            cfg.stiffness_scale(ratio[:m]), corr, rand(19, m), rand(15, m))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("corotated", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mid_kernels_match_plain(dtype, corotated, blocked):
    """mid_records and mid_records_bwd, one launch each over every row,
    against their plain versions (the eager mid-section and autograd
    through it) on a jittered body and on the body at rest, centered dots
    (sparse scene) and raw dots with their correction (blocked scene);
    srT's columns past the rows zero; a second launch bit for bit the
    first.  At rest F = I and S, M are rounding noise in both versions, so
    there the errors are taken against the jittered rows' max |plain|."""
    dev = _card()
    cfg, scene, pos, ratio = _scene(dtype, dev, blocked)
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    tol = {"float32": 1e-4, "float64": 1e-10}[dtype]
    ref = []
    for at in (pos, scene.rest_position):
        ayT, rs, scale, corr, dfmT, dsrT = _mid_operands(scene, cfg, at, ratio, blocked, 3)

        def launch():
            return (mk.mid_records(ayT, rs, scale, corotated, sb.n_slots, *corr)
                    + mk.mid_records_bwd(ayT, rs, scale, corotated, dfmT, dsrT, *corr))

        pk.reset_launch_counts()
        got = launch()
        counts = pk.launch_counts()
        assert counts == dict.fromkeys(counts, 0) | {"mid_records": 1, "mid_records_bwd": 1}
        want = (mk.mid_records_plain(ayT, rs, scale, corotated, sb.n_slots, *corr)
                + mk.mid_records_bwd_plain(ayT, rs, scale, corotated, dfmT, dsrT, *corr))
        if not ref:
            ref = [None if w is None else float(torch.max(torch.abs(w))) for w in want]
        for g, w, r in zip(got, want, ref):
            if w is None:
                assert g is None
                continue
            assert g.shape == w.shape and bool(torch.isfinite(g).all())
            err = float(torch.max(torch.abs(g - w))) / r
            assert err <= tol, err
        assert got[1].shape == (15, sb.n_slots) and not got[1][:, m:].any()
        assert all(torch.equal(x, y) for x, y in zip(got, launch()) if x is not None)


def test_one_mid_launch_per_evaluation():
    """One force evaluation and its VJP: the default path, path A and path
    B launch mid_records once and mid_records_bwd once, the fused path only
    the backward; the plain path launches neither."""
    dev = _card()
    runs = ((False, {}), (False, {"pair_def_grad": "j"}), (False, {"fused_mid": True}),
            (True, {}), (True, {"pair_def_grad": "j"}))
    for blocked, over in runs:
        cfg, scene, pos, ratio = _scene("float32", dev, blocked)
        c = cfg.replace(**over)
        for ops in (pk.KERNELS, pk.PLAIN):
            p = pos.clone().requires_grad_()
            pk.reset_launch_counts()
            f = elastic_forces_pallas(p, ratio, scene.materials, scene, c, ops)
            fwd = pk.launch_counts()
            pk.reset_launch_counts()
            torch.autograd.grad(f, p, torch.ones_like(f))
            bwd = pk.launch_counts()
            kern = ops is pk.KERNELS
            fused = c.fused_mid and not blocked
            assert fwd["mid_records"] == (kern and not fused), (over, fwd)
            assert (fwd["mid_records_bwd"], bwd["mid_records"]) == (0, 0), (over, bwd)
            assert bwd["mid_records_bwd"] == kern, (over, bwd)


def test_mid_kernels_refuse_bad_operands():
    dev = _card()
    cfg, scene, pos, ratio = _scene("float32", dev)
    n = scene.blocked.n_slots
    ayT, rs, scale, _, dfmT, dsrT = _mid_operands(scene, cfg, pos, ratio, False, 2)
    with pytest.raises(ValueError, match="18"):
        mk.mid_records(ayT[:17], rs, scale, True, n)
    with pytest.raises(TypeError, match="dtype"):
        mk.mid_records(ayT, rs, scale.double(), True, n)
    with pytest.raises(ValueError, match="both"):
        mk.mid_records(ayT, rs, scale, True, n, ayT[:3], None)
    with pytest.raises(ValueError, match="fewer"):
        mk.mid_records(ayT, rs, scale, True, ayT.shape[1] - 1)
    with pytest.raises(ValueError, match="19"):
        mk.mid_records_bwd(ayT, rs, scale, True, dfmT[:18], dsrT)


def _mid_cols(ops, k):
    """The first k rows of _mid_operands' operands (views: the row strides
    stay the full scene's)."""
    ayT, rs, scale, (p, r6), dfmT, dsrT = ops
    c = slice(0, k)
    corr = (None, None) if p is None else (p[:, c], r6[:, c])
    return ayT[:, c], rs.cols(c), scale[c], corr, dfmT[:, c], dsrT[:, c]


def _mid_run(ops, corotated, n_sr):
    ayT, rs, scale, corr, dfmT, dsrT = ops
    return (mk.mid_records(ayT, rs, scale, corotated, n_sr, *corr)
            + mk.mid_records_bwd(ayT, rs, scale, corotated, dfmT, dsrT, *corr))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mid_kernels_ragged_row_counts(dtype, blocked):
    """Row counts that are not a multiple of a block's 128 rows (nor of a
    warp's 32), fewer rows than one block, and srT wider than the rows: one
    launch each, against the plain versions (the f32 forward bit for bit,
    as on the full scene), srT's padding zero."""
    dev = _card()
    cfg, scene, pos, ratio = _scene(dtype, dev, blocked)
    m = scene.blocked.n_tiles * scene.blocked.rows
    full = _mid_operands(scene, cfg, pos, ratio, blocked, 5)
    tol = {"float32": 1e-4, "float64": 1e-10}[dtype]
    threads = mk.kernel_info()["mid_records", dtype]["threads"]   # rows a block
    assert m - 77 > threads and (m - 77) % threads and (m - 77) % 32
    for k, n_sr in ((m - 77, m - 77), (threads - 28, threads - 28),
                    (m - 77, m + 1000), (threads - 28, 1000)):
        ops = _mid_cols(full, k)
        pk.reset_launch_counts()
        got = _mid_run(ops, True, n_sr)
        counts = pk.launch_counts()
        assert counts == dict.fromkeys(counts, 0) | {"mid_records": 1, "mid_records_bwd": 1}
        ayT, rs, scale, corr, dfmT, dsrT = ops
        want = (mk.mid_records_plain(ayT, rs, scale, True, n_sr, *corr)
                + mk.mid_records_bwd_plain(ayT, rs, scale, True, dfmT, dsrT, *corr))
        for i, (g, w) in enumerate(zip(got, want)):
            if w is None:
                assert g is None
                continue
            assert g.shape == w.shape and bool(torch.isfinite(g).all()), (k, n_sr, i)
            if dtype == "float32" and i < 2:
                assert torch.equal(g, w), (k, n_sr, i, _rel(g, w))
            assert _rel(g, w) <= tol, (k, n_sr, i, _rel(g, w))
        assert not got[1][:, k:].any()


@pytest.mark.parametrize("blocked", [False, True])
def test_mid_kernels_repeat_bitwise_and_rows_stand_alone(blocked):
    """A second launch repeats the first bit for bit, and a launch over the
    rows from an odd offset on (other blocks, other lanes) gives those rows'
    outputs bit for bit: no row's arithmetic depends on where it runs."""
    dev = _card()
    cfg, scene, pos, ratio = _scene("float32", dev, blocked)
    ops = _mid_operands(scene, cfg, pos, ratio, blocked, 6)
    n_sr = scene.blocked.n_slots
    first = _mid_run(ops, True, n_sr)
    assert all(torch.equal(x, y) for x, y in zip(first, _mid_run(ops, True, n_sr))
               if x is not None)
    ayT, rs, scale, (p, r6), dfmT, dsrT = ops
    m = ayT.shape[1]
    c = slice(37, m)
    shifted = _mid_run((ayT[:, c], rs.cols(c), scale[c],
                        (None, None) if p is None else (p[:, c], r6[:, c]),
                        dfmT[:, c], dsrT[:, c]), True, m - 37)
    assert all(torch.equal(x[..., c], y) for x, y in zip(first, shifted) if x is not None)


def _odd_stride(x, extra=2, offset=1):
    """x (k, n) as a view with row stride n + extra + offset, starting
    ``offset`` elements into its buffer (not 16-byte aligned)."""
    buf = torch.full((x.shape[0], x.shape[1] + extra + offset), float("nan"),
                     dtype=x.dtype, device=x.device)
    buf[:, offset:offset + x.shape[1]] = x
    return buf[:, offset:offset + x.shape[1]]


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mid_kernels_take_any_row_stride(dtype, blocked):
    """Every lane-major operand with a row stride that is not a multiple of
    4 and a base that is not 16-byte aligned (vectors one element into
    their buffer): the same records and cotangents, bit for bit, as from
    contiguous operands."""
    dev = _card()
    cfg, scene, pos, ratio = _scene(dtype, dev, blocked)
    ayT, rs, scale, (p, r6), dfmT, dsrT = _mid_operands(scene, cfg, pos, ratio, blocked, 7)
    n_sr = scene.blocked.n_slots
    want = _mid_run((ayT, rs, scale, (p, r6), dfmT, dsrT), True, n_sr)

    def vec(v):
        return _odd_stride(v[None])[0]

    odd = (_odd_stride(ayT), mk.RowStatic(vec(rs.mu), vec(rs.lam), vec(rs.vol),
                                          _odd_stride(rs.rcT)),
           vec(scale), (None, None) if p is None else (_odd_stride(p), _odd_stride(r6)),
           _odd_stride(dfmT), _odd_stride(dsrT))
    assert odd[0].stride(0) % 4 and odd[0].data_ptr() % 16
    got = _mid_run(odd, True, n_sr)
    assert all(torch.equal(x, y) for x, y in zip(got, want) if y is not None)


def _mid_run_ring(ops, corotated, n_sr):
    ayT, rs, scale, corr, dfmT, dsrT = ops
    return (mk.mid_records_ring(ayT, rs, scale, corotated, n_sr, *corr)
            + mk.mid_records_bwd_ring(ayT, rs, scale, corotated, dfmT, dsrT, *corr))


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mid_ring_kernels_match_the_one_wave_kernels(dtype, blocked):
    """The ring kernels (persistent blocks, rows staged by cp.async) give
    the one-wave kernels' outputs bit for bit, one launch each: on the
    scene's rows (a block for every tile, one stage), on those rows
    repeated past every SM's resident blocks (blocks walking several tiles
    through two stages), on a ragged row count with srT wider than the
    rows, and at a row stride that is not a multiple of 4."""
    dev = _card()
    cfg, scene, pos, ratio = _scene(dtype, dev, blocked)
    ayT, rs, scale, corr, dfmT, dsrT = _mid_operands(scene, cfg, pos, ratio, blocked, 8)
    m = ayT.shape[1]
    names = mk.INSTANCES[int(blocked)::2]       # forward, backward
    grid = max(mk.ring_plan(i, ayT.dtype, 1 << 30)["grid"] for i in names)
    r = 3 * grid * 128 // m + 1       # rows for three tiles a block and more

    def rep(x):
        return None if x is None else x.repeat(*(x.dim() - 1) * (1,), r)

    big = (rep(ayT), mk.RowStatic(*(rep(v) for v in rs)), rep(scale),
           tuple(rep(v) for v in corr), rep(dfmT), rep(dsrT))
    assert all(mk.ring_plan(i, ayT.dtype, m * r)["stages"] == 2 for i in names)
    # the plan: a block a tile up to every SM's resident blocks, one stage
    # where that covers the tiles, the ring sized for the staged fields
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads = mk.kernel_info()[names[0], dtype]["threads"]
    for name, fields in zip(names, (31 + 9 * blocked, 63 + 9 * blocked)):
        for rows in (100, m, m * r):
            p = mk.ring_plan(name, ayT.dtype, rows)
            tiles = -(-rows // threads)
            assert p["grid"] == min(tiles, sms * p["blocks_per_sm"]) > 0, (name, rows, p)
            assert (p["stages"] == 1) == (tiles <= p["grid"]), (name, rows, p)
            assert p["smem_bytes"] == p["stages"] * fields * threads * ayT.element_size()
    k = m * r - 77
    ragged = (big[0][:, :k], big[1].cols(slice(0, k)), big[2][:k],
              tuple(None if v is None else v[:, :k] for v in big[3]), big[4][:, :k],
              big[5][:, :k])
    odd = (_odd_stride(ayT), mk.RowStatic(*(_odd_stride(v[None])[0] for v in rs[:3]),
                                          _odd_stride(rs.rcT)),
           _odd_stride(scale[None])[0], tuple(None if v is None else _odd_stride(v)
                                              for v in corr),
           _odd_stride(dfmT), _odd_stride(dsrT))
    for ops, n_sr in (((ayT, rs, scale, corr, dfmT, dsrT), scene.blocked.n_slots),
                      (big, m * r), (ragged, k + 1000), (odd, scene.blocked.n_slots)):
        want = _mid_run(ops, True, n_sr)
        mk.mid_records_ring.launches = mk.mid_records_bwd_ring.launches = 0
        got = _mid_run_ring(ops, True, n_sr)
        assert mk.mid_records_ring.launches == mk.mid_records_bwd_ring.launches == 1
        assert all(torch.equal(g, w) for g, w in zip(got, want) if w is not None), n_sr
        assert not got[1][:, ops[0].shape[1]:].any()


# ------------------------------------------------------------ the gather backend
GATHER = ("gather_moments", "gather_moments_bwd", "gather_forces", "gather_forces_bwd")


def _gather_case(dtype, dev, pairing="i", corotated=True, max_neighbors=0):
    from softbody_tpu_torch.sim.scene import build_scene

    pts, out_num = inflatable_sphere(n_outer=600)
    cfg = warp_parity().replace(h=suggest_h(pts, 32), dtype=dtype, backend="gather",
                                max_neighbors=max_neighbors, pair_def_grad=pairing,
                                corotated=corotated)
    scene = build_scene(pts, cfg, out_num=out_num, device=dev)
    rng = np.random.default_rng(31)
    F = np.eye(3) + 0.05 * rng.normal(size=(3, 3))
    pos = (pts - pts.mean(0)) @ F.T + pts.mean(0) + 0.05 * cfg.h * rng.normal(size=pts.shape)
    as_t = (lambda a: torch.as_tensor(a, dtype=scene.dtype, device=dev))
    x = rng.normal(scale=0.5, size=len(pts))
    return (cfg, scene, as_t(pos), compute_ratio(as_t(x), cfg),
            as_t(rng.normal(size=(18, len(pts)))), as_t(rng.normal(size=pts.shape)))


def _gather_shard(topo, rows):
    """The rows' part of a table that keeps reading every particle (as
    parallel/sharding.shard_scene builds a shard's)."""
    from softbody_tpu_torch.core.types import Topology

    fields = {f: getattr(topo, f)[rows].contiguous() for f in Topology._fields[:10]}
    return Topology(**fields, **gk.inverse_fields(fields["idx"], topo.idx.shape[0], fields),
                    rcT=gk.rest_corr_lanes(fields["rest_corr"]))


def _padded(topo, K):
    """The table with pad entries appended up to K a row (each pointing at
    its own row, all its weights zero), its inverse rebuilt."""
    from softbody_tpu_torch.core.types import Topology

    n, k0 = topo.idx.shape
    own = torch.arange(n, device=topo.idx.device)[:, None].expand(n, K - k0)
    fields = {f: getattr(topo, f) for f in Topology._fields[:10]}
    fields["idx"] = torch.cat([topo.idx, own], dim=1).contiguous()
    for f in ("mask", "w", "c", "vj", "nw", "xji"):
        x = fields[f]
        fields[f] = torch.cat([x, x.new_zeros((n, K - k0) + x.shape[2:])], dim=1).contiguous()
    return Topology(**fields, **gk.inverse_fields(fields["idx"], n, fields),
                    rcT=topo.rcT)


def _gather_calls(pos, src, topo, fmT, rec, sep, dayT, df):
    """Each gather kernel's call on these operands, and its plain version's."""
    args = {"gather_moments": (pos, src, topo),
            "gather_moments_bwd": (pos, src, topo, dayT),
            "gather_forces": (fmT, rec, topo, sep),
            "gather_forces_bwd": (fmT, rec, topo, sep, df)}
    return {k: (getattr(gk, k), getattr(gk, k + "_plain"), a) for k, a in args.items()}


def _outs(x):
    return [t for t in (x if isinstance(x, tuple) else (x,)) if t is not None]


def _held(name, kern, plain, args, tol):
    """One call of ``kern`` (one launch counted on ``name``) against its
    plain version and a second call bit for bit."""
    pk.reset_launch_counts()
    got = _outs(kern(*args))
    torch.cuda.synchronize()
    counts = pk.launch_counts()
    assert counts == dict.fromkeys(counts, 0) | {name: 1}, (name, counts)
    want = _outs(plain(*args))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= tol, (name, _rel(g, w))
    assert all(torch.equal(a, b) for a, b in zip(got, _outs(kern(*args)))), name


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("pairing,corotated", [("i", True), ("i", False), ("j", True),
                                               ("j", False)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gather_kernels_match_plain(dtype, pairing, corotated, shard):
    """Each gather kernel against its plain version on the same operands
    (1e-4 of max |plain| in f32, 1e-10 in f64), one launch counted per
    call, a second call bit for bit the first; on one device (the record
    the rows' own) and on a shard-like source (a ragged run of rows reading
    every particle's packed record)."""
    dev = _card()
    cfg, scene, pos, ratio, dayT, df = _gather_case(dtype, dev, pairing, corotated)
    topo, n = scene.topology, pos.shape[0]
    sep = pairing == "j"
    ayT = gk.gather_moments_plain(pos, None, topo)
    fmT, srT = mk.mid_records_plain(ayT, mk.gather_row_static(scene.materials, topo),
                                    cfg.stiffness_scale(ratio), corotated, n)
    rec = gk.packed_record(fmT, srT, sep)
    src = None
    if shard:
        rows = slice(9, 9 + n // 2 + 5)
        topo = _gather_shard(topo, rows)
        src, pos = pos, pos[rows]
        fmT, dayT, df = fmT[:, rows].contiguous(), dayT[:, rows].contiguous(), df[rows]
    tol = {"float32": 1e-4, "float64": 1e-10}[dtype]
    for name, (kern, plain, args) in _gather_calls(pos, src, topo, fmT, rec, sep, dayT,
                                                   df).items():
        _held(name, kern, plain, args, tol)


# lanes a row of the forward and the row pass (f32 Warp, f32 Taichi, f64)
# and of the source pass (f32, f64) at K entries a row, K readers a source
# row on average
RAGGED_LANES = {20: ((32, 8, 16), (8, 16)), 37: ((32, 8, 32), (8, 32)),
                100: ((32, 32, 32), (32, 32))}


@pytest.mark.parametrize("pairing", ["i", "j"])
@pytest.mark.parametrize("K", [20, 37, 100])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gather_forces_ragged_lane_groups(dtype, pairing, K):
    """The forces kernels where K is not a multiple of their lane group:
    a table cut to its 20 or 37 nearest and one padded to 100 entries a
    row, each against its plain version (1e-4 of max |plain| in f32, 1e-10
    in f64); the padded table's forces and cotangents equal the unpadded
    plain version's (pad entries add nothing).  Between them the cases run
    every lane group of 8, 16 and 32 (RAGGED_LANES, as kernel_info gives
    them): the 8-lane forward and row pass in the f32 Taichi pairing, the
    8-lane source pass in f32."""
    dev = _card()
    mx = 0 if K == 100 else K
    cfg, scene, pos, ratio, _, df = _gather_case(dtype, dev, pairing, True, mx)
    topo, n = scene.topology, pos.shape[0]
    sep = pairing == "j"
    if K == 100:
        assert topo.idx.shape[1] < K
        topo = _padded(topo, K)
    assert topo.idx.shape[1] == K
    ayT = gk.gather_moments_plain(pos, None, scene.topology)
    fmT, srT = mk.mid_records_plain(ayT, mk.gather_row_static(scene.materials, topo),
                                    cfg.stiffness_scale(ratio), True, n)
    rec = gk.packed_record(fmT, srT, sep)
    rows, src = RAGGED_LANES[K]
    f64 = dtype == "float64"
    info = gk.kernel_info(K)
    pairing_name = "taichi" if sep else "warp"
    for kernel, lanes in (("gather_forces", rows[2 if f64 else int(sep)]),
                          ("gather_forces_bwd_rows", rows[2 if f64 else int(sep)]),
                          ("gather_forces_bwd_src", src[int(f64)])):
        assert info[kernel, pairing_name, dtype]["lanes"] == lanes, (kernel, info)
    tol = 1e-10 if f64 else 1e-4
    for name, (kern, plain, args) in _gather_calls(pos, None, topo, fmT, rec, sep, None,
                                                   df).items():
        if name.startswith("gather_forces"):
            _held(name, kern, plain, args, tol)
            if K == 100:
                ref = _outs(plain(*((args[0], args[1], scene.topology) + args[3:])))
                assert all(_rel(g, w) <= tol for g, w in zip(_outs(kern(*args)), ref))


# gather_moments_bwd's cases: (K, the shard-like run's share of the rows or
# None for one device) -> lanes a source row of its source pass (f32, f64)
# at their mean readers a source row (K; on the shard-like runs of 1447
# rows ~K / 4 and ~K / 2): between them every lane group of 8, 16 and 32
MOMENTS_CASES = {(20, None): (32, 16), (37, None): (32, 32), (100, None): (32, 32),
                 (20, 4): (8, 8), (20, 2): (16, 8), (37, 2): (32, 16), (100, 2): (32, 32)}


@pytest.mark.parametrize("K,share", list(MOMENTS_CASES))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gather_moments_bwd_ragged_lane_groups(dtype, K, share):
    """gather_moments_bwd where a source row's readers are not a multiple of
    its source pass's lane group: tables cut to their 20 or 37 nearest and
    one padded to 100 entries a row, on one device (one merged output) and
    on shard-like sources (a ragged run of a quarter or a half of the rows
    over every particle, some source rows read by none: their cotangent
    exactly zero), each against its plain version (1e-4 of max |plain| in
    f32, 1e-10 in f64), a second call bit for bit the first.  The padded
    table's cotangents equal the unpadded plain version's; each case runs
    the lane group of MOMENTS_CASES (kernel_info at its mean readers)."""
    dev = _card()
    f64 = dtype == "float64"
    cfg, scene, pos, ratio, dayT, _ = _gather_case(dtype, dev, "i", True,
                                                   0 if K == 100 else K)
    topo, n = scene.topology, pos.shape[0]
    if K == 100:
        assert topo.idx.shape[1] < K
        topo = _padded(topo, K)
    assert topo.idx.shape[1] == K
    src, tight = None, scene.topology
    if share:
        rows = slice(9, 9 + n // share + 5)
        topo, tight = _gather_shard(topo, rows), _gather_shard(tight, rows)
        src, pos, dayT = pos, pos[rows].contiguous(), dayT[:, rows].contiguous()
    mean = topo.idx.numel() / (topo.inv_ptr.numel() - 1)
    info = gk.kernel_info(mean)["gather_moments_bwd_src", "both", dtype]
    assert info["lanes"] == MOMENTS_CASES[K, share][int(f64)], (mean, info)
    tol = 1e-10 if f64 else 1e-4
    args = (pos, src, topo, dayT)
    _held("gather_moments_bwd", gk.gather_moments_bwd, gk.gather_moments_bwd_plain, args, tol)
    got = gk.gather_moments_bwd(*args)
    if share:
        unread = topo.inv_ptr.diff() == 0
        assert bool(unread.any()) and not got[1][unread].any()
    if K == 100:
        ref = gk.gather_moments_bwd_plain(pos, src, tight, dayT)
        assert all(_rel(g, w) <= tol for g, w in zip(_outs(got), _outs(ref)))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_mid_records_writes_the_packed_record(dtype):
    """mid_records with the gather path's packed record: one launch, fmT and
    srT bit for bit the plain record's call's, and the record's fields
    bitwise srT's and fmT's ([S_6 | R^T_9 | V] and [M_9 | V | 0 | 0])."""
    dev = _card()
    cfg, scene, pos, ratio, _, _ = _gather_case(dtype, dev)
    topo, n = scene.topology, pos.shape[0]
    args = (gk.gather_moments_plain(pos, None, topo),
            mk.gather_row_static(scene.materials, topo), cfg.stiffness_scale(ratio), True, n)
    fmT, srT = mk.mid_records(*args)
    for sep, width in ((False, 16), (True, 12)):
        pk.reset_launch_counts()
        fm, sr, rec = mk.mid_records(*args, rec=width)
        assert pk.launch_counts()["mid_records"] == 1
        assert rec.shape == (n, width) and rec.is_contiguous()
        assert torch.equal(fm, fmT) and torch.equal(sr, srT)
        assert torch.equal(rec, gk.packed_record(fmT, srT, sep))


def test_one_launch_of_each_gather_kernel_per_evaluation():
    """One gather force evaluation and its VJP, through the backend dispatch:
    gather_moments, mid_records and gather_forces once forward,
    gather_forces_bwd, mid_records_bwd and gather_moments_bwd once
    backward, in both pairings; no other kernel; the plain path none."""
    from softbody_tpu_torch.sim.rollout import elastic_forces

    dev = _card()
    for pairing in ("i", "j"):
        cfg, scene, pos, ratio, _, df = _gather_case("float32", dev, pairing)
        for ops in (pk.KERNELS, pk.PLAIN):
            p = pos.clone().requires_grad_()
            pk.reset_launch_counts()
            f = elastic_forces(p, ratio, scene, cfg, ops)
            fwd = pk.launch_counts()
            pk.reset_launch_counts()
            torch.autograd.grad(f, p, df)
            bwd = pk.launch_counts()
            kern = int(ops is pk.KERNELS)
            zero = dict.fromkeys(fwd, 0)
            assert fwd == zero | dict.fromkeys(
                ("gather_moments", "mid_records", "gather_forces"), kern), fwd
            assert bwd == zero | dict.fromkeys(
                ("gather_moments_bwd", "mid_records_bwd", "gather_forces_bwd"), kern), bwd


def test_gather_kernels_refuse_bad_operands():
    dev = _card()
    cfg, scene, pos, ratio, dayT, df = _gather_case("float32", dev)
    topo = scene.topology
    fmT, srT = mk.mid_records_plain(gk.gather_moments_plain(pos, None, topo),
                                    mk.gather_row_static(scene.materials, topo),
                                    cfg.stiffness_scale(ratio), True, pos.shape[0])
    rec = gk.packed_record(fmT, srT, False)
    with pytest.raises(TypeError, match="dtype"):
        gk.gather_moments(pos.double(), None, topo)
    with pytest.raises(ValueError, match="pos must be"):
        gk.gather_moments(pos[:-1], None, topo)
    with pytest.raises(ValueError, match="src must be"):
        gk.gather_moments(pos, pos[:, :2], topo)
    with pytest.raises(ValueError, match="dayT"):
        gk.gather_moments_bwd(pos, None, topo, dayT[:17])
    with pytest.raises(ValueError, match="inv_ptr"):
        gk.gather_moments_bwd(pos, pos[:-1], topo, dayT)
    with pytest.raises(ValueError, match="inv_cxw"):
        gk.gather_moments_bwd(pos, None, topo._replace(inv_cxw=topo.inv_cxw[:, :3]), dayT)
    with pytest.raises(ValueError, match="xji"):
        gk.gather_moments(pos, None, topo._replace(xji=topo.xji.transpose(0, 1)))
    with pytest.raises(ValueError, match="rec must be"):
        gk.gather_forces(fmT, rec[:, :15], topo, False)
    with pytest.raises(ValueError, match="rec must be"):
        gk.gather_forces(fmT, rec, topo, True)
    with pytest.raises(ValueError, match="16-byte"):
        gk.gather_forces(fmT, torch.cat([rec, rec[:, :1]], 1)[:, :16], topo, False)
    with pytest.raises(ValueError, match="df must be"):
        gk.gather_forces_bwd(fmT, rec, topo, False, df.T)
    with pytest.raises(TypeError, match="inv_row"):
        gk.gather_forces_bwd(fmT, rec, topo._replace(inv_row=topo.inv_row.long()), False, df)
    with pytest.raises(ValueError, match="is on"):
        gk.gather_forces(fmT, rec.cpu(), topo, False)