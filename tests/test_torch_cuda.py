"""PyTorch port on the card: the hand-written CUDA kernels against their
plain versions (marker ``cuda``; they skip without a card — the kernels have
no CPU mode).  This file imports nothing of JAX, so it runs on a machine
with only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets up JAX.)  The same comparisons at
full width are chip_smoke.py phases 3-4 (forward), 9-11 (backward),
14-19 (the fused path, ``cfg.fused_mid``), 21-24 (the Taichi pairing's
separable K2) and 25-28 (the blocked layout's raw K1, K2 v2 and the
separable K2)."""

import dataclasses

import numpy as np
import pytest
import torch

from softbody_tpu_torch import warp_parity
from softbody_tpu_torch.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu_torch.ops import fused_kernels as fk
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
    with pytest.raises(TypeError, match="float32 or float64"):
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
    others = {fn.__name__ for fn in fk.COUNTED + sk.COUNTED}
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
    fused = [fn for fn in fk.COUNTED if fn is not fk.moments_raw]
    assert all(counts[fn.__name__] > 0 for fn in fused), counts
    assert counts["moments_v4"] == counts["forces_warp_v4"] == counts["moments_raw"] == 0


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
