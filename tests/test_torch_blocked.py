"""PyTorch port, the blocked (column-dense slot) layout: ``build_blocked_scene``
against the JAX package's, the raw K1 plain version against
``packed.moments_packed`` (Pallas ``_moments_fwd_impl`` in interpret mode),
the ``pallas`` path (raw K1, the - pos_i * rs6 correction, the eager
mid-section, then K2 v2 or the separable K2) against JAX's
``elastic_forces_pallas`` and against the port's ``backend="blocked"``
plain reference, and the force VJP against ``jax.vjp``.

Tolerances, relative to max |JAX|:
* scene arrays: layout integers, rest positions and materials exactly;
  volume, the rest correction and the row sums rs6 1e-13 in f64 and 2e-6
  in f32 — the port sums density, volume and the rest correction on the
  host in f64 over the true pairs (the sparse build's pass), JAX over the
  slabs in the scene's dtype (measured 3.4e-7 in f32); rs6 comes from the
  raw K1 on an all-ones RHS in both, on those volumes;
* raw K1 per tile: 1e-12 in f64, 1e-5 in f32;
* forces and VJP, f64: 1e-10 (as tests/test_pallas_kernels.py:38-51 holds
  the JAX kernels), for the Warp preset with STRETCH and for
  ``taichi_parity()``;
* the fixed-order scatter on the varcol index: 1e-13 against numpy's
  add.at, exactly 0 on slots of groups that hold no particle."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import taichi_parity, warp_parity
from softbody_tpu.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu.ops.elasticity import compute_ratio as jratio
from softbody_tpu.ops.pallas import packed
from softbody_tpu.scenarios import STRETCH, dirichlet_mask
from softbody_tpu.sim.blocked import build_blocked_scene as jbuild
from softbody_tpu.sim.blocked import elastic_forces_pallas as jpallas
from softbody_tpu_torch.convert import scene_from_numpy, scene_to_numpy
from softbody_tpu_torch.ops import fused_kernels as fk
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.ops.pair_common import slab_slots
from softbody_tpu_torch.sim.blocked import (build_blocked_scene, elastic_forces_blocked,
                                            elastic_forces_pallas)
from softbody_tpu_torch.sim.rollout import elastic_forces
from softbody_tpu_torch.sim.sparse import build_sparse_scene

from tests.test_torch_helpers import small_body, to_jax

TOL_FORCES = 1e-10
TOL_BUILD = {"float64": 1e-13, "float32": 2e-6}
_MATERIALS = ("mass", "volume", "mu", "lam", "free", "external")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def blocked_body():
    """(points, out_num, h): the issue-sized parity body, 177 particles."""
    pts, out_num = inflatable_sphere(n_outer=120)
    return pts, out_num, suggest_h(pts, 32)


def jax_blocked_dict(scene) -> dict:
    """Every leaf of a JAX blocked Scene as numpy, in the layout
    ``convert.scene_from_numpy`` reads."""
    blk = scene.blocked
    d = {
        "rest_position": np.asarray(scene.rest_position),
        "rest_corr": np.asarray(scene.rest_corr),
        "slot_of_particle": np.asarray(scene.slot_of_particle),
        "rs6T": np.asarray(blk.rs6).T,
        "out_num": int(scene.out_num),
        "rows": int(blk.rows), "n_tiles": int(blk.n_tiles),
        "n_slots": int(blk.n_slots), "group": 8, "run_len": int(blk.run_len),
        "blocked.slab_start": np.asarray(blk.slab_start),
        "blocked.gidx8": np.asarray(blk.gidx8),
        "blocked.restT_rows": np.asarray(blk.restT_rows),
        "blocked.static_slab": np.asarray(blk.static_slab),
    }
    for k, name in enumerate(_MATERIALS):
        d[name] = np.asarray(scene.materials[k])
    return d


def both_blocked(pts, cfg, **kw):
    scene_j, sop = jbuild(pts, cfg, **kw)
    scene_t, _ = scene_from_numpy(jax_blocked_dict(scene_j), "cpu")
    return scene_j, scene_t, np.asarray(sop)


# ------------------------------------------------------------ scene build
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_blocked_scene_matches_jax(dtype):
    pts, out_num, h = blocked_body()
    cfg = warp_parity().replace(h=h, dtype=dtype, backend="pallas", **STRETCH)
    mask = dirichlet_mask(pts, "stretch")
    scene_j, sop_j = jbuild(pts, cfg, out_num=out_num, dirichlet_mask=mask)
    scene_t, sop = build_blocked_scene(pts, cfg, out_num=out_num, dirichlet_mask=mask,
                                       device="cpu")
    bj, bt = scene_j.blocked, scene_t.blocked
    assert np.array_equal(sop, np.asarray(sop_j))
    assert (bt.n_tiles, bt.rows, bt.slab_len, bt.run_len, bt.n_slots) == (
        bj.n_tiles, bj.rows, bj.slab_len, bj.run_len, bj.n_slots)
    for got, want in ((bt.bucket.gidx8, bj.gidx8), (bt.slab_start, bj.slab_start),
                      (scene_t.slot_of_particle, scene_j.slot_of_particle),
                      (bt.bucket.restT_rows, bj.restT_rows),
                      (bt.bucket.static_slab[:, :4], bj.static_slab[:, :4]),
                      (scene_t.rest_position, scene_j.rest_position)):
        assert np.array_equal(np.asarray(got), np.asarray(want))
    for name in ("mass", "mu", "lam", "free", "external"):
        assert np.array_equal(getattr(scene_t.materials, name).numpy(),
                              np.asarray(getattr(scene_j.materials, name))), name
    tol = TOL_BUILD[dtype]
    assert _rel(scene_t.materials.volume, scene_j.materials.volume) < tol
    assert _rel(bt.bucket.static_slab[:, 4], bj.static_slab[:, 4]) < tol
    assert _rel(scene_t.rest_corr, scene_j.rest_corr) < tol
    assert _rel(bt.rs6T.T, bj.rs6) < tol
    assert scene_t.dtype == {"float64": torch.float64, "float32": torch.float32}[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_moments_raw_plain_matches_jax(dtype):
    pts, out_num, h = blocked_body()
    cfg = warp_parity().replace(h=h, dtype=dtype, backend="pallas")
    scene_j, scene_t, sop = both_blocked(pts, cfg, out_num=out_num)
    pos = np.asarray(scene_j.rest_position, np.float64).copy()
    pos[sop] += np.random.default_rng(41).normal(scale=3e-2 * h, size=(len(sop), 3))
    bj, bt = scene_j.blocked, scene_t.blocked
    want = np.asarray(packed.moments_packed(bj.restT_rows, bj.static_slab, None,
                                            jnp.asarray(pos, dtype), bj.gidx8, cfg.h,
                                            True), np.float64)
    b = bt.bucket
    posT = torch.as_tensor(pos.T.copy()).to(scene_t.dtype)
    got = fk.moments_raw_plain(b.restT_rows, b.static_slab, posT, b.gidx8, cfg.h)
    assert got.shape == (18, bt.n_tiles * bt.rows) and got.dtype == scene_t.dtype
    assert _rel(got.T.numpy(), want.reshape(-1, 18)) < (1e-12 if dtype == "float64"
                                                        else 1e-5)
    pk.reset_launch_counts()
    assert torch.equal(fk.moments_raw(b.restT_rows, b.static_slab, posT, b.gidx8, cfg.h),
                       got)
    assert pk.launch_counts()["moments_raw"] == 0


# ------------------------------------------------------------ forces
@pytest.fixture(scope="module", params=["warp_stretch", "taichi_parity"])
def forces_case(request):
    pts, out_num, h = blocked_body()
    if request.param == "warp_stretch":
        cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas", **STRETCH)
    else:
        cfg = taichi_parity().replace(h=h, backend="pallas")
    scene_j, scene_t, sop = both_blocked(pts, cfg, out_num=out_num)
    rng = np.random.default_rng(42)
    pos = np.asarray(scene_j.rest_position, np.float64).copy()
    pos[sop] += rng.normal(scale=3e-2 * h, size=(len(sop), 3))
    x = np.zeros(scene_j.blocked.n_slots)
    x[sop] = rng.normal(scale=0.5, size=len(sop))
    ct = np.zeros_like(pos)
    ct[sop] = rng.normal(size=(len(sop), 3))
    return cfg, scene_j, scene_t, sop, pos, x, ct


def _jax_f(cfg, scene_j):
    def f(p, xv):
        return jpallas(p, jratio(xv, cfg), scene_j.materials, scene_j, cfg,
                       interpret=True)
    return f


def _port(fn, cfg, scene_t, pos, x, ct=None):
    p = torch.as_tensor(pos).requires_grad_(ct is not None)
    xv = torch.as_tensor(x).requires_grad_(ct is not None)
    f = fn(p, compute_ratio(xv, cfg), scene_t.materials, scene_t, cfg)
    if ct is None:
        return f.detach().numpy()
    return f.detach().numpy(), [g.numpy() for g in
                                torch.autograd.grad(f, (p, xv), torch.as_tensor(ct))]


def test_pallas_path_matches_jax_and_the_blocked_reference(forces_case):
    cfg, scene_j, scene_t, sop, pos, x, _ = forces_case
    want = np.asarray(jax.jit(_jax_f(cfg, scene_j))(to_jax(pos, "float64"),
                                                   to_jax(x, "float64")))
    got = _port(elastic_forces_pallas, cfg, scene_t, pos, x)
    ref = _port(elastic_forces_blocked, cfg, scene_t, pos, x)
    assert _rel(got, want) < TOL_FORCES
    assert _rel(ref, want) < TOL_FORCES
    pad = np.ones(len(got), bool)
    pad[sop] = False
    assert not got[pad].any()
    # the rollout's dispatch: "pallas" and "blocked" on a blocked scene
    ratio = compute_ratio(torch.as_tensor(x), cfg)
    p = torch.as_tensor(pos)
    assert np.array_equal(elastic_forces(p, ratio, scene_t, cfg).numpy(), got)
    assert np.array_equal(
        elastic_forces(p, ratio, scene_t, cfg.replace(backend="blocked")).numpy(), ref)


def test_pallas_vjp_matches_jax(forces_case):
    cfg, scene_j, scene_t, _, pos, x, ct = forces_case
    want = jax.jit(lambda p, xv, c: jax.vjp(_jax_f(cfg, scene_j), p, xv)[1](c))(
        to_jax(pos, "float64"), to_jax(x, "float64"), to_jax(ct, "float64"))
    _, got = _port(elastic_forces_pallas, cfg, scene_t, pos, x, ct)
    _, ref = _port(elastic_forces_blocked, cfg, scene_t, pos, x, ct)
    for g, r, w in zip(got, ref, want):
        assert np.abs(np.asarray(w)).max() > 0
        assert _rel(g, w) < TOL_FORCES
        assert _rel(r, w) < TOL_FORCES


def test_pallas_path_ignores_fused_mid(forces_case):
    cfg, _, scene_t, _, pos, x, _ = forces_case
    a = _port(elastic_forces_pallas, cfg, scene_t, pos, x)
    b = _port(elastic_forces_pallas, cfg.replace(fused_mid=True), scene_t, pos, x)
    assert np.array_equal(a, b)


def test_own_build_gives_the_jax_forces(forces_case):
    """The port's own build (host-f64 density and rest correction) against
    JAX's forces on its own build, f64."""
    cfg, scene_j, _, sop, pos, x, _ = forces_case
    pts, out_num, _ = blocked_body()
    own, _ = build_blocked_scene(pts, cfg, out_num=out_num, device="cpu")
    want = np.asarray(jax.jit(_jax_f(cfg, scene_j))(to_jax(pos, "float64"),
                                                   to_jax(x, "float64")))
    assert _rel(_port(elastic_forces_pallas, cfg, own, pos, x), want) < TOL_FORCES


def test_cells_layout_matches_jax():
    """The JAX cell layout's tiles of tz * C rows, cut into 32-row tiles
    by the port (carried across, and the port's own cells build)."""
    pts, out_num, h = blocked_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas", **STRETCH)
    scene_j, scene_t, sop = both_blocked(pts, cfg, out_num=out_num, layout="cells")
    assert scene_j.blocked.rows > 32 and scene_t.blocked.rows == 32
    own, _ = build_blocked_scene(pts, cfg, out_num=out_num, layout="cells", device="cpu")
    assert own.blocked.n_tiles == scene_t.blocked.n_tiles
    rng = np.random.default_rng(43)
    pos = np.asarray(scene_j.rest_position, np.float64).copy()
    pos[sop] += rng.normal(scale=3e-2 * h, size=(len(sop), 3))
    x = np.zeros(scene_j.blocked.n_slots)
    want = np.asarray(jpallas(to_jax(pos, "float64"), jratio(to_jax(x, "float64"), cfg),
                              scene_j.materials, scene_j, cfg, interpret=True))
    for scene in (scene_t, own):
        assert _rel(_port(elastic_forces_pallas, cfg, scene, pos, x), want) < TOL_FORCES


def test_blocked_scene_round_trips_through_numpy():
    pts, out_num, h = blocked_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas")
    own, _ = build_blocked_scene(pts, cfg, out_num=out_num, device="cpu")
    back, x = scene_from_numpy(scene_to_numpy(own), "cpu")
    assert x is None and back.blocked.run_len == own.blocked.run_len
    for a, b in ((back.blocked.bucket.static_slab, own.blocked.bucket.static_slab),
                 (back.blocked.slab_idx, own.blocked.slab_idx),
                 (back.blocked.rs6T, own.blocked.rs6T), (back.rest_corr, own.rest_corr)):
        assert torch.equal(a, b)


def test_blocked_backend_and_gather_dispatch():
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="blocked")
    scene, _ = build_sparse_scene(pts, cfg, out_num=out_num, device="cpu")
    ratio = torch.zeros(scene.blocked.n_slots, dtype=torch.float64)
    with pytest.raises(ValueError, match="build_blocked_scene"):
        elastic_forces(scene.rest_position, ratio, scene, cfg)
    with pytest.raises(ValueError, match="build_scene"):
        elastic_forces(scene.rest_position, ratio, scene, cfg.replace(backend="gather"))


# ------------------------------------------------------------ the scatter
def _backward_buffer(sb, h, seed):
    """The raw K1 backward of every bucket on a random cotangent: a real
    per-slab-entry buffer (zero on empty slots, as every backward's)."""
    rng = np.random.default_rng(seed)
    m = sb.n_tiles * sb.rows
    dayT = torch.as_tensor(rng.normal(size=(18, m)))
    parts = [fk.moments_raw_bwd_plain(b.restT_rows, b.static_slab,
                                      dayT[:, b.row_start:b.row_start + b.n_tiles * sb.rows], h)
             for b in sb.buckets]
    return torch.cat([p.permute(1, 0, 2).reshape(3, -1) for p in parts], dim=1)


def _add_at(sb, buf):
    slots = torch.cat([slab_slots(b.gidx8, b.slab_len).reshape(-1) for b in sb.buckets])
    out = np.zeros((buf.shape[0], sb.n_slots))
    for k in range(buf.shape[0]):
        np.add.at(out[k], slots.numpy(), buf[k].numpy())
    return out


def test_scatter_index_leaves_out_empty_groups_on_varcol():
    """Every absent neighbour column points at the empty run, whose groups
    then have thousands of readers: the index keeps only groups that hold a
    particle, and the scatter is exact (0 on the rest)."""
    pts, out_num, h = blocked_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas")
    scene, sop = build_blocked_scene(pts, cfg, out_num=out_num, device="cpu")
    blk = scene.blocked
    live = np.zeros(blk.n_slots, bool)
    live[sop] = True
    live = live.reshape(-1, blk.group).any(axis=1)
    gidx = blk.bucket.gidx8.numpy().reshape(-1)
    assert (blk.slab_start == blk.n_slots - blk.run_len).any()
    assert blk.slab_idx.numel() == live[gidx].sum() < gidx.size
    buf = _backward_buffer(blk, cfg.h, 44)
    got = pk.slab_to_slots_plain(buf, blk.slab_ptr, blk.slab_idx, blk.n_slots, blk.group)
    want = _add_at(blk, buf)
    assert _rel(got.numpy(), want) < 1e-13
    dead = ~np.repeat(live, blk.group)
    assert not got.numpy()[:, dead].any() and not want[:, dead].any()


def _last_group_inverse(gidx8s, n_slots, group):
    """The scatter index as it was built before it took the particle slots:
    only the layout's last, all-empty group left out."""
    n_groups = n_slots // group
    flat = np.concatenate([np.asarray(g, np.int64).reshape(-1) for g in gidx8s])
    keep = flat < n_groups - 1
    order = np.flatnonzero(keep)[np.argsort(flat[keep], kind="stable")]
    ptr = np.zeros(n_groups + 1, np.int64)
    np.cumsum(np.bincount(flat[keep], minlength=n_groups), out=ptr[1:])
    return ptr.astype(np.int32), order.astype(np.int32)


def test_scatter_output_unchanged_on_a_sparse_scene():
    """On the sparse scene the index built from the particle slots gives
    the same scatter as the one that leaves out only the last group."""
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas")
    scene, sop = build_sparse_scene(pts, cfg, out_num=out_num, device="cpu")
    sb = scene.blocked
    gids = [b.gidx8.numpy() for b in sb.buckets]
    ptr0, idx0 = _last_group_inverse(gids, sb.n_slots, sb.group)
    buf = _backward_buffer(sb, cfg.h, 45)
    got = pk.slab_to_slots_plain(buf, sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
    old = pk.slab_to_slots_plain(buf, torch.as_tensor(ptr0), torch.as_tensor(idx0),
                                 sb.n_slots, sb.group)
    assert torch.equal(got, old)
