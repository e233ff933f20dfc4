"""PyTorch port: the Taichi pairing's separable K2 (``forces_sep``) and its
backward (``forces_sep_bwd``) over a whole scene, on the CPU, where the
wrappers run their scene plain versions:

* the whole-scene plain forward and backward equal the per-bucket plain
  versions placed into the whole-scene outputs (the per-entry buffer by
  the tile schedule), bit for bit, on a sparse scene and on a varcol
  scene whose 216-entry slab ends inside a 32- and a 128-entry piece,
  f64 and f32;
* the kernels read svnw_b = sum_j V_j grad W_ij from the scene's static
  row sums rs6T[3:6] instead of summing it over the slab: that form
  (f = 0.5 V (term_j + M rs6T[3:6]), dG_rows = (d / V_safe) rs6T[3:6]),
  written plainly, against the plain versions' in-slab sum at 1e-12 in
  f64 (another summation order);
* path B (``elastic_forces_pallas``) with ``pair_def_grad="j"`` on that
  varcol scene, its forces and their VJP wrt (positions, x) against the
  JAX package's (Pallas interpret mode) at 1e-10 in f64, on the converted
  scene and on the port's own build.

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py phases 21 and 25."""

import jax
import numpy as np
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops.elasticity import compute_ratio as jratio
from softbody_tpu.scenarios import STRETCH
from softbody_tpu.sim.blocked import build_blocked_scene as jbuild
from softbody_tpu.sim.blocked import elastic_forces_pallas as jpallas
from softbody_tpu_torch.convert import scene_from_numpy
from softbody_tpu_torch.ops import pair_common as pc
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops import separable_kernels as sk
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.sim.blocked import build_blocked_scene, elastic_forces_pallas

from tests.test_torch_blocked import jax_blocked_dict
from tests.test_torch_helpers import to_jax
from tests.test_torch_v2_scene import TOL_FORCES, TOL_RS6, _placed, _rel, _scene, tail_body


def _operands(scene, seed):
    """gT (9, n_slots) = V M with random M, zero past the tile rows; the
    rows' volumes vol_m (m,); dfT (3, m): seeded."""
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    rng = np.random.default_rng(seed)
    vol = scene.materials.volume[:m].contiguous()
    gT = torch.zeros((9, sb.n_slots), dtype=scene.dtype)
    gT[:, :m] = torch.as_tensor(rng.normal(size=(9, m)), dtype=scene.dtype) * vol
    return gT, vol, torch.as_tensor(rng.normal(size=(3, m)), dtype=scene.dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("kind", ["sparse", "varcol"])
def test_scene_plain_equals_per_bucket_plain(kind, dtype):
    """What the wrappers run on the CPU (and PLAIN on any device) against
    the per-bucket plain versions, concatenated and placed: bit for bit."""
    scene, cfg = _scene(kind, dtype)
    sb = scene.blocked
    if kind == "varcol":
        assert sb.buckets[0].slab_len == 216
    gT, vol, dfT = _operands(scene, 7)
    pk.reset_launch_counts()
    f = sk.forces_sep(sb, gT, vol, cfg.h)
    dgs, dgr = sk.forces_sep_bwd(sb, vol, dfT, cfg.h)
    assert not any(pk.launch_counts().values())          # plain on the CPU
    per_f, per_b = [], []
    for b in sb.buckets:
        c = pk.bucket_cols(b, sb.rows)
        per_f.append(sk.forces_sep_plain(b.restT_rows, b.static_slab, gT[:, c], gT,
                                         vol[c], b.gidx8, cfg.h))
        per_b.append(sk.forces_sep_bwd_plain(b.restT_rows, b.static_slab, vol[c],
                                             dfT[:, c], cfg.h))
    m = sb.n_tiles * sb.rows
    assert f.shape == (3, m) and dgr.shape == (9, m)
    assert dgs.shape == (9, pk.n_entries(sb))
    assert torch.equal(f, torch.cat(per_f, dim=1))
    assert torch.equal(dgr, torch.cat([p[0] for p in per_b], dim=1))
    assert torch.equal(dgs, _placed([p[1] for p in per_b], sb, 9))


@pytest.mark.parametrize("kind", ["sparse", "varcol"])
def test_rs6_form_equals_the_in_slab_sum(kind):
    """The kernels' form against the plain versions that sum svnw over the
    slab, f64: f = 0.5 V (term_j + (G_i / V_safe) rs6T[3:6]) with term_j =
    sum_j G_j grad W_ij, and dG_rows = (0.5 V df / V_safe) rs6T[3:6]."""
    scene, cfg = _scene(kind, "float64")
    sb = scene.blocked
    gT, vol, dfT = _operands(scene, 8)
    sv = sb.rs6T[3:6]
    v_safe = torch.where(vol > 0, vol, torch.ones_like(vol))
    termj = []
    for b in sb.buckets:
        dx, gfac = pc.pair_coeffs_g(b.restT_rows, b.static_slab[:, 0:3], cfg.h)
        g_slab = gT[:, pc.slab_slots(b.gidx8, b.slab_len)]          # (9, t, slab)
        termj.append(torch.stack([
            sum(torch.einsum("trs,ts->tr", gfac * dx[k], g_slab[3 * a + k])
                for k in range(3)).reshape(-1) for a in range(3)]))
    termj = torch.cat(termj, dim=1)
    m_rows = gT[:, :sb.n_tiles * sb.rows] / v_safe
    f = torch.stack([0.5 * vol * (termj[a] + sum(m_rows[3 * a + k] * sv[k]
                                                  for k in range(3)))
                     for a in range(3)])
    assert _rel(f, sk.forces_sep_scene_plain(sb, gT, vol, cfg.h)) <= TOL_RS6
    d_over_v = dfT * (0.5 * vol) / v_safe
    dgr = torch.stack([d_over_v[a] * sv[k] for a in range(3) for k in range(3)])
    assert _rel(dgr, sk.forces_sep_bwd_scene_plain(sb, vol, dfT, cfg.h)[1]) <= TOL_RS6


@pytest.fixture(scope="module")
def tail_case_j():
    """The varcol body of the 216-entry slab with the Taichi pairing: JAX's
    path-B forces and VJP, the converted scene and the port's own build."""
    pts, out_num, h = tail_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                pair_def_grad="j", **STRETCH)
    scene_j, sop = jbuild(pts, cfg, out_num=out_num)
    sop = np.asarray(sop)
    rng = np.random.default_rng(47)
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
def test_tail_varcol_path_b_j_matches_jax(tail_case_j, which):
    """Path B with "j": forces and their VJP wrt (positions, x) through the
    whole-scene separable ops on the 216-entry slab, against JAX's."""
    cfg, conv, own, pos, x, ct, want_f, want_g = tail_case_j
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
