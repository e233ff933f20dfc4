"""PyTorch port: the mid-section kernels' plain versions against the JAX
package, on the CPU in f64.

* ``ops/mid_kernels.mid_records_plain`` and ``mid_records_bwd_plain``
  against JAX's ``packed._mid_xla`` and ``jax.vjp`` of it, to 1e-12 of each
  output's largest value (the polar VJP's tolerance in
  tests/test_torch_grad.py), on rows built from a seed: near-rotations
  with stretch, exact multiples of I (the quiet body's equal singular
  values), rows with a negative determinant and a zero row; centered dots
  (``dyn`` = [0 | scale]) and raw dots with the - pos_i * rs6 correction
  (``dyn`` = [pos_i | scale]), corotated or not.
* The differentiable op ``mid_records_all`` on the CPU (its wrapper runs
  the plain versions there and counts no launch) against autograd through
  the eager mid-section, to 1e-13.
* Every path that runs the mid-section goes through the ``PairOps``
  entries ``mid_records`` / ``mid_records_bwd``: the default path, the
  Taichi pairing (path A), the blocked layout (path B, its raw dots
  corrected in the op) and the fused path's backward.

The kernels themselves run only on the card: tests/test_torch_cuda.py
(``-k mid``) and chip_smoke.py phase 44 hold them against these plain
versions.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu.ops.pallas.packed import _mid_xla
from softbody_tpu_torch import warp_parity
from softbody_tpu_torch.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu_torch.ops import mid_kernels as mk
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.scenarios import STRETCH, dirichlet_mask
from softbody_tpu_torch.sim.blocked import build_blocked_scene, elastic_forces_pallas
from softbody_tpu_torch.sim.sparse import build_sparse_scene

import tests.test_torch_helpers  # noqa: F401  (one torch thread per process)

T, ROWS = 10, 32          # rows of the JAX tile layout: m = 320
M = T * ROWS


def _rows(seed=0):
    """Seeded per-row operands (numpy f64): ayT (18, M), pos (3, M), rs6
    (6, M), mu / lam / vol / scale (M,), rcT (9, M) and cotangents dfm
    (19, M), dsr (15, M)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(M, 3, 3)))
    q *= np.sign(np.linalg.det(q))[:, None, None]                 # rotations
    stretch = np.eye(3) + 0.2 * rng.normal(size=(M, 3, 3))
    A = q @ stretch * rng.uniform(0.5, 3.0, (M, 1, 1))
    k = M // 5
    A[:k] = np.eye(3) * rng.uniform(0.5, 2.0, (k, 1, 1))         # multiples of I
    A[k:2 * k] = A[k:2 * k] @ np.diag([1.0, 1.0, -1.0])           # det < 0
    A[2 * k] = 0.0
    Y = A + 0.1 * rng.normal(size=(M, 3, 3))
    # ayT row 3b+a = [a][b]
    ayT = np.concatenate([np.swapaxes(A, 1, 2).reshape(M, 9),
                          np.swapaxes(Y, 1, 2).reshape(M, 9)], axis=1).T
    return {
        "ayT": np.ascontiguousarray(ayT),
        "pos": rng.normal(size=(3, M)), "rs6": rng.normal(size=(6, M)),
        "mu": rng.uniform(1.0, 2.0, M), "lam": rng.uniform(1.0, 2.0, M),
        "vol": rng.uniform(0.1, 1.0, M), "scale": rng.uniform(0.5, 2.0, M),
        "rcT": 0.05 * rng.normal(size=(9, M)),
        "dfm": rng.normal(size=(19, M)), "dsr": rng.normal(size=(15, M)),
    }


def _jax(r, corotated, raw):
    """JAX's _mid_xla and its VJP on the rows: (fm (19, M), sr (15, M),
    day (18, M), dscale (M,), dpos (3, M))."""
    def tiles(a):                                 # (k, M) -> (T, ROWS, k)
        return jnp.asarray(a.T.reshape(T, ROWS, -1))

    pos = r["pos"] if raw else np.zeros_like(r["pos"])
    dyn = tiles(np.concatenate([pos, r["scale"][None]]))
    stat = tiles(np.concatenate([r["rs6"], r["mu"][None], r["lam"][None],
                                 r["vol"][None], r["rcT"]]))

    def g(ay, d):
        return _mid_xla(ay, d, stat, corotated, 8)

    (fm, sr), vjp = jax.vjp(g, tiles(r["ayT"]), dyn)
    dsr16 = np.concatenate([r["dsr"], np.zeros((1, M))])
    day, ddyn = vjp((tiles(r["dfm"]), tiles(dsr16)))

    def lanes(a):                                 # (T, ROWS, k) -> (k, M)
        return np.asarray(a).reshape(M, -1).T

    ddyn = lanes(ddyn)
    return lanes(fm), lanes(sr)[:15], lanes(day), ddyn[3], ddyn[:3]


def _torch(r):
    t = {k: torch.as_tensor(v) for k, v in r.items()}
    rs = mk.RowStatic(t["mu"], t["lam"], t["vol"], t["rcT"])
    return t, rs


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max() / scale
    assert err <= tol, err


@pytest.mark.parametrize("raw", [False, True], ids=["centered", "raw_dots"])
@pytest.mark.parametrize("corotated", [True, False])
def test_plain_mid_section_and_vjp_match_jax(corotated, raw):
    r = _rows()
    want = _jax(r, corotated, raw)
    t, rs = _torch(r)
    corr = (t["pos"], t["rs6"]) if raw else (None, None)
    n_sr = M + 24
    fmT, srT = mk.mid_records_plain(t["ayT"], rs, t["scale"], corotated, n_sr, *corr)
    assert srT.shape == (15, n_sr) and not srT[:, M:].any()
    dayT, dscale, dpos = mk.mid_records_bwd_plain(t["ayT"], rs, t["scale"], corotated,
                                                  t["dfm"], t["dsr"], *corr)
    assert (dpos is None) == (not raw)
    got = (fmT, srT[:, :M], dayT, dscale) + ((dpos,) if raw else ())
    for g, w in zip(got, want):                   # centered: JAX's dpos unused
        _close(g.numpy(), w, 1e-12)


@pytest.mark.parametrize("raw", [False, True], ids=["centered", "raw_dots"])
@pytest.mark.parametrize("corotated", [True, False])
def test_mid_records_op_matches_autograd_through_the_eager_mid_section(corotated, raw):
    """``mid_records_all`` through KERNELS on CPU tensors (the wrappers run
    the plain versions: no launch counted) against autograd through
    ``mid_records_plain``: outputs bitwise, gradients to 1e-13."""
    r = _rows(1)
    t, rs = _torch(r)
    n_sr = M + 8

    def run(op):
        ay = t["ayT"].clone().requires_grad_()
        sc = t["scale"].clone().requires_grad_()
        p = t["pos"].clone().requires_grad_()
        corr = (p, t["rs6"]) if raw else (None, None)
        fmT, srT = op(ay, sc, corr)
        loss = (fmT * t["dfm"]).sum() + (srT[:, :M] * t["dsr"]).sum()
        ins = (ay, sc, p) if raw else (ay, sc)
        return (fmT.detach(), srT.detach()) + torch.autograd.grad(loss, ins)

    pk.reset_launch_counts()
    got = run(lambda ay, sc, corr: mk.mid_records_all(ay, sc, rs, corotated, n_sr,
                                                       pk.KERNELS, *corr))
    assert not any(pk.launch_counts().values())
    want = run(lambda ay, sc, corr: mk.mid_records_plain(ay, rs, sc, corotated, n_sr,
                                                         *corr))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        _close(g.numpy(), w.numpy(), 1e-13)


@pytest.fixture(scope="module")
def small_scenes():
    pts, out_num = inflatable_sphere(n_outer=80)
    cfg = warp_parity().replace(h=suggest_h(pts, 32), dtype="float64", backend="pallas",
                                **STRETCH)
    out = {}
    for blocked in (False, True):
        build = build_blocked_scene if blocked else build_sparse_scene
        scene, _ = build(pts, cfg, out_num=out_num,
                         dirichlet_mask=dirichlet_mask(pts, "stretch"), device="cpu")
        rng = np.random.default_rng(5)
        pos = scene.rest_position.clone()
        pos[scene.slot_of_particle] += torch.as_tensor(
            rng.normal(scale=0.05 * cfg.h, size=(len(pts), 3)))
        x = torch.as_tensor(rng.normal(scale=0.5, size=scene.blocked.n_slots))
        out[blocked] = (scene, pos, x)
    return cfg, out


@pytest.mark.parametrize("path", ["default", "taichi", "fused", "blocked", "blocked_taichi"])
def test_every_path_runs_the_mid_section_through_its_ops(small_scenes, path):
    """A force evaluation and its VJP through a spying PairOps: the
    unfused paths call ``mid_records`` once and ``mid_records_bwd`` once
    (path B with its raw-dot correction operands), the fused path only
    ``mid_records_bwd`` (its forward is the fused K1's epilogue); the
    forces and gradients equal the plain table's bit for bit."""
    cfg, scenes = small_scenes
    blocked = path.startswith("blocked")
    scene, pos, x = scenes[blocked]
    c = cfg.replace(pair_def_grad="j" if path.endswith("taichi") else "i",
                    fused_mid=path == "fused")
    seen = []

    def spy(name, fn):
        def wrapped(*a, **k):
            if name.startswith("mid_records"):   # rs6T, last of 7 / 8: the correction
                seen.append((name, len(a) in (7, 8) and a[-1] is not None))
            return fn(*a, **k)
        return wrapped

    ops = pk.PairOps(*(spy(n, f) for n, f in zip(pk.PairOps._fields, pk.PLAIN)))
    ct = torch.as_tensor(np.random.default_rng(6).normal(size=tuple(pos.shape)))

    def run(table):
        p = pos.clone().requires_grad_()
        xv = x.clone().requires_grad_()
        f = elastic_forces_pallas(p, compute_ratio(xv, c), scene.materials, scene, c,
                                  table)
        return (f.detach(),) + torch.autograd.grad(f, (p, xv), ct)

    got = run(ops)
    want = ([] if path == "fused" else [("mid_records", blocked)]) + [
        ("mid_records_bwd", blocked)]
    assert seen == want
    assert all(torch.equal(a, b) for a, b in zip(got, run(pk.PLAIN)))
    assert float(got[2].abs().max()) > 0
