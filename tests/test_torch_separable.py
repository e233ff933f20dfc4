"""PyTorch port, Taichi pairing (``pair_def_grad="j"``): the separable K2's
plain versions against the JAX package's ``packed.forces_packed`` and its
VJP (Pallas kernels in interpret mode), bucket by bucket, on the small
parity body carried across with ``convert.scene_from_numpy``; then the
whole ``elastic_forces_sparse`` with ``"j"`` and its VJP against JAX's.

Tolerances, relative to max |JAX|: per bucket 1e-12 in f64 and 2e-4 in f32
(another summation order over <= 384 slab entries and 32 rows; in f32 the
TPU kernel's MXU dot and the plain einsum round differently); the whole
force and its VJP 1e-10 in f64, for STRETCH with ``"j"`` and for the
``taichi_parity()`` preset (corotated off, self density).  The CUDA kernels
are held against these plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py phases 21-24."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import taichi_parity, warp_parity
from softbody_tpu.ops.elasticity import compute_ratio as jratio
from softbody_tpu.ops.pallas import packed
from softbody_tpu.scenarios import STRETCH
from softbody_tpu.sim.sparse import elastic_forces_sparse as jforces
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops import separable_kernels as sk
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.ops.pair_common import slab_slots
from softbody_tpu_torch.sim.sparse import elastic_forces_sparse

from tests.test_torch_helpers import both_scenes, perturbed, small_body, to_jax

TOL_BUCKET = {"float64": 1e-12, "float32": 2e-4}
TOL_FORCES = 1e-10


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _t(a, dtype):
    return torch.as_tensor(np.array(a, np.float64)).to(
        {"float32": torch.float32, "float64": torch.float64}[dtype])


@pytest.fixture(scope="module", params=["float64", "float32"])
def case(request):
    """Both scenes in one dtype, a random G = V M per slot, a random force
    cotangent, and JAX's forces_packed and its VJP per bucket."""
    dtype = request.param
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype=dtype, backend="pallas", pair_def_grad="j")
    scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num)
    sb = scene_j.blocked
    rows, m = sb.rows, sb.n_tiles * sb.rows
    rng = np.random.default_rng(31)
    g = np.zeros((sb.n_slots, 9))
    g[:m] = rng.normal(size=(m, 9)) * np.asarray(scene_j.materials.volume[:m])[:, None]
    df = rng.normal(size=(m, 3))
    vol = np.asarray(scene_j.materials.volume[:m], np.float64)
    refs = []
    for b in sb.buckets:
        r0, mb = b.tile_start * rows, b.n_tiles * rows

        def f(g_rows, g_slots, b=b, r0=r0, mb=mb):
            return packed.forces_packed(
                b.restT_rows, b.static_slab, g_rows, g_slots,
                jnp.asarray(vol[r0:r0 + mb].reshape(b.n_tiles, rows), dtype),
                b.gidx8, cfg.h, True)

        g_rows = jnp.asarray(g[r0:r0 + mb].reshape(b.n_tiles, rows, 9), dtype)
        out, vjp = jax.vjp(f, g_rows, jnp.asarray(g, dtype))
        dgr, dgs = vjp(jnp.asarray(df[r0:r0 + mb].reshape(b.n_tiles, rows, 3), dtype))
        refs.append({k: np.asarray(v, np.float64) for k, v in
                     dict(f=out, dgr=dgr, dgs=dgs).items()})
    return dict(dtype=dtype, cfg=cfg, scene_t=scene_t, g=g, df=df, vol=vol, refs=refs)


def test_forces_sep_plain_matches_jax_per_bucket(case):
    dtype, sb = case["dtype"], case["scene_t"].blocked
    gT = _t(case["g"].T, dtype)
    vol = _t(case["vol"], dtype)
    for b, ref in zip(sb.buckets, case["refs"]):
        c = slice(b.row_start, b.row_start + b.n_tiles * sb.rows)
        got = sk.forces_sep_plain(b.restT_rows, b.static_slab, gT[:, c], gT, vol[c],
                                  b.gidx8, case["cfg"].h)
        assert got.dtype == gT.dtype
        assert _rel(got.T.numpy(), ref["f"].reshape(-1, 3)) < TOL_BUCKET[dtype]


def test_forces_sep_bwd_plain_matches_jax_vjp_per_bucket(case):
    """The rows' dG (term_i path) and the slab's dG (term_j path, added
    into slots) against JAX's VJP wrt (g_rows, g_slots)."""
    dtype, sb = case["dtype"], case["scene_t"].blocked
    vol, dfT = _t(case["vol"], dtype), _t(case["df"].T, dtype)
    for b, ref in zip(sb.buckets, case["refs"]):
        c = slice(b.row_start, b.row_start + b.n_tiles * sb.rows)
        dgr, dgs = sk.forces_sep_bwd_plain(b.restT_rows, b.static_slab, vol[c],
                                           dfT[:, c], case["cfg"].h)
        assert dgs.shape == (b.n_tiles, 9, b.slab_len)
        assert _rel(dgr.T.numpy(), ref["dgr"].reshape(-1, 9)) < TOL_BUCKET[dtype]
        slots = np.zeros((sb.n_slots, 9))
        np.add.at(slots, slab_slots(b.gidx8, b.slab_len).reshape(-1).numpy(),
                  dgs.permute(0, 2, 1).reshape(-1, 9).double().numpy())
        assert _rel(slots, ref["dgs"]) < TOL_BUCKET[dtype]


def test_forces_sep_all_backward_matches_autograd_of_plain(case):
    """The autograd op's backward (row and slab passes, one CSR scatter)
    equals autograd through the plain forward (to rounding: 1e-13 in f64,
    1e-6 in f32)."""
    dtype, sb, h = case["dtype"], case["scene_t"].blocked, case["cfg"].h
    gT = _t(case["g"].T, dtype)
    vol = _t(case["vol"], dtype)
    ct = _t(case["df"].T, dtype)
    g1 = gT.clone().requires_grad_()
    (got,) = torch.autograd.grad(sk.forces_sep_all(g1, vol, sb, h, pk.PLAIN), g1, ct)
    g2 = gT.clone().requires_grad_()
    f = torch.cat([sk.forces_sep_plain(b.restT_rows, b.static_slab,
                                       g2[:, b.row_start:b.row_start + b.n_tiles * sb.rows],
                                       g2, vol[b.row_start:b.row_start + b.n_tiles * sb.rows],
                                       b.gidx8, h) for b in sb.buckets], dim=1)
    (want,) = torch.autograd.grad(f, g2, ct)
    assert _rel(got.numpy(), want.numpy()) < (1e-13 if dtype == "float64" else 1e-6)


def test_cpu_dispatch_is_the_plain_version_and_counts_nothing(case):
    dtype, sb = case["dtype"], case["scene_t"].blocked
    gT, vol, dfT = _t(case["g"].T, dtype), _t(case["vol"], dtype), _t(case["df"].T, dtype)
    b = sb.buckets[0]
    c = slice(b.row_start, b.row_start + b.n_tiles * sb.rows)
    args = (b.restT_rows, b.static_slab, gT[:, c], gT, vol[c], b.gidx8, case["cfg"].h)
    bargs = (b.restT_rows, b.static_slab, vol[c], dfT[:, c], case["cfg"].h)
    pk.reset_launch_counts()
    assert torch.equal(sk.forces_sep(*args), sk.forces_sep_plain(*args))
    rows, slab = sk.forces_sep_bwd(*bargs)
    assert torch.equal(rows, sk.forces_sep_bwd_rows(*bargs))
    assert torch.equal(slab, sk.forces_sep_bwd_slab(*bargs))
    counts = pk.launch_counts()
    assert all(counts[k] == 0 for k in ("forces_sep", "forces_sep_bwd_rows",
                                        "forces_sep_bwd_slab"))


# ------------------------------------------------------------ whole forces
@pytest.fixture(scope="module", params=["stretch_j", "taichi_parity"])
def forces_case(request):
    pts, out_num, h = small_body()
    if request.param == "stretch_j":
        cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                    pair_def_grad="j", **STRETCH)
    else:
        cfg = taichi_parity().replace(h=h, backend="pallas")
    scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num)
    rng = np.random.default_rng(32)
    pos = perturbed(scene_j, sop, 3e-2 * h, seed=32)
    x = np.zeros(scene_j.blocked.n_slots)
    x[sop] = rng.normal(scale=0.5, size=len(sop))
    ct = np.zeros_like(pos)
    ct[sop] = rng.normal(size=(len(sop), 3))
    return cfg, scene_j, scene_t, sop, pos, x, ct


def _port(cfg, scene_t, pos, x, ct=None, ops=pk.KERNELS):
    p = torch.as_tensor(pos).requires_grad_(ct is not None)
    xv = torch.as_tensor(x).requires_grad_(ct is not None)
    f = elastic_forces_sparse(p, compute_ratio(xv, cfg), scene_t.materials, scene_t,
                              cfg, ops)
    if ct is None:
        return f.detach().numpy()
    return f.detach().numpy(), [g.numpy() for g in
                                torch.autograd.grad(f, (p, xv), torch.as_tensor(ct))]


def _jax_f(cfg, scene_j):
    def f(p, xv):
        return jforces(p, jratio(xv, cfg), scene_j.materials, scene_j, cfg,
                       interpret=True)
    return f


def test_taichi_forces_match_jax(forces_case):
    cfg, scene_j, scene_t, sop, pos, x, _ = forces_case
    want = np.asarray(jax.jit(_jax_f(cfg, scene_j))(to_jax(pos, "float64"),
                                                   to_jax(x, "float64")))
    got = _port(cfg, scene_t, pos, x)
    assert _rel(got, want) < TOL_FORCES
    pad = np.ones(len(got), bool)
    pad[sop] = False
    assert not got[pad].any()


def test_taichi_vjp_matches_jax(forces_case):
    cfg, scene_j, scene_t, _, pos, x, ct = forces_case
    want = jax.jit(lambda p, xv, c: jax.vjp(_jax_f(cfg, scene_j), p, xv)[1](c))(
        to_jax(pos, "float64"), to_jax(x, "float64"), to_jax(ct, "float64"))
    _, got = _port(cfg, scene_t, pos, x, ct)
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 0
        assert _rel(g, w) < TOL_FORCES


def test_fused_mid_with_taichi_pairing_runs_the_j_branch(forces_case):
    """JAX's fused path covers only the Warp pairing: with "j" it runs the
    "j" branch, and so does the port, bit for bit, through the separable
    ops alone."""
    cfg, _, scene_t, _, pos, x, ct = forces_case
    seen = []

    def spy(name, fn):
        def wrapped(*a, **k):
            seen.append(name)
            return fn(*a, **k)
        return wrapped

    ops = pk.PairOps(*(spy(n, f) for n, f in zip(pk.PairOps._fields, pk.PLAIN)))
    f_j, g_j = _port(cfg, scene_t, pos, x, ct, ops)
    fused = set(seen)
    seen.clear()
    f_fm, g_fm = _port(cfg.replace(fused_mid=True), scene_t, pos, x, ct, ops)
    assert set(seen) == fused == {"moments", "moments_bwd", "forces_sep",
                                  "forces_sep_bwd", "to_slots"}
    assert np.array_equal(f_fm, f_j)
    assert all(np.array_equal(a, b) for a, b in zip(g_fm, g_j))
