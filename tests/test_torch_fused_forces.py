"""PyTorch port: ``elastic_forces_sparse`` on the fused path
(``cfg.fused_mid``: fused K1 + mid-section, then K2 v2) against the JAX
package's fused path (Pallas kernels in interpret mode) and against the
port's own unfused path, f64, for ``corotated`` True and False; and one VJP
wrt (positions, x) with a random cotangent against ``jax.vjp`` of JAX's
fused path.  Tolerances relative to max |JAX|: 1e-10 against JAX (its fused
path centers its moments against the host's static row sums, the port's
against its in-kernel ones: equal in exact arithmetic), 1e-12 against the
port's unfused path (the same K1 moments; only the mid-section's order of
operations and K2's term_i sum differ)."""

import numpy as np
import jax
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops.elasticity import compute_ratio as jratio
from softbody_tpu.sim.sparse import elastic_forces_sparse as jforces
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.sim.sparse import elastic_forces_sparse

from tests.test_torch_helpers import both_scenes, perturbed, small_body, to_jax

TOL_JAX = 1e-10
TOL_UNFUSED = 1e-12


@pytest.fixture(scope="module")
def setup():
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                fused_mid=True)
    scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num)
    rng = np.random.default_rng(12)
    pos = perturbed(scene_j, sop, 3e-2 * cfg.h, seed=12)
    x = np.zeros(scene_j.blocked.n_slots)
    x[sop] = rng.normal(scale=0.5, size=len(sop))
    ct = np.zeros_like(pos)
    ct[sop] = rng.normal(size=(len(sop), 3))
    return cfg, scene_j, scene_t, pos, x, ct


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _port(cfg, scene_t, pos, x, ct=None):
    p = torch.as_tensor(pos).requires_grad_(ct is not None)
    xv = torch.as_tensor(x).requires_grad_(ct is not None)
    f = elastic_forces_sparse(p, compute_ratio(xv, cfg), scene_t.materials,
                              scene_t, cfg)
    if ct is None:
        return f.detach().numpy()
    return f.detach().numpy(), [g.numpy() for g in
                                torch.autograd.grad(f, (p, xv), torch.as_tensor(ct))]


@pytest.mark.parametrize("corotated", [True, False])
def test_fused_forces_match_jax_and_the_unfused_path(setup, corotated):
    cfg, scene_j, scene_t, pos, x, _ = setup
    cfg = cfg.replace(corotated=corotated)
    want = np.asarray(jax.jit(lambda p, xv: jforces(
        p, jratio(xv, cfg), scene_j.materials, scene_j, cfg, interpret=True))(
        to_jax(pos, "float64"), to_jax(x, "float64")))
    got = _port(cfg, scene_t, pos, x)
    assert _rel(got, want) < TOL_JAX
    unfused = _port(cfg.replace(fused_mid=False), scene_t, pos, x)
    assert _rel(got, unfused) < TOL_UNFUSED
    # padding slots carry exactly zero force
    pad = np.ones(len(got), bool)
    pad[np.asarray(scene_t.slot_of_particle)] = False
    assert not got[pad].any()


def test_fused_vjp_matches_jax(setup):
    cfg, scene_j, scene_t, pos, x, ct = setup

    def f(p, xv):
        return jforces(p, jratio(xv, cfg), scene_j.materials, scene_j, cfg,
                       interpret=True)

    want = jax.jit(lambda p, xv, c: jax.vjp(f, p, xv)[1](c))(
        to_jax(pos, "float64"), to_jax(x, "float64"), to_jax(ct, "float64"))
    _, got = _port(cfg, scene_t, pos, x, ct)
    for g, w in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 0
        assert _rel(g, w) < TOL_JAX
    # and the port's own unfused VJP
    _, unfused = _port(cfg.replace(fused_mid=False), scene_t, pos, x, ct)
    for g, u in zip(got, unfused):
        assert _rel(g, u) < TOL_UNFUSED


def test_fused_path_goes_through_the_fused_ops(setup, monkeypatch):
    """The fused config calls only the fused entries of the PairOps table
    (forward and backward), the unfused one only the v4 entries."""
    cfg, _, scene_t, pos, x, ct = setup
    seen = []

    def spy(name, fn):
        def wrapped(*a, **k):
            seen.append(name)
            return fn(*a, **k)
        return wrapped

    ops = pk.PairOps(*(spy(n, f) for n, f in zip(pk.PairOps._fields, pk.PLAIN)))
    for fused in (True, False):
        seen.clear()
        c = cfg.replace(fused_mid=fused)
        p = torch.as_tensor(pos).requires_grad_()
        f = elastic_forces_sparse(p, compute_ratio(torch.as_tensor(x), c),
                                  scene_t.materials, scene_t, c, ops)
        torch.autograd.grad(f, p, torch.as_tensor(ct))
        want = ({"moments_mid", "forces_v2", "moments_raw_bwd", "forces_v2_bwd",
                 "to_slots"} if fused else
                {"moments", "forces", "moments_bwd", "forces_bwd", "to_slots"})
        assert set(seen) == want


@pytest.mark.parametrize("override", [{"pair_def_grad": "j", "pair_dtype": "bfloat16"},
                                      {"pair_dtype": "bfloat16"}])
def test_fused_path_keeps_the_unported_refusals(setup, override):
    cfg, _, scene_t, pos, x, _ = setup
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(cfg.replace(**override), scene_t, pos, x)
