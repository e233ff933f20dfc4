"""PyTorch port: the per-particle math against the JAX package in f64 —
Jacobi eigh3 / svd3 / polar3 (including degenerate and negative-determinant
inputs, tests/test_svd3.py:72,112), the SPH kernel, the StVK stress, the
ground penalty, the inflation ratio and the Lame parameters."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops import mat3 as jmat3
from softbody_tpu.ops import kernels as jkernels
from softbody_tpu.ops.collision import ground_penalty as jground
from softbody_tpu.ops.elasticity import compute_ratio as jratio
from softbody_tpu.sim.blocked import stvk_stress_m3 as jstvk
from softbody_tpu.sim.scene import lame_parameters as jlame
from softbody_tpu_torch.ops import kernels, mat3
from softbody_tpu_torch.ops.collision import ground_penalty
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.sim.blocked import stvk_stress_m3
from softbody_tpu_torch.sim.scene import lame_parameters

TOL = 1e-12


def _batches():
    rng = np.random.default_rng(0)
    rand = rng.normal(size=(64, 3, 3))
    degenerate = np.zeros((5, 3, 3))
    degenerate[1] = np.diag([1.0, 0.0, 0.0])      # rank 1
    degenerate[2] = np.diag([1.0, 1.0, 0.0])      # rank 2
    degenerate[3] = np.diag([1.0, 1.0, -1.0])     # negative det
    degenerate[4] = np.eye(3) * 1e-20             # tiny
    negdet = rng.normal(size=(64, 3, 3))
    negdet[::2] *= -1.0
    th = rng.uniform(-0.3, 0.3, 32)
    near = np.zeros((32, 3, 3))
    near[:, 0, 0] = np.cos(th); near[:, 0, 1] = -np.sin(th)
    near[:, 1, 0] = np.sin(th); near[:, 1, 1] = np.cos(th)
    near[:, 2, 2] = 1.0
    near = near * rng.uniform(0.5, 2.0, (32, 1, 1)) + rng.normal(scale=1e-4, size=near.shape)
    return {"random": rand, "degenerate": degenerate, "negdet": negdet,
            "near_identity": near}


def _lead(a):
    """(N, 3, 3) -> (3, 3, N)."""
    return np.ascontiguousarray(np.moveaxis(a, 0, -1))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max()


@pytest.mark.parametrize("case", ["random", "degenerate", "negdet", "near_identity"])
def test_svd3_polar3_match_jax(case):
    A = _lead(_batches()[case])
    Uj, sj, Vj = jmat3.svd3(jnp.asarray(A))
    Ut, st, Vt = mat3.svd3(torch.as_tensor(A))
    for got, want in ((Ut, Uj), (st, sj), (Vt, Vj)):
        assert np.isfinite(got.numpy()).all()
        _close(got.numpy(), want)
    _close(mat3.polar3(torch.as_tensor(A)).numpy(), jmat3.polar3(jnp.asarray(A)))


def test_eigh3_matches_jax():
    A = _batches()["random"]
    S = _lead(np.einsum("nba,nbc->nac", A, A))
    ej, Vj = jmat3.eigh3(jnp.asarray(S))
    et, Vt = mat3.eigh3(torch.as_tensor(S))
    _close(et.numpy(), ej)
    _close(Vt.numpy(), Vj)


def test_sph_kernel_matches_jax():
    h = 0.01
    xij = np.random.default_rng(1).uniform(-2.5 * h, 2.5 * h, size=(512, 3))
    xij[0] = 0.0
    _close(kernels.W(torch.as_tensor(xij), h).numpy() * h**3,
           np.asarray(jkernels.W(jnp.asarray(xij), h)) * h**3)
    _close(kernels.nabla_W(torch.as_tensor(xij), h).numpy() * h**4,
           np.asarray(jkernels.nabla_W(jnp.asarray(xij), h)) * h**4)


def test_numpy_sph_kernel_matches_oracle():
    from softbody_tpu.oracle import sim as oracle
    from softbody_tpu_torch.topology import neighbors

    h = 0.01
    xij = np.random.default_rng(3).uniform(-2.5 * h, 2.5 * h, size=(512, 3))
    xij[0] = 0.0
    np.testing.assert_array_equal(neighbors.W(xij, h), oracle.W(xij, h))
    np.testing.assert_array_equal(neighbors.nabla_W(xij, h), oracle.nabla_W(xij, h))
    # and the torch kernels of the force path agree with them
    _close(kernels.W(torch.as_tensor(xij), h).numpy() * h**3,
           neighbors.W(xij, h) * h**3)
    _close(kernels.nabla_W(torch.as_tensor(xij), h).numpy() * h**4,
           neighbors.nabla_W(xij, h) * h**4)


def test_stvk_stress_matches_jax():
    rng = np.random.default_rng(2)
    F = np.eye(3)[:, :, None] + 0.1 * rng.normal(size=(3, 3, 100))
    mu, lam, scale = (rng.uniform(1, 2, 100) for _ in range(3))
    want = np.asarray(jstvk(jnp.asarray(F), jnp.asarray(mu), jnp.asarray(lam),
                            jnp.asarray(scale)))
    Ft = mat3.unpack(torch.as_tensor(F))
    got = mat3.pack(stvk_stress_m3(Ft, torch.as_tensor(mu), torch.as_tensor(lam),
                                   torch.as_tensor(scale))).numpy()
    _close(got, want)


def test_ground_penalty_ratio_and_lame_match_jax():
    cfg = warp_parity().replace(collision_damping=50.0, dtype="float64")
    rng = np.random.default_rng(4)
    pos = rng.uniform(-2e-4, 3e-4, size=(200, 3))
    vel = rng.normal(size=(200, 3))
    _close(ground_penalty(torch.as_tensor(pos), cfg, torch.as_tensor(vel)).numpy(),
           jground(jnp.asarray(pos), cfg, jnp.asarray(vel)))
    _close(ground_penalty(torch.as_tensor(pos), cfg).numpy(),
           jground(jnp.asarray(pos), cfg))
    x = rng.normal(size=300)
    _close(compute_ratio(torch.as_tensor(x), cfg).numpy(), jratio(jnp.asarray(x), cfg))
    assert lame_parameters(1.5e5, 0.4) == jlame(1.5e5, 0.4)
