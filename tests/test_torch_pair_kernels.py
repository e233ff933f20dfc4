"""PyTorch port: the plain K1 (moments_v4) and K2 (forces_warp_v4) against
the JAX Pallas kernels (interpret mode), bucket by bucket: 1e-12 in f64,
1e-5 in f32 (another summation order over <= 384 slab entries here).
The hand-written CUDA kernels against the plain versions run on the card
only: tests/test_torch_cuda.py, and at full width chip_smoke.py phase 3."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops.pallas.packed import (forces_warp_packed_v4,
                                            moments_packed_v4, pack_components)
from softbody_tpu.sim.sparse import build_sparse_scene as jax_build
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops.pair_common import pair_coeffs

from tests.test_torch_helpers import perturbed, small_body, to_jax, to_torch

TOL = {"float64": 1e-12, "float32": 1e-5}


def _inputs(dtype, seed=0):
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype=dtype, backend="pallas")
    scene_j, sop = jax_build(pts, cfg, out_num=out_num)
    sb = scene_j.blocked
    m = sb.n_tiles * sb.rows
    pos = perturbed(scene_j, np.asarray(sop), 1e-2 * h, seed)
    rng = np.random.default_rng(seed + 1)
    f9 = np.eye(3).reshape(9, 1) + 0.1 * rng.normal(size=(9, m))
    sr = rng.normal(size=(15, sb.n_slots))
    sr[:, m:] = 0.0                       # the trailing empty group
    return cfg, scene_j, pos, f9, sr


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_kernels_match_jax_per_bucket(dtype):
    cfg, scene_j, pos, f9, sr = _inputs(dtype)
    sb = scene_j.blocked
    pos_j = to_jax(pos, dtype)
    packed = pack_components([pos_j[:, 0], pos_j[:, 1], pos_j[:, 2]], 8, 8)
    sr_packed = pack_components([to_jax(sr[k], dtype) for k in range(15)],
                                16, 8, n_total=sb.n_slots)
    posT = to_torch(pos.T, dtype)
    f9_t, sr_t = to_torch(f9, dtype), to_torch(sr, dtype)
    assert len(sb.buckets) >= 2
    for b in sb.buckets:
        r0, mb = b.tile_start * sb.rows, b.n_tiles * sb.rows
        want1 = moments_packed_v4(b.restT_rows, b.static_slab, packed,
                                  pos_j.T[:, r0:r0 + mb], sb.rs6T[:, r0:r0 + mb],
                                  b.gidx8, cfg.h, True)
        want2 = forces_warp_packed_v4(b.restT_rows, b.static_slab,
                                      to_jax(f9[:, r0:r0 + mb], dtype), sr_packed,
                                      b.gidx8, cfg.h, True)
        rr, st = to_torch(b.restT_rows, dtype), to_torch(b.static_slab, dtype)
        gi = torch.as_tensor(np.array(b.gidx8))
        rs6 = to_torch(np.asarray(sb.rs6T)[:, r0:r0 + mb], dtype)
        got1 = pk.moments_v4(rr, st, posT, posT[:, r0:r0 + mb], rs6, gi, cfg.h)
        got2 = pk.forces_warp_v4(rr, st, f9_t[:, r0:r0 + mb], sr_t, gi, cfg.h)
        assert got1.shape == (18, mb) and got2.shape == (3, mb)
        assert got1.dtype == got2.dtype == to_torch(0.0, dtype).dtype
        assert _rel(got1, want1) < TOL[dtype], (b.slab_len, _rel(got1, want1))
        assert _rel(got2, want2) < TOL[dtype], (b.slab_len, _rel(got2, want2))


def test_self_pair_and_far_grid_vanish():
    """rsqrt form: zero gradient factor at r = 0 without a mask, and zero
    coefficients beyond 2h (where the far-grid padding slots sit)."""
    h = 0.01
    rows = torch.tensor([[[0.0, 0.0]], [[0.0, 0.0]], [[0.0, 0.0]]],
                        dtype=torch.float32).reshape(3, 2)
    slab = torch.tensor([[0.0, 2.5 * h, 0.5 * h]] + [[0.0, 0.0, 0.0]] * 2,
                        dtype=torch.float32)
    dx, w, gfac = pair_coeffs(rows, slab, h)
    assert torch.isfinite(gfac).all() and torch.isfinite(w).all()
    assert gfac[0, 0] == 0.0 and gfac[0, 1] == 0.0 and w[0, 1] == 0.0
    assert gfac[0, 2] != 0.0 and w[0, 0] > w[0, 2] > 0.0


def test_wrappers_refuse_other_devices_and_count_nothing_on_cpu():
    cfg, scene_j, pos, f9, sr = _inputs("float32")
    b = scene_j.blocked.buckets[0]
    mb = b.n_tiles * scene_j.blocked.rows
    args = [to_torch(b.restT_rows, "float32"), to_torch(b.static_slab, "float32"),
            to_torch(pos.T, "float32"), None,
            to_torch(np.asarray(scene_j.blocked.rs6T)[:, :mb], "float32"),
            torch.as_tensor(np.array(b.gidx8))]
    args[3] = args[2][:, :mb]
    pk.reset_launch_counts()
    pk.moments_v4(*args, cfg.h)
    assert pk.moments_v4.launches == 0          # the plain version launches nothing
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cpu or cuda"):
        pk.moments_v4(*meta, cfg.h)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pk.forces_warp_v4(meta[0], meta[1], to_torch(f9[:, :mb], "float32").to("meta"),
                          to_torch(sr, "float32").to("meta"), meta[5], cfg.h)
