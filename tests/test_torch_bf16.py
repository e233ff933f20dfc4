"""PyTorch port: the bf16 K2 slab (``cfg.pair_dtype="bfloat16"``) against
the JAX package's bf16 path (Pallas kernels in interpret mode), in f32.

The mode is storage only in both packages: the K2 slot record S | R is
rounded to bfloat16 (round to nearest even in both) and every pair product
runs in f32.  The f32 S | R of the two packages differ at f32 rounding
(their f32 forces at ~1e-5 of max |f| here), so now and then one component
lands in the neighbouring bf16 value, 2^-8 of it apart.  Tolerances:

* K2 on the SAME bf16 slab (no rounding to disagree on): the forces 1e-5 of
  max |JAX| (f32, another summation order), dF 1e-5; the slab cotangent is
  bf16 in both, rounded at the same places (each bucket's f32 slot sums to
  bf16, then the buckets added in bf16, last first): equal but where
  another f32 summation order tips a rounding, at most 1 in 200 values, by
  at most 2^-7 of the largest;
* the forces of a whole evaluation, default path and path B: 1e-3 of max
  |JAX bf16| (measured 3.7e-4 / 2.4e-4 from those bucket flips), and the
  port's bf16 forces at most half as far from JAX's bf16 forces as from
  either package's f32 forces (measured 0.32 / 0.26): no systematic part;
* a 24-step episode against the port's f32 path: drift <= 5% of the
  displacement (``tests/test_pair_dtype.py:69``);
* an 8-step episode gradient against JAX's bf16 gradient, the arithmetic
  in f64 so that no S | R value rounds differently (an f32 gradient of so
  short an episode is rounding noise in both packages): loss 1e-12
  relative, gradient 1e-8 of max |g| (rounding the cotangent once instead
  of JAX's way moves it by 1.6e-3); against the f32-slab gradient the JAX
  test's guard, cos > 0.85 and norm within 10%
  (``tests/test_pair_dtype.py:91-92``).

The fused path with bf16 and the Taichi pairing with bf16:
``tests/test_torch_fused_forces.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.ops.elasticity import compute_ratio as jratio
from softbody_tpu.ops.pallas.packed import forces_warp_packed_v4, pack_components
from softbody_tpu.scenarios import STRETCH, dirichlet_mask
from softbody_tpu.sim.blocked import elastic_forces_pallas as jpallas
from softbody_tpu.sim.rollout import value_and_grad_fn as jvalue_and_grad_fn
from softbody_tpu.sim.sparse import elastic_forces_sparse as jforces
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops.elasticity import compute_ratio
from softbody_tpu_torch.sim.blocked import elastic_forces_pallas
from softbody_tpu_torch.sim.rollout import rollout, value_and_grad_fn
from softbody_tpu_torch.sim.sparse import elastic_forces_sparse

from tests.test_torch_blocked import blocked_body, both_blocked
from tests.test_torch_helpers import both_scenes, perturbed, small_body, to_jax


def _rel(got, want, scale=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / (np.abs(want).max() if scale is None else scale)


def _cfg(h, pd, **over):
    return warp_parity().replace(**{"h": h, "dtype": "float32", "backend": "pallas",
                                    "pair_dtype": pd, **STRETCH, **over})


def test_k2_on_the_same_bf16_slab_matches_jax():
    """K2 v4 and its VJP per bucket on one bf16 slab in both packages."""
    pts, out_num, h = small_body()
    cfg = _cfg(h, "bfloat16")
    scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num)
    sbj, sbt = scene_j.blocked, scene_t.blocked
    m = sbj.n_tiles * sbj.rows
    rng = np.random.default_rng(5)
    f9 = (np.eye(3).reshape(9, 1) + 0.1 * rng.normal(size=(9, m))).astype(np.float32)
    sr = rng.normal(size=(15, sbj.n_slots)).astype(np.float32)
    sr[:, m:] = 0.0
    srb = torch.as_tensor(sr).to(torch.bfloat16)
    sr_packed = pack_components([jnp.asarray(sr[k], jnp.bfloat16) for k in range(15)],
                                16, 8, n_total=sbj.n_slots)
    assert np.array_equal(np.asarray(sr_packed[:, :8], np.float32),
                          srb[0].float().numpy()[:8 * sr_packed.shape[0]].reshape(-1, 8))
    f9_t = torch.as_tensor(f9).requires_grad_()
    sr_t = srb.clone().requires_grad_()
    got = pk.forces_all(f9_t, sr_t, sbt, cfg.h)
    dfT = rng.normal(size=(3, m)).astype(np.float32)
    df9_t, dsr_t = torch.autograd.grad(got, (f9_t, sr_t), torch.as_tensor(dfT))
    assert dsr_t.dtype == torch.bfloat16
    want, df9_j, dsr_j = [], [], []
    for b in sbj.buckets:
        c = slice(b.tile_start * sbj.rows, (b.tile_start + b.n_tiles) * sbj.rows)
        out, vjp = jax.vjp(lambda f, s: forces_warp_packed_v4(
            b.restT_rows, b.static_slab, f, s, b.gidx8, cfg.h, True),
            jnp.asarray(f9[:, c]), sr_packed)
        want.append(np.asarray(out))
        d_f9, d_sr = vjp(jnp.asarray(dfT[:, c]))
        assert d_sr.dtype == jnp.bfloat16
        df9_j.append(np.asarray(d_f9))
        dsr_j.append(d_sr)
    assert _rel(got.detach(), np.concatenate(want, axis=1)) < 1e-5
    assert _rel(df9_t, np.concatenate(df9_j, axis=1)) < 1e-5
    # autograd's bf16 sum of the buckets' cotangents, last bucket first
    acc = dsr_j[-1]
    for d in dsr_j[-2::-1]:
        acc = acc + d
    # field-major packed rows (n_slots / 8, 16 * 8) -> (15, n_slots), at the
    # particle slots; JAX's group 0 also takes its tile padding's entries
    # (gidx 0), undefined in interpret mode (NaN at one particle here): left out
    acc = np.asarray(acc, np.float32).reshape(-1, 16, 8).transpose(1, 0, 2)
    want = acc.reshape(16, -1)[:15, sop]
    got = dsr_t.float().numpy()[:, sop]
    ok = np.isfinite(want)
    assert ok.mean() > 0.99
    got, want = got[ok], want[ok]
    assert (got != want).mean() < 5e-3, (got != want).mean()
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.fixture(scope="module", params=["sparse", "blocked"])
def forces_case(request):
    """Both packages' forces in f32 and bf16 on one perturbed state."""
    sparse = request.param == "sparse"
    pts, out_num, h = (small_body if sparse else blocked_body)()
    build = both_scenes if sparse else both_blocked
    jf, tf = (jforces, elastic_forces_sparse) if sparse else (jpallas,
                                                              elastic_forces_pallas)
    out = {}
    for pd in ("float32", "bfloat16"):
        cfg = _cfg(h, pd)
        scene_j, scene_t, sop = build(pts, cfg, out_num=out_num)
        pos = perturbed(scene_j, sop, 3e-2 * h, 3)
        x = np.zeros(scene_j.blocked.n_slots)
        x[sop] = np.random.default_rng(4).normal(scale=0.5, size=len(sop))
        want = jf(to_jax(pos, "float32"), jratio(to_jax(x, "float32"), cfg),
                  scene_j.materials, scene_j, cfg, interpret=True)
        got = tf(torch.as_tensor(pos, dtype=torch.float32),
                 compute_ratio(torch.as_tensor(x, dtype=torch.float32), cfg),
                 scene_t.materials, scene_t, cfg)
        out[pd] = (got.double().numpy(), np.asarray(want, np.float64))
    return out


def test_bf16_forces_match_jax(forces_case):
    (t32, j32), (t16, j16) = forces_case["float32"], forces_case["bfloat16"]
    scale = np.abs(j16).max()
    err = _rel(t16, j16)
    assert err < 1e-3, err
    assert _rel(t16, j32, scale) > 1e-4          # the mode moves the forces at all
    assert err <= 0.5 * min(_rel(t16, j32, scale), _rel(t16, t32, scale)), (
        err, _rel(t16, j32, scale), _rel(t16, t32, scale))


def test_bf16_episode_drift_bounded():
    """24 steps of warp_parity (the JAX test's preset and depth) against the
    port's f32 path."""
    pts, out_num, h = small_body()
    finals = {}
    for pd in ("float32", "bfloat16"):
        cfg = warp_parity().replace(h=h, dtype="float32", dt=1e-6, backend="pallas",
                                    frames=24, target_frames=4, pair_dtype=pd)
        _, scene_t, sop = both_scenes(pts, cfg, out_num=out_num)
        x = np.random.default_rng(7).normal(size=scene_t.blocked.n_slots) * 0.4
        _, state, _ = rollout(x, scene_t, cfg, device="cpu")
        finals[pd] = state.position.double().numpy()
    rest = scene_t.rest_position.double().numpy()
    disp = np.abs(finals["float32"] - rest).max()
    drift = np.abs(finals["bfloat16"] - finals["float32"]).max()
    assert 0 < drift <= 0.05 * disp, (drift, disp)


def test_bf16_episode_gradient_matches_jax():
    pts, out_num, h = small_body()
    mask = dirichlet_mask(pts, "stretch")
    frames = 4
    grads = {}
    for pd in ("float32", "bfloat16"):
        cfg = _cfg(h, pd, frames=8, target_frames=frames, dtype="float64")
        scene_j, scene_t, sop = both_scenes(pts, cfg, out_num=out_num,
                                            dirichlet_mask=mask)
        rng = np.random.default_rng(21)
        x = np.zeros(scene_j.blocked.n_slots)
        x[sop] = rng.normal(scale=0.5, size=len(sop))
        tp = np.tile(np.asarray(scene_j.rest_position, np.float64), (frames, 1, 1))
        tv = np.zeros_like(tp)
        tp[:, sop] += rng.normal(scale=1e-4, size=(frames, len(sop), 3))
        tv[:, sop] += rng.normal(scale=1e-2, size=(frames, len(sop), 3))
        loss_t, g_t = value_and_grad_fn(scene_t, cfg)(x, tp, tv)
        grads[pd] = g_t.numpy()
        if pd == "bfloat16":
            loss_j, g_j = jvalue_and_grad_fn(scene_j, cfg)(
                to_jax(x, "float64"), to_jax(tp, "float64"), to_jax(tv, "float64"))
            g_j = np.asarray(g_j)
            assert abs(loss_t - float(loss_j)) <= 1e-12 * float(loss_j)
    a, b = grads["float32"], grads["bfloat16"]
    assert _rel(b, g_j) <= 1e-8, _rel(b, g_j)
    assert _rel(b, a) > 1e-4                     # the slab's rounding shows
    cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.85, cos
    assert np.linalg.norm(b) == pytest.approx(np.linalg.norm(a), rel=0.10)
