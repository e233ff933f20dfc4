"""PyTorch port: the gather backend's kernels' plain versions
(``ops/gather_kernels.py``: gather_moments, gather_forces and their VJPs,
with ``mid_records`` between them) against the JAX package's gather
backend (``softbody_tpu/ops/elasticity.py``), on the CPU in f64.

The kernels themselves run on the card only (tests/test_torch_cuda.py,
chip_smoke.py); here each plain version is what a CPU tensor runs.
Tolerance: 1e-12 of max |JAX| throughout (``OPS_TOL``, as
tests/test_torch_gather.py's; the two sides sum in other orders).  The
cases cover both pairings, ``corotated`` on and off, and a shard-like
source: a ragged run of rows whose table reads a source of every
particle, with its CSR inverse over the source (as
``parallel/sharding.shard_scene`` builds it).  The forces read the packed
source record ``mid_records`` writes (its fields bitwise srT's and
fmT's); the backwards' passes as the kernels compute them, their source
passes streaming the Topology's ``inv_row`` with ``inv_nw`` (the forces)
or ``inv_cxw`` (the moments) in CSR order, are emulated in plain torch
and held to the plain VJPs, the moments' plain VJP also to ``jax.vjp`` of
the JAX package's ``deformation``, and every Topology builder's streamed
inverse to its definition."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from softbody_tpu import build_scene as jbuild_scene
from softbody_tpu import warp_parity
from softbody_tpu.ops import elasticity as jel
from softbody_tpu_torch.core.types import Topology
from softbody_tpu_torch.ops import elasticity as tel
from softbody_tpu_torch.ops import gather_kernels as gk
from softbody_tpu_torch.ops import mid_kernels as mk
from softbody_tpu_torch.ops import pair_kernels as pk
from softbody_tpu_torch.ops.pair_common import SYM6
from softbody_tpu_torch.sim.scene import build_scene

from tests.test_torch_helpers import small_body

OPS_TOL = 1e-12
CASES = [("i", True), ("i", False), ("j", True), ("j", False)]
ROWS = slice(7, 150)        # the shard-like rows: ragged, not a multiple of a block's 8


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def body():
    pts, out_num, h = small_body()
    rng = np.random.default_rng(21)
    F = np.eye(3) + 0.05 * rng.normal(size=(3, 3))
    pos = (pts - pts.mean(0)) @ F.T + pts.mean(0) + 1e-4 * rng.normal(size=pts.shape)
    return dict(pts=pts, out_num=out_num, h=h, pos=pos,
                x=rng.normal(size=len(pts)), dayT=rng.normal(size=(18, len(pts))),
                df=rng.normal(size=pts.shape))


def _scenes(body, pairing="i", corotated=True):
    cfg = warp_parity().replace(h=body["h"], dtype="float64", pair_def_grad=pairing,
                                corotated=corotated)
    return (cfg, jbuild_scene(body["pts"], cfg, out_num=body["out_num"]),
            build_scene(body["pts"], cfg, out_num=body["out_num"], device="cpu"))


def _shard(topo: Topology, rows: slice) -> Topology:
    """The rows' part of a table that keeps reading every particle."""
    fields = {f: getattr(topo, f)[rows].contiguous() for f in Topology._fields[:10]}
    return Topology(**fields, **gk.inverse_fields(fields["idx"], topo.idx.shape[0], fields),
                    rcT=gk.rest_corr_lanes(fields["rest_corr"]))


def _jrows(topo, rows):
    return topo._replace(**{f: getattr(topo, f)[rows] for f in topo._fields})


def _jax_ay(pos, src, topo):
    """JAX's A and Y einsums (softbody_tpu/ops/elasticity.py:44-50)."""
    pji = jel.gather(src, topo.idx) - pos[:, None, :]
    return (jnp.einsum("ij,ija,ijb->iab", topo.c, pji, topo.xji),
            jnp.einsum("ij,ija,ijb->iab", topo.vj, pji, topo.nw))


def _ay(ayT):
    """ayT (18, N), row 3b+a -> A, Y (N, 3, 3)."""
    n = ayT.shape[1]
    return [ayT[9 * k:9 * k + 9].reshape(3, 3, n).permute(2, 1, 0).numpy()
            for k in range(2)]


def _jax_forces(F, M, V, rec, vsrc, topo, sep):
    """JAX's pair contraction (softbody_tpu/ops/elasticity.py:84-100) from
    the rows' F, M, V and the source's (V S, R) or G = V M."""
    term_i = jnp.einsum("iab,ib->ia", M, topo.sum_v_nw)
    if sep:
        term_j = jnp.einsum("ijab,ijb->ia", jel.gather(vsrc[:, None, None] * rec[0],
                                                       topo.idx), topo.nw)
    else:
        VSj = jel.gather(vsrc[:, None, None] * rec[0], topo.idx)
        y = jnp.einsum("iab,ijbc,ijc->ija", F, VSj, topo.nw)
        term_j = jnp.einsum("ijab,ijb->ia", jel.gather(rec[1], topo.idx), y)
    return 0.5 * V[:, None] * (term_j + term_i)


def _records(body, scene_t, cfg):
    """The torch plain chain's records of every row: (fmT, srT)."""
    pos = torch.as_tensor(body["pos"])
    ayT = gk.gather_moments_plain(pos, None, scene_t.topology)
    ratio = tel.compute_ratio(torch.as_tensor(body["x"]), cfg)
    return mk.mid_records_plain(ayT, mk.gather_row_static(scene_t.materials,
                                                          scene_t.topology),
                                cfg.stiffness_scale(ratio), cfg.corotated, len(pos))


def _m33(rows9):
    """(9, n) row 3a+b -> (n, 3, 3) numpy."""
    return rows9.T.reshape(-1, 3, 3).numpy()


def _s33(srT):
    return srT[list(SYM6)].T.reshape(-1, 3, 3).numpy()


def _r33(srT):
    return srT[6:15].T.reshape(-1, 3, 3).transpose(1, 2).numpy()


@pytest.mark.parametrize("shard", [False, True])
def test_gather_moments_plain_matches_jax(body, shard):
    """gather_moments and its VJP against JAX's A and Y einsums and
    jax.vjp of them, on one device and on a shard-like source."""
    _, scene_j, scene_t = _scenes(body)
    rows = ROWS if shard else slice(None)
    tj = _jrows(scene_j.topology, rows)
    tt = _shard(scene_t.topology, rows) if shard else scene_t.topology
    pos = torch.as_tensor(body["pos"])
    src = pos if shard else None
    ayT = gk.gather_moments_plain(pos[rows], src, tt)
    jpos = jnp.asarray(body["pos"])
    A_j, Y_j = _jax_ay(jpos[rows], jpos, tj)
    A_t, Y_t = _ay(ayT)
    assert _rel(A_t, A_j) <= OPS_TOL and _rel(Y_t, Y_j) <= OPS_TOL

    dayT = torch.as_tensor(body["dayT"][:, rows]).contiguous()
    dA, dY = _ay(dayT)
    if shard:
        _, vjp = jax.vjp(lambda p, s: _jax_ay(p, s, tj), jpos[rows], jpos)
        dp_j, ds_j = vjp((jnp.asarray(dA), jnp.asarray(dY)))
    else:
        _, vjp = jax.vjp(lambda p: _jax_ay(p, p, tj), jpos)
        (dp_j,) = vjp((jnp.asarray(dA), jnp.asarray(dY)))
    dp_t, ds_t = gk.gather_moments_bwd_plain(pos[rows], src, tt, dayT)
    assert _rel(dp_t, dp_j) <= OPS_TOL
    if shard:
        assert ds_t.shape == pos.shape and _rel(ds_t, ds_j) <= OPS_TOL
    else:
        assert ds_t is None


def test_gather_moments_bwd_plain_matches_jax_deformation(body):
    """The plain moments VJP against jax.vjp of the JAX package's
    ``deformation`` itself (not corotated: F = I + Y^T - rest_corr^T, so
    its A and F carry A and Y), on the same seeded positions and
    cotangents, within 1e-10 of max |JAX|; the forward's A and Y too."""
    cfg, scene_j, scene_t = _scenes(body, corotated=False)
    pos, jpos = torch.as_tensor(body["pos"]), jnp.asarray(body["pos"])
    (A_j, R_j, F_j), vjp = jax.vjp(lambda p: jel.deformation(p, scene_j.topology, cfg),
                                   jpos)
    A_t, Y_t = _ay(gk.gather_moments_plain(pos, None, scene_t.topology))
    Y_j = np.swapaxes(np.asarray(F_j) - np.eye(3), 1, 2) + np.asarray(
        scene_j.topology.rest_corr)
    assert _rel(A_t, A_j) <= 1e-10 and _rel(Y_t, Y_j) <= 1e-10
    dayT = torch.as_tensor(body["dayT"])
    dA, dY = _ay(dayT)
    (dp_j,) = vjp((jnp.asarray(dA), jnp.zeros_like(R_j),
                   jnp.asarray(np.swapaxes(dY, 1, 2))))
    dp_t, ds_t = gk.gather_moments_bwd_plain(pos, None, scene_t.topology, dayT)
    assert ds_t is None and _rel(dp_t, dp_j) <= 1e-10


@pytest.mark.parametrize("pairing,corotated", CASES)
def test_gather_chain_matches_jax_elastic_forces(body, pairing, corotated):
    """gather_moments -> mid_records -> gather_forces (the plain versions,
    ``PLAIN``, and what a CPU tensor runs by default) against JAX's
    elastic_forces, and its VJP wrt (positions, x) against jax.vjp."""
    cfg, scene_j, scene_t = _scenes(body, pairing, corotated)
    jpos, jx = jnp.asarray(body["pos"]), jnp.asarray(body["x"])

    def jfn(p, x):
        return jel.elastic_forces(p, jel.compute_ratio(x, cfg), scene_j.materials,
                                  scene_j.topology, cfg)[0]

    f_j, vjp = jax.vjp(jfn, jpos, jx)
    dp_j, dx_j = vjp(jnp.asarray(body["df"]))
    for ops in (pk.PLAIN, pk.KERNELS):
        p = torch.as_tensor(body["pos"]).requires_grad_()
        x = torch.as_tensor(body["x"]).requires_grad_()
        f, (R, F, S) = tel.elastic_forces(p, tel.compute_ratio(x, cfg), scene_t.materials,
                                          scene_t.topology, cfg, pair_ops=ops)
        dp, dx = torch.autograd.grad(f, (p, x), torch.as_tensor(body["df"]))
        assert _rel(f.detach(), f_j) <= OPS_TOL
        assert _rel(dp, dp_j) <= OPS_TOL and _rel(dx, dx_j) <= OPS_TOL
    _, R_j, F_j = jel.deformation(jpos, scene_j.topology, cfg)
    assert _rel(R.detach(), R_j) <= OPS_TOL and _rel(F.detach(), F_j) <= OPS_TOL
    assert torch.equal(S, S.transpose(1, 2))


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("pairing,corotated", CASES[::2] + [("i", False)])
def test_gather_forces_plain_matches_jax(body, pairing, corotated, shard):
    """gather_forces and its VJP from the records against JAX's pair
    contraction and jax.vjp of it; the VJP's cotangent of the packed record
    folds the full 3x3 V_j S_j into the six S fields times V_j, and R_j's
    into R^T_9, its V field zero.  On a shard-like source the record is
    every particle's, the rows a ragged run of them; on one device it is
    the rows' own."""
    cfg, scene_j, scene_t = _scenes(body, pairing, corotated)
    sep = pairing == "j"
    fmT, srT = _records(body, scene_t, cfg)
    rows = ROWS if shard else slice(None)
    tt = _shard(scene_t.topology, rows) if shard else scene_t.topology
    tj = _jrows(scene_j.topology, rows)
    fm = fmT[:, rows].contiguous()
    rec = gk.packed_record(fmT, srT, sep)
    f_t = gk.gather_forces_plain(fm, rec, tt, sep)

    F, M = jnp.asarray(_m33(fm[:9])), jnp.asarray(_m33(fm[9:18]))
    V, vsrc = jnp.asarray(fm[18].numpy()), jnp.asarray(fmT[18].numpy())
    jrec = ((jnp.asarray(_m33(fmT[9:18])),) if sep
            else (jnp.asarray(_s33(srT)), jnp.asarray(_r33(srT))))
    f_j, vjp = jax.vjp(lambda F, M, *r: _jax_forces(F, M, V, r, vsrc, tj, sep),
                       F, M, *jrec)
    assert _rel(f_t, f_j) <= OPS_TOL

    df = torch.as_tensor(body["df"][rows]).contiguous()
    dF_j, dM_j, *drec_j = vjp(jnp.asarray(df.numpy()))
    dfm, dsrc = gk.gather_forces_bwd_plain(fm, rec, tt, sep, df)
    assert torch.equal(dfm[18], torch.zeros_like(dfm[18]))
    if not sep:
        assert _rel(_m33(dfm[:9]), dF_j) <= OPS_TOL
    assert _rel(_m33(dfm[9:18]), dM_j) <= OPS_TOL
    if sep:       # dM_src = V_j dG_j
        assert dsrc.shape == (len(body["pts"]), 12) and not dsrc[:, 9:].any()
        assert _rel(dsrc[:, :9].numpy().reshape(-1, 3, 3), np.asarray(drec_j[0])) <= OPS_TOL
        return
    dS, dR = np.asarray(drec_j[0]), np.asarray(drec_j[1])      # dS = V_j dVS
    dS6 = np.stack([dS[:, a, b] + (dS[:, b, a] if a != b else 0)
                    for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))], 1)
    dRT9 = np.stack([dR[:, a, c] for c in range(3) for a in range(3)], 1)
    assert dsrc.shape == (len(body["pts"]), 16) and not dsrc[:, 15].any()
    assert _rel(dsrc[:, :15].numpy(), np.concatenate([dS6, dRT9], 1)) <= OPS_TOL


def _streamed_bwd(fmT, rec, topo, sep, df):
    """The forces backward as its two kernels compute it, in plain torch:
    the row pass's dfmT and rowrec, then the source pass walking inv_row /
    inv_nw in CSR order (each entry's term from the reader's rowrec and the
    source row's own record, summed per source row in that order)."""
    n, K = topo.idx.shape
    n_src = rec.shape[0]
    F = fmT[:9].T.reshape(n, 3, 3)
    h = 0.5 * fmT[18][:, None] * df                                  # (n, 3)
    rj = rec[topo.idx]                                               # (n, K, W)
    dfm = torch.zeros_like(fmT)
    if not sep:
        S = rj[..., list(SYM6)].reshape(n, K, 3, 3)
        R = rj[..., list(gk.R9)].reshape(n, K, 3, 3)
        vs = rj[..., 15, None] * torch.einsum("ijbc,ijc->ijb", S, topo.nw)
        dy = torch.einsum("ijac,ia->ijc", R, h)
        dfm[:9] = torch.einsum("ija,ijb->iab", dy, vs).reshape(n, 9).T
    dfm[9:18] = (h[:, :, None] * topo.sum_v_nw[:, None, :]).reshape(n, 9).T
    seg = torch.repeat_interleave(torch.arange(n_src), topo.inv_ptr.diff())
    i, w = topo.inv_row.long(), topo.inv_nw                          # CSR order
    hi, own_r = h[i], rec[seg]
    vr = own_r[:, gk.VOL[sep], None]
    if sep:
        terms = (hi[:, :, None] * w[:, None, :]).reshape(-1, 9)
    else:
        Fi = F[i]
        S = own_r[:, list(SYM6)].reshape(-1, 3, 3)
        R = own_r[:, list(gk.R9)].reshape(-1, 3, 3)
        y = torch.einsum("qab,qb->qa", Fi, vr * torch.einsum("qbc,qc->qb", S, w))
        u = torch.einsum("qab,qa->qb", Fi, torch.einsum("qac,qa->qc", R, hi))
        terms = torch.cat([(hi[:, :, None] * y[:, None, :]).reshape(-1, 9),
                           (u[:, :, None] * w[:, None, :]).reshape(-1, 9)], dim=1)
    acc = torch.segment_reduce(terms, "sum", offsets=topo.inv_ptr, axis=0)
    drec = torch.zeros_like(rec)
    vsrc = rec[:, gk.VOL[sep], None]
    if sep:
        drec[:, :9] = vsrc * acc
        return dfm, drec
    dR, dVS = acc[:, :9].reshape(-1, 3, 3), acc[:, 9:].reshape(-1, 3, 3)
    dS = vsrc[:, :, None] * (dVS + dVS.transpose(1, 2))
    drec[:, :6] = torch.stack([dS[:, a, b] if a != b else dS[:, a, a] / 2
                               for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))],
                              dim=1)
    drec[:, 6:15] = torch.stack([dR[:, a, c] for c in range(3) for a in range(3)], dim=1)
    return dfm, drec


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("pairing", ["i", "j"])
def test_streamed_source_pass_matches_plain(body, pairing, shard):
    """The forces backward's two passes as the kernels compute them, the
    source pass streaming inv_row / inv_nw in CSR order (``_streamed_bwd``),
    against gather_forces_bwd_plain (autograd through the plain forces)
    within 1e-12 of max |plain|: both pairings, on one device and on the
    shard-like source."""
    cfg, _, scene_t = _scenes(body, pairing)
    sep = pairing == "j"
    fmT, srT = _records(body, scene_t, cfg)
    rec = gk.packed_record(fmT, srT, sep)
    rows = ROWS if shard else slice(None)
    tt = _shard(scene_t.topology, rows) if shard else scene_t.topology
    fm = fmT[:, rows].contiguous()
    df = torch.as_tensor(body["df"][rows]).contiguous()
    dfm, drec = _streamed_bwd(fm, rec, tt, sep, df)
    want_dfm, want_drec = gk.gather_forces_bwd_plain(fm, rec, tt, sep, df)
    assert _rel(dfm, want_dfm) <= OPS_TOL
    assert drec.shape == want_drec.shape and _rel(drec, want_drec) <= OPS_TOL


def _streamed_moments_bwd(topo, dayT, merged):
    """The moments backward as its two kernels compute it, in plain torch:
    the row pass's own term -(dA_i sum_c_xji_i + dY_i sum_v_nw_i) from the
    scene's sums, then the source pass walking inv_row / inv_cxw in CSR
    order (each reader's g = dA_i (c X_ji) + dY_i (vj nW_ik), summed per
    source row in that order); ``merged``: the source is the rows, one
    output."""
    dA, dY = (torch.as_tensor(m) for m in _ay(dayT))               # (n, 3, 3)
    drow = -(torch.einsum("iab,ib->ia", dA, topo.sum_c_xji)
             + torch.einsum("iab,ib->ia", dY, topo.sum_v_nw))
    i, p = topo.inv_row.long(), topo.inv_cxw                        # CSR order
    terms = (torch.einsum("qab,qb->qa", dA[i], p[:, :3])
             + torch.einsum("qab,qb->qa", dY[i], p[:, 3:]))
    dsrc = torch.segment_reduce(terms, "sum", offsets=topo.inv_ptr, axis=0)
    return (drow + dsrc, None) if merged else (drow, dsrc)


@pytest.mark.parametrize("shard", [False, True])
def test_streamed_moments_bwd_matches_plain(body, shard):
    """The moments backward's two passes as the kernels compute them
    (``_streamed_moments_bwd``: no per-entry buffer, the rows' term from
    the scene's statics, the source pass streaming inv_row / inv_cxw)
    against gather_moments_bwd_plain within 1e-12 of max |plain|: on one
    device (one merged output) and on the shard-like source (dpos and dsrc
    apart, source rows with no reader among them)."""
    _, _, scene_t = _scenes(body)
    rows = ROWS if shard else slice(None)
    tt = _shard(scene_t.topology, rows) if shard else scene_t.topology
    pos = torch.as_tensor(body["pos"])
    src = pos if shard else None
    dayT = torch.as_tensor(body["dayT"][:, rows]).contiguous()
    got = _streamed_moments_bwd(tt, dayT, not shard)
    want = gk.gather_moments_bwd_plain(pos[rows], src, tt, dayT)
    assert _rel(got[0], want[0]) <= OPS_TOL
    if shard:
        assert bool((tt.inv_ptr.diff() == 0).any())
        assert got[1].shape == want[1].shape == pos.shape
        assert _rel(got[1], want[1]) <= OPS_TOL
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("pairing", ["i", "j"])
def test_mid_records_packed_record_is_srT_and_fmT(body, pairing):
    """The gather path's packed source record from mid_records' plain path
    holds srT's and fmT's fields bit for bit ([S_6 | R^T_9 | V], srT then a
    view of it; [M_9 | V | 0 | 0] beside srT), and the differentiable op
    gives both records' cotangents to mid_records_bwd."""
    cfg, _, scene_t = _scenes(body, pairing)
    sep = pairing == "j"
    pos = torch.as_tensor(body["pos"])
    ayT = gk.gather_moments_plain(pos, None, scene_t.topology)
    rs = mk.gather_row_static(scene_t.materials, scene_t.topology)
    scale = cfg.stiffness_scale(tel.compute_ratio(torch.as_tensor(body["x"]), cfg))
    n = len(pos)
    fmT, srT = mk.mid_records_plain(ayT, rs, scale, True, n)
    fm, sr, rec = mk.mid_records_plain(ayT, rs, scale, True, n, rec=gk.REC_W[sep])
    assert torch.equal(fm, fmT) and torch.equal(sr, srT)
    assert rec.shape == (n, gk.REC_W[sep]) and rec.is_contiguous()
    if sep:
        assert torch.equal(rec[:, :9], fmT[9:18].T) and not rec[:, 10:].any()
    else:
        assert torch.equal(rec[:, :15], srT.T) and sr.data_ptr() == rec.data_ptr()
    assert torch.equal(rec[:, gk.VOL[sep]], fmT[18])
    # the cotangent of the record reaches the mid-section's VJP as srT's and
    # fmT's would
    rng = np.random.default_rng(3)
    cot = torch.as_tensor(rng.normal(size=(n, gk.REC_W[sep])))
    a = ayT.clone().requires_grad_()
    _, _, r = mk.mid_records_all(a, scale, rs, True, n, pk.PLAIN, rec=gk.REC_W[sep])
    (g_rec,) = torch.autograd.grad(r, a, cot)
    b = ayT.clone().requires_grad_()
    f2, s2 = mk.mid_records_all(b, scale, rs, True, n, pk.PLAIN)
    (g_ref,) = torch.autograd.grad((gk.packed_record(f2, s2, sep) * cot).sum(), b)
    assert _rel(g_rec, g_ref) <= OPS_TOL


def test_gather_scene_carries_the_kernels_statics(body):
    """The scene build gives the Topology its lane-major rest correction
    and the prefix sum of its inverse; the plain chain reads them."""
    _, _, scene_t = _scenes(body)
    t = scene_t.topology
    n = t.idx.shape[0]
    assert torch.equal(t.rcT, t.rest_corr.permute(1, 2, 0).reshape(9, n))
    assert t.inv_ptr[0] == 0 and torch.equal(t.inv_ptr.diff(),
                                             torch.bincount(t.idx.reshape(-1), minlength=n))
    assert int(t.inv_ptr[-1]) == t.idx.numel()
    rs = mk.gather_row_static(scene_t.materials, t)
    assert rs.rcT is t.rcT and rs.vol is scene_t.materials.volume


def _streamed_inverse_ok(t, n_src):
    """inv_row, inv_nw and inv_cxw as their definition: the reader row, its
    entry's nw and its products [c X_ji | vj nW_ik] in the scene's dtype,
    in inv_order's CSR order over n_src source rows."""
    K = t.idx.shape[1]
    assert t.inv_row.dtype == torch.int32 and t.inv_row.is_contiguous()
    assert torch.equal(t.inv_row.long(), t.inv_order // K)
    assert t.inv_nw.is_contiguous() and torch.equal(t.inv_nw, t.nw.reshape(-1, 3)[t.inv_order])
    cxw = torch.cat([t.c[..., None] * t.xji, t.vj[..., None] * t.nw], dim=-1)
    assert t.inv_cxw.dtype == t.nw.dtype and t.inv_cxw.is_contiguous()
    assert torch.equal(t.inv_cxw, cxw.reshape(-1, 6)[t.inv_order])
    assert t.inv_ptr.shape == (n_src + 1,) and int(t.inv_ptr[-1]) == t.idx.numel()
    assert torch.equal(t.idx.reshape(-1)[t.inv_order],
                       torch.repeat_interleave(torch.arange(n_src), t.inv_ptr.diff()))


@pytest.mark.parametrize("builder", ["scene", "pad_scene", "shard_scene", "halo_scene"])
def test_every_builder_fills_the_streamed_inverse(body, builder):
    """Every Topology builder gives the backwards' streamed inverse fields
    (inv_row, inv_nw, inv_cxw): build_scene (one device), pad_scene, shard_scene (3 shards of
    a padded scene: ragged runs of rows reading every particle) and
    halo_scene (its local + halo source)."""
    from softbody_tpu_torch.parallel import halo, sharding

    cfg, _, scene_t = _scenes(body)
    n = scene_t.topology.idx.shape[0]
    if builder == "scene":
        return _streamed_inverse_ok(scene_t.topology, n)
    padded, _ = sharding.pad_scene(scene_t, 3, cfg)
    if builder == "pad_scene":
        return _streamed_inverse_ok(padded.topology, padded.topology.idx.shape[0])
    n_pad = padded.topology.idx.shape[0]
    for rank in range(3):
        group = sharding.Group(rank, 3, "cpu", "gloo")
        if builder == "shard_scene":
            loc = sharding.shard_scene(padded, group)
            assert loc.topology.idx.shape[0] == n_pad // 3
            _streamed_inverse_ok(loc.topology, n_pad)
        else:
            plan = halo.build_halo_plan(padded.topology.idx.cpu().numpy(), 3)
            loc = halo.halo_scene(padded, plan, group)
            _streamed_inverse_ok(loc.topology, plan.ext)


@pytest.mark.parametrize("pairing", ["i", "j"])
def test_gather_gradient_calls_each_kernel_once_per_evaluation(body, pairing):
    """An episode gradient of S symplectic steps in 2 chunks through a
    spying PairOps: gather_moments, mid_records and gather_forces 3 S times
    (the no-grad forward, the chunks' recompute and their checkpointed
    steps), their VJPs S times each, nothing else: the counts chip_smoke.py
    gates on the card.  The gradient equals the plain table's bit for
    bit."""
    from softbody_tpu.scenarios import STRETCH
    from softbody_tpu_torch.sim.rollout import episode_value_and_grad_chunked, rollout

    S = 6
    cfg = warp_parity().replace(h=body["h"], dtype="float64", pair_def_grad=pairing,
                                frames=S, target_frames=3, **STRETCH)
    scene = build_scene(body["pts"], cfg, out_num=body["out_num"], device="cpu")
    calls = {}

    def spy(name, fn):
        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return wrapped

    ops = pk.PairOps(*(spy(n, f) for n, f in zip(pk.PairOps._fields, pk.PLAIN)))
    x = torch.as_tensor(body["x"])
    with torch.no_grad():
        _, _, (tp, tv) = rollout(x, scene, cfg, n_steps=S, record_every=2, device="cpu")
    x0 = torch.zeros_like(x)
    got = episode_value_and_grad_chunked(scene, cfg, 2, S, ops)(x0, tp, tv)
    want = {**dict.fromkeys(("gather_moments", "mid_records", "gather_forces"), 3 * S),
            **dict.fromkeys(("gather_moments_bwd", "mid_records_bwd",
                             "gather_forces_bwd"), S)}
    assert calls == want
    ref = episode_value_and_grad_chunked(scene, cfg, 2, S, pk.PLAIN)(x0, tp, tv)
    assert got[0] == ref[0] and torch.equal(got[1], ref[1])
    assert float(got[1].abs().max()) > 0
