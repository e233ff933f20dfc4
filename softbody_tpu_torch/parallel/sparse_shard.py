"""SPMD episode of the sparse (pallas) backend over the process group
(counterpart of ``softbody_tpu/parallel/sparse_shard.py``).

The gather backend shards per-particle rows (``sharding.py``, ``halo.py``);
this module shards the SPARSE slot space (``sim/sparse.py``) over the same
group:

* The scene must be built with ``build_sparse_scene(..., n_shards=world)``:
  ``topology/sparse.py`` then pads every cap's tile list to an n_shards
  multiple and orders tiles SHARD-MAJOR, so each rank owns a contiguous
  run of tiles (slots [r m_loc, (r + 1) m_loc)) with the same bucket shapes.
* Each rank runs the port's whole-scene kernels on its own tiles, K1
  ``moments_v4`` and K2 ``forces_warp_v4`` (or, with the Taichi pairing,
  the separable K2) and their backwards, one launch each per evaluation.
  They read their slab operands from a per-rank SOURCE laid out as
  [the rank's own slots | the other slots it reads | one zero group]:
  the rank's own rows first, so that a kernel's rows are the source's
  first m_loc columns as on one device, and the trailing all-empty group
  of the layout (its values meet exactly-zero pair coefficients) a zero
  group.  The source is either the all-gathered slots of every rank
  rotated so the rank's own come first (two all-gathers per evaluation,
  positions and the K2 record, as in JAX) or, with ``halo=True``, the
  boundary groups the rank reads, sent in ring rounds of point-to-point
  transfers (:class:`HaloPlan`).  Each rank's candidate tables (``gidx8``)
  are remapped into its source on the host; the collectives' backwards
  send the cotangents of the source's remote columns home.
* Per-slot state, the integrator, the mid-section, obstacles and the loss
  terms are local: the port's own ``sim.rollout.step`` runs the rank's
  slots through its ``elastic_fn`` hook.  Dynamic contact bins the
  all-gathered positions and queries the rank's rows against them (the
  layout's exclude table sharded by rows), riding with the elastic forces
  through the hook: both are evaluated at the same positions in either
  integrator, so the step is the single-device step.  The loss is summed
  over the ranks once per episode, in rank order.
* ``cfg.pair_dtype = "bfloat16"`` casts the K2 record before it is
  exchanged (``sparse_shard.py:269`` in JAX), so the exchange moves bf16
  and its backward adds bf16 cotangents, as JAX's ``psum_scatter`` does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SimConfig
from ..core.types import Materials, Scene, SparseBlocked
from ..ops.contact import contact_forces_query
from ..ops.gather_kernels import gather
from ..ops.mid_kernels import mid_records_all, row_static
from ..ops.pair_kernels import KERNELS, PairOps, forces_all, moments_all, sparse_blocked
from ..ops.separable_kernels import forces_sep_all
from ..sim.sparse import pair_slab, term_i_forces
from .sharding import Group, group_episode


def stack_shard_buckets(sb: SparseBlocked):
    """Stack the shard-major bucket list into per-position leaves.

    Returns (stacked, meta): ``stacked`` is a list (one entry per bucket
    position) of dicts of (n_shards, ...) tensors; ``meta`` the static
    (local_tile_start, rows, slab_len) per position."""
    S = sb.n_shards
    if S <= 1:
        raise ValueError("scene was not built with n_shards > 1")
    nb = len(sb.buckets) // S
    stacked, meta = [], []
    start = 0
    for k in range(nb):
        per = [sb.buckets[d * nb + k] for d in range(S)]
        b0 = per[0]
        assert all(b.slab_len == b0.slab_len and b.n_tiles == b0.n_tiles
                   for b in per), "shard bucket signature mismatch"
        stacked.append({
            "gidx8": torch.stack([b.gidx8 for b in per]),
            "restT_rows": torch.stack([b.restT_rows for b in per]),
            "static_slab": torch.stack([b.static_slab for b in per]),
        })
        meta.append((start, b0.rows, b0.slab_len))
        start += b0.n_tiles
    return stacked, meta


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static halo-exchange plan of the sparse SPMD path.

    Replaces the two full all-gathers per force evaluation with ring rounds
    moving only BOUNDARY groups.  Round k (k = 1..S-1): shard s sends shard
    (s + k) % S the rows (8-slot groups) that shard statically needs from
    s.  Per-round send lists are padded to the max over shards; padding
    rows land in the receiver's halo buffer but no remapped table reads
    them.

    send_idx: tuple of (S, L_k) int32 numpy arrays, the LOCAL group rows
    each shard sends in round k.  halo_rows: total received rows sum_k
    L_k; the source is [local gpl rows | halo_rows | 1 zero row], which
    the remapped gidx8 tables index."""

    send_idx: tuple
    halo_rows: int
    n_local_groups: int
    rounds: tuple          # ring offset k of each send_idx entry (empty rounds dropped)
    n_shards: int = 1


def _host(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def build_halo_plan(sb: SparseBlocked):
    """(plan, remapped stacked, meta) from a shard-major layout: the same
    (stacked, meta) as :func:`stack_shard_buckets` but with every shard's
    gidx8 remapped into its [local | halo | zero] source space."""
    S = sb.n_shards
    if S <= 1:
        raise ValueError("scene was not built with n_shards > 1")
    m = sb.n_tiles * sb.rows
    gpl = m // (S * 8)             # groups per shard (shard-major, contiguous)
    empty_gid = m // 8             # the trailing all-empty group (global)
    nb = len(sb.buckets) // S

    needed = []                    # needed[d][s] = sorted gids shard d reads from s
    for d in range(S):
        gids = np.unique(np.concatenate(
            [_host(b.gidx8).ravel() for b in sb.buckets[d * nb:(d + 1) * nb]]))
        gids = gids[gids != empty_gid]
        owner = gids // gpl
        needed.append([gids[owner == s] for s in range(S)])

    send_idx, rounds = [], []
    halo_off = 0
    remap = np.full((S, empty_gid + 1), 0, dtype=np.int64)
    for d in range(S):
        lo = d * gpl
        remap[d, lo:lo + gpl] = np.arange(gpl)
    for k in range(1, S):
        lists = [needed[(s + k) % S][s] for s in range(S)]  # s sends these
        L = max(len(x) for x in lists)
        if L == 0:
            continue
        idx = np.zeros((S, L), dtype=np.int32)
        for s, gl in enumerate(lists):
            idx[s, :len(gl)] = gl - s * gpl                 # local rows at s
            d = (s + k) % S
            remap[d, gl] = gpl + halo_off + np.arange(len(gl))
        send_idx.append(idx)
        rounds.append(k)
        halo_off += L
    zero_row = gpl + halo_off
    for d in range(S):
        remap[d, empty_gid] = zero_row
    plan = HaloPlan(send_idx=tuple(send_idx), halo_rows=halo_off, n_local_groups=gpl,
                    rounds=tuple(rounds), n_shards=S)

    stacked, meta = stack_shard_buckets(sb)
    for k in range(nb):
        g = np.stack([remap[d][_host(sb.buckets[d * nb + k].gidx8)] for d in range(S)])
        stacked[k]["gidx8"] = torch.as_tensor(g.astype(np.int32))
    return plan, stacked, meta


@dataclasses.dataclass
class ShardRun:
    """What one rank runs the SPMD episode with (:func:`shard_sparse`):
    ``scene`` its slots (m_loc rows) with a SparseBlocked of its tiles over
    its source, ``source(aT)`` the source (k, n_src) of a lane-major
    (k, m_loc) array of its slots, ``rows`` its slots of the global slot
    axis, and its share of the contact grid's exclude table."""

    scene: Scene
    source: object
    rows: slice
    m: int
    plan: HaloPlan | None
    contact: object = None
    exclude: torch.Tensor | None = None


def _ring_source(plan: HaloPlan, group: Group):
    r, S = group.rank, plan.n_shards
    sends = [torch.as_tensor(i[r], dtype=torch.int64, device=group.device)
             for i in plan.send_idx]

    def source(aT):
        k, m_loc = aT.shape
        groups = aT.reshape(k, m_loc // 8, 8).permute(1, 0, 2)     # (gpl, k, 8)
        parts = [aT]
        for off, rows in zip(plan.rounds, sends):
            blk = group.p2p(gather(groups, rows), (r + off) % S, (r - off) % S)
            parts.append(blk.permute(1, 0, 2).reshape(k, -1))
        parts.append(aT.new_zeros((k, 8)))
        return torch.cat(parts, dim=1)
    return source


def _gathered_source(group: Group):
    def source(aT):
        k, m_loc = aT.shape
        full = group.all_gather(aT, dim=1)                          # (k, m)
        own = group.rank * m_loc
        return torch.cat([full[:, own:], full[:, :own], aT.new_zeros((k, 8))], dim=1)
    return source


def shard_sparse(scene: Scene, group: Group, halo: bool = False) -> ShardRun:
    """This rank's part of a shard-major sparse scene (``build_sparse_scene(
    ..., n_shards=group.world)``, on any device) on the group's device: its
    slots, its tiles' buckets with gidx8 remapped into its source (the
    rotated all-gather, or with ``halo`` the :func:`build_halo_plan`
    source), their schedules and the CSR inverse over the source."""
    sb: SparseBlocked = scene.blocked
    S, r, dev = sb.n_shards, group.rank, group.device
    if S != group.world:
        raise ValueError(f"the scene has {S} shards, the group {group.world} ranks")
    if sb.group != 8:
        raise ValueError("SPMD sparse scenes take slot groups of 8")
    m = sb.n_tiles * sb.rows
    m_loc, gpl, nb = m // S, m // (S * 8), len(sb.buckets) // S
    real = np.zeros(sb.n_slots, bool)
    real[_host(scene.slot_of_particle)] = True
    real_g = real[:m].reshape(S * gpl, 8)
    if halo:
        plan, stacked, _ = build_halo_plan(sb)
        gidx = [_host(stacked[k]["gidx8"][r]) for k in range(nb)]
        src_gid = [r * gpl + np.arange(gpl)]
        for off, idx in zip(plan.rounds, plan.send_idx):
            s = (r - off) % S
            src_gid.append(s * gpl + idx[s].astype(np.int64))
        live = np.concatenate([real_g[np.concatenate(src_gid)],
                               np.zeros((1, 8), bool)])
        source = _ring_source(plan, group)
    else:
        plan = None
        n = S * gpl
        gidx = []
        for b in sb.buckets[r * nb:(r + 1) * nb]:
            g = _host(b.gidx8).astype(np.int64)
            gidx.append(np.where(g < n, (g - r * gpl) % n, n).astype(np.int32))
        live = np.concatenate([np.roll(real_g, -r * gpl, axis=0), np.zeros((1, 8), bool)])
        source = _gathered_source(group)
    t0 = sb.buckets[r * nb].tile_start
    parts = [(g, _host(b.restT_rows), _host(b.static_slab), b.tile_start - t0)
             for g, b in zip(gidx, sb.buckets[r * nb:(r + 1) * nb])]
    rows = slice(r * m_loc, (r + 1) * m_loc)
    dtype = scene.rest_position.dtype
    lsb = sparse_blocked(parts, _host(sb.rs6T)[:, rows], live.size, 8, live.ravel(), dev,
                         dtype, sb.rows)
    mats = Materials(*(a[rows].to(dev) for a in scene.materials))
    lscene = Scene(rest_position=scene.rest_position[rows].to(dev), materials=mats,
                   out_num=scene.out_num, blocked=lsb,
                   rest_corr=scene.rest_corr[:, :, rows].to(dev),
                   obstacles=None if scene.obstacles is None else scene.obstacles.to(dev))
    contact, excl = scene.contact, None
    if contact is not None:
        contact = contact.to(dev)
        if contact.exclude is not None:
            excl = contact.exclude[rows]
            contact = dataclasses.replace(contact, exclude=None)
    return ShardRun(lscene, source, rows, m, plan, contact, excl)


def _elastic_local(pos_loc, ratio_loc, run: ShardRun, cfg: SimConfig, group: Group,
                   pair_ops: PairOps):
    """The rank's (m_loc, 3) elastic forces (plus its contact forces): the
    sparse path's dataflow (``sim/sparse.elastic_forces_sparse``) on the
    rank's tiles, its slab operands read from the exchanged source."""
    lscene = run.scene
    sb = lscene.blocked
    m_loc = pos_loc.shape[0]
    posT = pos_loc.T.contiguous()
    ayT = moments_all(run.source(posT), posT, sb, cfg.h, pair_ops)   # (18, m_loc)
    fmT, srT = mid_records_all(ayT, cfg.stiffness_scale(ratio_loc[:m_loc]),
                               row_static(sb, lscene.materials, lscene.rest_corr),
                               cfg.corotated, m_loc, pair_ops)
    if cfg.pair_def_grad == "j":
        gT = fmT[18] * fmT[9:18]                                        # G = V M
        f = forces_sep_all(run.source(gT), fmT[18], sb, cfg.h, pair_ops).T
    else:
        termjT = forces_all(fmT[:9], run.source(pair_slab(srT, cfg)), sb, cfg.h,
                            pair_ops)                                   # (3, m_loc)
        f = term_i_forces(fmT, termjT, sb.rs6T).T
    if run.contact is not None:
        pos_all = group.all_gather(pos_loc, 0)
        f = f + contact_forces_query(pos_all, pos_loc, run.rows.start, run.contact,
                                     exclude_q=run.exclude)
    return f


def _local(a, run: ShardRun, device, dtype, dim=0):
    a = torch.as_tensor(a).to(device=device, dtype=dtype)
    return a.narrow(dim, run.rows.start, run.rows.stop - run.rows.start)


def _episode(x_loc, run: ShardRun, cfg: SimConfig, target_p, target_v, group: Group,
             n_steps, pair_ops: PairOps):
    def elastic(pos, ratio):
        return _elastic_local(pos, ratio, run, cfg, group, pair_ops)

    return group_episode(x_loc, run.scene, cfg, group, elastic, target_p, target_v,
                         n_steps)


def sparse_sharded_episode(x, scene: Scene, cfg: SimConfig, target_p, target_v,
                           group: Group, n_steps=None, halo=False, run=None,
                           pair_ops: PairOps = KERNELS):
    """The sharded episode, run by every rank of ``group``.  Returns (loss,
    (final_pos, final_vel)) with the state in GLOBAL slot order (m, 3) on
    every rank.  ``x`` / the targets in global slot space ((n_slots,) /
    (T, n_slots, 3), as on one device; the trailing empty group is left
    out here).  ``halo=True``: exchange only the boundary groups in ring
    rounds instead of all-gathering the sources.  ``run``: a
    :func:`shard_sparse` of the scene, to build it once."""
    run = shard_sparse(scene, group, halo) if run is None else run
    dev, dt = run.scene.device, run.scene.dtype
    loss, state = _episode(_local(x, run, dev, dt), run, cfg,
                           _local(target_p, run, dev, dt, 1),
                           _local(target_v, run, dev, dt, 1), group, n_steps, pair_ops)
    return loss, (group.all_gather(state.position, 0), group.all_gather(state.velocity, 0))


def sparse_sharded_value_and_grad(scene: Scene, cfg: SimConfig, group: Group,
                                  n_steps=None, halo=False, run=None,
                                  pair_ops: PairOps = KERNELS):
    """(loss, dloss/dx) over the sharded episode, the multi-rank training
    step of the flagship backend: ``f(x, target_p, target_v)`` in global
    slot space, the loss a float and the gradient (n_slots,) the same on
    every rank (the trailing empty group's exactly zero)."""
    run = shard_sparse(scene, group, halo) if run is None else run
    dev, dt = run.scene.device, run.scene.dtype
    n_slots = scene.blocked.n_slots

    def f(x, target_p, target_v):
        x_loc = _local(x, run, dev, dt).detach().requires_grad_()
        with torch.enable_grad():
            loss, _ = _episode(x_loc, run, cfg, _local(target_p, run, dev, dt, 1),
                               _local(target_v, run, dev, dt, 1), group, n_steps, pair_ops)
            (g_loc,) = torch.autograd.grad(loss, x_loc)
        g = torch.zeros(n_slots, dtype=dt, device=dev)
        g[:run.m] = group.all_gather(g_loc, 0)
        return float(loss.detach()), g
    return f


def rank_sparse(group: Group, scene: Scene, cfg: SimConfig, x, target_p, target_v,
                n_steps=None, halo=False, grad=False):
    """A rank's part of the sparse SPMD episode, for ``sharding.spawn``
    (the scene on any device; it is sharded onto the group's): (loss,
    final positions, final velocities) in global slot order, or with
    ``grad`` (loss, dloss/dx (n_slots,))."""
    run = shard_sparse(scene, group, halo)
    if grad:
        return sparse_sharded_value_and_grad(scene, cfg, group, n_steps, halo, run)(
            x, target_p, target_v)
    loss, (pos, vel) = sparse_sharded_episode(x, scene, cfg, target_p, target_v, group,
                                              n_steps, halo, run)
    return float(loss.detach()), pos, vel
