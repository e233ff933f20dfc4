"""Explicit halo exchange over the process group (counterpart of
``softbody_tpu/parallel/halo.py``).

The all-gathers of ``sharding.py`` move every particle to every rank.
Static rest topology means each shard's remote neighbour rows (its "halo")
are known before the episode, so the plan is built on the host:

* particles are spatially sorted (``topology/sort.morton_sort``) before
  partitioning so that halos come from nearby shards;
* for each hop distance k (1..hops) every rank sends exactly the rows its
  k-th ring neighbour needs, in two point-to-point rounds (from rank d + k
  and from rank d - k, as the JAX ``ppermute`` rotations, wrapping);
* neighbour indices are remapped into the local + halo address space, so
  the per-shard physics is a dense local gather.

:func:`build_halo_plan` gives JAX's tables bit for bit.  :func:`exchange`
builds the (ext, F) local + halo block: each round's send buffer is a
fixed-order ``ops.gather_kernels.gather`` of the rank's rows and the transfer
is ``Group.p2p``, so the backward sends the cotangents back along the ring
and sums them into the rows in a fixed order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SimConfig
from ..core.types import Scene
from ..ops.elasticity import forces_and_records
from ..ops.gather_kernels import gather, inverse_fields
from .sharding import Group, group_episode, shard_rows, shard_scene


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static halo-exchange plan.

    send_idx:  (D, 2*hops, H) local row indices each device contributes to
               the ring buffer headed for its (hop, direction) neighbour.
    local_idx: (D, shard, K) neighbour table remapped into the local + halo
               address space: [0, shard) local rows, then hop/direction
               halo blocks of H rows each."""

    send_idx: np.ndarray
    local_idx: np.ndarray
    n_devices: int
    shard: int
    halo: int          # H: padded rows per (hop, direction) block
    hops: int

    @property
    def ext(self) -> int:
        return self.shard + 2 * self.hops * self.halo


def build_halo_plan(idx: np.ndarray, n_devices: int) -> HaloPlan:
    """Build the plan from a global (N, K) neighbour table (N % D == 0)."""
    idx = np.asarray(idx)
    n, K = idx.shape
    assert n % n_devices == 0, "pad the scene first"
    shard = n // n_devices
    owner = idx // shard                                 # (N, K) owner device

    # required remote rows per (device, signed hop)
    needed = {}
    max_hop = 0
    for d in range(n_devices):
        rows = idx[d * shard:(d + 1) * shard]
        own = owner[d * shard:(d + 1) * shard]
        for e in np.unique(own):
            if e == d:
                continue
            hop = int(e - d)
            max_hop = max(max_hop, abs(hop))
            needed[(d, hop)] = np.unique(rows[own == e])
    hops = max(max_hop, 1)
    halo = max((len(v) for v in needed.values()), default=1)
    halo = ((halo + 7) // 8) * 8

    send_idx = np.zeros((n_devices, 2 * hops, halo), dtype=np.int64)
    recv_rows = {}
    for d in range(n_devices):
        for b in range(2 * hops):
            # block b: hop k = b//2 + 1; even b receives from device d+k, odd b
            # from device d-k.  Hops do not wrap (owners are raw device
            # indices); out-of-range sources leave padding the receiver never
            # references and a zero send table on the (wrapped) sender.
            k = b // 2 + 1
            src = d + k if b % 2 == 0 else d - k
            if 0 <= src < n_devices:
                rows = needed.get((d, src - d), np.zeros(0, dtype=np.int64))
                pad = np.full(halo, src * shard, dtype=np.int64)  # benign dup row
                pad[: len(rows)] = rows
                recv_rows[(d, b)] = pad
                send_idx[src, b] = pad - src * shard
            else:
                recv_rows[(d, b)] = np.zeros(0, dtype=np.int64)

    # remap global idx -> local + halo addresses per device: the first
    # occurrence over the concatenated receive blocks, one searchsorted
    local_idx = np.zeros((n_devices, shard, K), dtype=np.int64)
    for d in range(n_devices):
        keys, vals = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
        for b in range(2 * hops):
            g = recv_rows[(d, b)]
            keys.append(np.asarray(g, np.int64))
            vals.append(shard + b * halo + np.arange(len(g), dtype=np.int64))
        keys = np.concatenate(keys)
        vals = np.concatenate(vals)
        uk, first = np.unique(keys, return_index=True)
        uv = vals[first]
        rows = idx[d * shard:(d + 1) * shard]
        own = owner[d * shard:(d + 1) * shard]
        pos = np.clip(np.searchsorted(uk, rows), 0, max(len(uk) - 1, 0))
        mapped = uv[pos] if len(uk) else np.zeros_like(rows)
        local_idx[d] = np.where(own == d, rows - d * shard, mapped)

    return HaloPlan(send_idx=send_idx.astype(np.int32),
                    local_idx=local_idx.astype(np.int32), n_devices=n_devices,
                    shard=shard, halo=halo, hops=hops)


def exchange(local, plan: HaloPlan, group: Group):
    """(shard, F) rows of this rank -> (ext, F) local + halo: per (hop,
    direction) block every rank sends the rows its ring neighbour needs,
    one point-to-point round each (even blocks from rank d + k, odd ones
    from d - k, wrapping as the JAX ``ppermute`` does).  Differentiable."""
    d, D = group.rank, plan.n_devices
    if group.world != D:
        raise ValueError(f"the plan is for {D} ranks, the group has {group.world}")
    parts = [local]
    for b in range(2 * plan.hops):
        k = b // 2 + 1
        rows = torch.as_tensor(plan.send_idx[d, b], dtype=torch.int64,
                               device=local.device)
        buf = gather(local, rows)                          # (H, F)
        if b % 2 == 0:                                     # from d+k to d
            dst, src = (d - k) % D, (d + k) % D
        else:                                              # from d-k to d
            dst, src = (d + k) % D, (d - k) % D
        parts.append(group.p2p(buf, dst, src))
    return torch.cat(parts, dim=0)


def halo_gather(values_loc, plan: HaloPlan, group: Group, fn):
    """``fn(ext, local_idx)`` on this rank's (ext, F) local + halo block of
    ``values_loc`` (its (shard, F) rows) and its remapped (shard, K)
    neighbour table; returns what ``fn`` returns."""
    ext = exchange(values_loc, plan, group)
    return fn(ext, torch.as_tensor(plan.local_idx[group.rank], dtype=torch.int64,
                                   device=values_loc.device))


def halo_scene(scene: Scene, plan: HaloPlan, group: Group) -> Scene:
    """This rank's part of a gather-backend scene with its topology's index
    table remapped into the local + halo space of ``plan`` (and the CSR
    inverse over the ext rows)."""
    loc = shard_scene(scene, group)
    idx = torch.as_tensor(plan.local_idx[group.rank], dtype=torch.int64,
                          device=group.device)
    return loc._replace(topology=loc.topology._replace(
        idx=idx, **inverse_fields(idx, plan.ext, loc.topology._asdict())))


def elastic_forces_halo(pos_loc, ratio_loc, scene_loc: Scene, plan: HaloPlan,
                        group: Group, cfg: SimConfig):
    """This rank's (shard, 3) elastic forces with explicit halo exchanges:
    the gather physics (``ops/elasticity.forces_and_records``, its kernels
    on the card) with two exchanges per evaluation, positions before the
    moments and the pair records ([S_6 | R^T_9 | V], or [M_9 | V] in the
    Taichi pairing) before the forces.
    ``scene_loc`` from :func:`halo_scene`.  Numerically the dense path's."""
    return forces_and_records(pos_loc, ratio_loc, scene_loc.materials,
                              scene_loc.topology, cfg,
                              exchange=lambda a: exchange(a, plan, group))[0]


def halo_rollout(x_loc, scene_loc: Scene, plan: HaloPlan, group: Group, cfg: SimConfig,
                 target_p=None, target_v=None, n_steps=None):
    """Episode whose elastic forces run through the halo exchange: the
    integrator, loss and accumulator are ``sim.rollout``'s own ``step`` and
    loop, only the force evaluation is swapped through the ``elastic_fn``
    hook, so the step's semantics cannot drift between the dense and the
    SPMD paths.  ``x_loc`` and the targets are this rank's rows.  Returns
    (loss summed over the ranks, final local state)."""
    def elastic(pos, ratio):
        return elastic_forces_halo(pos, ratio, scene_loc, plan, group, cfg)

    x_loc = torch.as_tensor(x_loc).to(device=scene_loc.device, dtype=scene_loc.dtype)
    return group_episode(x_loc, scene_loc, cfg, group, elastic, target_p, target_v,
                         n_steps)


def shard_of(a, n: int, group: Group, dim: int = 0):
    """This rank's rows of a particle-axis array ``a`` (axis ``dim`` of
    length n)."""
    return torch.as_tensor(a).narrow(dim, shard_rows(n, group).start, n // group.world)



def rank_halo(group: Group, scene: Scene, cfg: SimConfig, x, target_p=None,
              target_v=None, n_steps=None, pos=None):
    """A rank's part of the halo path, for ``sharding.spawn``: the whole
    gather scene (N a multiple of the world size) and x, targets as on one
    device.  With ``pos`` (N, 3): this rank's :func:`elastic_forces_halo`
    at ``pos``; else (loss, this rank's final positions) of
    :func:`halo_rollout`.  Also returns the plan's (hops, halo)."""
    n = scene.rest_position.shape[0]
    plan = build_halo_plan(scene.topology.idx.cpu().numpy(), group.world)
    loc = halo_scene(scene, plan, group)
    dev, dt = loc.device, loc.dtype

    def mine(a, dim=0):
        return shard_of(a, n, group, dim).to(device=dev, dtype=dt)

    if pos is not None:
        from ..ops.elasticity import compute_ratio

        f = elastic_forces_halo(mine(pos), compute_ratio(mine(x), cfg), loc, plan, group,
                                cfg)
        return f, (plan.hops, plan.halo)
    tp = None if target_p is None else mine(target_p, 1)
    tv = None if target_v is None else mine(target_v, 1)
    loss, state = halo_rollout(mine(x), loc, plan, group, cfg, tp, tv, n_steps)
    return (float(loss), state.position), (plan.hops, plan.halo)
