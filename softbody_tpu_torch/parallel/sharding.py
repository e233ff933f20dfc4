"""Particle sharding over a process group (counterpart of
``softbody_tpu/parallel/sharding.py``).

The JAX package shards particles over a 1-D device mesh axis ``"p"`` and
lets XLA insert the all-gathers inside one jitted episode.  Here the mesh is
a ``torch.distributed`` process group, one rank per device (or several ranks
on one device), and the collectives are explicit:

* :class:`Group` holds a rank's place in the group (rank, world size,
  device, backend) and its collectives: a differentiable all-gather whose
  backward sums the cotangents home in rank order (the JAX VJP's
  ``psum_scatter``; no float atomics, no order that depends on timing), a
  differentiable point-to-point transfer (the ring rounds of the halo
  exchanges, ``dist.batch_isend_irecv``), and a sum over the ranks in rank
  order.  The backend is the caller's choice: ``"nccl"`` by default on
  CUDA, ``"gloo"`` on the CPU (the tests) or where the caller asks for it.
  A collective named in ``host`` copies its tensors through host memory
  for that call (gloo takes some collectives on CPU tensors only); nothing
  switches backend or device by itself.
* :func:`spawn` starts ``world`` ranks from a function of this package and
  returns their results in rank order; the ranks meet through a ``file://``
  store in a temporary directory, so concurrent runs never contend for a
  port.
* :func:`pad_scene`, :func:`pad_targets`, :func:`pad_x` and
  :func:`shard_scene` with JAX's semantics on gather-backend scenes
  (sparse and blocked scenes are refused with a typed error: they shard by
  slot groups, ``parallel/sparse_shard.py``).
* :func:`sharded_rollout` / :func:`sharded_value_and_grad`: the gather
  backend's episode over the group.  Each rank steps its own rows with the
  port's own ``sim.rollout.step`` through its ``elastic_fn`` hook; the
  forces of its rows take two all-gathers per evaluation (positions, then
  the pair records: ``ops/elasticity.elastic_forces``' ``exchange``).  The
  loss is summed over the ranks once per episode, in rank order.
"""

from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist

from ..config import SimConfig
from ..core.types import Materials, Scene, Topology
from ..ops.elasticity import compute_ratio, forces_and_records
from ..ops.gather_kernels import inverse_fields, rest_corr_lanes
from ..ops.pair_kernels import KERNELS
from ..sim.rollout import (_run_steps, _step_fn, _to_scene, acc_init, acc_scalar,
                           initial_state)

COLLECTIVES = ("all_gather", "all_reduce", "reduce_scatter", "batch_isend_irecv")


class Group:
    """A rank of a process group over the particle axis: ``rank``,
    ``world``, its ``device`` and the ``backend`` the group was joined
    with; the collectives named in ``host`` go through host memory.  The
    group must be initialised (:func:`join` or :func:`spawn`)."""

    def __init__(self, rank: int, world: int, device, backend: str, host=()):
        self.rank, self.world = int(rank), int(world)
        self.device = torch.device(device)
        self.backend = backend
        self.host = frozenset(host)
        unknown = self.host - set(COLLECTIVES)
        if unknown:
            raise ValueError(f"no collective named {sorted(unknown)}")

    def _staged(self, name, x):
        """``x`` as the transfer takes it: through host memory when ``name``
        is staged."""
        x = x.contiguous()
        return x.cpu() if name in self.host else x
    def _all_gather_raw(self, x, dim):
        y = self._staged("all_gather", x)
        parts = [torch.empty_like(y) for _ in range(self.world)]
        dist.all_gather(parts, y)
        return torch.cat(parts, dim=dim).to(x.device)

    def all_gather(self, x, dim: int = 0):
        """Every rank's ``x`` joined along ``dim`` in rank order;
        differentiable (the backward sums each rank's slice of every
        rank's cotangent in rank order)."""
        return _AllGather.apply(x, self, dim)

    def p2p(self, x, dst: int, src: int):
        """Send ``x`` to rank ``dst``, receive a tensor of its shape from
        rank ``src``; differentiable (the backward sends the cotangent
        back along the same pair)."""
        return _P2P.apply(x, self, dst, src)

    def _p2p_raw(self, x, dst, src):
        y = self._staged("batch_isend_irecv", x)
        out = torch.empty_like(y)
        ops = [dist.P2POp(dist.isend, y, dst), dist.P2POp(dist.irecv, out, src)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out.to(x.device)

    def sum(self, x):
        """The sum of every rank's tensor ``x`` in rank order, the same on
        every rank (a replicated output, as ``psum``'s): differentiable, each
        rank's cotangent of the sum being its own ``x``'s."""
        return _Sum.apply(x, self)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return group._all_gather_raw(x, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim, n = ctx.group, ctx.dim, ctx.n
        every = group._all_gather_raw(g, 0).chunk(group.world, dim=0)
        mine = [e.narrow(dim, group.rank * n, n) for e in every]
        total = mine[0]
        for p in mine[1:]:
            total = total + p
        return total, None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        parts = group._all_gather_raw(x.reshape(1, *x.shape), 0)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    @staticmethod
    def backward(ctx, g):
        return g, None


class _P2P(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dst, src):
        ctx.group, ctx.dst, ctx.src = group, dst, src
        return group._p2p_raw(x, dst, src)

    @staticmethod
    def backward(ctx, g):
        return ctx.group._p2p_raw(g, ctx.src, ctx.dst), None, None, None


def probe_collectives(group: Group, names=COLLECTIVES) -> dict:
    """Which collectives the group's backend takes on its device's tensors:
    {name: None, or the error it raised} for each of ``names``, run once
    each on a small tensor (every rank must call it).  A caller names the
    failing ones in ``Group.host``.  Some refusals end the process instead
    of raising (gloo aborts on a point-to-point send from CUDA memory), so
    a caller that must survive them probes each name in its own
    :func:`spawn`."""
    w, r = group.world, group.rank
    x = torch.ones(4, device=group.device)

    def p2p():
        y = torch.empty_like(x)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (r + 1) % w),
                                           dist.P2POp(dist.irecv, y, (r - 1) % w)]):
            req.wait()

    runs = {
        "all_gather": lambda: dist.all_gather([torch.empty_like(x) for _ in range(w)], x),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "reduce_scatter": lambda: dist.reduce_scatter(torch.empty_like(x),
                                                      [x.clone() for _ in range(w)]),
        "batch_isend_irecv": p2p,
    }
    out = {}
    for name in names:
        run = runs[name]
        try:
            run()
            if group.device.type == "cuda":
                torch.cuda.synchronize(group.device)
            out[name] = None
        except Exception as e:       # noqa: BLE001 - reported to the caller
            out[name] = f"{type(e).__name__}: {e}".splitlines()[0]
    return out


def default_backend(device) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def join(rank: int, world: int, store: str, device, backend=None, host=()) -> Group:
    """Join the process group through the ``file://`` store at path
    ``store`` and return this rank's :class:`Group`."""
    device = torch.device(device)
    backend = default_backend(device) if backend is None else backend
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=600))
    return Group(rank, world, device, backend, host)


def rank_device(device, rank: int) -> torch.device:
    """The device of ``rank``: ``device`` itself, or for a bare ``"cuda"``
    card ``rank`` modulo the cards there are (every rank on one card when
    there is one)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    return obj


def _rank_main(rank, fn, world, tmp, device, backend, host, args):
    dev = rank_device(device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    group = join(rank, world, os.path.join(tmp, "store"), dev, backend, host)
    try:
        out = fn(group, *args)
        torch.save(_to_cpu(out), os.path.join(tmp, f"result{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, *args, device="cpu", backend=None, host=()):
    """Run ``fn(group, *args)`` in ``world`` new processes, ranks 0..world-1
    of one process group on ``device`` (:func:`rank_device`), and return
    their results (moved to the CPU) in rank order.  ``fn`` must be a
    module-level function the children can import (they import this
    package and what ``fn`` and ``args`` need, nothing else); a rank that
    raises makes this raise."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(fn, world, tmp, device, backend, tuple(host), args),
                 nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(world)]


# ------------------------------------------------------------ gather scenes
def _refuse_slot_scene(scene: Scene, what: str):
    if scene.blocked is not None:
        raise NotImplementedError(
            f"{what} handles gather-backend scenes; blocked/sparse scenes shard by "
            "slot groups: build them with build_sparse_scene(..., n_shards=...) and "
            "run parallel.sparse_shard")


def pad_scene(scene: Scene, multiple: int, cfg: SimConfig):
    """Pad with inert particles so N is a multiple of ``multiple``.

    Pad particles are fully decoupled: no neighbours (mask 0, their table
    rows point at themselves), Dirichlet-frozen (free = 0), zero material
    coupling, parked 1e3 above the ground plane so the collision penalty
    never fires.  Returns (padded_scene, n_original).  Loss parity with the
    unpadded scene needs padded targets: :func:`pad_targets`."""
    _refuse_slot_scene(scene, "pad_scene")
    n = scene.rest_position.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return scene, n
    t = scene.topology
    K = t.idx.shape[1]

    def cat(a, value, tail=()):
        return torch.cat([a, torch.full((pad, *tail), value, dtype=a.dtype,
                                        device=a.device)])

    rest = cat(scene.rest_position, 0.0, (3,))
    rest[n:, 1] = 1e3
    m = scene.materials
    mats = Materials(mass=cat(m.mass, 1.0), volume=cat(m.volume, 1.0), mu=cat(m.mu, 0.0),
                     lam=cat(m.lam, 0.0), free=cat(m.free, 0.0, (3,)),
                     external=cat(m.external, 0.0, (3,)))
    own = torch.arange(n, n + pad, device=t.idx.device)[:, None].expand(pad, K)
    idx = torch.cat([t.idx, own.to(t.idx.dtype)])
    rest_corr = cat(t.rest_corr, 0.0, (3, 3))
    table = dict(idx=idx, mask=cat(t.mask, 0.0, (K,)), w=cat(t.w, 0.0, (K,)),
                 nw=cat(t.nw, 0.0, (K, 3)), xji=cat(t.xji, 0.0, (K, 3)),
                 c=cat(t.c, 0.0, (K,)), vj=cat(t.vj, 0.0, (K,)),
                 sum_c_xji=cat(t.sum_c_xji, 0.0, (3,)), rest_corr=rest_corr,
                 sum_v_nw=cat(t.sum_v_nw, 0.0, (3,)))
    topo = Topology(**table, **inverse_fields(idx, n + pad, table),
                    rcT=rest_corr_lanes(rest_corr))
    return Scene(rest, mats, scene.out_num, obstacles=scene.obstacles,
                 contact=scene.contact, topology=topo), n


def pad_targets(target_p, target_v, padded_scene: Scene, n_orig: int, cfg: SimConfig):
    """Pad target trajectories so padded particles contribute exactly zero
    loss: their target position is their (frozen) rest position, their
    target velocity the initial velocity (free = 0 keeps it)."""
    target_p, target_v = torch.as_tensor(target_p), torch.as_tensor(target_v)
    n_pad = padded_scene.rest_position.shape[0] - n_orig
    if n_pad == 0:
        return target_p, target_v
    rest_pad = padded_scene.rest_position[n_orig:].to(target_p)
    tp_pad = rest_pad.expand(target_p.shape[0], n_pad, 3)
    v0 = torch.tensor(cfg.initial_velocity, dtype=target_v.dtype, device=target_v.device)
    tv_pad = v0.expand(target_v.shape[0], n_pad, 3)
    return torch.cat([target_p, tp_pad], dim=1), torch.cat([target_v, tv_pad], dim=1)


def pad_x(x, padded_scene: Scene, n_orig: int):
    """``x`` with zeros for the padded particles."""
    x = torch.as_tensor(x)
    n_pad = padded_scene.rest_position.shape[0] - n_orig
    if n_pad == 0:
        return x
    return torch.cat([x, x.new_zeros(n_pad)])


def shard_rows(n: int, group: Group) -> slice:
    """This rank's rows of an N-row particle axis (N a multiple of the
    world size: :func:`pad_scene` first)."""
    if n % group.world:
        raise ValueError(f"n_particles={n} not divisible by the group's "
                         f"{group.world} ranks; pad_scene first")
    shard = n // group.world
    return slice(group.rank * shard, (group.rank + 1) * shard)


def shard_scene(scene: Scene, group: Group) -> Scene:
    """This rank's part of a gather-backend scene, on the group's device:
    its rows of every per-particle leaf (the topology's index table keeps
    GLOBAL neighbour ids, read from the all-gathered arrays, with its CSR
    inverse over all N rows); obstacles and contact grids, small per-scene
    constants, whole.  Every ``Scene`` field is handled explicitly; sparse
    and blocked scenes are refused with a typed error."""
    _refuse_slot_scene(scene, "shard_scene")
    n = scene.rest_position.shape[0]
    rows = shard_rows(n, group)
    dev = group.device

    def put(a):
        return a[rows].to(dev)

    t = scene.topology
    fields = {f: put(getattr(t, f)) for f in Topology._fields[:10]}
    topo = Topology(**fields, **inverse_fields(fields["idx"], n, fields),
                    rcT=rest_corr_lanes(fields["rest_corr"]))
    return Scene(
        rest_position=put(scene.rest_position),
        materials=Materials(*(put(a) for a in scene.materials)),
        out_num=scene.out_num,
        obstacles=None if scene.obstacles is None else scene.obstacles.to(dev),
        contact=None if scene.contact is None else scene.contact.to(dev),
        topology=topo,
    )


# ------------------------------------------------------------ the episode
def group_episode(x_loc, scene_loc: Scene, cfg: SimConfig, group: Group, elastic,
                  target_p=None, target_v=None, n_steps=None):
    """An episode of this rank's rows: the port's ``step`` (per-step
    checkpoint under ``cfg.remat``) with ``elastic(pos, ratio)`` as its
    ``elastic_fn``, the sampled loss terms in the rollout's order (the
    Neumaier pair per rank), summed over the ranks once in rank order.
    Returns (loss on every rank, final local state).  Differentiable wrt
    ``x_loc``; every rank must run it, with the same config."""
    n_steps = cfg.frames if n_steps is None else n_steps
    ratio = compute_ratio(x_loc, cfg)
    state = initial_state(scene_loc, ratio, cfg,
                          elastic_fn=lambda p: elastic(p, ratio))
    if target_p is not None:
        target_p, target_v = _to_scene(scene_loc, target_p), _to_scene(scene_loc, target_v)
    state, acc = _run_steps(state, acc_init(scene_loc.dtype, scene_loc.device), ratio,
                            _step_fn(scene_loc, cfg, KERNELS, elastic=elastic), 0, n_steps,
                            target_p, target_v, cfg, n_steps)
    return group.sum(acc_scalar(acc)), state


def _gather_elastic(scene_loc: Scene, cfg: SimConfig, group: Group):
    def elastic(pos, ratio):
        return forces_and_records(pos, ratio, scene_loc.materials, scene_loc.topology,
                                  cfg, exchange=group.all_gather)[0]
    return elastic


def sharded_rollout(x_loc, scene_loc: Scene, cfg: SimConfig, group: Group,
                    target_p=None, target_v=None, n_steps=None):
    """The gather backend's episode over the group: ``scene_loc`` and
    ``x_loc`` / the targets this rank's rows (:func:`shard_scene`, and the
    same rows of the padded arrays).  Returns (loss, final local state)."""
    x_loc = _to_scene(scene_loc, x_loc)
    return group_episode(x_loc, scene_loc, cfg, group,
                         _gather_elastic(scene_loc, cfg, group), target_p, target_v,
                         n_steps)


def sharded_value_and_grad(scene_loc: Scene, cfg: SimConfig, group: Group, n_steps=None):
    """(loss, dloss/dx_loc) over the group, the multi-rank training step of
    the gather backend: ``f(x_loc, target_p_loc, target_v_loc)`` with the
    loss a float, the same on every rank."""
    def f(x_loc, target_p, target_v):
        x = _to_scene(scene_loc, x_loc).detach().requires_grad_()
        with torch.enable_grad():
            loss, _ = sharded_rollout(x, scene_loc, cfg, group, target_p, target_v,
                                      n_steps)
            (g,) = torch.autograd.grad(loss, x)
        return float(loss.detach()), g
    return f


def rank_episode(group: Group, scene: Scene, cfg: SimConfig, x, target_p, target_v,
                 n_steps=None, grad=False):
    """A rank's part of the gather backend's sharded episode, for
    :func:`spawn`: the whole scene (already padded to the world size), x
    and the targets as on one device; returns (loss, this rank's final
    positions) or, with ``grad``, (loss, this rank's dloss/dx)."""
    rows = shard_rows(scene.rest_position.shape[0], group)
    loc = shard_scene(scene, group)
    args = (torch.as_tensor(x)[rows], torch.as_tensor(target_p)[:, rows],
            torch.as_tensor(target_v)[:, rows])
    if grad:
        return sharded_value_and_grad(loc, cfg, group, n_steps)(*args)
    loss, state = sharded_rollout(*args[:1], loc, cfg, group, *args[1:], n_steps)
    return float(loss), state.position
