"""``dryrun_multichip``: the multi-device dry run of the JAX package's
``__graft_entry__.dryrun_multichip`` on the port: the full training step
(an episode's value and gradient, the unit of work L-BFGS consumes) over ``n_devices`` ranks on tiny shapes, once on the gather
backend's particle shards and, with two ranks or more, once on the sparse
SPMD path (all-gather and halo sources)."""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from ..ops.pair_kernels import launch_counts, reset_launch_counts
from .sharding import (pad_scene, pad_targets, pad_x, shard_rows, shard_scene,
                       sharded_value_and_grad, spawn)
from .sparse_shard import sparse_sharded_value_and_grad


def _tiny_problem(device):
    from .. import build_scene, warp_parity
    from ..geometry.shapes import inflatable_sphere, suggest_h

    pts, out_num = inflatable_sphere(n_outer=64, radius=0.05)
    cfg = warp_parity().replace(h=suggest_h(pts, 16), dtype="float32", dt=1e-6,
                                target_frames=2)
    scene = build_scene(pts, cfg, out_num=out_num, device=device)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=len(pts)) * 0.3)
    tp = torch.as_tensor(np.stack([pts * 1.1, pts * 1.2]))
    return cfg, scene, x, tp, torch.zeros_like(tp)


def _rank(group):
    from .. import warp_parity
    from ..geometry.shapes import inflatable_sphere, suggest_h
    from ..sim.sparse import build_sparse_scene

    out = {}
    cfg, scene, x, tp, tv = _tiny_problem(group.device)
    padded, n0 = pad_scene(scene, group.world, cfg)
    tp_p, tv_p = pad_targets(tp, tv, padded, n0, cfg)
    rows = shard_rows(padded.rest_position.shape[0], group)
    reset_launch_counts()
    loss, grad = sharded_value_and_grad(shard_scene(padded, group), cfg, group, 8)(
        pad_x(x, padded, n0)[rows], tp_p[:, rows], tv_p[:, rows])
    out["launches"] = launch_counts()
    assert np.isfinite(loss), "multichip dryrun produced non-finite loss"
    assert bool(torch.isfinite(grad).all()), "multichip dryrun produced non-finite grad"
    out["gather"] = (loss, grad)
    if group.world < 2:
        return out          # the SPMD path needs a real mesh

    pts, out_num = inflatable_sphere(n_outer=64, radius=0.05)
    cfg = warp_parity().replace(h=suggest_h(pts, 16), dtype="float32", dt=1e-6,
                                target_frames=2, backend="pallas")
    scene, sop = build_sparse_scene(pts, cfg, out_num=out_num, n_shards=group.world,
                                    device=group.device)
    ns = scene.blocked.n_slots
    x = np.zeros(ns, np.float32)
    x[sop] = np.random.default_rng(0).normal(size=len(pts)) * 0.3
    base = scene.rest_position.cpu().numpy()
    tp = np.stack([base, base])
    for halo in (False, True):
        loss, grad = sparse_sharded_value_and_grad(scene, cfg, group, 4, halo)(
            x, tp, np.zeros_like(tp))
        what = "halo" if halo else "sparse"
        assert np.isfinite(loss), f"{what} SPMD dryrun: non-finite loss"
        assert bool(torch.isfinite(grad).all()), f"{what} SPMD dryrun: non-finite grad"
        out[what] = (loss, grad)
    np.testing.assert_allclose(out["halo"][1].cpu().numpy(), out["sparse"][1].cpu().numpy(),
                               rtol=1e-4, atol=1e-7)
    return out


def dryrun_multichip(n_devices: int, device="cuda", backend=None, host=()) -> list:
    """One training step over ``n_devices`` spawned ranks on ``device``
    (``"cuda"``: rank r on card r modulo the cards there are; ``"cpu"``)
    joined with ``backend`` (``sharding.default_backend`` when None;
    ``host``: the collectives staged through host memory): finite loss and
    gradient on the gather backend and, with two ranks or more, on the
    sparse SPMD path, whose halo gradient matches its all-gather one
    (rtol 1e-4, atol 1e-7, f32).  Returns each rank's {path: (loss,
    gradient)} and under "launches" the rank's kernel launch counts of its
    gather step (``pair_kernels.launch_counts``; all zero on the CPU)."""
    if torch.device(device).type == "cuda":
        resolve_device(None)                 # raises without a card
    return spawn(_rank, n_devices, device=device, backend=backend, host=host)
