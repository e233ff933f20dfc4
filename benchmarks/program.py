"""Driving the program under test, ``softbody_tpu_torch``, through its own
entry points: the scene builders, ``episode_value_and_grad_chunked``,
``forward_chunked`` and ``rollout`` (for targets)."""

from __future__ import annotations

import time

import numpy as np
import torch

from . import inputs


def sim_config(cell, h: float):
    """The program's ``SimConfig`` of a cell: the configuration's ``sim``
    fields, its h, and the traffic's episode length, loss and frames."""
    from softbody_tpu_torch.config import SimConfig

    sim = {k: tuple(v) if isinstance(v, list) else v for k, v in cell.config["sim"].items()}
    targets = cell.traffic.get("targets") or {}
    return SimConfig(**sim).replace(
        h=h, frames=cell.steps(), target_frames=int(targets.get("frames", 1)),
        loss_mode=cell.traffic.get("loss_mode", "sampled"))


def build_scene(layout: str, pts, n_outer, cfg, mask, device):
    """(scene, slot of each particle (device int64)) on the configuration's
    layout."""
    if layout == "sparse":
        from softbody_tpu_torch.sim.sparse import build_sparse_scene
        scene, sop = build_sparse_scene(pts, cfg, out_num=n_outer, dirichlet_mask=mask,
                                        device=device)
    elif layout in ("varcol", "cells"):
        from softbody_tpu_torch.sim.blocked import build_blocked_scene
        scene, sop = build_blocked_scene(pts, cfg, out_num=n_outer, dirichlet_mask=mask,
                                         layout=layout, device=device)
    elif layout == "gather":
        from softbody_tpu_torch.sim.scene import build_scene as build
        scene, sop = build(pts, cfg, out_num=n_outer, dirichlet_mask=mask,
                           device=device), np.arange(len(pts))
    else:
        raise ValueError(f"unknown layout {layout!r}")
    return scene, torch.as_tensor(np.asarray(sop), dtype=torch.long, device=device)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """One cell's program: its scene, targets and the unit of work the
    window repeats (one gradient evaluation or one forward episode)."""

    def __init__(self, cell, pts, n_outer, h, mask, device):
        self.cell = cell
        self.device = torch.device(device)
        self.cfg = sim_config(cell, h)
        self.steps = cell.steps()
        t0 = time.perf_counter()
        self.scene, self.sop = build_scene(cell.config["layout"], pts, n_outer, self.cfg,
                                           mask, self.device)
        sync(self.device)
        self.scene_build_s = time.perf_counter() - t0
        self.dtype = self.scene.rest_position.dtype
        self.n_slots = self.scene.rest_position.shape[0]
        self.pts = pts
        self.entry = cell.traffic["entry"]
        if self.entry == "value_and_grad":
            self.tp, self.tv = self.targets()

    def to_slots(self, x_particles):
        x = torch.zeros(self.n_slots, dtype=self.dtype, device=self.device)
        x[self.sop] = x_particles.to(self.dtype)
        return x

    def targets(self):
        """(tp, tv) (frames, n_slots, 3) of the traffic's targets.  Empty
        slots get their rest position and the initial velocity: they never
        move, so they add nothing to the loss."""
        spec = self.cell.traffic["targets"]
        rest = self.scene.rest_position
        v0 = torch.tensor(self.cfg.initial_velocity, dtype=self.dtype, device=self.device)
        if spec["kind"] == "inflate":
            c = self.pts.mean(0)
            tp = rest.clone()
            tp[self.sop] = torch.as_tensor(c + spec["factor"] * (self.pts - c),
                                           dtype=self.dtype, device=self.device)
            return tp[None], v0.expand(1, self.n_slots, 3).contiguous()
        if spec["kind"] == "rollout":
            from softbody_tpu_torch.sim.rollout import rollout

            x_star = self.to_slots(torch.as_tensor(inputs.target_field(self.pts, spec),
                                                  device=self.device))
            with torch.no_grad():
                _, _, (tp, tv) = rollout(x_star, self.scene, self.cfg, n_steps=self.steps,
                                         record_every=self.steps // spec["frames"],
                                         device=self.device)
            return tp, tv
        raise ValueError(f"unknown targets {spec['kind']!r}")

    def run(self, x_particles):
        """One unit on x (particles): (loss, grad (particles)) or the final
        (position, velocity) (particles)."""
        from softbody_tpu_torch.sim.rollout import (episode_value_and_grad_chunked,
                                                    forward_chunked)

        x = self.to_slots(x_particles)
        t = self.cell.traffic
        if self.entry == "value_and_grad":
            loss, grad = episode_value_and_grad_chunked(
                self.scene, self.cfg, int(t["chunks"]), n_steps=self.steps)(x, self.tp, self.tv)
            return float(loss), grad[self.sop]
        final, _ = forward_chunked(x, self.scene, self.cfg, self.steps, int(t["chunk_len"]))
        return final.position[self.sop], final.velocity[self.sop]

    def warm_up(self, x_particles):
        """One whole unit: every kernel built or loaded, every shape and
        every allocation of the window's units made once (a shorter warm-up
        left path B's first evaluation in a window ~0.35 s slower)."""
        self.run(x_particles)
        sync(self.device)

