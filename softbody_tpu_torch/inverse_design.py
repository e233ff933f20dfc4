"""Reference-scale inverse design on one CUDA card (the port of
``examples/inverse_design_100k.py``).

The reference's unit of work is a 3000-step differentiable episode with 100
loss frames inside a scipy L-BFGS-B loop (sim.py:63-65, 341-372, 449-461).
This entry point runs that workload at ~100k particles:

1. build a procedural inflatable body of ~``--particles`` particles;
2. apply a named scenario (``scenarios.py``): "stretch" (clamp the top 15%
   and load the rest, contact-free) or "drop" (the body falls onto the ground
   plane with penalty contact and the Kelvin-Voigt damper);
3. pick a ground-truth inflation field x* (radial bands) and generate the
   target trajectory by rolling x* forward: ``--target-frames`` sampled
   frames of ``--steps`` steps;
4. L-BFGS-B (or, with ``--optimizer adam``, ``--maxiter`` Adam steps at
   ``--lr``) from x0 = 0 (or ``--x0``), writing the reference's artifacts
   (x.npy, losses.json, distances.json: one entry per iteration or step)
   and ``report.json`` under ``--out``, with a resumable checkpoint in
   ``{out}/checkpoint``.

Usage: python -m softbody_tpu_torch.inverse_design [--particles 100000]
           [--steps 3000] [--maxiter 25] [--optimizer lbfgs|adam] [--lr 0.05]
           [--out out/inverse100k_torch] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import datetime
import json
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--target-frames", type=int, default=100)
    ap.add_argument("--maxiter", type=int, default=25)
    ap.add_argument("--x0", default=None,
                    help="warm-start x (slot-space .npy from a prior run's "
                         "artifacts; the reference warm-starts the same way, "
                         "sim.py:454)")
    ap.add_argument("--eval-chunks", type=int, default=8,
                    help="cut each episode's gradient into N chunks: only "
                         "chunk-boundary states are kept between the forward "
                         "and the backward")
    ap.add_argument("--out", default="out/inverse100k_torch")
    ap.add_argument("--scenario", default="stretch", choices=["stretch", "drop"])
    ap.add_argument("--resume", action="store_true", default=False,
                    help="resume an interrupted run from {out}/checkpoint")
    ap.add_argument("--optimizer", default="lbfgs", choices=["lbfgs", "adam"])
    ap.add_argument("--lr", type=float, default=0.05, help="Adam's learning rate")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from . import warp_parity
    from .config import resolve_device
    from .geometry.shapes import suggest_h
    from .opt import driver
    from .scenarios import (SCENARIOS, dirichlet_mask, drop_gap, fit_body,
                            scale_mass_for_resolution, x_star_bands)
    from .sim.rollout import rollout
    from .sim.sparse import build_sparse_scene

    device = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # ---- body + named scenario
    t0 = time.perf_counter()
    pts, out_num = fit_body(args.particles)
    pts = drop_gap(pts, args.scenario)
    n = len(pts)
    cfg = warp_parity().replace(
        h=suggest_h(pts, 32), dtype="float32", frames=args.steps,
        target_frames=args.target_frames, backend="pallas",
        **SCENARIOS[args.scenario])
    cfg = scale_mass_for_resolution(cfg, n, args.scenario)
    scene, sop = build_sparse_scene(
        pts, cfg, out_num=out_num,
        dirichlet_mask=dirichlet_mask(pts, args.scenario), device=device)
    sb = scene.blocked
    print(f"scene: N={n} slots={sb.n_slots} tiles={sb.n_tiles} "
          f"build={time.perf_counter() - t0:.1f}s device={device}", flush=True)

    # ---- ground-truth inflation field and its target trajectory
    x_star = x_star_bands(pts, sb.n_slots, sop)
    interval = max(args.steps // args.target_frames, 1)
    t0 = time.perf_counter()
    with torch.no_grad():
        _, _, (tp, tv) = rollout(x_star, scene, cfg, n_steps=args.steps,
                                 record_every=interval, device=device)
    print(f"targets: {tp.shape[0]} frames of {args.steps} steps in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    np.save(out / "x_star.npy", x_star[sop])

    # ---- L-BFGS-B (sim.py:449-461) or Adam
    x0 = np.zeros(sb.n_slots)
    if args.x0:
        x0 = np.load(args.x0)
        if x0.shape != (sb.n_slots,):
            raise ValueError(f"--x0 has shape {x0.shape}, the scene has "
                             f"{sb.n_slots} slots")
    t0 = time.perf_counter()
    if args.optimizer == "adam":
        _, losses = driver.optimize_adam(
            scene, cfg, x0, tp, tv, steps=args.maxiter, learning_rate=args.lr,
            n_steps=args.steps, resume_dir=out / "checkpoint", resume=args.resume,
            eval_chunks=args.eval_chunks, opt_dir=out, x_target=x_star,
            verbose=True)
        losses = [float(v) for v in losses]
        dists = json.loads((out / "distances.json").read_text())
        iterations = evals = len(losses)
        message = "adam: fixed step budget"
    else:
        result, history = driver.optimize_lbfgs(
            scene, cfg, x0, tp, tv, opt_dir=out, x_target=x_star,
            maxiter=args.maxiter, n_steps=args.steps, eval_chunks=args.eval_chunks,
            resume_dir=out / "checkpoint", resume=args.resume)
        iterations, evals, message = int(result.nit), int(result.nfev), str(result.message)
        losses, dists = history["losses"], history["distances"]
    wall = time.perf_counter() - t0
    print(f"{args.optimizer}: {iterations} iterations / {evals} evals in "
          f"{wall:.0f}s — {message}", flush=True)

    report = {
        "run_id": datetime.datetime.now().isoformat(timespec="seconds"),
        "scenario": args.scenario,
        "optimizer": args.optimizer,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
        "cfg": {"dt": cfg.dt, "youngs_modulus": cfg.youngs_modulus,
                "integrator": cfg.integrator, "damping": cfg.damping,
                "h": cfg.h, "mass": cfg.mass,
                "collision": cfg.collision,
                "collision_stiffness": cfg.collision_stiffness,
                "collision_damping": cfg.collision_damping,
                "initial_velocity": list(cfg.initial_velocity),
                "external_force": list(cfg.external_force)},
        "n_particles": n,
        "steps": args.steps,
        "target_frames": args.target_frames,
        "maxiter": args.maxiter,
        "iterations": iterations,
        "function_evals": evals,
        "wall_seconds": wall,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "distance_first": dists[0] if dists else None,
        "distance_last": dists[-1] if dists else None,
        "message": message,
    }
    (out / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
