"""Is the forward simulation STABLE?  A quiescent body (v0 = 0, no external
force, no collision contact) must stay at rest; any growing displacement is
numerical instability (zero-energy / negative-stiffness SPH modes or CFL
violation), which turns the inverse-design landscape into amplified noise.
The port's copy of ``tools/probe_stability.py``, with the same flags and
output, plus ``--device``.

Usage: python -m softbody_tpu_torch.probe_stability [--particles 20000]
           [--steps 3000] [--dt 1e-6] [--integrator trapezoidal]
           [--damping ...] [--quiet 0/1] [--device cuda|cpu]

``drift_records`` is the probe as a function: ``chip_smoke.py`` runs it on
a cheaper pair mode (the bf16 K2 slab) as the repo's gate for such a mode.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def drift_records(x, scene, sop, cfg, steps: int, record_every: int, device=None):
    """Roll ``x`` out ``steps`` steps and return, per recorded frame, the
    particles' drift with the rigid translation taken out: {step,
    max_disp, rms, max_v_rigid, max_v, y_min} (metres, m/s)."""
    from .sim.rollout import rollout

    with torch.no_grad():
        _, _, rec = rollout(x, scene, cfg, n_steps=steps, record_every=record_every,
                            device=device)
    rest = scene.rest_position.double()
    sl = torch.as_tensor(np.asarray(sop), device=rest.device)
    out = []
    for k in range(rec[0].shape[0]):
        p, v = rec[0][k].double()[sl], rec[1][k].double()[sl]
        d = p - rest[sl]
        d = d - d.mean(dim=0, keepdim=True)          # quiet=0 runs fall uniformly
        vr = v - v.mean(dim=0, keepdim=True)
        out.append({"step": (k + 1) * record_every,
                    "max_disp": float(d.abs().max()),
                    "rms": float(torch.sqrt((d * d).mean())),
                    "max_v_rigid": float(vr.abs().max()),
                    "max_v": float(v.abs().max()),
                    "y_min": float(p[:, 1].min())})
    return out


def main(argv=None):
    from .utils.hostmem import enable_heap_reuse

    enable_heap_reuse()

    from . import build_scene, warp_parity
    from .config import resolve_device
    from .geometry.shapes import suggest_h
    from .scenarios import (add_physics_args, apply_physics_args, dirichlet_mask,
                            drop_gap, fit_body, scale_mass_for_resolution)
    from .sim.sparse import build_sparse_scene

    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=20_000)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--quiet", type=int, default=1,
                    help="1: v0=0, ext=0 (pure stability); 0: warp defaults")
    ap.add_argument("--x", default="zero", choices=["zero", "star"],
                    help="inflation field: zero (ratio 0.5) or radial bands")
    ap.add_argument("--record-every", type=int, default=250)
    add_physics_args(ap)
    ap.add_argument("--f64", action="store_true",
                    help="f64 gather backend: separates discretization "
                         "instability (math) from f32 rounding seeds")
    ap.add_argument("--gather-f32", action="store_true",
                    help="f32 gather backend (centered moments): isolates "
                         "the pair kernels from generic f32")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the CUDA card (the default; raises without one) or "
                         "the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)

    pts, out_num = fit_body(args.particles)
    pts = drop_gap(pts, args.scenario)
    gather = args.f64 or args.gather_f32
    cfg = warp_parity().replace(
        h=suggest_h(pts, 32),
        dtype="float64" if args.f64 else "float32",
        dt=1e-6, integrator="trapezoidal",
        frames=args.steps, target_frames=100,
        backend="gather" if gather else "pallas")
    cfg = apply_physics_args(cfg, args)
    if args.mass is None:
        cfg = scale_mass_for_resolution(cfg, len(pts), args.scenario)
    if args.quiet:
        cfg = cfg.replace(initial_velocity=(0.0, 0.0, 0.0),
                          external_force=(0.0, 0.0, 0.0))
    print(f"cfg: dt={cfg.dt:g} integ={cfg.integrator} damping={cfg.damping:g} "
          f"h={cfg.h:g} mass={cfg.mass:g} E={cfg.youngs_modulus:g} "
          f"scale=({cfg.scale_a:g},{cfg.scale_b:g}) pdg={cfg.pair_def_grad} "
          f"quiet={args.quiet}", flush=True)
    t0 = time.perf_counter()
    mask = dirichlet_mask(pts, args.scenario)
    if gather:
        scene = build_scene(pts, cfg, out_num=out_num, dirichlet_mask=mask,
                            device=device)
        sop = np.arange(len(pts))
        n_slots = len(pts)
    else:
        scene, sop = build_sparse_scene(pts, cfg, out_num=out_num,
                                        dirichlet_mask=mask, device=device)
        n_slots = scene.blocked.n_slots
    print(f"scene: N={len(pts)} slots={n_slots} "
          f"build={time.perf_counter()-t0:.1f}s", flush=True)

    if args.x == "star":
        r = np.linalg.norm(pts - pts.mean(0), axis=1)
        xp = np.sin(r / r.max() * 3.0 * np.pi)
    else:
        xp = np.zeros(len(pts))
    x = np.zeros(n_slots)
    x[sop] = xp

    t0 = time.perf_counter()
    recs = drift_records(x, scene, sop, cfg, args.steps, args.record_every, device)
    print(f"rollout in {time.perf_counter()-t0:.1f}s", flush=True)
    for r in recs:
        print(f"step {r['step']:5d}: max|disp-rigid|={r['max_disp']:.3e} "
              f"rms={r['rms']:.3e} "
              f"max|v-rigid|={r['max_v_rigid']:.3e} "
              f"max|v|={r['max_v']:.3e} "
              f"y_min={r['y_min']:+.4f}", flush=True)


if __name__ == "__main__":
    main()
