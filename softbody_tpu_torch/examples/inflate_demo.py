"""End-to-end inverse-design demo: recover a hidden inflation field (the
port of ``examples/inflate_demo.py``).

Workflow (the reference's full loop, sim.py:440-476):
  1. build a procedural inflatable body (outer shell + filling): a blocked
     varcol scene on ``--backend pallas`` (its CUDA kernels: the raw K1, K2
     v2 and their backwards) or ``blocked`` (its plain torch reference), or a
     gather scene;
  2. simulate an episode with a hidden inflation field x* -> target frames;
  3. optimize x from zero so the episode matches the targets (Adam, then a
     scipy L-BFGS-B polish — both drivers exercised);
  4. write artifacts: recovered x, loss curve, PBRT scene files of the first /
     final frames, and a recovery report.

Run:  python -m softbody_tpu_torch.examples.inflate_demo --particles 3000
          --frames 200 --out /tmp/demo [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=3000)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--adam-steps", type=int, default=60)
    ap.add_argument("--lbfgs-iters", type=int, default=5)
    ap.add_argument("--backend", default="pallas",
                    choices=["pallas", "blocked", "gather"])
    ap.add_argument("--out", type=str, default="demo_out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    return ap.parse_args(argv)


def build(args, device):
    """(pts, out_num, mask, cfg, scene, slot_of_particle or None): the
    demo's body, its Dirichlet mask (the top clamped) and its scene on the
    chosen backend."""
    from .. import warp_parity
    from ..geometry.shapes import inflatable_sphere, suggest_h

    probe, _ = inflatable_sphere(n_outer=500)
    n_outer = max(int(500 * args.particles / len(probe)), 16)
    pts, out_num = inflatable_sphere(n_outer=n_outer, radius=0.05)
    # clamp the top so the falling body deforms (gradients need strain)
    mask = np.ones((len(pts), 3))
    mask[pts[:, 1] > np.percentile(pts[:, 1], 88)] = 0.0
    # dt: the inflation field drives the stiffness scale up to ~200x, so the
    # stable explicit step is ~sqrt(200) below the unit-scale CFL limit
    cfg = warp_parity().replace(
        h=suggest_h(pts, 16), dt=5e-7, frames=args.frames,
        target_frames=min(10, args.frames), backend=args.backend,
        dtype="float32",
    )
    if args.backend in ("pallas", "blocked"):
        from ..sim.blocked import build_blocked_scene

        scene, sop = build_blocked_scene(pts, cfg, out_num=out_num,
                                         dirichlet_mask=mask, device=device)
    else:
        from ..sim.scene import build_scene

        scene, sop = build_scene(pts, cfg, out_num=out_num, dirichlet_mask=mask,
                                 device=device), None
    return pts, out_num, mask, cfg, scene, sop


def hidden_field(pts):
    """x*: a blob inflated on one side of the body (smooth, in [-1.5, 1.5])."""
    return 1.5 * np.tanh(3.0 * (pts[:, 0] - pts[:, 0].mean()) / pts[:, 0].std())


def main(argv=None) -> dict:
    from ..utils.hostmem import enable_heap_reuse

    enable_heap_reuse()
    args = parse_args(argv)
    import torch

    from ..config import resolve_device
    from ..opt import driver
    from ..render.adapters import sphere_cloud_scene
    from ..sim.rollout import rollout

    device = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # ---- scene -------------------------------------------------------------
    pts, out_num, _, cfg, scene, sop = build(args, device)
    n_state = scene.rest_position.shape[0]

    def to_state(xp):
        if sop is None:
            return np.asarray(xp)
        xs = np.zeros(n_state)
        xs[sop] = xp
        return xs

    # ---- hidden field + targets --------------------------------------------
    x_true = hidden_field(pts)
    t0 = time.time()
    tp, tv = driver.generate_targets(to_state(x_true), scene, cfg,
                                     out / "target", particle_index=sop,
                                     device=device)
    print(f"targets generated in {time.time() - t0:.1f}s "
          f"({len(pts)} particles x {args.frames} steps)")
    tp_s, tv_s = tp, tv
    if sop is not None:
        tp_s = np.tile(scene.rest_position.cpu().numpy(), (len(tp), 1, 1))
        tv_s = np.zeros_like(tp_s) + np.asarray(cfg.initial_velocity)
        tp_s[:, sop], tv_s[:, sop] = tp, tv

    # ---- optimize -----------------------------------------------------------
    t0 = time.time()
    x_adam, losses = driver.optimize_adam(
        scene, cfg, to_state(np.zeros(len(pts))), tp_s, tv_s,
        steps=args.adam_steps, learning_rate=0.2,
    )
    print(f"adam: {losses[0]:.3e} -> {losses[-1]:.3e} in {time.time() - t0:.1f}s")

    t0 = time.time()
    result, history = driver.optimize_lbfgs(
        scene, cfg, x_adam.cpu().numpy().astype(np.float64), tp_s, tv_s,
        opt_dir=out / "opt", x_target=to_state(x_true),
        maxiter=args.lbfgs_iters, verbose=False,
    )
    if history["losses"]:
        print(f"lbfgs polish: {history['losses'][0]:.3e} -> {history['losses'][-1]:.3e} "
              f"in {time.time() - t0:.1f}s")
    else:
        print(f"lbfgs polish: converged immediately ({result.message})")

    # ---- report + render artifacts ------------------------------------------
    x_rec = np.asarray(result.x)
    x_rec_p = x_rec[sop] if sop is not None else x_rec
    ratio_err = float(np.linalg.norm(
        (0.5 * np.tanh(3 * x_rec_p) + 0.5) - (0.5 * np.tanh(3 * x_true) + 0.5)
    ) / np.sqrt(len(pts)))
    print(f"inflation-ratio RMS recovery error: {ratio_err:.4f}")

    with torch.no_grad():
        _, _, rec = rollout(x_rec, scene, cfg, record_every=max(args.frames // 4, 1),
                            device=device)
    frames_p = rec[0].cpu().numpy()
    if sop is not None:
        frames_p = frames_p[:, sop]
    for tag, frame in (("first", frames_p[0]), ("final", frames_p[-1])):
        sc = sphere_cloud_scene(frame, str(out / f"{tag}.png"), radius=0.0015,
                                eye=(0.0, 0.1, 0.4), look_at=(0, 0.05, 0),
                                area_light=False, workdir=out / f".pbrt_{tag}")
        sc.write(out / f"scene_{tag}.pbrt")
    report = {"ratio_rms_error": ratio_err,
              "adam_loss": [float(losses[0]), float(losses[-1])],
              "lbfgs_loss": [float(v) for v in
                             (history["losses"][:1] + history["losses"][-1:])]}
    (out / "report.json").write_text(json.dumps(report, indent=1))
    print(f"artifacts in {out}: report.json, opt/, target/, scene_first/final.pbrt")
    return report


if __name__ == "__main__":
    main()
