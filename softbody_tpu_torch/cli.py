"""Experiment CLI (counterpart of ``softbody_tpu/cli.py``) — mirrors the
reference entry point (sim.py:29-35,440-476):

    python -m softbody_tpu_torch.cli --name pear [--render] [--set_target]
        [--debug] [--init] [--device cuda|cpu]

The JAX CLI's flags, defaults and flows, in the same order: --backend
{pallas,blocked,gather} (gather by default), the procedural sphere
(--procedural N) when no asset directory is given, Adam or L-BFGS,
--resume, explicit asset and model directories.  One flag more:
--device (the CUDA card by default, raising without one; ``cpu`` runs
the kernels' plain PyTorch versions).  --dtype float64 stays on --device:
the kernels have f64 instantiations (the JAX CLI moves f64 runs to the CPU,
since the TPU has no f64 units).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="softbody_tpu_torch")
    # reference flags (sim.py:29-35)
    p.add_argument("--name", "-n", required=True, type=str)
    p.add_argument("--render", "-r", action="store_true", default=False)
    p.add_argument("--set_target", "-t", action="store_true", default=False)
    p.add_argument("--debug", "-d", action="store_true", default=False)
    p.add_argument("--init", "-i", action="store_true", default=False)
    # extensions
    p.add_argument("--backend", choices=["pallas", "blocked", "gather"], default="gather",
                   help="pallas: the sparse scene on the CUDA pair kernels; "
                        "blocked: the blocked varcol scene on its plain torch "
                        "reference (small bodies only); gather: the (N, K) tables")
    p.add_argument("--layout", choices=["sparse"], default="sparse",
                   help="pallas-backend slot layout (sparse candidate groups)")
    p.add_argument("--asset-dir", type=str, default=None,
                   help="dir with {name}/point_cloud_downsampled.ply etc (sim.py:41-45)")
    p.add_argument("--model-dir", type=str, default=None,
                   help="dir with {name}/model_*.pth DeepSDF checkpoints (sim.py:57-60)")
    p.add_argument("--procedural", type=int, default=None,
                   help="use a procedural sphere with ~N particles instead of assets")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--optimizer", choices=["lbfgs", "adam"], default="lbfgs")
    p.add_argument("--maxiter", type=int, default=1000)
    p.add_argument("--warm-start", type=str, default="auto",
                   help="x.npy to warm-start L-BFGS from (+1e-2 noise).  "
                        "'auto' (default, reference parity — sim.py:454 "
                        "unconditionally warm-starts from opt/pear/x.npy + "
                        "noise): use {out}/opt/{name}/x.npy when it exists, "
                        "zeros otherwise; 'none': always zeros")
    p.add_argument("--resume", action="store_true", default=False,
                   help="resume an interrupted optimization from "
                        "opt/{name}/checkpoint (saved every iteration; Adam "
                        "resume is exact incl. moments, L-BFGS restarts from "
                        "the saved iterate with the remaining budget)")
    p.add_argument("--out-dir", type=str, default=".")
    p.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the CUDA card (default; raises without one) or the CPU")
    return p


def load_body(args):
    """Asset body (reference layout) or procedural fallback."""
    from .geometry.shapes import inflatable_sphere

    if args.procedural is not None or args.asset_dir is None:
        n = args.procedural or 20000
        probe, _ = inflatable_sphere(n_outer=1000)
        n_outer = max(int(1000 * n / len(probe)), 8)
        pts, out_num = inflatable_sphere(n_outer=n_outer)
        return {"points": pts, "out_num": out_num, "raw_points": pts,
                "faces": None, "uv": None}
    from .geometry.io import load_reference_body

    return load_reference_body(args.asset_dir, args.name)


def initial_x(args, body, cfg, device):
    """DeepSDF-based x init (sim.py:98-104) when a model dir is given; the
    network runs on ``device``, the result comes back as numpy."""
    n = len(body["points"])
    if args.model_dir is None:
        return np.full(n, -1.0)
    from .models import deepsdf

    model_dir = Path(args.model_dir) / args.name
    idx_file = model_dir / "min_loss_index.npy"
    idx = int(np.load(idx_file)) if idx_file.exists() else 10000  # sim.py:56-59
    params = deepsdf.load_pth(model_dir / f"model_{idx}.pth", device=device)
    return deepsdf.init_x_from_sdf(
        params, body["raw_points"], body["out_num"], set_target=args.set_target
    ).cpu().numpy()


def main(argv=None):
    from .utils.hostmem import enable_heap_reuse

    enable_heap_reuse()
    args = build_parser().parse_args(argv)
    import torch

    from . import warp_parity
    from .config import resolve_device
    from .geometry.shapes import suggest_h
    from .opt import driver
    from .sim.rollout import rollout
    from .sim.scene import build_scene

    device = resolve_device(None if args.device == "cuda" else args.device)
    body = load_body(args)
    pts, out_num = body["points"], body["out_num"]
    cfg = warp_parity().replace(backend="gather", dtype=args.dtype)
    if args.procedural is not None or args.asset_dir is None:
        cfg = cfg.replace(h=suggest_h(pts, 32), dt=1e-6)
    if args.frames is not None:
        cfg = cfg.replace(frames=args.frames)
    if cfg.frames < cfg.target_frames:
        # short episodes (tests/smoke runs): sample every frame
        cfg = cfg.replace(target_frames=cfg.frames)

    if args.backend == "pallas":
        # flagship path: sparse candidate-group layout (topology/sparse.py)
        from .sim.sparse import build_sparse_scene

        cfg = cfg.replace(backend="pallas")
        scene, sop = build_sparse_scene(pts, cfg, out_num=out_num, device=device)
    elif args.backend == "blocked":
        from .sim.blocked import build_blocked_scene

        cfg = cfg.replace(backend=args.backend)
        scene, sop = build_blocked_scene(pts, cfg, out_num=out_num, device=device)
    else:
        scene, sop = build_scene(pts, cfg, out_num=out_num, device=device), None

    out = Path(args.out_dir)
    x0 = initial_x(args, body, cfg, device)
    n_state = scene.rest_position.shape[0]

    def to_state(x_particles):
        if sop is None:
            return x_particles
        xs = np.zeros(n_state)
        xs[sop] = x_particles
        return xs

    target_dir = out / "target" / args.name

    def render_x(x_state, sub):
        """Roll out x and render every 50th frame (visualize loop,
        sim.py:385-395).  Procedural bodies without a mesh fall back to the
        sphere-cloud adapter (sim_taichi.py:300-315)."""
        from .render.adapters import render_episode

        every = 50 if cfg.frames % 50 == 0 else 1
        with torch.no_grad():
            _, _, rec = rollout(x_state, scene, cfg, record_every=every,
                                device=device)
        frames = rec[0].cpu().numpy()
        if sop is not None:
            frames = frames[:, sop]  # slot space -> particle order
        render_episode(frames, out_num, body["faces"], body["uv"],
                       None, out / "render" / f"{args.name}{sub}", every=1)

    x_render = None   # optimized x (state space) for --render, set by opt paths
    if args.set_target:
        driver.generate_targets(to_state(x0), scene, cfg, target_dir,
                                particle_index=sop, device=device)
        print(f"targets written to {target_dir}")
    elif args.init:
        with torch.no_grad():
            _, final, _ = rollout(to_state(x0), scene, cfg, device=device)
        print("forward rollout done; final position mean:",
              final.position.cpu().numpy().mean(0))
    else:
        tp, tv = driver.load_targets(target_dir, cfg.target_frames)
        if sop is not None:
            tp_s = np.tile(scene.rest_position.cpu().numpy(), (len(tp), 1, 1))
            tv_s = np.zeros_like(tp_s) + np.asarray(cfg.initial_velocity)
            tp_s[:, sop], tv_s[:, sop] = tp, tv
            tp, tv = tp_s, tv_s
        opt_dir = out / "opt" / args.name
        x0_state = None  # warm starts land in STATE space (saved x.npy is)
        if args.warm_start == "auto":
            prev = opt_dir / "x.npy"
            if prev.exists():
                x0_state = driver.warm_start_x0(n_state, prev)
        elif args.warm_start not in (None, "none"):
            ws = driver.warm_start_x0(n_state, args.warm_start)
            if np.any(ws):
                x0_state = ws
            else:  # particle-space file: route through to_state below
                x0 = driver.warm_start_x0(len(pts), args.warm_start)
        if args.debug:
            driver.grad_check(scene, cfg, to_state(np.zeros(len(pts))),
                              [1e-3, 1e-7, 1e-6, 1e-5, 1e-4], tp, tv)
            return
        if args.optimizer == "adam":
            x_fin, losses = driver.optimize_adam(
                scene, cfg, to_state(x0), tp, tv,
                resume_dir=opt_dir / "checkpoint", resume=args.resume)
            opt_dir.mkdir(parents=True, exist_ok=True)
            x_render = x_fin.cpu().numpy()
            np.save(opt_dir / "x.npy", x_render)
            print("adam final loss:", losses[-1])
        else:
            # --render during L-BFGS: the reference renders the CURRENT
            # iterate's trajectory after EVERY loss evaluation, overwriting
            # render/{name}_opt (sim.py:385-395)
            # the optimization variable is already STATE-space (x0 passes
            # through to_state below)
            on_eval = ((lambda xo: render_x(xo, "_opt"))
                       if args.render else None)
            x0s = x0_state if x0_state is not None else to_state(x0)
            result, history = driver.optimize_lbfgs(
                scene, cfg, x0s, tp, tv, opt_dir=opt_dir,
                x_target=x0s, maxiter=args.maxiter, on_eval=on_eval,
                resume_dir=opt_dir / "checkpoint", resume=args.resume,
            )
            x_render = np.asarray(result.x)
            print("L-BFGS done:", result.message)

    if args.render:
        # final render: the OPTIMIZED x for the opt paths (x_render is already
        # in state space), the initial x for --init/--set_target
        x_state = x_render
        if x_state is None or args.set_target or args.init:
            x_state = to_state(x0)
        sub = "" if args.set_target else ("_init" if args.init else "_opt")
        render_x(x_state, sub)


if __name__ == "__main__":
    main()
