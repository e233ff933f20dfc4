"""A 1M-particle inflation episode on one card with a reference-length
rollout, a gradient step and PBRT frame export (the port of
``examples/million_particles.py``).

Runs the sparse-scene kernel path (``build_sparse_scene``, K1/K2 v4 and
their backwards) end to end at ~1M particles (procedural inflatable sphere,
the "stretch" scenario):

1. the full reference-length episode (3000 steps, sim.py:63-64) as
   ``forward_chunked`` in chunks of ``--chunk-steps``, recording frames every
   ``--render-every`` steps;
2. PBRT scene export of the recorded frames (sphere-cloud surface, the
   Taichi visualize path, sim_taichi.py:300-315); rendered to PNG + mp4 when
   pbrt-v4/ffmpeg are installed, scene files otherwise;
3. ONE gradient: the episode loss's (value, dloss/dx) against an
   analytically inflated target (the Taichi set_target pattern,
   sim_taichi.py:290-294), ``episode_value_and_grad_chunked`` in
   ``--grad-chunks`` chunks with ``loss_mode="final"``.

``report.json`` has the JAX example's keys.  ``compile_seconds`` and
``grad_compile_seconds`` are 0: nothing is traced or compiled per shape here.
The CUDA kernels are built (or loaded from ``_build/``) by a one-step
warm-up before the timed episode, which is printed and not timed.

Usage: python -m softbody_tpu_torch.examples.million_particles
           [--particles 1000000] [--steps 3000] [--grad-steps 3000]
           [--render-every 500] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--grad-steps", type=int, default=3000,
                    help="episode length for the gradient step (0 = skip)")
    ap.add_argument("--render-every", type=int, default=500,
                    help="record + export a frame every N steps (0 = final only)")
    ap.add_argument("--render-particles", type=int, default=200_000,
                    help="surface particles per exported scene")
    ap.add_argument("--chunk-steps", type=int, default=250,
                    help="forward steps per chunk of forward_chunked")
    ap.add_argument("--grad-chunks", type=int, default=40,
                    help="chunks of the gradient's episode (only the chunk "
                         "boundary states are kept between forward and backward)")
    ap.add_argument("--out", default="out/million_torch")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    return ap.parse_args(argv)


def run(args):
    """The example's work.  Returns (report, scene, cfg, x): the report as
    ``main`` writes it, and the scene, config and inflation field the
    episode ran on."""
    import torch

    from .. import warp_parity
    from ..config import resolve_device
    from ..geometry.shapes import suggest_h
    from ..render.adapters import sphere_cloud_scene
    from ..render.video import export_mp4
    from ..scenarios import STRETCH, dirichlet_mask, fit_body
    from ..sim.rollout import episode_value_and_grad_chunked, forward_chunked
    from ..sim.sparse import build_sparse_scene
    from ..utils.profiling import sync_point

    device = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    report = {"run_id": datetime.datetime.now().isoformat(timespec="seconds"),
              "scenario": "stretch"}

    # ---- body + flagship stretch scenario (scenarios.py)
    t0 = time.perf_counter()
    pts, out_num = fit_body(args.particles)
    n = len(pts)
    print(f"body: N={n} ({out_num} outer) gen={time.perf_counter()-t0:.1f}s",
          flush=True)

    cfg = warp_parity().replace(h=suggest_h(pts, 32), dtype="float32",
                                frames=args.steps, target_frames=2,
                                backend="pallas", **STRETCH)
    t0 = time.perf_counter()
    scene, sop = build_sparse_scene(
        pts, cfg, out_num=out_num,
        dirichlet_mask=dirichlet_mask(pts, "stretch"), device=device)
    sync_point(device)
    build_s = time.perf_counter() - t0
    sb = scene.blocked
    pairs = sum(b.n_tiles * b.slab_len * sb.rows for b in sb.buckets)
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else str(device))
    print(f"scene: slots={sb.n_slots} tiles={sb.n_tiles} "
          f"pairs/step={pairs:.3e} build={build_s:.1f}s "
          f"device={dev_name}", flush=True)
    report.update(n_particles=n, steps=args.steps, build_seconds=build_s,
                  pairs_per_step=pairs)

    # uniform mid-inflation field (ratio ~ 0.73 at x = 0.5)
    x = torch.zeros(sb.n_slots, dtype=torch.float32, device=device)
    x[torch.as_tensor(sop, device=device)] = 0.5

    # ---- full-length forward episode in chunks, frames recorded at chunk
    # boundaries
    chunk = max(1, min(args.chunk_steps, args.steps))
    rec_every = args.render_every or args.steps
    if args.steps % rec_every or rec_every % chunk:
        rec_every = args.steps  # record_every must divide steps, chunk | rec
        chunk = min(chunk, rec_every)

    t0 = time.perf_counter()
    forward_chunked(x, scene, cfg, 1, 1)     # builds / loads the kernels
    sync_point(device)
    print(f"warm-up (kernel build or load + one step): "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    final, recorded = forward_chunked(x, scene, cfg, args.steps, chunk,
                                      record_every=rec_every)
    sync_point(device)
    wall = time.perf_counter() - t0
    thr = n * args.steps / wall
    print(f"episode: {args.steps} steps in {wall:.2f}s -> "
          f"{thr:.3e} particle-steps/s", flush=True)
    report.update(compile_seconds=0.0, wall_seconds=wall,
                  particle_steps_per_sec=thr, chunk_steps=chunk)

    # ---- artifacts: recorded frames -> npy + PBRT scenes (render if pbrt)
    frames_dir = out / "frames"
    frames_dir.mkdir(exist_ok=True)
    rec_pos = np.stack([p.cpu().numpy() for p in recorded])  # (n_frames, slots, 3)
    sop_np = np.asarray(sop)[:min(out_num, args.render_particles)]
    rendered = 0
    for i, frame in enumerate(rec_pos):
        pos = frame[sop_np]
        np.save(frames_dir / f"positions_{i:04d}.npy", pos.astype(np.float32))
        png = str(frames_dir / f"frame_{i:04d}.png")
        sc = sphere_cloud_scene(pos, png, workdir=frames_dir / f".pbrt_{i:04d}")
        sc.render()  # writes scene.pbrt; renders when pbrt-v4 is installed
        rendered += os.path.exists(png)
    np.save(out / "final_positions.npy",
            rec_pos[-1][np.asarray(sop)].astype(np.float32))
    video = None
    if rendered == len(rec_pos) and rendered > 1:
        video = str(out / "episode.mp4")
        if not export_mp4(str(frames_dir), video, 10, "frame_", ".png"):
            video = None  # ffmpeg missing — PNG frames remain
    print(f"frames: {len(rec_pos)} exported, {rendered} rendered"
          + (f", video={video}" if video else " (pbrt-v4 not installed: "
             "scene.pbrt files written for offline rendering)"), flush=True)
    report.update(frames_exported=len(rec_pos), frames_rendered=rendered,
                  video=video)

    # ---- one gradient at scale
    if args.grad_steps:
        gcfg = cfg.replace(loss_mode="final")
        center = pts.mean(0)
        tp = torch.zeros((1, sb.n_slots, 3), dtype=torch.float32, device=device)
        tp[0, torch.as_tensor(sop, device=device)] = torch.as_tensor(
            center + 1.2 * (pts - center), dtype=torch.float32, device=device)
        tv = torch.zeros_like(tp)
        vg = episode_value_and_grad_chunked(scene, gcfg, args.grad_chunks,
                                            n_steps=args.grad_steps)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        loss, grad = vg(x, tp, tv)
        sync_point(device)
        grad_wall = time.perf_counter() - t0
        gthr = n * args.grad_steps / grad_wall
        gnorm = float(torch.linalg.norm(grad))
        peak = (f", peak device memory "
                f"{torch.cuda.max_memory_allocated(device) / 2**30:.3f} GiB"
                if device.type == "cuda" else "")
        print(f"grad step: {args.grad_steps}-step fwd+bwd in {grad_wall:.1f}s "
              f"-> {gthr:.3e} p-steps/s, loss={float(loss):.6e} "
              f"|grad|={gnorm:.3e}{peak}", flush=True)
        report.update(grad_steps=args.grad_steps, grad_wall_seconds=grad_wall,
                      grad_compile_seconds=0.0,
                      grad_particle_steps_per_sec=gthr,
                      grad_loss=float(loss), grad_norm=gnorm)
    return report, scene, cfg, x


def main(argv=None) -> dict:
    from ..utils.hostmem import enable_heap_reuse

    enable_heap_reuse()
    args = parse_args(argv)
    report, *_ = run(args)
    (Path(args.out) / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
