"""Device time per evaluation of the sparse path's K1 (``moments_v4``) and
K2 (``forces_warp_v4``) forward kernels and their backwards
(``moments_v4_bwd``, ``forces_warp_v4_bwd_rows`` and ``_slab``) at the
~112k stretch scene on one CUDA card, and the steps they sit in, for this
checkout or another one (``--tree``), so that two versions can be compared
on one card in one sitting:

    python softbody_tpu_torch/pair_times.py --tree /path/to/other/checkout

Run it for each version in turns (A, B, B, A).  The scene and the
operands are those of ``chip_smoke.py`` phase 3 (``fit_body(100000)``,
STRETCH, f32, a stretched and jittered body, the plain path's F, S, R),
and seeded random cotangents for the backwards.  A kernel whose wrapper
takes one bucket is timed as its 8 launches back to back (and, as
``chip_smoke.py`` summed them, launch by launch); one whose wrapper takes
the whole scene as its one launch.  CUDA events around
``--reps`` evaluations queued behind a sleep kernel, warm.  Prints one JSON
line: the tree, the card (``nvidia-smi`` name and power limit), the ms per
evaluation and the launches per evaluation of each kernel, and for the
default path and the Taichi pairing (``j_``) one forward step's wall ms
(fastest of 5 rounds of 5) and one gradient step's (a 10-step
``episode_value_and_grad_chunked``, fastest of 3), each with the device's
busy ms and activities per step (``torch.profiler`` over 10 steps, as
``chip_smoke.py`` phases 8 and 11 take them), and each kernel's SASS
instructions per pair in f32 (``cuobjdump -sass`` of the built library: the
innermost loop around the pair's one ``MUFU.RSQ``, its instructions over
its ``MUFU`` count).  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def busy(torch, fn, per):
    """(device busy ms, device activities) per ``per`` units of ``fn``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in on_card) / 1e3 / per,
            len(on_card) / per)


def step_numbers(torch, scene, cfg, ratio, x, dev):
    """Forward and gradient step: wall ms, device busy ms, activities."""
    from softbody_tpu_torch.sim.rollout import (episode_value_and_grad_chunked,
                                                initial_state, rollout, step)

    state = initial_state(scene, ratio, cfg)
    out = {"fwd_step_ms": min(host_ms(torch, lambda: step(state, ratio, scene, cfg), 5)
                              for _ in range(5))}

    def ten():
        st = state
        for _ in range(10):
            st = step(st, ratio, scene, cfg)

    out["fwd_busy_ms"], out["fwd_activities"] = busy(torch, ten, 10)
    cfg_g = cfg.replace(frames=30, target_frames=10)
    with torch.no_grad():
        _, _, (tp, tv) = rollout(x, scene, cfg_g, n_steps=30, record_every=3,
                                 device=dev)
    x0 = torch.zeros_like(x)
    short = episode_value_and_grad_chunked(scene, cfg_g, 1, 10)
    grad = lambda: short(x0, tp[:3], tv[:3])
    out["grad_step_ms"] = min(host_ms(torch, grad, 1) for _ in range(3)) / 10
    out["grad_busy_ms"], out["grad_activities"] = busy(torch, grad, 10)
    return out


def sass_per_pair(lib_path, names):
    """{name: SASS instructions per pair of the f32 kernel ``name``}: the
    shortest backward-branch loop holding a MUFU, its length over its MUFU
    count (one rsqrt per pair)."""
    import re

    from softbody_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    out = {}
    for fn in text.split("Function : ")[1:]:
        name = next((n for n in names if f"{len(n) + 7}{n}_kernelIf" in fn.split()[0]),
                    None)
        if name is None:
            continue
        ins = [(int(a, 16), op) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
        loops = []
        for a, op in ins:
            tgt = re.search(r"BRA\s.*?0x([0-9a-f]+)", op)
            if tgt and int(tgt.group(1), 16) < a:
                body = [o for x, o in ins if int(tgt.group(1), 16) <= x <= a]
                mufu = sum("MUFU" in o for o in body)
                if mufu:
                    loops.append((len(body), mufu))
        if loops:
            n, mufu = min(loops)
            out[name] = n / mufu
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent),
                    help="root of the checkout whose softbody_tpu_torch is timed")
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("pair_times.py needs a CUDA card")
    from softbody_tpu_torch import warp_parity
    from softbody_tpu_torch.geometry.shapes import suggest_h
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.scenarios import STRETCH, dirichlet_mask, fit_body, x_star_bands
    from softbody_tpu_torch.sim.blocked import mid_section
    from softbody_tpu_torch.sim.sparse import build_sparse_scene

    assert Path(pk.__file__).resolve().is_relative_to(Path(args.tree).resolve())
    dev = torch.device("cuda", torch.cuda.current_device())
    pts, out_num = fit_body(args.particles)
    cfg = warp_parity().replace(h=suggest_h(pts, 32), dtype="float32",
                                backend="pallas", **STRETCH)
    scene, sop = build_sparse_scene(pts, cfg, out_num=out_num,
                                    dirichlet_mask=dirichlet_mask(pts, "stretch"),
                                    device=dev)
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    rng = np.random.default_rng(0)
    pos_np = scene.rest_position.cpu().numpy().astype(np.float64)
    body = pos_np[sop] + 0.05 * cfg.h * rng.normal(size=(len(sop), 3))
    body[:, 1] = body[:, 1].mean() + 1.05 * (body[:, 1] - body[:, 1].mean())
    pos_np[sop] = body
    posT = torch.as_tensor(pos_np.T.copy(), dtype=torch.float32, device=dev)
    x_star = torch.as_tensor(x_star_bands(pts, sb.n_slots, sop), dtype=torch.float32,
                             device=dev)
    ratio = compute_ratio(x_star, cfg)
    ayT = pk.moments_all(posT, posT[:, :m], sb, cfg.h, pk.PLAIN)
    A = [[ayT[3 * b + a] for b in range(3)] for a in range(3)]
    Y = [[ayT[9 + 3 * b + a] for b in range(3)] for a in range(3)]
    R, F, S, _, _ = mid_section(A, Y, ratio, scene.materials, scene, cfg, m)
    f9T = torch.stack([F[c][d] for c in range(3) for d in range(3)])
    srT = torch.zeros((15, sb.n_slots), dtype=torch.float32, device=dev)
    srT[:, :m] = torch.stack([S[0][0], S[0][1], S[0][2], S[1][1], S[1][2], S[2][2]]
                             + [R[a][c] for c in range(3) for a in range(3)])
    h = cfg.h
    dayT = torch.as_tensor(rng.normal(size=(18, m)), dtype=torch.float32, device=dev)
    dfT = torch.as_tensor(rng.normal(size=(3, m)), dtype=torch.float32, device=dev)

    def cols(b):
        return slice(b.row_start, b.row_start + b.n_tiles * sb.rows)

    per_bucket = {      # the per-bucket wrappers of a version that has them
        "moments_v4": lambda b: pk.moments_v4(
            b.restT_rows, b.static_slab, posT, posT[:, cols(b)], sb.rs6T[:, cols(b)],
            b.gidx8, h),
        "forces_warp_v4": lambda b: pk.forces_warp_v4(
            b.restT_rows, b.static_slab, f9T[:, cols(b)], srT, b.gidx8, h),
        "moments_v4_bwd": lambda b: pk.moments_v4_bwd(
            b.restT_rows, b.static_slab, dayT[:, cols(b)], sb.rs6T[:, cols(b)], h),
        "forces_warp_v4_bwd_rows": lambda b: pk.forces_warp_v4_bwd_rows(
            b.restT_rows, b.static_slab, f9T[:, cols(b)], srT, b.gidx8,
            dfT[:, cols(b)], h),
        "forces_warp_v4_bwd_slab": lambda b: pk.forces_warp_v4_bwd_slab(
            b.restT_rows, b.static_slab, f9T[:, cols(b)], srT, b.gidx8,
            dfT[:, cols(b)], h),
    }
    whole = {}
    if hasattr(sb, "schedule"):             # forward: one launch per evaluation
        whole["moments_v4"] = lambda: pk.moments_v4(sb, posT, posT[:, :m], h)
        whole["forces_warp_v4"] = lambda: pk.forces_warp_v4(sb, f9T, srT, h)
    if hasattr(sb, "chunks"):               # backward: one launch per evaluation
        whole["moments_v4_bwd"] = lambda: pk.moments_v4_bwd(sb, dayT, h)
        whole["forces_warp_v4_bwd_rows"] = lambda: pk.forces_warp_v4_bwd_rows(
            sb, f9T, srT, dfT, h)
        whole["forces_warp_v4_bwd_slab"] = lambda: pk.forces_warp_v4_bwd_slab(
            sb, f9T, srT, dfT, h)
    evals, per_launch = {}, {}
    for key, launch in per_bucket.items():
        if key in whole:
            evals[key] = whole[key]
        else:                               # one launch per bucket
            fns = [lambda b=b, launch=launch: launch(b) for b in sb.buckets]
            evals[key] = lambda fns=fns: [f() for f in fns]
            per_launch[key] = fns
    out = {"tree": str(Path(args.tree).resolve()),
           "card": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True).stdout.strip().splitlines()[0],
           "buckets": [[b.slab_len, b.n_tiles] for b in sb.buckets]}
    for key, fn in evals.items():
        pk.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        out[f"{key}_launches"] = pk.launch_counts()[key]
        out[f"{key}_ms"] = cuda_ms(torch, fn, args.reps)
        if key in per_launch:
            out[f"{key}_sum_of_launches_ms"] = sum(
                cuda_ms(torch, f, args.reps) for f in per_launch[key])
    from softbody_tpu_torch.ops import _build
    out["sass_per_pair"] = sass_per_pair(_build.library_path("pair_kernels"),
                                         tuple(per_bucket))
    out.update(step_numbers(torch, scene, cfg, ratio, x_star, dev))
    out.update({f"j_{k}": v for k, v in step_numbers(
        torch, scene, cfg.replace(pair_def_grad="j"), ratio, x_star, dev).items()})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
