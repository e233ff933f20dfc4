#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (softbody_tpu_torch) runs on the GPU.

Drives the port's main path on one CUDA card at full width — the ~112k
particle "stretch" inverse-design scene (fit_body(100000), STRETCH physics,
top-15% Dirichlet clamp, f32) — and holds every hand-written kernel on that
path against its plain PyTorch version.  Phases, each printed as it runs:

  1  the card (nvidia-smi name and power limit)
  2  kernel build (nvcc, from csrc/ in this checkout)
  3  per bucket: K1 moments_v4 and K2 forces_warp_v4, kernel vs plain on the
     card (max error relative to max |plain| <= 1e-4), ms per launch,
     the work's bound
  4  one elastic_forces_sparse call, kernel path vs plain path (<= 1e-4)
  5  the forward episode: generate_targets (x*, 3000 steps, 100 frames) and
     the sampled loss of x = 0 against those targets; ms/step and
     particle-steps/s; a per-part breakdown of one step
  6  kernel-path vs plain-path rollout over 300 steps:
     max |dpos| <= 1e-3 max |pos - rest|
  7  quiet body: no load, x = 0, 3000 steps, rms drift from rest < 1e-6 m
  8  the launch counts of phase 5 against the launches the path implies

Then one JSON line with every kernel's numbers, the card line, and the last
line ``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before that line; without a CUDA device it exits 1 at once.  Imports nothing
of JAX.

Usage: python3 chip_smoke.py   (needs one CUDA card; builds the kernels)
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

TOL = 1e-4                 # f32, another summation order over <= 1024 entries
STEPS = 3000
FRAMES = 100
TIME_BUDGET_S = 400.0      # cut the episodes' steps if phases 5-7 would exceed it
PEAK_FP32 = 67e12          # H100 SXM FP32 without tensor cores (data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
FLOPS_PER_PAIR = {"moments_v4": 78, "forces_warp_v4": 75}  # as the kernels do them
SLEEP_CYCLES = 200_000_000  # ~0.1 s of card time, longer than any timed batch's enqueue


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device ms per call of ``fn`` (CUDA events, warm).  A sleep kernel
    queued first keeps the card busy while the host enqueues all ``reps``
    calls, so the events time the device work back to back, not the host's
    launch overhead."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps):
    """Mean wall ms per call, ending in a synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def rel_err(a, b):
    import torch

    return float(torch.max(torch.abs(a - b)) / torch.max(torch.abs(b)))


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    import numpy as np

    from softbody_tpu_torch import warp_parity
    from softbody_tpu_torch.geometry.shapes import suggest_h
    from softbody_tpu_torch.ops import _build
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.opt.driver import generate_targets, load_targets
    from softbody_tpu_torch.scenarios import (STRETCH, dirichlet_mask, fit_body,
                                              x_star_bands)
    from softbody_tpu_torch.sim.blocked import mid_section
    from softbody_tpu_torch.sim.rollout import acc_float, rollout, step, initial_state
    from softbody_tpu_torch.sim.sparse import build_sparse_scene, elastic_forces_sparse

    dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(0)

    # ---- 1 the card
    card = card_line()
    say(f"[1] card: {card}")
    tag = f"({card})"

    # ---- 2 build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    say(f"[2] kernels built from {os.path.relpath(_build.SRC)} in "
        f"{time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"    ptxas: {line.strip()}")

    # ---- scene
    t0 = time.perf_counter()
    pts, out_num = fit_body(100_000)
    n = len(pts)
    cfg = warp_parity().replace(h=suggest_h(pts, 32), dtype="float32",
                                frames=STEPS, target_frames=FRAMES,
                                backend="pallas", **STRETCH)
    scene, sop = build_sparse_scene(pts, cfg, out_num=out_num,
                                    dirichlet_mask=dirichlet_mask(pts, "stretch"),
                                    device=dev)
    torch.cuda.synchronize()
    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    pairs = sum(b.n_tiles * sb.rows * b.slab_len for b in sb.buckets)
    say(f"    scene: N={n} slots={sb.n_slots} tiles={sb.n_tiles} "
        f"buckets={len(sb.buckets)} (slab:tiles "
        + " ".join(f"{b.slab_len}:{b.n_tiles}" for b in sb.buckets)
        + f") pairs/eval={pairs} host build {time.perf_counter() - t0:.1f} s")

    x_star = torch.as_tensor(x_star_bands(pts, sb.n_slots, sop),
                             dtype=torch.float32, device=dev)
    ratio = compute_ratio(x_star, cfg)

    # main-path-shaped inputs: a stretched, jittered body
    rng = np.random.default_rng(0)
    rest = scene.rest_position
    pos_np = rest.cpu().numpy().astype(np.float64)
    body = pos_np[sop]
    body = body + 0.05 * cfg.h * rng.normal(size=body.shape)
    body[:, 1] = body[:, 1].mean() + 1.05 * (body[:, 1] - body[:, 1].mean())
    pos_np[sop] = body
    pos = torch.as_tensor(pos_np, dtype=torch.float32, device=dev)
    posT = pos.T.contiguous()
    ayT = torch.cat([pk.moments_v4_plain(
        b.restT_rows, b.static_slab, posT,
        posT[:, b.row_start:b.row_start + b.n_tiles * sb.rows], b.gidx8, cfg.h)
        for b in sb.buckets], dim=1)
    A = [[ayT[3 * b + a] for b in range(3)] for a in range(3)]
    Y = [[ayT[9 + 3 * b + a] for b in range(3)] for a in range(3)]
    R, F, S, M, _ = mid_section(A, Y, ratio, scene.materials, scene, cfg, m)
    f9T = torch.stack([F[c][d] for c in range(3) for d in range(3)])
    srT = torch.zeros((15, sb.n_slots), dtype=torch.float32, device=dev)
    srT[:, :m] = torch.stack([S[0][0], S[0][1], S[0][2], S[1][1], S[1][2], S[2][2]]
                             + [R[a][c] for c in range(3) for a in range(3)])

    # ---- 3 kernel vs plain, per bucket
    say(f"[3] per bucket, kernel vs plain on the card {tag}")
    stats = {k: {"ms": 0.0, "launch_ms": 0.0, "plain_ms": 0.0, "flops": 0, "bytes": 0,
                 "max_abs_err": 0.0, "max_rel_err": 0.0}
             for k in FLOPS_PER_PAIR}
    f32 = 4
    for i, b in enumerate(sb.buckets):
        t, slab = b.n_tiles, b.slab_len
        mb = t * sb.rows
        r0 = b.row_start
        uniq = int(torch.unique(b.gidx8).numel()) * sb.group   # slots this bucket reads
        args1 = (b.restT_rows, b.static_slab, posT, posT[:, r0:r0 + mb], b.gidx8, cfg.h)
        args2 = (b.restT_rows, b.static_slab, f9T[:, r0:r0 + mb], srT, b.gidx8, cfg.h)
        static_bytes = (t * 3 * sb.rows + t * 5 * slab + t * slab // sb.group) * f32
        work = {
            "moments_v4": (pk.moments_v4, pk.moments_v4_plain, args1,
                           static_bytes + (3 * mb + 3 * uniq + 18 * mb) * f32),
            "forces_warp_v4": (pk.forces_warp_v4, pk.forces_warp_v4_plain, args2,
                               static_bytes + (9 * mb + 15 * uniq + 3 * mb) * f32),
        }
        line = [f"    bucket {i}: slab {slab:4d} tiles {t:4d}"]
        for key, (kern, plain, args, nbytes) in work.items():
            out_k = kern(*args)
            out_p = plain(*args)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(out_k).all()):
                fail(f"{key} bucket {i}: non-finite kernel output")
            err = rel_err(out_k, out_p)
            abs_err = float(torch.max(torch.abs(out_k - out_p)))
            if not err <= TOL:
                fail(f"{key} bucket {i}: kernel vs plain error {err:.3e} > {TOL}")
            ms = cuda_ms(lambda: kern(*args), 20)
            launch_ms = host_ms(lambda: kern(*args), 20)
            plain_ms = cuda_ms(lambda: plain(*args), 3)
            flops = FLOPS_PER_PAIR[key] * t * sb.rows * slab
            bound = max(flops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
            s = stats[key]
            s["ms"] += ms
            s["launch_ms"] += launch_ms
            s["plain_ms"] += plain_ms
            s["flops"] += flops
            s["bytes"] += nbytes
            s["max_abs_err"] = max(s["max_abs_err"], abs_err)
            s["max_rel_err"] = max(s["max_rel_err"], err)
            line.append(f"{key} err {err:.2e} {ms:.4f} ms (host-paced "
                        f"{launch_ms:.4f}, plain {plain_ms:.3f}, bound {bound:.4f})")
        say(" | ".join(line))
    for key, s in stats.items():
        s["bound_ms"] = max(s["flops"] / PEAK_FP32, s["bytes"] / PEAK_BYTES) * 1e3
        s["bound_by"] = ("operations" if s["flops"] / PEAK_FP32
                         >= s["bytes"] / PEAK_BYTES else "bytes")
        say(f"    {key}: {s['ms']:.4f} ms device per evaluation ({len(sb.buckets)} "
            f"launches; {s['launch_ms']:.4f} ms host-paced) vs bound "
            f"{s['bound_ms']:.4f} ms ({s['bound_by']}: "
            f"{s['flops'] / 1e9:.2f} GFLOP, {s['bytes'] / 1e6:.1f} MB); plain "
            f"{s['plain_ms']:.3f} ms {tag}")

    # ---- 4 one full force evaluation, kernel path vs plain path
    f_k = elastic_forces_sparse(pos, ratio, scene.materials, scene, cfg)
    f_p = elastic_forces_sparse(pos, ratio, scene.materials, scene, cfg,
                                pair_ops=pk.PLAIN)
    err = rel_err(f_k, f_p)
    say(f"[4] elastic_forces_sparse kernel vs plain: max err / max |plain| "
        f"= {err:.3e} (tol {TOL})")
    if not (err <= TOL and bool(torch.isfinite(f_k).all())):
        fail("elastic_forces_sparse kernel path disagrees with the plain path")

    # ---- step breakdown + the episode's step budget.  Host clock: these
    # parts are host-bound and the shared host's load varies, so each part
    # is the fastest of 5 interleaved rounds of 5 calls.
    state = initial_state(scene, ratio, cfg)
    parts = {
        "step": lambda: step(state, ratio, scene, cfg),
        "forces": lambda: elastic_forces_sparse(state.position, ratio,
                                                scene.materials, scene, cfg),
        "mid": lambda: mid_section(A, Y, ratio, scene.materials, scene, cfg, m),
    }
    best = {k: math.inf for k in parts}
    for _ in range(5):
        for k, fn in parts.items():
            best[k] = min(best[k], host_ms(fn, 5))
    ms_step = best["step"]
    say(f"    one step: {ms_step:.3f} ms wall; elastic forces {best['forces']:.3f} "
        f"ms, of which mid-section {best['mid']:.3f} ms; integrator and the rest "
        f"{ms_step - best['forces']:.3f} ms; K1 {stats['moments_v4']['ms']:.3f} ms, "
        f"K2 {stats['forces_warp_v4']['ms']:.3f} ms device time (fastest of 5 "
        f"rounds) {tag}")

    plain_step_ms = host_ms(lambda: step(state, ratio, scene, cfg, pk.PLAIN), 3)
    projected = (3 * STEPS + 300) * ms_step / 1e3 + 300 * plain_step_ms / 1e3
    steps = STEPS
    if projected > TIME_BUDGET_S:
        steps = max(FRAMES, int(STEPS * TIME_BUDGET_S / projected) // FRAMES * FRAMES)
        say(f"    CUT: episodes run {steps} steps, not {STEPS} (projected "
            f"{projected:.0f} s > {TIME_BUDGET_S:.0f} s)")
    cfg = cfg.replace(frames=steps)

    # ---- 5 the main path: targets from x*, then the sampled loss of x = 0
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        generate_targets(x_star, scene, cfg, tmp, particle_index=sop, device=dev)
        t_targets = time.perf_counter() - t0
        tp_p, tv_p = load_targets(tmp, FRAMES)
    tp = np.tile(rest.cpu().numpy(), (FRAMES, 1, 1))
    tv = np.zeros_like(tp) + np.asarray(cfg.initial_velocity)
    tp[:, sop], tv[:, sop] = tp_p, tv_p
    if not (np.isfinite(tp).all() and np.isfinite(tv).all()):
        fail("non-finite target frames")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    acc, fin, _ = rollout(torch.zeros(sb.n_slots), scene, cfg, tp, tv,
                          acc_pair=True, device=dev)
    loss = acc_float(acc)
    t_loss = time.perf_counter() - t1
    launches_path = {"moments_v4": pk.moments_v4.launches,
                     "forces_warp_v4": pk.forces_warp_v4.launches}
    ms_ep = (t_targets + t_loss) * 1e3 / (2 * steps)
    say(f"[5] episode: {steps} steps x 2 (targets from x*: {t_targets:.1f} s "
        f"incl. {FRAMES} frames to disk; loss of x=0: {t_loss:.1f} s) -> "
        f"{ms_ep:.3f} ms/step, {n * 1e3 / ms_ep:.4g} particle-steps/s {tag}")
    say(f"    loss(x=0 vs x* targets) = {loss:.9g}")
    if not (math.isfinite(loss) and loss > 0
            and bool(torch.isfinite(fin.position).all())):
        fail("episode produced a non-finite or zero loss / state")
    for key, s in stats.items():
        say(f"    {key}: {s['ms'] / len(sb.buckets):.4f} ms/launch (mean over "
            f"buckets, CUDA events) {tag}")

    # ---- 6 kernel path vs plain path, 300 steps
    _, fin_k, _ = rollout(x_star, scene, cfg, n_steps=300, device=dev)
    _, fin_p, _ = rollout(x_star, scene, cfg, n_steps=300, device=dev,
                          pair_ops=pk.PLAIN)
    dpos = float(torch.max(torch.abs(fin_k.position - fin_p.position)))
    disp = float(torch.max(torch.abs(fin_p.position - rest)))
    say(f"[6] 300-step rollout kernel vs plain: max|dpos| = {dpos:.3e}, "
        f"max|pos - rest| = {disp:.3e}, ratio {dpos / disp:.3e} (tol 1e-3)")
    if not dpos <= 1e-3 * disp:
        fail("kernel-path rollout drifts from the plain-path rollout")

    # ---- 7 quiet body
    quiet = cfg.replace(external_force=(0.0, 0.0, 0.0))
    q_scene = scene._replace(materials=scene.materials._replace(
        external=torch.zeros_like(scene.materials.external)))
    _, fin_q, _ = rollout(torch.zeros(sb.n_slots), q_scene, quiet,
                          n_steps=steps, device=dev)
    d = (fin_q.position - rest)[scene.slot_of_particle]
    drift = float(torch.sqrt(torch.mean(torch.sum(d * d, dim=1))))
    say(f"[7] quiet body, {steps} steps: rms drift from rest {drift:.3e} m "
        f"(tol 1e-6)")
    if not drift < 1e-6:
        fail("a quiet body drifts")

    # ---- 8 launch counts of the main path (phase 5)
    evals = 2 * steps      # symplectic: one force evaluation per step, none at start
    want = len(sb.buckets) * evals
    say(f"[8] launches on the main path: " + ", ".join(
        f"{k} {v}" for k, v in launches_path.items())
        + f" (expected {want} each = {len(sb.buckets)} buckets x {evals} "
        "force evaluations)")
    for k, v in launches_path.items():
        if v != want:
            fail(f"{k} launched {v} times on the main path, expected {want}")

    # device busy share of a steady window (after every timed phase: the
    # profiler's tracing must not slow what the phases above measured)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    state = initial_state(scene, ratio, cfg)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(10):
            state = step(state, ratio, scene, cfg)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in on_card) / 1e3 / 10
    pair_ms = sum(e.time_range.elapsed_us() for e in on_card
                  if "moments_v4_kernel" in e.name
                  or "forces_warp_v4_kernel" in e.name) / 1e3 / 10
    if busy_ms > 0:
        say(f"    profile: device busy {busy_ms:.3f} ms/step over 10 steps in "
            f"{len(on_card) / 10:.0f} device activities per step, of which the "
            f"two pair kernels {pair_ms:.3f} ms; idle share "
            f"{1 - busy_ms / ms_ep:.3f} of the episode's {ms_ep:.3f} ms/step {tag}")
    else:
        say("    profile: the profiler saw no device time; idle share not measured")

    kernels = []
    for key, s in stats.items():
        kernels.append({
            "name": key,
            "route": "cuda",
            "source": "softbody_tpu_torch/csrc/pair_kernels.cu",
            "replaces": {"moments_v4": "softbody_tpu/ops/pallas/pair_kernels.py:505",
                         "forces_warp_v4": "softbody_tpu/ops/pallas/pair_kernels.py:879"}[key],
            "launches": launches_path[key],
            "max_abs_err": s["max_abs_err"],
            "ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
