#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (softbody_tpu_torch) runs on the GPU.

Drives the port's main path on one CUDA card at full width — the ~112k
particle "stretch" inverse-design scene (fit_body(100000), STRETCH physics,
top-15% Dirichlet clamp, f32) — and holds every hand-written kernel on that
path against its plain PyTorch version.  Phases, each printed as it runs:

  1  the card (nvidia-smi name and power limit)
  2  kernel build (nvcc, from csrc/ in this checkout); the five
     whole-scene kernels' (K1/K2 forward and their backwards) registers,
     shared memory, spills and resident blocks per SM, f32 and f64
  3  K1 moments_v4 and K2 forces_warp_v4, one launch each over every tile of
     every bucket: each bucket's columns vs that bucket's plain version on
     the card (max error relative to max |plain| <= 1e-4), a bitwise
     repeat, ms per evaluation, the work's bound
  4  one elastic_forces_sparse call, kernel path vs plain path (<= 1e-4)
  5  the forward episode: generate_targets (x*, 3000 steps, 100 frames) and
     the sampled loss of x = 0 against those targets; ms/step and
     particle-steps/s; a per-part breakdown of one step
  6  kernel-path vs plain-path rollout over 300 steps:
     max |dpos| <= 1e-3 max |pos - rest|
  7  quiet body: no load, x = 0, 3000 steps, rms drift from rest < 1e-6 m
  8  the launch counts of phase 5 against the launches the path implies
     (K1 and K2: one per force evaluation)
     (phases 5-7 run fewer steps when they would exceed TIME_BUDGET_S;
     the cut is printed)
  9  the K1 backward and the two K2 backward passes, one launch each over
     every tile of every bucket: each bucket's columns vs that bucket's
     plain version on the card (the slab side composed with the
     fixed-order slab_to_slots scatter; <= 1e-4 of max |plain|), a bitwise
     repeat, ms per evaluation, the work's bound
 10  one VJP of elastic_forces_sparse wrt (positions, x), kernel path vs
     plain path (<= 1e-4), and bitwise equal across two kernel-path calls
 11  the episode gradient at full width: episode_value_and_grad_chunked over
     GRAD_STEPS steps (GRAD_FRAMES frames) at x = 0 against targets from
     x*; fwd+bwd ms/step, particle-steps/s, peak device memory, the
     profiler's busy share; two kernel-path gradients bitwise equal; kernel
     vs plain path over the first PREFIX_STEPS steps in f64 (loss <= 1e-5
     relative, max |dg| <= 1e-3 max |g_plain|; the f32 values are printed,
     not gated)
 12  the product loop: optimize_lbfgs from x = 0, maxiter 2, EVAL_CHUNKS
     chunks, into a temporary directory: the losses strictly decrease,
     x.npy / losses.json / distances.json exist, every gradient is finite
 13  the launch counts of phases 11 and 12 against the launches the
     gradient path implies

 14  the fused K1 + mid-section path (cfg.fused_mid), per bucket: the fused
     moments_mid, K2 forces_warp_v2, the raw K1 backward moments_raw_bwd
     and the two K2 v2 backward passes (each backward composed with
     slab_to_slots), kernel vs plain (<= 1e-4 of max |plain|, the records'
     parts F, M, V, S, R each on its own), ms per launch, the work's bound
 15  one fused force evaluation vs the unfused kernel path and vs the plain
     fused path (<= 1e-4), its VJP wrt (positions, x) vs the plain fused
     VJP (<= 1e-4); forces and VJP bitwise equal across two calls
 16  the fused forward episode, as phase 5: generate_targets from x* and
     the sampled loss of x = 0, STEPS steps each; ms/step,
     particle-steps/s, the profiler's device activities per step and idle
     share, beside phase 5's unfused numbers
 17  quiet body on the fused path, STEPS steps: rms drift from rest < 1e-6 m
     (phases 16-17 run fewer steps when they would exceed FUSED_BUDGET_S;
     the cut is printed)
 18  300-step fused rollout vs phase 6's unfused kernel-path rollout:
     max |dpos| <= 1e-3 max |pos - rest|
 19  the fused episode gradient: GRAD_STEPS steps in EVAL_CHUNKS chunks;
     fwd+bwd ms/step, peak memory, busy share; bitwise repeat; kernel vs
     plain fused path over PREFIX_STEPS steps in f64 (phase 11's gates)
 20  the launch counts of phases 16 and 19 against what the fused path
     implies (none of the v4 kernels, K1/K2 and their backwards)

 21  path A, the Taichi pairing (pair_def_grad="j") on the sparse scene, per
     bucket: the separable K2 forces_sep and its backward's two passes
     forces_sep_bwd_rows / _slab (the slab pass composed with
     slab_to_slots), kernel vs plain (<= 1e-4 of max |plain|), ms per
     launch, the work's bound
 22  one "j" force evaluation and its VJP wrt (positions, x), kernel path
     vs plain path (<= 1e-4), both bitwise equal across two calls;
     fused_mid=True with "j" equals "j" bit for bit
 23  path A's forward episode (generate_targets from x*, the loss of
     x = 0): ms/step, particle-steps/s, the profiler's activities per step
     and idle share; its quiet body, rms drift < 1e-6 m (both cut to
     NEW_BUDGET_S, the cut printed)
 24  path A's gradient, GRAD_STEPS steps in EVAL_CHUNKS chunks: fwd+bwd
     ms/step, peak memory, a bitwise repeat, the f64 gradient over
     NEW_PREFIX_STEPS steps kernel vs plain under phase 11's gates
 25  path B, the blocked varcol layout of the same body on the pallas
     backend: its build seconds, n_tiles, run length L, slab_len,
     candidate pairs per evaluation (beside the sparse scene's) and static
     bytes; per launch on its tiles the raw K1 moments_raw, forces_warp_v2,
     forces_sep and their backwards (each backward's slab side composed
     with slab_to_slots), kernel vs plain (<= 1e-4), ms per launch, bound
 26  one path-B evaluation for "i" and "j" against the sparse path at the
     same particle positions (<= 1e-3 of max |f|: the uncentered f32 raw
     dots add noise the centered sparse path lacks), and against its own
     plain path, forces and VJP wrt (positions, x) (<= 1e-4); bitwise
     repeat; fused_mid is ignored, as in the JAX package
 27  path B's forward episode and quiet body, as phase 23, the quiet-body
     gate rms drift < 1e-4 m (uncentered true-f32 raw dots)
 28  path B's gradient, as phase 24
 29  the launch counts of phases 23-24 and 27-28 against what each path
     implies: no kernel of another path runs

Each phase's first line ends with the seconds since the start.  Then one
JSON line with every kernel's numbers (``launches`` from phase 12, the
product loop, for the v4 path's kernels and the scatter; from phase 19, one
fused gradient evaluation, for the fused path's; from phases 24 and 28, one
gradient each, for the separable K2 and the raw K1; ms per force
evaluation: one launch for K1 and K2 v4 and their backwards, the sum over
the sparse scene's buckets for the other kernels, the raw K1 on the varcol
scene),
the card line, and the last line
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
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
TIME_BUDGET_S = 20.0       # cut the episodes' steps if phases 5-7 would exceed it
FUSED_BUDGET_S = 15.0      # the same for the fused phases 16-17
NEW_BUDGET_S = 20.0        # the same for each of the paths A and B (23, 27)
GRAD_STEPS = 99            # depth of every gradient phase (33 frames, interval 3)
GRAD_FRAMES = 33
PREFIX_STEPS = 99          # kernel vs plain f64 gradient prefix, phases 11 and 19
NEW_PREFIX_STEPS = 30      # the same for the new paths' phases 24 and 28 (10 frames)
EVAL_CHUNKS = 3
PEAK_FP32 = 67e12          # H100 SXM FP32 without tensor cores (data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
FLOPS_PER_PAIR = {"moments_v4": 72, "forces_warp_v4": 74,   # as the kernels do them
                  "moments_v4_bwd": 67, "forces_warp_v4_bwd_rows": 71,
                  "forces_warp_v4_bwd_slab": 118,
                  "moments_mid": 78, "forces_warp_v2": 78, "moments_raw_bwd": 72,
                  "forces_warp_v2_bwd_rows": 78, "forces_warp_v2_bwd_slab": 123,
                  "forces_sep": 50, "forces_sep_bwd_rows": 32,
                  "forces_sep_bwd_slab": 44, "moments_raw": 72}
# moments_mid's per-row epilogue, counted from csrc/fused_kernels.cu: A | Y
# from the warp sums (180), A^T A (45), 24 Jacobi rotations (~68 each), the
# SVD's U and R = U V^T (~180), R^T Y, F, E, S and M = R F S (~240)
MID_FLOPS_PER_ROW = 2250
T_START = time.perf_counter()
SLEEP_CYCLES = 200_000_000  # ~0.1 s of card time, longer than any timed batch's enqueue


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg):
    if msg.startswith("["):
        msg = f"{msg}  [t={time.perf_counter() - T_START:.0f} s]"
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


def summarize(key, s, launches, tag):
    """Bound of the summed work of one evaluation, and its report line."""
    s["bound_ms"] = max(s["flops"] / PEAK_FP32, s["bytes"] / PEAK_BYTES) * 1e3
    s["bound_by"] = ("operations" if s["flops"] / PEAK_FP32
                     >= s["bytes"] / PEAK_BYTES else "bytes")
    say(f"    {key}: {s['ms']:.4f} ms device per evaluation ({launches} "
        f"launches; {s['launch_ms']:.4f} ms host-paced) vs bound "
        f"{s['bound_ms']:.4f} ms ({s['bound_by']}: "
        f"{s['flops'] / 1e9:.2f} GFLOP, {s['bytes'] / 1e6:.1f} MB); plain "
        f"{s['plain_ms']:.3f} ms {tag}")


def record(s, out_k, out_p, what):
    """Hold one kernel output against its plain version; keep the errors."""
    import torch

    if not bool(torch.isfinite(out_k).all()):
        fail(f"{what}: non-finite kernel output")
    err = rel_err(out_k, out_p)
    if not err <= TOL:
        fail(f"{what}: kernel vs plain error {err:.3e} > {TOL}")
    s["max_abs_err"] = max(s["max_abs_err"], float(torch.max(torch.abs(out_k - out_p))))
    s["max_rel_err"] = max(s["max_rel_err"], err)
    return err


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

    # ---- 2 build (one nvcc per source, all started together)
    t0 = time.perf_counter()
    libs = _build.build()
    for source in libs:
        _build.library(source)
    say(f"[2] kernels built from {', '.join(f'csrc/{s}.cu' for s in libs)} in "
        f"{time.perf_counter() - t0:.1f} s -> "
        + ", ".join(p.name for p in libs.values()))
    for source, lib_path in libs.items():
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say(f"    ptxas {source}: {line.strip()}")
    for (key, dt), a in pk.ragged_info().items():
        warps = a["threads"] // 32 * a["blocks_per_sm"]
        say(f"    {key} {dt}: {a['registers']} registers, {a['local_bytes']} B local "
            f"(stack and spills), {a['static_smem']} B static + {a['dynamic_smem']} B "
            f"dynamic shared memory per block of {a['threads']} threads, "
            f"{a['blocks_per_sm']} blocks ({warps} of 64 warps) resident per SM")

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

    say(f"    CUT: every gradient phase runs {GRAD_STEPS} of the episode's {STEPS} "
        f"steps ({GRAD_FRAMES} frames), the f64 kernel-vs-plain gradients "
        f"{PREFIX_STEPS} steps (phases 11 and 19) and {NEW_PREFIX_STEPS} (phases 24 "
        f"and 28); the forward phases are cut to budgets of "
        f"{TIME_BUDGET_S:.0f} s (default path), {FUSED_BUDGET_S:.0f} s (fused) and "
        f"{NEW_BUDGET_S:.0f} s (each of paths A and B), each cut printed; width "
        f"is never cut")
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
    ayT = pk.moments_all(posT, posT[:, :m], sb, cfg.h, pk.PLAIN)
    A = [[ayT[3 * b + a] for b in range(3)] for a in range(3)]
    Y = [[ayT[9 + 3 * b + a] for b in range(3)] for a in range(3)]
    R, F, S, M, _ = mid_section(A, Y, ratio, scene.materials, scene, cfg, m)
    f9T = torch.stack([F[c][d] for c in range(3) for d in range(3)])
    srT = torch.zeros((15, sb.n_slots), dtype=torch.float32, device=dev)
    srT[:, :m] = torch.stack([S[0][0], S[0][1], S[0][2], S[1][1], S[1][2], S[2][2]]
                             + [R[a][c] for c in range(3) for a in range(3)])

    # ---- 3 the two ragged kernels: one launch per evaluation, each bucket's
    # columns held against that bucket's plain version
    say(f"[3] K1 and K2, one launch each over all {sb.n_tiles} tiles, kernel vs plain "
        f"per bucket on the card {tag}")
    stats = {k: {"ms": 0.0, "launch_ms": 0.0, "plain_ms": 0.0, "flops": 0, "bytes": 0,
                 "max_abs_err": 0.0, "max_rel_err": 0.0, "library_ms": None}
             for k in list(FLOPS_PER_PAIR) + ["slab_to_slots"]}
    f32 = 4
    k1 = pk.moments_v4(sb, posT, posT[:, :m], cfg.h)
    k2 = pk.forces_warp_v4(sb, f9T, srT, cfg.h)
    torch.cuda.synchronize()
    for i, b in enumerate(sb.buckets):
        c = slice(b.row_start, b.row_start + b.n_tiles * sb.rows)
        a1 = (b.restT_rows, b.static_slab, posT, posT[:, c], sb.rs6T[:, c], b.gidx8,
              cfg.h)
        a2 = (b.restT_rows, b.static_slab, f9T[:, c], srT, b.gidx8, cfg.h)
        p1, p2 = pk.moments_v4_plain(*a1), pk.forces_warp_v4_plain(*a2)
        e1 = record(stats["moments_v4"], k1[:, c], p1, f"moments_v4 bucket {i}")
        e2 = record(stats["forces_warp_v4"], k2[:, c], p2, f"forces_warp_v4 bucket {i}")
        ms1 = cuda_ms(lambda: pk.moments_v4_plain(*a1), 1)
        ms2 = cuda_ms(lambda: pk.forces_warp_v4_plain(*a2), 1)
        stats["moments_v4"]["plain_ms"] += ms1
        stats["forces_warp_v4"]["plain_ms"] += ms2
        say(f"    bucket {i}: slab {b.slab_len:4d} tiles {b.n_tiles:4d} | moments_v4 "
            f"err {e1:.2e} (plain {ms1:.2f} ms) | forces_warp_v4 err {e2:.2e} (plain "
            f"{ms2:.2f} ms)")
    same = (torch.equal(k1, pk.moments_v4(sb, posT, posT[:, :m], cfg.h))
            and torch.equal(k2, pk.forces_warp_v4(sb, f9T, srT, cfg.h)))
    say(f"    second launch of each bitwise equal: {same}")
    if not same:
        fail("a ragged kernel does not repeat bit for bit")
    pairs = sum(b.n_tiles * sb.rows * b.slab_len for b in sb.buckets)
    uniq = int(torch.unique(sb.gidx_all).numel()) * sb.group   # slots the scene reads
    static_bytes = (sb.rest_rows.numel() + sb.static_all.numel()
                    + sb.gidx_all.numel() + sb.schedule.numel() * 2) * f32
    work = {
        "moments_v4": (lambda: pk.moments_v4(sb, posT, posT[:, :m], cfg.h),
                       static_bytes + (3 * uniq + 3 * m + 18 * m) * f32),
        "forces_warp_v4": (lambda: pk.forces_warp_v4(sb, f9T, srT, cfg.h),
                           static_bytes + (9 * m + 15 * uniq + 3 * m) * f32),
    }
    for key, (fn, nbytes) in work.items():
        st = stats[key]
        st["ms"] = cuda_ms(fn, 50)
        st["launch_ms"] = host_ms(fn, 50)
        st["flops"] = FLOPS_PER_PAIR[key] * pairs
        st["bytes"] = nbytes
        summarize(key, st, 1, tag)

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
    launches_fwd = pk.launch_counts()
    ms_ep = (t_targets + t_loss) * 1e3 / (2 * steps)
    say(f"[5] episode: {steps} steps x 2 (targets from x*: {t_targets:.1f} s "
        f"incl. {FRAMES} frames to disk; loss of x=0: {t_loss:.1f} s) -> "
        f"{ms_ep:.3f} ms/step, {n * 1e3 / ms_ep:.4g} particle-steps/s {tag}")
    say(f"    loss(x=0 vs x* targets) = {loss:.9g}")
    if not (math.isfinite(loss) and loss > 0
            and bool(torch.isfinite(fin.position).all())):
        fail("episode produced a non-finite or zero loss / state")
    for key in ("moments_v4", "forces_warp_v4"):
        say(f"    {key}: {stats[key]['ms']:.4f} ms per evaluation, one launch (CUDA "
            f"events) {tag}")

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
    want = evals           # one launch of each ragged kernel per evaluation
    say(f"[8] launches on the forward path: " + ", ".join(
        f"{k} {v}" for k, v in launches_fwd.items())
        + f" (expected {want} for each forward kernel = one launch x {evals} force "
        f"evaluations, 0 for the backward ones)")
    for k, v in launches_fwd.items():
        expect = want if k in ("moments_v4", "forces_warp_v4") else 0
        if v != expect:
            fail(f"{k} launched {v} times on the forward path, expected {expect}")

    # device busy share of a steady window (after every timed phase: the
    # profiler's tracing must not slow what the phases above measured)
    busy_ms, activities, pair_ms = profile_card(
        torch, ten_steps(initial_state(scene, ratio, cfg), ratio, scene, cfg),
        ("moments_v4_kernel", "forces_warp_v4_kernel"), 10)
    if busy_ms > 0:
        say(f"    profile: device busy {busy_ms:.3f} ms/step over 10 steps in "
            f"{activities:.0f} device activities per step, of which the "
            f"two pair kernels {pair_ms:.3f} ms; idle share "
            f"{1 - busy_ms / ms_ep:.3f} of the episode's {ms_ep:.3f} ms/step {tag}")
    else:
        say("    profile: the profiler saw no device time; idle share not measured")

    ctx = phase_grad(torch, np, dev, tag, scene, sop, cfg, x_star, stats,
                     pos, pts, out_num)
    ctx.update(ratio=ratio, loss=loss, ms_ep=ms_ep, steps=steps, fin_k=fin_k,
               busy_ms=busy_ms, activities=activities, pos=pos)
    counts_fused = phase_fused(torch, np, dev, tag, scene, cfg, x_star, stats,
                               pos, ctx)
    path_a = phase_taichi(torch, np, dev, tag, scene, cfg, x_star, stats, pos, ctx)
    path_b = phase_blocked(torch, np, dev, tag, pts, out_num, scene, cfg, x_star,
                           stats, body, ctx)
    phase_counts(path_a, path_b)
    launches = {**ctx["counts_opt"],
                **{k: counts_fused[k] for k in REPLACES
                   if REPLACES[k][0] == "fused_kernels"},
                **{k: path_a["grad"][k] for k in REPLACES
                   if REPLACES[k][0] == "separable_kernels"},
                "moments_raw": path_b["grad"]["moments_raw"]}
    kernels = kernel_json(stats, launches)
    say(f"    total {time.perf_counter() - T_START:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


def phase_grad(torch, np, dev, tag, scene, sop, cfg, x_star, stats, pos,
               pts, out_num):
    """Phases 9-13: the gradient path, its kernels, and the product loop."""
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops.pair_common import slab_slots
    from softbody_tpu_torch.scenarios import dirichlet_mask
    from softbody_tpu_torch.sim.sparse import build_sparse_scene
    from softbody_tpu_torch.opt import driver
    from softbody_tpu_torch.sim.rollout import episode_value_and_grad_chunked, rollout
    from softbody_tpu_torch.sim.sparse import elastic_forces_sparse
    from softbody_tpu_torch.ops.elasticity import compute_ratio

    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    n = len(sop)
    f32 = 4
    rng = np.random.default_rng(9)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    # ---- 9 the three backward kernels: one launch per evaluation each, each
    # bucket's columns held against that bucket's plain version
    say(f"[9] K1 backward and the two K2 backward passes, one launch each over all "
        f"{sb.n_tiles} tiles, kernel vs plain per bucket on the card {tag}")
    dayT, dfT = rand(18, m), rand(3, m)
    f9T = torch.eye(3, device=dev).reshape(9, 1) + 0.1 * rand(9, m)
    srT = rand(15, sb.n_slots)
    srT[:, m:] = 0
    n_entries = pk.n_entries(sb)
    index_bytes = (sb.slab_idx.numel() + sb.slab_ptr.numel()) * 4
    kept = sb.slab_idx.numel() * sb.group     # entries the scatter reads
    to_slots = (sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)

    def slots(d, k, scatter):
        """Per-entry columns ``d`` of one bucket alone in the scene's
        buffer, added into slots."""
        buf = torch.zeros((k, n_entries), dtype=torch.float32, device=dev)
        buf[:, seg] = d
        return scatter(buf, *to_slots)

    def bwd():
        return pk.moments_v4_bwd(sb, dayT, cfg.h) + (
            pk.forces_warp_v4_bwd_rows(sb, f9T, srT, dfT, cfg.h),
            pk.forces_warp_v4_bwd_slab(sb, f9T, srT, dfT, cfg.h))

    k_dps, k_dprow, k_df9, k_dsr = bwd()
    torch.cuda.synchronize()
    e0 = 0
    for i, b in enumerate(sb.buckets):
        t, slab = b.n_tiles, b.slab_len
        c = slice(b.row_start, b.row_start + t * sb.rows)
        seg = slice(e0, e0 + t * slab)
        e0 += t * slab
        a1 = (b.restT_rows, b.static_slab, dayT[:, c], sb.rs6T[:, c], cfg.h)
        a2 = (b.restT_rows, b.static_slab, f9T[:, c], srT, b.gidx8, dfT[:, c], cfg.h)
        p_dps, p_dprow = pk.moments_v4_bwd_plain(*a1)
        p_df9, p_dsr = pk.forces_warp_v4_bwd_plain(*a2)
        e1 = max(record(stats["moments_v4_bwd"], slots(k_dps[:, seg], 3, pk.slab_to_slots),
                        slots(p_dps.permute(1, 0, 2).reshape(3, -1), 3,
                              pk.slab_to_slots_plain), f"moments_v4_bwd bucket {i}"),
                 record(stats["moments_v4_bwd"], k_dprow[:, c], p_dprow,
                        f"moments_v4_bwd rows bucket {i}"))
        e2 = record(stats["forces_warp_v4_bwd_rows"], k_df9[:, c], p_df9,
                    f"forces_warp_v4_bwd_rows bucket {i}")
        e3 = record(stats["forces_warp_v4_bwd_slab"], slots(k_dsr[:, seg], 15, pk.slab_to_slots),
                    slots(p_dsr.permute(1, 0, 2).reshape(15, -1), 15, pk.slab_to_slots_plain),
                    f"forces_warp_v4_bwd_slab bucket {i}")
        ms1 = cuda_ms(lambda: pk.moments_v4_bwd_plain(*a1), 1)
        ms2 = cuda_ms(lambda: pk.forces_warp_v4_bwd_plain(*a2), 1)
        stats["moments_v4_bwd"]["plain_ms"] += ms1
        for key in ("forces_warp_v4_bwd_rows", "forces_warp_v4_bwd_slab"):
            stats[key]["plain_ms"] += ms2
        say(f"    bucket {i}: slab {slab:4d} tiles {t:4d} | moments_v4_bwd err {e1:.2e} "
            f"(plain {ms1:.2f} ms) | forces_warp_v4_bwd rows err {e2:.2e}, slab err "
            f"{e3:.2e} (plain {ms2:.2f} ms)")
    same = all(torch.equal(x, y) for x, y in zip((k_dps, k_dprow, k_df9, k_dsr), bwd()))
    say(f"    second launch of each bitwise equal: {same}")
    if not same:
        fail("a backward kernel does not repeat bit for bit")
    pairs = sum(b.n_tiles * sb.rows * b.slab_len for b in sb.buckets)
    uniq = int(torch.unique(sb.gidx_all).numel()) * sb.group   # slots the scene reads
    rest_static = (sb.rest_rows.numel() + sb.static_all.numel()) * f32
    gidx_bytes = sb.gidx_all.numel() * 4
    work = {
        "moments_v4_bwd": (
            lambda: pk.moments_v4_bwd(sb, dayT, cfg.h),
            rest_static + sb.chunks.numel() * 8
            + (18 * m + 6 * m + 3 * n_entries + 3 * m) * f32),
        "forces_warp_v4_bwd_rows": (
            lambda: pk.forces_warp_v4_bwd_rows(sb, f9T, srT, dfT, cfg.h),
            rest_static + gidx_bytes + sb.schedule.numel() * 8
            + (15 * uniq + 3 * m + 9 * m) * f32),
        "forces_warp_v4_bwd_slab": (
            lambda: pk.forces_warp_v4_bwd_slab(sb, f9T, srT, dfT, cfg.h),
            rest_static + gidx_bytes + sb.chunks.numel() * 8
            + (9 * m + 15 * uniq + 3 * m + 15 * n_entries) * f32),
    }
    for key, (fn, nbytes) in work.items():
        st = stats[key]
        st["ms"] = cuda_ms(fn, 50)
        st["launch_ms"] = host_ms(fn, 50)
        st["flops"] = FLOPS_PER_PAIR[key] * pairs
        st["bytes"] = nbytes
        summarize(key, st, 1, tag)
    # the scatter: once for K1's 3 fields and once for K2's 15 per evaluation.
    # Its library counterpart is one index_add_ over every entry's slot
    # (float atomics, so not bitwise repeatable; it also adds the padding
    # group's readers, which the CSR index leaves out); timed, never used.
    st = stats["slab_to_slots"]
    st["library_ms"] = 0.0
    entry_slots = torch.cat([slab_slots(b.gidx8, b.slab_len).reshape(-1)
                             for b in sb.buckets])
    for k in (3, 15):
        buf = rand(k, n_entries)
        record(st, pk.slab_to_slots(buf, *to_slots), pk.slab_to_slots_plain(buf, *to_slots),
               f"slab_to_slots k={k}")
        st["ms"] += cuda_ms(lambda: pk.slab_to_slots(buf, *to_slots), 20)
        st["launch_ms"] += host_ms(lambda: pk.slab_to_slots(buf, *to_slots), 20)
        st["plain_ms"] += cuda_ms(lambda: pk.slab_to_slots_plain(buf, *to_slots), 2)
        st["library_ms"] += cuda_ms(lambda: torch.zeros(
            (k, sb.n_slots), device=dev).index_add_(1, entry_slots, buf), 20)
        st["flops"] += k * kept
        st["bytes"] += (k * kept + k * sb.n_slots) * f32 + index_bytes
    summarize("slab_to_slots", st, 2, tag)
    say(f"    slab_to_slots library counterpart (index_add_, 2 calls): "
        f"{st['library_ms']:.4f} ms {tag}")
    say(f"    (each K2 pass's plain time is the whole plain K2 backward: the "
        f"plain version computes both outputs at once)")

    # ---- 10 one VJP of the elastic forces, kernel path vs plain path
    ct = torch.zeros_like(pos)
    ct[scene.slot_of_particle] = rand(n, 3)

    def vjp(ops):
        p = pos.clone().requires_grad_()
        xv = x_star.clone().requires_grad_()
        f = elastic_forces_sparse(p, compute_ratio(xv, cfg), scene.materials,
                                  scene, cfg, ops)
        return torch.autograd.grad(f, (p, xv), ct)

    k1, k2, pl = vjp(pk.KERNELS), vjp(pk.KERNELS), vjp(pk.PLAIN)
    errs = [rel_err(a, b) for a, b in zip(k1, pl)]
    same = all(torch.equal(a, b) for a, b in zip(k1, k2))
    say(f"[10] VJP of elastic_forces_sparse wrt (pos, x), kernel vs plain: "
        f"{errs[0]:.3e}, {errs[1]:.3e} of max |plain| (tol {TOL}); two kernel-path "
        f"calls bitwise equal: {same}")
    if not (max(errs) <= TOL and same
            and all(bool(torch.isfinite(a).all()) for a in k1)):
        fail("the force VJP's kernel path disagrees with the plain path or "
             "does not repeat")

    # ---- 11 the episode gradient at full width
    S = GRAD_STEPS
    cfg_g = cfg.replace(frames=S, target_frames=GRAD_FRAMES)
    t0 = time.perf_counter()
    with torch.no_grad():
        _, _, (tp, tv) = rollout(x_star, scene, cfg_g, n_steps=S,
                                 record_every=S // GRAD_FRAMES, device=dev)
    torch.cuda.synchronize()
    t_tp = time.perf_counter() - t0
    x0 = torch.zeros(sb.n_slots, device=dev)
    vg = episode_value_and_grad_chunked(scene, cfg_g, EVAL_CHUNKS, S)
    pk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss1, g1 = vg(x0, tp, tv)
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    counts_grad = pk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    loss2, g2 = vg(x0, tp, tv)
    ms_grad = t_grad * 1e3 / S
    gmax = float(torch.max(torch.abs(g1)))
    say(f"[11] episode gradient: {S} steps, {GRAD_FRAMES} frames, {EVAL_CHUNKS} "
        f"chunks, x = 0 (targets from x*: {t_tp:.1f} s forward): loss "
        f"{loss1:.9g}, max |g| {gmax:.3e}; fwd+bwd {t_grad:.1f} s = {ms_grad:.3f} "
        f"ms/step, {n * S / t_grad:.4g} particle-steps/s; peak device memory "
        f"{peak / 2**30:.3f} GiB {tag}")
    repeat = loss1 == loss2 and torch.equal(g1, g2)
    say(f"    second kernel-path gradient bitwise equal: {repeat}")
    if not (math.isfinite(loss1) and loss1 > 0 and gmax > 0 and repeat
            and bool(torch.isfinite(g1).all())):
        fail("the full-width gradient is not finite, is zero, or does not repeat")
    # kernel vs plain path over a prefix, in f64: in f32 two summation
    # orders give trajectories apart by ~4e-4 of the displacement after 300
    # steps (phase 6), and a loss against x*'s targets is the square of the
    # small x*-vs-x0 difference, so any two f32 evaluations differ by ~5e-3
    # (f32 vs f64 on the CPU at 2k particles, 99 steps).  In f64 the gates
    # measure the kernels and their wiring.  The f32 values are printed.
    P = PREFIX_STEPS
    cfg64 = cfg_g.replace(dtype="float64")
    scene64, _ = build_sparse_scene(pts, cfg64, out_num=out_num, device=dev,
                                    dirichlet_mask=dirichlet_mask(pts, "stretch"))
    with torch.no_grad():
        _, _, (tp64, tv64) = rollout(x_star.double(), scene64, cfg64, n_steps=P,
                                     record_every=S // GRAD_FRAMES, device=dev)
    x64 = torch.zeros(sb.n_slots, dtype=torch.float64, device=dev)
    n_tp = P // (S // GRAD_FRAMES)
    prefix = {}
    for label, sc, c, x_, a, b in (("f64", scene64, cfg64, x64, tp64, tv64),
                                   ("f32", scene, cfg_g, x0, tp[:n_tp], tv[:n_tp])):
        for ops in (pk.KERNELS, pk.PLAIN):
            prefix[label, ops is pk.PLAIN] = episode_value_and_grad_chunked(
                sc, c, 1, P, ops)(x_, a, b)
    for label in ("f64", "f32"):
        (lk, gk), (lp, gp) = prefix[label, False], prefix[label, True]
        dl, dg = abs(lk - lp) / lp, rel_err(gk, gp)
        gate = "(tol 1e-5 and 1e-3)" if label == "f64" else "(not gated)"
        say(f"    first {P} steps in {label}, kernel vs plain path: loss {lk:.12g} "
            f"vs {lp:.12g} (rel {dl:.3e}); max |dg| / max |g_plain| {dg:.3e} {gate}")
        if label == "f64" and not (dl <= 1e-5 and dg <= 1e-3):
            fail("the gradient's kernel path disagrees with its plain path")
    # device busy share of a gradient (a 10-step chunk, after the timed runs)
    short = episode_value_and_grad_chunked(scene, cfg_g, 1, 10)
    busy, activities, ours = profile_card(torch, lambda: short(x0, tp[:3], tv[:3]),
                                          ("_v4_", "slab_to_slots"), 10)
    if busy > 0:
        say(f"    profile: device busy {busy:.3f} ms/step of fwd+bwd in "
            f"{activities:.0f} device activities per step, of which the "
            f"pair and scatter kernels {ours:.3f} ms; idle share "
            f"{1 - busy / ms_grad:.3f} of the gradient's {ms_grad:.3f} ms/step {tag}")
    else:
        say("    profile: the profiler saw no device time; idle share not measured")

    # ---- 12 the product loop: two L-BFGS iterations at full width
    grads_ok = []
    chunked = driver.episode_value_and_grad_chunked

    def watched(*args, **kw):
        f = chunked(*args, **kw)

        def g(*a):
            loss, grad = f(*a)
            grads_ok.append(math.isfinite(loss) and bool(torch.isfinite(grad).all()))
            return loss, grad
        return g

    driver.episode_value_and_grad_chunked = watched
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res, hist = driver.optimize_lbfgs(
            scene, cfg_g, np.zeros(sb.n_slots), tp, tv, opt_dir=tmp,
            x_target=x_star.cpu().numpy(), maxiter=2, n_steps=S, plot=False,
            eval_chunks=EVAL_CHUNKS)
        written = sorted(os.listdir(tmp))
    t_opt = time.perf_counter() - t0
    driver.episode_value_and_grad_chunked = chunked
    counts_opt = pk.launch_counts()
    losses = hist["losses"]
    say(f"[12] L-BFGS from x = 0, maxiter 2: {res.nit} iterations, {res.nfev} "
        f"evaluations in {t_opt:.1f} s ({t_opt / res.nfev:.1f} s per evaluation, "
        f"scipy: {res.message}); "
        f"losses {[loss1] + losses} (first: x = 0); distances "
        f"{hist['distances']}; artifacts {written} {tag}")
    if not (len(losses) == 2 and losses[0] < loss1 and losses[1] < losses[0]):
        fail("two L-BFGS iterations did not strictly lower the loss")
    if not {"x.npy", "losses.json", "distances.json"} <= set(written):
        fail("the L-BFGS artifacts were not written")
    if not (grads_ok and all(grads_ok)):
        fail("a gradient of the product loop is not finite")

    # ---- 13 launch counts of the gradient path
    # symplectic: one force evaluation per step.  One gradient evaluation
    # runs each step's forces 3 times (the no-grad forward keeping chunk
    # boundaries, the chunk's recompute under autograd, the per-step
    # checkpoint's recompute in the backward) and backward once:
    #   K1, K2 forward:               3 S (one launch over every tile)
    #   K1 bwd, K2 bwd rows and slab: S (one launch over every tile)
    #   slab_to_slots:                2 S (one after K1's, one after K2's)
    per_eval = {"moments_v4": 3 * S, "forces_warp_v4": 3 * S,
                "moments_v4_bwd": S, "forces_warp_v4_bwd_rows": S,
                "forces_warp_v4_bwd_slab": S, "slab_to_slots": 2 * S}
    say(f"[13] launches of one gradient (phase 11): {counts_grad}; of the "
        f"L-BFGS run (phase 12, {res.nfev} evaluations): {counts_opt}; "
        f"expected per evaluation {per_eval}")
    for k in counts_grad:
        v = per_eval.get(k, 0)      # the fused path's kernels: none
        if counts_grad[k] != v or counts_opt[k] != res.nfev * v:
            fail(f"{k}: {counts_grad[k]} / {counts_opt[k]} launches, expected "
                 f"{v} / {res.nfev * v}")

    return {"counts_opt": counts_opt, "cfg_g": cfg_g, "tp_g": tp, "tv_g": tv,
            "x0": x0, "loss_g": loss1, "g_g": g1, "ms_grad": ms_grad,
            "scene64": scene64, "cfg64": cfg64, "tp64": tp64, "tv64": tv64,
            "x64": x64}


def phase_fused(torch, np, dev, tag, scene, cfg, x_star, stats, pos, ctx):
    """Phases 14-20: the fused K1 + mid-section path (cfg.fused_mid) at full
    width.  Returns the launch counts of one fused gradient (phase 19)."""
    from softbody_tpu_torch.ops import fused_kernels as fk
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.opt.driver import generate_targets, load_targets
    from softbody_tpu_torch.sim.rollout import (acc_float, episode_value_and_grad_chunked,
                                                initial_state, rollout, step)
    from softbody_tpu_torch.sim.sparse import elastic_forces_sparse

    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    nb = len(sb.buckets)
    n = len(scene.slot_of_particle)
    f32 = 4
    cfg_f = cfg.replace(fused_mid=True)
    ratio = ctx["ratio"]
    rng = np.random.default_rng(14)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    # ---- 14 the fused kernels vs plain, per bucket (backwards composed
    # with the scatter)
    say(f"[14] fused path, per bucket, kernels vs plain on the card {tag}")
    posT = pos.T.contiguous()
    rs = fk.row_static(sb, scene.materials, scene.rest_corr)
    scale = cfg.stiffness_scale(ratio[:m])
    fmT, srT = fk.moments_mid_all(posT, posT[:, :m], scale, sb, rs, cfg.h,
                                  cfg.corotated, pk.PLAIN)
    dayT, dfT = rand(18, m), rand(3, m)
    n_entries = sum(b.n_tiles * b.slab_len for b in sb.buckets)
    to_slots = (sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
    parts = {"F": slice(0, 9), "M": slice(9, 18), "V": slice(18, 19)}
    e0 = 0
    for i, b in enumerate(sb.buckets):
        t, slab = b.n_tiles, b.slab_len
        mb = t * sb.rows
        c = slice(b.row_start, b.row_start + mb)
        seg = slice(e0, e0 + t * slab)
        e0 += t * slab
        uniq = int(torch.unique(b.gidx8).numel()) * sb.group
        tile_bytes = (t * 3 * sb.rows + t * 5 * slab) * f32
        gidx_bytes = t * slab // sb.group * 4
        pairs = t * sb.rows * slab
        a_mid = (b.restT_rows, b.static_slab, posT, posT[:, c], rs.cols(c), scale[c],
                 b.gidx8, cfg.h, cfg.corotated)
        a_k2 = (b.restT_rows, b.static_slab, fmT[:, c], srT, b.gidx8)
        a_k6 = (b.restT_rows, b.static_slab, dayT[:, c], cfg.h)

        def slots(d, k, scatter, seg=seg):
            buf = torch.zeros((k, n_entries), dtype=torch.float32, device=dev)
            buf[:, seg] = d.permute(1, 0, 2).reshape(k, -1)
            return scatter(buf, *to_slots)

        def mid_parts(o, sc):
            fm_, sr_ = o[0], o[1]
            return ([fm_[p] for p in parts.values()]
                    + [sr_[0:6], sr_[6:15]])

        work = {   # key: (kernel, plain, outputs compared, flops, bytes)
            "moments_mid": (
                lambda: fk.moments_mid(*a_mid), lambda: fk.moments_mid_plain(*a_mid),
                mid_parts, FLOPS_PER_PAIR["moments_mid"] * pairs + MID_FLOPS_PER_ROW * mb,
                tile_bytes + gidx_bytes
                + (3 * uniq + 3 * mb + 6 * mb + 3 * mb + 9 * mb + mb + 19 * mb
                   + 15 * mb) * f32),
            "forces_warp_v2": (
                lambda: fk.forces_warp_v2(*a_k2, cfg.h),
                lambda: fk.forces_warp_v2_plain(*a_k2, cfg.h), lambda o, sc: (o,),
                FLOPS_PER_PAIR["forces_warp_v2"] * pairs,
                tile_bytes + gidx_bytes + (19 * mb + 15 * uniq + 3 * mb) * f32),
            "moments_raw_bwd": (
                lambda: fk.moments_raw_bwd(*a_k6), lambda: fk.moments_raw_bwd_plain(*a_k6),
                lambda o, sc: (slots(o, 3, sc),),
                FLOPS_PER_PAIR["moments_raw_bwd"] * pairs,
                tile_bytes + (18 * mb + 3 * t * slab) * f32),
            "forces_warp_v2_bwd_rows": (
                lambda: fk.forces_warp_v2_bwd_rows(*a_k2, dfT[:, c], cfg.h),
                lambda: fk.forces_warp_v2_bwd_plain(*a_k2, dfT[:, c], cfg.h)[0],
                lambda o, sc: (o,), FLOPS_PER_PAIR["forces_warp_v2_bwd_rows"] * pairs,
                tile_bytes + gidx_bytes + (15 * uniq + mb + 3 * mb + 19 * mb) * f32),
            "forces_warp_v2_bwd_slab": (
                lambda: fk.forces_warp_v2_bwd_slab(*a_k2, dfT[:, c], cfg.h),
                lambda: fk.forces_warp_v2_bwd_plain(*a_k2, dfT[:, c], cfg.h)[1],
                lambda o, sc: (slots(o, 15, sc),),
                FLOPS_PER_PAIR["forces_warp_v2_bwd_slab"] * pairs,
                tile_bytes + gidx_bytes
                + (9 * mb + mb + 15 * uniq + 3 * mb + 15 * t * slab) * f32),
        }
        say(" | ".join([f"    bucket {i}: slab {slab:4d} tiles {t:4d}"]
                       + held_per_launch(torch, work, f"bucket {i}", stats)))
    for key in ("moments_mid", "forces_warp_v2", "moments_raw_bwd",
                "forces_warp_v2_bwd_rows", "forces_warp_v2_bwd_slab"):
        summarize(key, stats[key], nb, tag)
    say("    (moments_mid is timed as the forward runs it, without the A | Y rows "
        "the gradient's recompute also stores; each K2 v2 pass's plain time is "
        "the whole plain K2 v2 backward)")

    # ---- 15 one fused force evaluation and its VJP
    mats = scene.materials
    f_k = elastic_forces_sparse(pos, ratio, mats, scene, cfg_f)
    f_k2 = elastic_forces_sparse(pos, ratio, mats, scene, cfg_f)
    f_p = elastic_forces_sparse(pos, ratio, mats, scene, cfg_f, pair_ops=pk.PLAIN)
    f_u = elastic_forces_sparse(pos, ratio, mats, scene, cfg)
    err_u, err_p = rel_err(f_k, f_u), rel_err(f_k, f_p)
    ct = torch.zeros_like(pos)
    ct[scene.slot_of_particle] = rand(n, 3)

    def vjp(ops):
        p = pos.clone().requires_grad_()
        xv = x_star.clone().requires_grad_()
        f = elastic_forces_sparse(p, compute_ratio(xv, cfg_f), mats, scene, cfg_f, ops)
        return torch.autograd.grad(f, (p, xv), ct)

    k1, k2, pl = vjp(pk.KERNELS), vjp(pk.KERNELS), vjp(pk.PLAIN)
    errs = [rel_err(a, b) for a, b in zip(k1, pl)]
    same = torch.equal(f_k, f_k2) and all(torch.equal(a, b) for a, b in zip(k1, k2))
    say(f"[15] fused elastic_forces_sparse: vs the unfused kernel path {err_u:.3e}, "
        f"vs the plain fused path {err_p:.3e}; its VJP wrt (pos, x) vs the plain "
        f"fused VJP {errs[0]:.3e}, {errs[1]:.3e} (of max |plain|, tol {TOL}); two "
        f"kernel-path calls bitwise equal (forces and VJP): {same}")
    if not (max([err_u, err_p] + errs) <= TOL and same
            and bool(torch.isfinite(f_k).all())
            and all(bool(torch.isfinite(a).all()) for a in k1)):
        fail("the fused force evaluation or its VJP disagrees or does not repeat")

    # ---- 16 the fused forward episode
    state = initial_state(scene, ratio, cfg)
    rounds = {
        "fused step": lambda: step(state, ratio, scene, cfg_f),
        "fused forces": lambda: elastic_forces_sparse(state.position, ratio, mats,
                                                      scene, cfg_f),
        "unfused step": lambda: step(state, ratio, scene, cfg),
    }
    best = {k: math.inf for k in rounds}
    for _ in range(5):
        for k, fn in rounds.items():
            best[k] = min(best[k], host_ms(fn, 5))
    steps = STEPS
    projected = 3 * STEPS * best["fused step"] / 1e3
    if projected > FUSED_BUDGET_S:
        steps = max(FRAMES, int(STEPS * FUSED_BUDGET_S / projected) // FRAMES * FRAMES)
        say(f"    CUT: fused episodes run {steps} steps, not {STEPS} (projected "
            f"{projected:.0f} s > {FUSED_BUDGET_S:.0f} s)")
    cfg_f = cfg_f.replace(frames=steps)
    sop = scene.slot_of_particle.cpu().numpy()
    rest = scene.rest_position
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        generate_targets(x_star, scene, cfg_f, tmp, particle_index=sop, device=dev)
        t_targets = time.perf_counter() - t0
        tp_p, tv_p = load_targets(tmp, FRAMES)
    tp = np.tile(rest.cpu().numpy(), (FRAMES, 1, 1))
    tv = np.zeros_like(tp) + np.asarray(cfg.initial_velocity)
    tp[:, sop], tv[:, sop] = tp_p, tv_p
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    acc, fin, _ = rollout(torch.zeros(sb.n_slots), scene, cfg_f, tp, tv,
                          acc_pair=True, device=dev)
    loss_f = acc_float(acc)
    t_loss = time.perf_counter() - t1
    counts_fwd = pk.launch_counts()
    ms_f = (t_targets + t_loss) * 1e3 / (2 * steps)
    say(f"[16] fused episode: {steps} steps x 2 (targets from x*: {t_targets:.1f} s "
        f"incl. {FRAMES} frames to disk; loss of x=0: {t_loss:.1f} s) -> "
        f"{ms_f:.3f} ms/step, {n * 1e3 / ms_f:.4g} particle-steps/s; unfused "
        f"(phase 5, {ctx['steps']} steps) {ctx['ms_ep']:.3f} ms/step, "
        f"{n * 1e3 / ctx['ms_ep']:.4g} particle-steps/s {tag}")
    same_depth = (f"vs the unfused {ctx['loss']:.9g} (rel "
                  f"{abs(loss_f - ctx['loss']) / ctx['loss']:.3e}, f32 summation "
                  f"orders; not gated)" if steps == ctx["steps"] else
                  f"(phase 5 ran {ctx['steps']} steps: not comparable)")
    say(f"    loss(x=0 vs x* targets) = {loss_f:.9g} {same_depth}; one step (fastest "
        f"of 5 rounds): fused {best['fused step']:.3f} ms wall, of which forces "
        f"{best['fused forces']:.3f} ms; unfused {best['unfused step']:.3f} ms")
    if not (math.isfinite(loss_f) and loss_f > 0 and np.isfinite(tp).all()
            and bool(torch.isfinite(fin.position).all())):
        fail("the fused episode produced a non-finite or zero loss / state")
    busy, activities, ours = profile_card(
        torch, ten_steps(initial_state(scene, ratio, cfg_f), ratio, scene, cfg_f),
        ("moments_mid_kernel", "forces_warp_v2_kernel"), 10)
    if busy > 0:
        say(f"    profile: device busy {busy:.3f} ms/step over 10 steps in "
            f"{activities:.0f} device activities per step, of which the two "
            f"fused pair kernels {ours:.3f} ms; idle share {1 - busy / ms_f:.3f} of "
            f"the fused episode's {ms_f:.3f} ms/step (unfused: {ctx['busy_ms']:.3f} "
            f"ms in {ctx['activities']:.0f} activities) {tag}")
    else:
        say("    profile: the profiler saw no device time; idle share not measured")

    # ---- 17 quiet body on the fused path
    quiet = cfg_f.replace(external_force=(0.0, 0.0, 0.0))
    q_scene = scene._replace(materials=mats._replace(
        external=torch.zeros_like(mats.external)))
    _, fin_q, _ = rollout(torch.zeros(sb.n_slots), q_scene, quiet, n_steps=steps,
                          device=dev)
    d = (fin_q.position - scene.rest_position)[scene.slot_of_particle]
    drift = float(torch.sqrt(torch.mean(torch.sum(d * d, dim=1))))
    say(f"[17] fused quiet body, {steps} steps: rms drift from rest {drift:.3e} m "
        f"(tol 1e-6)")
    if not drift < 1e-6:
        fail("a quiet body drifts on the fused path")

    # ---- 18 fused rollout vs the unfused kernel path (phase 6), 300 steps
    _, fin_fk, _ = rollout(x_star, scene, cfg_f, n_steps=300, device=dev)
    fin_k = ctx["fin_k"]
    dpos = float(torch.max(torch.abs(fin_fk.position - fin_k.position)))
    disp = float(torch.max(torch.abs(fin_k.position - scene.rest_position)))
    say(f"[18] 300-step rollout fused vs unfused kernel path: max|dpos| = "
        f"{dpos:.3e}, max|pos - rest| = {disp:.3e}, ratio {dpos / disp:.3e} "
        f"(tol 1e-3)")
    if not dpos <= 1e-3 * disp:
        fail("the fused rollout drifts from the unfused one")

    # ---- 19 the fused episode gradient
    S = GRAD_STEPS
    cfg_gf = ctx["cfg_g"].replace(fused_mid=True)
    tp, tv, x0 = ctx["tp_g"], ctx["tv_g"], ctx["x0"]
    vg = episode_value_and_grad_chunked(scene, cfg_gf, EVAL_CHUNKS, S)
    pk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss1, g1 = vg(x0, tp, tv)
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    counts_grad = pk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    loss2, g2 = vg(x0, tp, tv)
    ms_grad = t_grad * 1e3 / S
    gmax = float(torch.max(torch.abs(g1)))
    say(f"[19] fused episode gradient: {S} steps, {EVAL_CHUNKS} chunks, x = 0: loss "
        f"{loss1:.9g}, max |g| {gmax:.3e}; fwd+bwd {t_grad:.1f} s = {ms_grad:.3f} "
        f"ms/step, {n * S / t_grad:.4g} particle-steps/s (unfused, phase 11: "
        f"{ctx['ms_grad']:.3f} ms/step); peak device memory {peak / 2**30:.3f} GiB "
        f"{tag}")
    say(f"    vs the unfused gradient (phase 11, f32, not gated): loss rel "
        f"{abs(loss1 - ctx['loss_g']) / ctx['loss_g']:.3e}, max |dg| / max |g| "
        f"{rel_err(g1, ctx['g_g']):.3e}")
    repeat = loss1 == loss2 and torch.equal(g1, g2)
    say(f"    second fused gradient bitwise equal: {repeat}")
    if not (math.isfinite(loss1) and loss1 > 0 and gmax > 0 and repeat
            and bool(torch.isfinite(g1).all())):
        fail("the fused gradient is not finite, is zero, or does not repeat")
    P = PREFIX_STEPS
    cfg64 = ctx["cfg64"].replace(fused_mid=True)
    n_tp = P // (S // GRAD_FRAMES)
    prefix = {ops is pk.PLAIN: episode_value_and_grad_chunked(
        ctx["scene64"], cfg64, 1, P, ops)(ctx["x64"], ctx["tp64"], ctx["tv64"])
        for ops in (pk.KERNELS, pk.PLAIN)}
    (lk, gk), (lp, gp) = prefix[False], prefix[True]
    dl, dg = abs(lk - lp) / lp, rel_err(gk, gp)
    say(f"    first {P} steps ({n_tp} targets) in f64, fused kernel vs plain path: "
        f"loss {lk:.12g} vs {lp:.12g} (rel {dl:.3e}); max |dg| / max |g_plain| "
        f"{dg:.3e} (tol 1e-5 and 1e-3)")
    if not (dl <= 1e-5 and dg <= 1e-3):
        fail("the fused gradient's kernel path disagrees with its plain path")
    short = episode_value_and_grad_chunked(scene, cfg_gf, 1, 10)
    busy, activities, ours = profile_card(
        torch, lambda: short(x0, tp[:3], tv[:3]),
        ("moments_mid", "forces_warp_v2", "moments_raw_bwd", "slab_to_slots"), 10)
    if busy > 0:
        say(f"    profile: device busy {busy:.3f} ms/step of fused fwd+bwd in "
            f"{activities:.0f} device activities per step, of which the "
            f"fused pair and scatter kernels {ours:.3f} ms; idle share "
            f"{1 - busy / ms_grad:.3f} of the gradient's {ms_grad:.3f} ms/step {tag}")
    else:
        say("    profile: the profiler saw no device time; idle share not measured")

    # ---- 20 launch counts of the fused path
    # forward: one fused K1 + mid-section and one K2 v2 per bucket and step,
    # two episodes.
    # Gradient (as phase 13): forward kernels 3 times per step, backward
    # kernels once, slab_to_slots twice (after the raw K1 and the K2 v2
    # backward); none of the v4 kernels.
    fwd = {"moments_mid": 2 * nb * steps, "forces_warp_v2": 2 * nb * steps}
    per_eval = {"moments_mid": 3 * nb * S, "forces_warp_v2": 3 * nb * S,
                "moments_raw_bwd": nb * S, "forces_warp_v2_bwd_rows": nb * S,
                "forces_warp_v2_bwd_slab": nb * S, "slab_to_slots": 2 * S}
    say(f"[20] fused launches: forward episode (phase 16) {counts_fwd}; one "
        f"gradient (phase 19) {counts_grad}; expected {fwd} / {per_eval}, every "
        f"other kernel 0")
    for k in counts_fwd:
        if counts_fwd[k] != fwd.get(k, 0) or counts_grad[k] != per_eval.get(k, 0):
            fail(f"{k}: {counts_fwd[k]} / {counts_grad[k]} launches, expected "
                 f"{fwd.get(k, 0)} / {per_eval.get(k, 0)}")
    return counts_grad


def ten_steps(state, ratio, scene, cfg):
    """A function running 10 episode steps from ``state``."""
    from softbody_tpu_torch.sim.rollout import step

    def run():
        st = state
        for _ in range(10):
            st = step(st, ratio, scene, cfg)

    return run


def profile_card(torch, fn, names, per):
    """(device busy ms, device activities, ms of the kernels whose names
    contain one of ``names``), each per ``per`` units of ``fn``'s work."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    on_card = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in on_card) / 1e3 / per
    ours = sum(e.time_range.elapsed_us() for e in on_card
               if any(k in e.name for k in names)) / 1e3 / per
    return busy, len(on_card) / per, ours


def forward_phase(torch, np, dev, tag, num, label, scene, cfg_p, x_star,
                  budget_s, drift_tol, names):
    """Phases 23 and 27: a path's forward episode (generate_targets from x*,
    the sampled loss of x = 0 against those targets; ms/step, profile) and
    its quiet body, cut to ``budget_s``.  Returns (launch counts of the two
    episodes, steps, ms/step)."""
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.opt.driver import generate_targets, load_targets
    from softbody_tpu_torch.sim.rollout import acc_float, initial_state, rollout, step

    n_slots = scene.blocked.n_slots
    n = len(scene.slot_of_particle)
    ratio = compute_ratio(x_star, cfg_p)
    state = initial_state(scene, ratio, cfg_p)
    one = min(host_ms(lambda: step(state, ratio, scene, cfg_p), 3) for _ in range(3))
    steps, projected = STEPS, 3 * STEPS * one / 1e3
    if projected > budget_s:
        steps = max(FRAMES, int(STEPS * budget_s / projected) // FRAMES * FRAMES)
        say(f"    CUT: {label} episodes run {steps} steps, not {STEPS} (projected "
            f"{projected:.0f} s > {budget_s:.0f} s)")
    cfg_p = cfg_p.replace(frames=steps)
    sop = scene.slot_of_particle.cpu().numpy()
    rest = scene.rest_position
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        generate_targets(x_star, scene, cfg_p, tmp, particle_index=sop, device=dev)
        t_targets = time.perf_counter() - t0
        tp_p, tv_p = load_targets(tmp, FRAMES)
    tp = np.tile(rest.cpu().numpy(), (FRAMES, 1, 1))
    tv = np.zeros_like(tp) + np.asarray(cfg_p.initial_velocity)
    tp[:, sop], tv[:, sop] = tp_p, tv_p
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    acc, fin, _ = rollout(torch.zeros(n_slots), scene, cfg_p, tp, tv, acc_pair=True,
                          device=dev)
    loss = acc_float(acc)
    t_loss = time.perf_counter() - t1
    counts = pk.launch_counts()
    ms = (t_targets + t_loss) * 1e3 / (2 * steps)
    say(f"[{num}] {label} forward episode: {steps} steps x 2 (targets from x*: "
        f"{t_targets:.1f} s incl. {FRAMES} frames to disk; loss of x=0: {t_loss:.1f} s)"
        f" -> {ms:.3f} ms/step, {n * 1e3 / ms:.4g} particle-steps/s; one step "
        f"{one:.3f} ms wall (fastest of 3 rounds) {tag}")
    say(f"    loss(x=0 vs x* targets) = {loss:.9g}")
    if not (math.isfinite(loss) and loss > 0 and np.isfinite(tp).all()
            and bool(torch.isfinite(fin.position).all())):
        fail(f"the {label} episode produced a non-finite or zero loss / state")
    busy, acts, ours = profile_card(
        torch, ten_steps(initial_state(scene, ratio, cfg_p), ratio, scene, cfg_p),
        names, 10)
    if busy > 0:
        say(f"    profile: device busy {busy:.3f} ms/step over 10 steps in {acts:.0f} "
            f"device activities per step, of which the pair kernels {ours:.3f} ms; "
            f"idle share {1 - busy / ms:.3f} of the episode's {ms:.3f} ms/step {tag}")
    else:
        say("    profile: the profiler saw no device time; idle share not measured")
    quiet = cfg_p.replace(external_force=(0.0, 0.0, 0.0))
    q_scene = scene._replace(materials=scene.materials._replace(
        external=torch.zeros_like(scene.materials.external)))
    _, fin_q, _ = rollout(torch.zeros(n_slots), q_scene, quiet, n_steps=steps, device=dev)
    d = (fin_q.position - rest)[scene.slot_of_particle]
    drift = float(torch.sqrt(torch.mean(torch.sum(d * d, dim=1))))
    say(f"    {label} quiet body, {steps} steps: rms drift from rest {drift:.3e} m "
        f"(tol {drift_tol:g})")
    if not drift < drift_tol:
        fail(f"a quiet body drifts on the {label} path")
    return counts, steps, ms


def grad_phase(torch, np, dev, tag, num, label, scene, cfg_g, x_star, scene64,
               cfg64, names):
    """Phases 24 and 28: a path's episode gradient, GRAD_STEPS steps in
    EVAL_CHUNKS chunks at x = 0 against targets from x* (fwd+bwd ms/step,
    peak memory, a bitwise repeat, the profile) and the f64 gradient over
    NEW_PREFIX_STEPS steps, kernel vs plain path, under phase 11's gates.
    Returns (launch counts of one gradient, ms/step)."""
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.sim.rollout import episode_value_and_grad_chunked, rollout

    S, P = GRAD_STEPS, NEW_PREFIX_STEPS
    every = S // GRAD_FRAMES
    n_slots = scene.blocked.n_slots
    n = len(scene.slot_of_particle)
    with torch.no_grad():
        _, _, (tp, tv) = rollout(x_star, scene, cfg_g, n_steps=S, record_every=every,
                                 device=dev)
    x0 = torch.zeros(n_slots, device=dev)
    vg = episode_value_and_grad_chunked(scene, cfg_g, EVAL_CHUNKS, S)
    pk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss1, g1 = vg(x0, tp, tv)
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    counts = pk.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    loss2, g2 = vg(x0, tp, tv)
    ms = t_grad * 1e3 / S
    gmax = float(torch.max(torch.abs(g1)))
    repeat = loss1 == loss2 and torch.equal(g1, g2)
    say(f"[{num}] {label} episode gradient: {S} steps, {GRAD_FRAMES} frames, "
        f"{EVAL_CHUNKS} chunks, x = 0: loss {loss1:.9g}, max |g| {gmax:.3e}; fwd+bwd "
        f"{t_grad:.1f} s = {ms:.3f} ms/step, {n * S / t_grad:.4g} particle-steps/s; "
        f"peak device memory {peak / 2**30:.3f} GiB; second gradient bitwise equal: "
        f"{repeat} {tag}")
    if not (math.isfinite(loss1) and loss1 > 0 and gmax > 0 and repeat
            and bool(torch.isfinite(g1).all())):
        fail(f"the {label} gradient is not finite, is zero, or does not repeat")
    x64 = torch.zeros(n_slots, dtype=torch.float64, device=dev)
    with torch.no_grad():
        _, _, (tp64, tv64) = rollout(x_star.double(), scene64, cfg64, n_steps=P,
                                     record_every=every, device=dev)
    prefix = {ops is pk.PLAIN: episode_value_and_grad_chunked(
        scene64, cfg64, 1, P, ops)(x64, tp64, tv64) for ops in (pk.KERNELS, pk.PLAIN)}
    (lk, gk), (lp, gp) = prefix[False], prefix[True]
    dl, dg = abs(lk - lp) / lp, rel_err(gk, gp)
    say(f"    first {P} steps in f64, kernel vs plain path: loss {lk:.12g} vs "
        f"{lp:.12g} (rel {dl:.3e}); max |dg| / max |g_plain| {dg:.3e} (tol 1e-5 "
        f"and 1e-3)")
    if not (dl <= 1e-5 and dg <= 1e-3):
        fail(f"the {label} gradient's kernel path disagrees with its plain path")
    short = episode_value_and_grad_chunked(scene, cfg_g, 1, 10)
    busy, acts, ours = profile_card(torch, lambda: short(x0, tp[:3], tv[:3]),
                                    names + ("slab_to_slots",), 10)
    if busy > 0:
        say(f"    profile: device busy {busy:.3f} ms/step of fwd+bwd in {acts:.0f} "
            f"device activities per step, of which the pair and scatter kernels "
            f"{ours:.3f} ms; idle share {1 - busy / ms:.3f} of the gradient's "
            f"{ms:.3f} ms/step {tag}")
    else:
        say("    profile: the profiler saw no device time; idle share not measured")
    return counts, ms


def held_per_launch(torch, work, prefix, stats=None, reps=20):
    """Each kernel of ``work`` (key: (kernel, plain, outputs compared,
    flops, bytes)) against its plain version on the same inputs; its ms per
    launch, plain ms and bound.  Into ``stats[key]`` when given.  Returns the
    line's parts."""
    from softbody_tpu_torch.ops import pair_kernels as pk

    line = []
    for key, (kern, plain, outs, flops, nbytes) in work.items():
        got = outs(kern(), pk.slab_to_slots)
        want = outs(plain(), pk.slab_to_slots_plain)
        torch.cuda.synchronize()
        s = stats[key] if stats is not None else {"max_abs_err": 0.0, "max_rel_err": 0.0}
        err = max(record(s, g, w, f"{key} {prefix}") for g, w in zip(got, want))
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, 1)
        bound = max(flops / PEAK_FP32, nbytes / PEAK_BYTES) * 1e3
        if stats is not None:
            s["ms"] += ms
            s["launch_ms"] += host_ms(kern, reps)
            s["plain_ms"] += plain_ms
            s["flops"] += flops
            s["bytes"] += nbytes
        line.append(f"{key} err {err:.2e} {ms:.4f} ms (plain {plain_ms:.2f}, bound "
                    f"{bound:.4f})")
    return line


def phase_taichi(torch, np, dev, tag, scene, cfg, x_star, stats, pos, ctx):
    """Phases 21-24: path A, the Taichi pairing (pair_def_grad="j") on the
    sparse scene.  Returns the launch counts of its forward episodes and of
    one gradient."""
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops import separable_kernels as sk
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.sim.blocked import mid_section
    from softbody_tpu_torch.sim.sparse import elastic_forces_sparse, slot_rows

    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    n = len(scene.slot_of_particle)
    f32 = 4
    cfg_j = cfg.replace(pair_def_grad="j")
    ratio = ctx["ratio"]
    rng = np.random.default_rng(21)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    # ---- 21 the separable K2 and its backward vs plain, per bucket
    say(f"[21] Taichi pairing (path A), per bucket, kernels vs plain on the card {tag}")
    posT = pos.T.contiguous()
    ayT = pk.moments_all(posT, posT[:, :m], sb, cfg.h, pk.PLAIN)
    A = [[ayT[3 * b + a] for b in range(3)] for a in range(3)]
    Y = [[ayT[9 + 3 * b + a] for b in range(3)] for a in range(3)]
    _, _, _, M, vol_m = mid_section(A, Y, ratio, scene.materials, scene, cfg_j, m)
    gT = slot_rows([vol_m * M[a][b] for a in range(3) for b in range(3)], sb.n_slots)
    dfT = rand(3, m)
    n_entries = sum(b.n_tiles * b.slab_len for b in sb.buckets)
    to_slots = (sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
    e0 = 0
    for i, b in enumerate(sb.buckets):
        t, slab = b.n_tiles, b.slab_len
        mb = t * sb.rows
        c = slice(b.row_start, b.row_start + mb)
        seg = slice(e0, e0 + t * slab)
        e0 += t * slab
        uniq = int(torch.unique(b.gidx8).numel()) * sb.group
        tile_bytes = (t * 3 * sb.rows + t * 5 * slab) * f32
        gidx_bytes = t * slab // sb.group * 4
        pairs = t * sb.rows * slab
        a_f = (b.restT_rows, b.static_slab, gT[:, c], gT, vol_m[c], b.gidx8, cfg.h)
        a_b = (b.restT_rows, b.static_slab, vol_m[c], dfT[:, c], cfg.h)

        def slots(d, k, scatter, seg=seg):
            buf = torch.zeros((k, n_entries), dtype=torch.float32, device=dev)
            buf[:, seg] = d.permute(1, 0, 2).reshape(k, -1)
            return scatter(buf, *to_slots)

        work = {
            "forces_sep": (
                lambda: sk.forces_sep(*a_f), lambda: sk.forces_sep_plain(*a_f),
                lambda o, sc: (o,), FLOPS_PER_PAIR["forces_sep"] * pairs,
                tile_bytes + gidx_bytes + (9 * uniq + 9 * mb + mb + 3 * mb) * f32),
            "forces_sep_bwd_rows": (
                lambda: sk.forces_sep_bwd_rows(*a_b),
                lambda: sk.forces_sep_bwd_plain(*a_b)[0], lambda o, sc: (o,),
                FLOPS_PER_PAIR["forces_sep_bwd_rows"] * pairs,
                tile_bytes + (mb + 3 * mb + 9 * mb) * f32),
            "forces_sep_bwd_slab": (
                lambda: sk.forces_sep_bwd_slab(*a_b),
                lambda: sk.forces_sep_bwd_plain(*a_b)[1],
                lambda o, sc: (slots(o, 9, sc),),
                FLOPS_PER_PAIR["forces_sep_bwd_slab"] * pairs,
                tile_bytes + (mb + 3 * mb + 9 * t * slab) * f32),
        }
        say(" | ".join([f"    bucket {i}: slab {slab:4d} tiles {t:4d}"]
                       + held_per_launch(torch, work, f"bucket {i}", stats)))
    for key in ("forces_sep", "forces_sep_bwd_rows", "forces_sep_bwd_slab"):
        summarize(key, stats[key], len(sb.buckets), tag)

    # ---- 22 one "j" force evaluation and its VJP
    mats = scene.materials
    f_k = elastic_forces_sparse(pos, ratio, mats, scene, cfg_j)
    f_k2 = elastic_forces_sparse(pos, ratio, mats, scene, cfg_j)
    f_p = elastic_forces_sparse(pos, ratio, mats, scene, cfg_j, pair_ops=pk.PLAIN)
    f_fm = elastic_forces_sparse(pos, ratio, mats, scene, cfg_j.replace(fused_mid=True))
    err = rel_err(f_k, f_p)
    ct = torch.zeros_like(pos)
    ct[scene.slot_of_particle] = rand(n, 3)

    def vjp(ops):
        p = pos.clone().requires_grad_()
        xv = x_star.clone().requires_grad_()
        f = elastic_forces_sparse(p, compute_ratio(xv, cfg_j), mats, scene, cfg_j, ops)
        return torch.autograd.grad(f, (p, xv), ct)

    k1, k2, pl = vjp(pk.KERNELS), vjp(pk.KERNELS), vjp(pk.PLAIN)
    errs = [rel_err(a, b) for a, b in zip(k1, pl)]
    same = torch.equal(f_k, f_k2) and all(torch.equal(a, b) for a, b in zip(k1, k2))
    fused_same = torch.equal(f_fm, f_k)
    say(f"[22] Taichi-pairing elastic_forces_sparse kernel vs plain: {err:.3e}; its "
        f"VJP wrt (pos, x) {errs[0]:.3e}, {errs[1]:.3e} (of max |plain|, tol {TOL}); "
        f"two kernel-path calls bitwise equal (forces and VJP): {same}; "
        f"fused_mid=True + \"j\" equals \"j\": {fused_same}")
    if not (max([err] + errs) <= TOL and same and fused_same
            and bool(torch.isfinite(f_k).all())
            and all(bool(torch.isfinite(a).all()) for a in k1)):
        fail("the Taichi-pairing force evaluation or its VJP disagrees or does not repeat")

    # ---- 23, 24 path A's forward episode, quiet body and gradient
    names = ("moments_v4", "forces_sep")
    counts_fwd, steps, ms = forward_phase(torch, np, dev, tag, 23, "Taichi-pairing",
                                          scene, cfg_j, x_star, NEW_BUDGET_S, 1e-6,
                                          names)
    counts_grad, ms_grad = grad_phase(
        torch, np, dev, tag, 24, "Taichi-pairing", scene, ctx["cfg_g"].replace(
            pair_def_grad="j"), x_star, ctx["scene64"],
        ctx["cfg64"].replace(pair_def_grad="j"), names)
    return {"fwd": counts_fwd, "grad": counts_grad, "steps": steps,
            "nb": len(sb.buckets)}


def phase_blocked(torch, np, dev, tag, pts, out_num, scene, cfg, x_star, stats,
                  body, ctx):
    """Phases 25-28: path B, the blocked varcol layout on the pallas
    backend, at the same body.  Returns the launch counts of its forward
    episodes and of one gradient."""
    from softbody_tpu_torch.ops import fused_kernels as fk
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops import separable_kernels as sk
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.scenarios import dirichlet_mask, x_star_bands
    from softbody_tpu_torch.sim.blocked import (build_blocked_scene,
                                                elastic_forces_pallas, mid_section)
    from softbody_tpu_torch.sim.sparse import elastic_forces_sparse, slot_rows

    f32 = 4
    rng = np.random.default_rng(25)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    # ---- 25 the varcol scene, its kernels per launch
    t0 = time.perf_counter()
    scene_b, sop_b = build_blocked_scene(pts, cfg, out_num=out_num, device=dev,
                                         dirichlet_mask=dirichlet_mask(pts, "stretch"))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    blk = scene_b.blocked
    b = blk.bucket
    t, slab, rows = blk.n_tiles, blk.slab_len, blk.rows
    m = t * rows
    pairs = t * rows * slab
    sparse_pairs = sum(bb.n_tiles * scene.blocked.rows * bb.slab_len
                       for bb in scene.blocked.buckets)
    static = [b.restT_rows, b.static_slab, b.gidx8, blk.slab_start, blk.rs6T,
              blk.slab_ptr, blk.slab_idx, scene_b.rest_corr, scene_b.rest_position,
              *scene_b.materials]
    static_bytes = sum(x.numel() * x.element_size() for x in static)
    say(f"[25] varcol scene of the same body: build {t_build:.1f} s; n_tiles {t} "
        f"(of {rows} rows), run length L {blk.run_len}, slab_len {slab}, slots "
        f"{blk.n_slots}, candidate pairs per evaluation {pairs} (sparse scene: "
        f"{sparse_pairs}, x{pairs / sparse_pairs:.2f}), static bytes "
        f"{static_bytes / 1e6:.1f} MB, scatter index {blk.slab_idx.numel()} live "
        f"group entries of {b.gidx8.numel()} {tag}")
    x_b = torch.as_tensor(x_star_bands(pts, blk.n_slots, sop_b), dtype=torch.float32,
                          device=dev)
    ratio_b = compute_ratio(x_b, cfg)
    pos_b = scene_b.rest_position.clone()
    pos_b[scene_b.slot_of_particle] = torch.as_tensor(body, dtype=torch.float32,
                                                      device=dev)
    posT = pos_b.T.contiguous()
    ayT = fk.moments_raw_all(posT, blk, cfg.h, pk.PLAIN)
    p = posT[:, :m]
    A = [[ayT[3 * bb + a] - p[a] * blk.rs6T[bb] for bb in range(3)] for a in range(3)]
    Y = [[ayT[9 + 3 * bb + a] - p[a] * blk.rs6T[3 + bb] for bb in range(3)]
         for a in range(3)]
    R, F, S, M, vol_m = mid_section(A, Y, ratio_b, scene_b.materials, scene_b, cfg, m)
    fmT = torch.stack([F[a][c] for a in range(3) for c in range(3)]
                      + [M[a][c] for a in range(3) for c in range(3)] + [vol_m])
    srT = slot_rows([S[0][0], S[0][1], S[0][2], S[1][1], S[1][2], S[2][2]]
                    + [R[a][c] for c in range(3) for a in range(3)], blk.n_slots)
    gT = slot_rows([vol_m * M[a][c] for a in range(3) for c in range(3)], blk.n_slots)
    dayT, dfT = rand(18, m), rand(3, m)
    to_slots = (blk.slab_ptr, blk.slab_idx, blk.n_slots, blk.group)
    uniq = int(torch.unique(b.gidx8).numel()) * blk.group
    tile_bytes = (t * 3 * rows + t * 5 * slab) * f32
    gidx_bytes = t * slab // blk.group * 4
    rr, st, gi, h = b.restT_rows, b.static_slab, b.gidx8, cfg.h

    def slots(k):
        return lambda d, sc: (sc(d.permute(1, 0, 2).reshape(k, -1), *to_slots),)

    work = {
        "moments_raw": (
            lambda: fk.moments_raw(rr, st, posT, gi, h),
            lambda: fk.moments_raw_plain(rr, st, posT, gi, h), lambda o, sc: (o,),
            FLOPS_PER_PAIR["moments_raw"] * pairs,
            tile_bytes + gidx_bytes + (3 * uniq + 18 * m) * f32),
        "moments_raw_bwd": (
            lambda: fk.moments_raw_bwd(rr, st, dayT, h),
            lambda: fk.moments_raw_bwd_plain(rr, st, dayT, h), slots(3),
            FLOPS_PER_PAIR["moments_raw_bwd"] * pairs,
            tile_bytes + (18 * m + 3 * t * slab) * f32),
        "forces_warp_v2": (
            lambda: fk.forces_warp_v2(rr, st, fmT, srT, gi, h),
            lambda: fk.forces_warp_v2_plain(rr, st, fmT, srT, gi, h),
            lambda o, sc: (o,), FLOPS_PER_PAIR["forces_warp_v2"] * pairs,
            tile_bytes + gidx_bytes + (19 * m + 15 * uniq + 3 * m) * f32),
        "forces_warp_v2_bwd_rows": (
            lambda: fk.forces_warp_v2_bwd_rows(rr, st, fmT, srT, gi, dfT, h),
            lambda: fk.forces_warp_v2_bwd_plain(rr, st, fmT, srT, gi, dfT, h)[0],
            lambda o, sc: (o,), FLOPS_PER_PAIR["forces_warp_v2_bwd_rows"] * pairs,
            tile_bytes + gidx_bytes + (15 * uniq + m + 3 * m + 19 * m) * f32),
        "forces_warp_v2_bwd_slab": (
            lambda: fk.forces_warp_v2_bwd_slab(rr, st, fmT, srT, gi, dfT, h),
            lambda: fk.forces_warp_v2_bwd_plain(rr, st, fmT, srT, gi, dfT, h)[1],
            slots(15), FLOPS_PER_PAIR["forces_warp_v2_bwd_slab"] * pairs,
            tile_bytes + gidx_bytes + (10 * m + 15 * uniq + 3 * m + 15 * t * slab) * f32),
        "forces_sep": (
            lambda: sk.forces_sep(rr, st, gT[:, :m], gT, vol_m, gi, h),
            lambda: sk.forces_sep_plain(rr, st, gT[:, :m], gT, vol_m, gi, h),
            lambda o, sc: (o,), FLOPS_PER_PAIR["forces_sep"] * pairs,
            tile_bytes + gidx_bytes + (9 * uniq + 9 * m + m + 3 * m) * f32),
        "forces_sep_bwd_rows": (
            lambda: sk.forces_sep_bwd_rows(rr, st, vol_m, dfT, h),
            lambda: sk.forces_sep_bwd_plain(rr, st, vol_m, dfT, h)[0],
            lambda o, sc: (o,), FLOPS_PER_PAIR["forces_sep_bwd_rows"] * pairs,
            tile_bytes + (m + 3 * m + 9 * m) * f32),
        "forces_sep_bwd_slab": (
            lambda: sk.forces_sep_bwd_slab(rr, st, vol_m, dfT, h),
            lambda: sk.forces_sep_bwd_plain(rr, st, vol_m, dfT, h)[1], slots(9),
            FLOPS_PER_PAIR["forces_sep_bwd_slab"] * pairs,
            tile_bytes + (m + 3 * m + 9 * t * slab) * f32),
    }
    say(f"    per launch on the varcol tiles, kernel vs plain {tag}:")
    for key in work:
        one = {key: work[key]}
        into = stats if key == "moments_raw" else None
        say("      " + held_per_launch(torch, one, "varcol", into, reps=10)[0])
    if stats["moments_raw"]["ms"]:
        summarize("moments_raw", stats["moments_raw"], 1, tag)
    n_entries = t * slab
    line = []
    for k in (3, 9, 15):
        buf = rand(k, n_entries)
        err = rel_err(pk.slab_to_slots(buf, *to_slots), pk.slab_to_slots_plain(buf, *to_slots))
        if not err <= TOL:
            fail(f"slab_to_slots on the varcol index, k={k}: error {err:.3e}")
        line.append(f"k={k} err {err:.2e} {cuda_ms(lambda: pk.slab_to_slots(buf, *to_slots), 10):.4f} ms")
    say("      slab_to_slots on the varcol index: " + ", ".join(line))

    # ---- 26 one path-B evaluation against the sparse path, and its VJP
    ratio_s = ctx["ratio"]
    mats = scene_b.materials
    ct = torch.zeros_like(pos_b)
    ct[scene_b.slot_of_particle] = rand(len(sop_b), 3)
    sop_s, sop_bt = scene.slot_of_particle, scene_b.slot_of_particle
    for pdg in ("i", "j"):
        c = cfg.replace(pair_def_grad=pdg)
        f_b = elastic_forces_pallas(pos_b, ratio_b, mats, scene_b, c)
        f_b2 = elastic_forces_pallas(pos_b, ratio_b, mats, scene_b, c)
        f_bp = elastic_forces_pallas(pos_b, ratio_b, mats, scene_b, c, pk.PLAIN)
        f_s = elastic_forces_sparse(ctx["pos"], ratio_s, scene.materials, scene, c)
        cross = rel_err(f_b[sop_bt], f_s[sop_s])
        own = rel_err(f_b, f_bp)

        def vjp(ops):
            pp = pos_b.clone().requires_grad_()
            xv = x_b.clone().requires_grad_()
            f = elastic_forces_pallas(pp, compute_ratio(xv, c), mats, scene_b, c, ops)
            return torch.autograd.grad(f, (pp, xv), ct)

        k1, pl = vjp(pk.KERNELS), vjp(pk.PLAIN)
        errs = [rel_err(a, bb) for a, bb in zip(k1, pl)]
        ignored = (torch.equal(elastic_forces_pallas(pos_b, ratio_b, mats, scene_b,
                                                     c.replace(fused_mid=True)), f_b)
                   if pdg == "i" else True)
        say(f"[26] path B (varcol, pallas) \"{pdg}\": vs the sparse path at the same "
            f"particle positions {cross:.3e} of max |f| (tol 1e-3); kernel vs plain "
            f"{own:.3e}, VJP wrt (pos, x) {errs[0]:.3e}, {errs[1]:.3e} (tol {TOL}); "
            f"bitwise repeat {torch.equal(f_b, f_b2)}"
            + ("; fused_mid ignored (bitwise equal forces): " + str(ignored)
               if pdg == "i" else ""))
        if not (cross <= 1e-3 and max([own] + errs) <= TOL and torch.equal(f_b, f_b2)
                and ignored and bool(torch.isfinite(f_b).all())
                and all(bool(torch.isfinite(a).all()) for a in k1)):
            fail(f"path B \"{pdg}\" disagrees with the sparse path or its plain path")

    # ---- 27, 28 path B's forward episode, quiet body and gradient
    names = ("moments_raw", "forces_warp_v2")
    counts_fwd, steps, ms = forward_phase(torch, np, dev, tag, 27, "varcol",
                                          scene_b, cfg, x_b, NEW_BUDGET_S, 1e-4, names)
    cfg64 = ctx["cfg64"]
    scene_b64, _ = build_blocked_scene(pts, cfg64, out_num=out_num, device=dev,
                                       dirichlet_mask=dirichlet_mask(pts, "stretch"))
    counts_grad, ms_grad = grad_phase(torch, np, dev, tag, 28, "varcol", scene_b,
                                      ctx["cfg_g"], x_b, scene_b64, cfg64, names)
    return {"fwd": counts_fwd, "grad": counts_grad, "steps": steps}


def phase_counts(a, b):
    """Phase 29: the launch counts of phases 23-24 (path A) and 27-28 (path
    B) against what each path implies; every other kernel 0."""
    S, nb = GRAD_STEPS, a["nb"]
    # symplectic: one force evaluation per step, two forward episodes; one
    # gradient runs the forward kernels 3 times per step and the backward
    # ones once (phase 13)
    want = {
        ("A", "fwd"): {"moments_v4": 2 * a["steps"], "forces_sep": 2 * nb * a["steps"]},
        ("A", "grad"): {"moments_v4": 3 * S, "forces_sep": 3 * nb * S,
                        "moments_v4_bwd": S, "forces_sep_bwd_rows": nb * S,
                        "forces_sep_bwd_slab": nb * S, "slab_to_slots": 2 * S},
        ("B", "fwd"): {"moments_raw": 2 * b["steps"], "forces_warp_v2": 2 * b["steps"]},
        ("B", "grad"): {"moments_raw": 3 * S, "forces_warp_v2": 3 * S,
                        "moments_raw_bwd": S, "forces_warp_v2_bwd_rows": S,
                        "forces_warp_v2_bwd_slab": S, "slab_to_slots": 2 * S},
    }
    got = {("A", "fwd"): a["fwd"], ("A", "grad"): a["grad"],
           ("B", "fwd"): b["fwd"], ("B", "grad"): b["grad"]}
    say(f"[29] launches: path A forward (phase 23) {a['fwd']}; path A gradient "
        f"(phase 24) {a['grad']}; path B forward (phase 27) {b['fwd']}; path B "
        f"gradient (phase 28) {b['grad']}; expected "
        + "; ".join(f"{p} {k}: {w}" for (p, k), w in want.items()) + "; every other 0")
    for run, counts in got.items():
        for k, v in counts.items():
            if v != want[run].get(k, 0):
                fail(f"{run}: {k} launched {v} times, expected {want[run].get(k, 0)}")


REPLACES = {   # kernel -> (its source here, the Pallas body it replaces)
    "moments_v4": ("pair_kernels", "pair_kernels.py:505"),
    "forces_warp_v4": ("pair_kernels", "pair_kernels.py:879"),
    "moments_v4_bwd": ("pair_kernels", "pair_kernels.py:564"),
    "forces_warp_v4_bwd_rows": ("pair_kernels", "pair_kernels.py:1038"),
    "forces_warp_v4_bwd_slab": ("pair_kernels", "pair_kernels.py:1038"),
    "slab_to_slots": ("pair_kernels", "packed.py:212"),
    "moments_mid": ("fused_kernels", "pair_kernels.py:602"),
    "forces_warp_v2": ("fused_kernels", "pair_kernels.py:822"),
    "moments_raw_bwd": ("fused_kernels", "pair_kernels.py:335"),
    "forces_warp_v2_bwd_rows": ("fused_kernels", "pair_kernels.py:936"),
    "forces_warp_v2_bwd_slab": ("fused_kernels", "pair_kernels.py:936"),
    "forces_sep": ("separable_kernels", "pair_kernels.py:690"),
    "forces_sep_bwd_rows": ("separable_kernels", "pair_kernels.py:716"),
    "forces_sep_bwd_slab": ("separable_kernels", "pair_kernels.py:716"),
    "moments_raw": ("fused_kernels", "pair_kernels.py:307"),
}


def kernel_json(stats, launches):
    """The kernels line: each kernel's numbers, ``launches`` from its path's
    gradient runs (phase 12's L-BFGS loop for the v4 path, phase 19's
    gradient for the fused path, phase 24's for the separable K2, phase
    28's for the raw K1)."""
    kernels = []
    for key, s in stats.items():
        source, body = REPLACES[key]
        kernels.append({
            "name": key,
            "route": "cuda",
            "source": f"softbody_tpu_torch/csrc/{source}.cu",
            "replaces": f"softbody_tpu/ops/pallas/{body}",
            "launches": launches[key],
            "max_abs_err": s["max_abs_err"],
            "ms": s["ms"],
            "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"],
            "bound_by": s["bound_by"],
            "library_ms": s["library_ms"],
        })
    return kernels


if __name__ == "__main__":
    main()
