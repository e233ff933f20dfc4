#!/usr/bin/env python3
"""Quickest proof that the PyTorch port (softbody_tpu_torch) runs on the GPU.

Drives the port's main path on one CUDA card at full width — the ~112k
particle "stretch" inverse-design scene (fit_body(100000), STRETCH physics,
top-15% Dirichlet clamp, f32) — and holds every hand-written kernel on that
path against its plain PyTorch version.  Phases, each printed as it runs:

  1  the card (nvidia-smi name and power limit)
  2  kernel build (nvcc, from csrc/ in this checkout); the whole-scene
     kernels' (K1/K2 v4 forward and their backwards, K2 v2 and its
     backward passes, the fused K1 + mid-section, the raw K1 backward, the
     separable K2 and its backward) registers, shared memory, spills and
     resident blocks per SM, f32 and f64
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

 14  the fused K1 + mid-section path (cfg.fused_mid): the fused
     moments_mid and the raw K1 backward moments_raw_bwd with its row term,
     K2 forces_warp_v2 and its two backward passes, one launch each over
     every tile, each bucket's columns vs that bucket's plain version
     (<= 1e-4 of max |plain|; the records' parts F, M, V, S, R each on its
     own, srT's padding columns zero; the slab sides composed with
     slab_to_slots), a bitwise repeat, ms per evaluation, the work's
     bound
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
     implies (each of its kernels one launch per evaluation; none of the
     v4 kernels, K1/K2 and their backwards)

 21  path A, the Taichi pairing (pair_def_grad="j") on the sparse scene:
     the separable K2 forces_sep and its backward forces_sep_bwd, one
     launch each over every tile, each bucket's columns vs that bucket's
     plain version (<= 1e-4 of max |plain|; the backward's slab side
     composed with slab_to_slots plus its row term), a bitwise repeat, ms
     per evaluation, the work's bound
 22  one "j" force evaluation and its VJP wrt (positions, x), kernel path
     vs plain path (<= 1e-4), both bitwise equal across two calls;
     fused_mid=True with "j" equals "j" bit for bit
 23  path A's forward episode (generate_targets from x*, the loss of
     x = 0): ms/step, particle-steps/s, the profiler's activities per step
     and idle share; its quiet body, rms drift < 1e-6 m (both cut to
     NEW_BUDGET_S, the cut printed)
 24  path A's gradient, GRAD_STEPS steps in EVAL_CHUNKS chunks: fwd+bwd
     ms/step, peak memory, a bitwise repeat, the f64 gradient over
     PREFIX_STEPS steps kernel vs plain under phase 11's gates
 25  path B, the blocked varcol layout of the same body on the pallas
     backend: its build seconds, n_tiles, run length L, slab_len,
     candidate pairs per evaluation (beside the sparse scene's) and static
     bytes; per launch on its tiles the raw K1 moments_raw and its
     backward moments_raw_bwd (one launch over the scene, its last
     128-entry chunk partial; composed with slab_to_slots), kernel vs plain
     (<= 1e-4), ms per launch, bound; K2 forces_warp_v2 and its passes as
     in phase 14 and forces_sep and its backward as in phase 21, on the
     slab of 1,944 entries whose last 32- and 128-entry pieces are
     partial
 26  one path-B evaluation for "i" and "j" against the sparse path at the
     same particle positions (<= 1e-3 of max |f|: the uncentered f32 raw
     dots add noise the centered sparse path lacks), and against its own
     plain path, forces and VJP wrt (positions, x) (<= 1e-4); bitwise
     repeat; one launch of its K2 and of its K2 backward in that VJP;
     fused_mid is ignored, as in the JAX package
 27  path B's forward episode and quiet body, as phase 23, the quiet-body
     gate rms drift < 1e-4 m (uncentered true-f32 raw dots)
 28  path B's gradient, as phase 24
 29  the launch counts of phases 23-24 and 27-28 against what each path
     implies: no kernel of another path runs

 30  the gather backend (build_scene, its (N, K) tables; no K-nearest
     truncation): build seconds, K, real pairs, table bytes; one
     evaluation against the sparse kernel path at the same positions,
     <= 1e-4 of max |f| in f32 and <= 1e-9 in f64
 31  the gather forward episode and quiet body, as phase 23 (cut to
     NEW_BUDGET_S; no pair kernel may launch); 300 steps against phase 6's
     sparse kernel rollout (<= 1e-3 max |pos - rest|); the CLI's
     configuration (warp_parity: trapezoidal, dt 1e-6, the ground with its
     damper), set through update_materials, finite
 32  the gather gradient, as phase 24 (bitwise repeat, peak memory,
     profile); its f64 gradient over PREFIX_STEPS steps against the
     sparse kernel path's: loss <= 1e-9 relative, max |dg| <= 1e-6 of
     max |g|
 33  the DROP scenario (drop_gap, scale_mass_for_resolution) on the sparse
     kernel path with a sphere, a box and a plane obstacle and a dynamic
     contact grid excluding the rest table in slot space (contact_check
     on): the forward episode cut to NEW_BUDGET_S, every recorded state
     finite, no overflow, K1/K2 one launch per step; contact_forces_query
     on 4,096 rows against the all-pairs law over every particle (<= 1e-5
     of max |f|, with and without the exclude table); one GRAD_STEPS
     gradient, finite, bitwise repeatable, phase 13's launch counts; a
     full-size seeded DeepSDF obstacle (3 -> 1024 x 8 -> 1): penalty_force
     over every slot and its VJP, ms and finite
 34  optimize_adam on the main path: 3 steps of GRAD_STEPS-step episodes;
     2 steps, a resume and 1 step bitwise equal to them; losses finite,
     distances.json one entry per step

Each phase's first line ends with the seconds since the start.  Then one
JSON line with every kernel's numbers (``launches`` from phase 12, the
product loop, for the v4 path's kernels and the scatter; from phase 19, one
fused gradient evaluation, for the fused path's; from phases 24 and 28, one
gradient each, for the separable K2 and the raw K1; ms per force
evaluation on the sparse scene, one launch each, but the raw K1's, per
launch on the varcol scene),
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
PREFIX_STEPS = 15          # the f64 gradient prefixes, phases 11, 19, 24, 28, 32 (5 frames)
EVAL_CHUNKS = 3
PEAK_FP32 = 67e12          # H100 SXM FP32 without tensor cores (data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# K2 v2 and its passes run K2 v4's pair loops (svnw is the scene's static
# row sums, not a per-pair sum, as in the separable K2 and its backward),
# moments_mid K1 v4's and moments_raw_bwd the K1 v4 backward's; their
# per-row epilogues add < 0.1% (moments_mid's mid-section is counted on
# its own)
FLOPS_PER_PAIR = {"moments_v4": 72, "forces_warp_v4": 74,   # as the kernels do them
                  "moments_v4_bwd": 67, "forces_warp_v4_bwd_rows": 71,
                  "forces_warp_v4_bwd_slab": 118,
                  "moments_mid": 72, "forces_warp_v2": 74, "moments_raw_bwd": 67,
                  "forces_warp_v2_bwd_rows": 71, "forces_warp_v2_bwd_slab": 118,
                  "forces_sep": 43, "forces_sep_bwd": 42, "moments_raw": 72}
# moments_mid's per-row epilogue, counted from csrc/mid.cuh: A | Y from the
# warp sums (180), A^T A (45), 24 Jacobi rotations (~68 each), the SVD's U
# and R = U V^T (~180), R^T Y, F, E, S and M = R F S (~240)
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
        f"steps ({GRAD_FRAMES} frames); the f64 gradient prefixes (kernel vs plain "
        f"in phases 11, 19, 24 and 28, gather vs sparse in 32) {PREFIX_STEPS} steps "
        f"(phases 11 and 19 ran 99, 24 and 28 ran 30, before phases 30-34 were "
        f"added); the forward phases are cut to budgets of {TIME_BUDGET_S:.0f} s (default path), "
        f"{FUSED_BUDGET_S:.0f} s (fused) and {NEW_BUDGET_S:.0f} s (each of paths A "
        f"and B, the gather path and the drop scenario), each cut printed; width "
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
    scene_g = phase_gather(torch, np, dev, tag, pts, out_num, scene, sop, cfg, x_star,
                           body, ctx)
    phase_drop(torch, np, dev, tag, pts, out_num, scene_g, cfg)
    del scene_g
    phase_adam(torch, np, dev, tag, scene, x_star, ctx)
    fused_path = ("moments_mid", "forces_warp_v2", "moments_raw_bwd",
                  "forces_warp_v2_bwd_rows", "forces_warp_v2_bwd_slab")
    launches = {**ctx["counts_opt"], **{k: counts_fused[k] for k in fused_path},
                **{k: path_a["grad"][k] for k in ("forces_sep", "forces_sep_bwd")},
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
    n = len(scene.slot_of_particle)
    f32 = 4
    cfg_f = cfg.replace(fused_mid=True)
    ratio = ctx["ratio"]
    rng = np.random.default_rng(14)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    # ---- 14 the fused kernels: one launch each over the scene, each
    # bucket's columns held against that bucket's plain version (the slab
    # sides composed with the scatter)
    say(f"[14] fused path: moments_mid, moments_raw_bwd (with its row term), K2 v2 and "
        f"its backward passes, one launch each over all {sb.n_tiles} tiles, kernels vs "
        f"plain per bucket on the card {tag}")
    posT = pos.T.contiguous()
    rs = fk.row_static(sb, scene.materials, scene.rest_corr)
    scale = cfg.stiffness_scale(ratio[:m])
    fmT, srT = fk.moments_mid_all(posT, posT[:, :m], scale, sb, rs, cfg.h,
                                  cfg.corotated, pk.PLAIN)
    dayT, dfT = rand(18, m), rand(3, m)
    n_entries = pk.n_entries(sb)
    to_slots = (sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
    parts = {"F": slice(0, 9), "M": slice(9, 18), "V": slice(18, 19)}

    def launch():
        return (fk.moments_mid(sb, posT, posT[:, :m], rs, scale, cfg.h, cfg.corotated),
                fk.moments_raw_bwd(sb, dayT, cfg.h, True))

    pk.reset_launch_counts()
    (k_fm, k_sr, _), (k_dps, k_dprow) = launch()
    torch.cuda.synchronize()
    counts = pk.launch_counts()
    if counts["moments_mid"] != 1 or counts["moments_raw_bwd"] != 1:
        fail(f"moments_mid / moments_raw_bwd launched {counts['moments_mid']} / "
             f"{counts['moments_raw_bwd']} times for one evaluation, expected 1 / 1")
    if k_sr[:, m:].any():
        fail("moments_mid left srT's padding columns non-zero")
    ct6 = dayT.view(6, 3, m)
    p_dprow = -sum(ct6[k] * sb.rs6T[k] for k in range(6))   # the plain row side

    def slots(d, k, scatter, seg):
        buf = torch.zeros((k, n_entries), dtype=torch.float32, device=dev)
        buf[:, seg] = d
        return scatter(buf, *to_slots)

    e0 = 0
    for i, b in enumerate(sb.buckets):
        t, slab = b.n_tiles, b.slab_len
        c = slice(b.row_start, b.row_start + t * sb.rows)
        seg = slice(e0, e0 + t * slab)
        e0 += t * slab
        a_mid = (b.restT_rows, b.static_slab, posT, posT[:, c], rs.cols(c), scale[c],
                 b.gidx8, cfg.h, cfg.corotated)
        a_k6 = (b.restT_rows, b.static_slab, dayT[:, c], cfg.h)
        p_fm, p_sr, _ = fk.moments_mid_plain(*a_mid)
        e1 = max([record(stats["moments_mid"], k_fm[p, c], p_fm[p],
                         f"moments_mid {name} bucket {i}") for name, p in parts.items()]
                 + [record(stats["moments_mid"], k_sr[p, c], p_sr[p],
                           f"moments_mid {name} bucket {i}")
                    for name, p in (("S", slice(0, 6)), ("R", slice(6, 15)))])
        p_dps = fk.moments_raw_bwd_plain(*a_k6)
        e2 = max(record(stats["moments_raw_bwd"], slots(k_dps[:, seg], 3, pk.slab_to_slots, seg),
                        slots(p_dps.permute(1, 0, 2).reshape(3, -1), 3,
                              pk.slab_to_slots_plain, seg),
                        f"moments_raw_bwd bucket {i}"),
                 record(stats["moments_raw_bwd"], k_dprow[:, c], p_dprow[:, c],
                        f"moments_raw_bwd rows bucket {i}"))
        del p_fm, p_sr, p_dps
        ms1 = cuda_ms(lambda: fk.moments_mid_plain(*a_mid), 1)
        ms2 = cuda_ms(lambda: fk.moments_raw_bwd_plain(*a_k6), 1)
        stats["moments_mid"]["plain_ms"] += ms1
        stats["moments_raw_bwd"]["plain_ms"] += ms2
        say(f"    bucket {i}: slab {slab:4d} tiles {t:4d} | moments_mid err {e1:.2e} "
            f"(plain {ms1:.2f} ms) | moments_raw_bwd err {e2:.2e} (plain {ms2:.2f} ms)")
    again = launch()
    same = all(torch.equal(x, y) for x, y in zip((k_fm, k_sr, k_dps, k_dprow),
                                                 again[0][:2] + again[1]))
    say(f"    second launch of each bitwise equal: {same}")
    if not same:
        fail("moments_mid or moments_raw_bwd does not repeat bit for bit")
    del again
    pairs = sum(b.n_tiles * sb.rows * b.slab_len for b in sb.buckets)
    uniq = int(torch.unique(sb.gidx_all).numel()) * sb.group   # slots the scene reads
    rest_static = (sb.rest_rows.numel() + sb.static_all.numel()) * f32
    work = {   # each input read once, each output written once
        "moments_mid": (
            lambda: fk.moments_mid(sb, posT, posT[:, :m], rs, scale, cfg.h, cfg.corotated),
            FLOPS_PER_PAIR["moments_mid"] * pairs + MID_FLOPS_PER_ROW * m,
            rest_static + sb.gidx_all.numel() * 4 + sb.schedule.numel() * 8
            + (3 * uniq + 3 * m + 4 * m + 9 * m + 19 * m + 15 * sb.n_slots) * f32),
        "moments_raw_bwd": (
            lambda: fk.moments_raw_bwd(sb, dayT, cfg.h, True),
            FLOPS_PER_PAIR["moments_raw_bwd"] * pairs,
            rest_static + sb.chunks.numel() * 8
            + (18 * m + 6 * m + 3 * n_entries + 3 * m) * f32),
    }
    for key, (fn, flops, nbytes) in work.items():
        st = stats[key]
        st.update(ms=cuda_ms(fn, 50), launch_ms=host_ms(fn, 50), flops=flops, bytes=nbytes)
        summarize(key, st, 1, tag)
    say("    (moments_mid is timed as the forward runs it, without the A | Y rows "
        "the gradient's recompute also stores)")
    v2_whole_scene(torch, tag, "sparse scene", sb, fmT, srT, dfT, cfg.h, stats)
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
    # forward: one fused K1 + mid-section and one K2 v2 over the scene per
    # step, two episodes.
    # Gradient (as phase 13): forward kernels 3 times per step, backward
    # kernels once (the raw K1 backward and each K2 v2 pass one launch),
    # slab_to_slots twice (after the raw K1 and the K2 v2 backward); none
    # of the v4 kernels.
    fwd = {"moments_mid": 2 * steps, "forces_warp_v2": 2 * steps}
    per_eval = {"moments_mid": 3 * S, "forces_warp_v2": 3 * S,
                "moments_raw_bwd": S, "forces_warp_v2_bwd_rows": S,
                "forces_warp_v2_bwd_slab": S, "slab_to_slots": 2 * S}
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
    """Phases 23, 27 and 31: a path's forward episode (generate_targets from
    x*, the sampled loss of x = 0 against those targets; ms/step, profile)
    and its quiet body, cut to ``budget_s``; on a slot scene or a gather
    scene (x* in the scene's space).  Returns (launch counts of the two
    episodes, steps, ms/step)."""
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.opt.driver import generate_targets, load_targets
    from softbody_tpu_torch.sim.rollout import acc_float, initial_state, rollout, step

    n_slots = scene.rest_position.shape[0]       # the particles on a gather scene
    real = (torch.arange(n_slots, device=dev) if scene.slot_of_particle is None
            else scene.slot_of_particle)
    n = len(real)
    ratio = compute_ratio(x_star, cfg_p)
    state = initial_state(scene, ratio, cfg_p)
    one = min(host_ms(lambda: step(state, ratio, scene, cfg_p), 3) for _ in range(3))
    steps, projected = STEPS, 3 * STEPS * one / 1e3
    if projected > budget_s:
        steps = max(FRAMES, int(STEPS * budget_s / projected) // FRAMES * FRAMES)
        say(f"    CUT: {label} episodes run {steps} steps, not {STEPS} (projected "
            f"{projected:.0f} s > {budget_s:.0f} s)")
    cfg_p = cfg_p.replace(frames=steps)
    sop = real.cpu().numpy()
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
        ours_part = f", of which the pair kernels {ours:.3f} ms" if names else ""
        say(f"    profile: device busy {busy:.3f} ms/step over 10 steps in {acts:.0f} "
            f"device activities per step{ours_part}; idle share {1 - busy / ms:.3f} of "
            f"the episode's {ms:.3f} ms/step {tag}")
    else:
        say("    profile: the profiler saw no device time; idle share not measured")
    quiet = cfg_p.replace(external_force=(0.0, 0.0, 0.0))
    q_scene = scene._replace(materials=scene.materials._replace(
        external=torch.zeros_like(scene.materials.external)))
    _, fin_q, _ = rollout(torch.zeros(n_slots), q_scene, quiet, n_steps=steps, device=dev)
    d = (fin_q.position - rest)[real]
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
    PREFIX_STEPS steps, kernel vs plain path, under phase 11's gates.
    Returns (launch counts of one gradient, ms/step)."""
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.sim.rollout import episode_value_and_grad_chunked, rollout

    S, P = GRAD_STEPS, PREFIX_STEPS
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


def scene_slots(torch, sb, side, seg, scatter, rows=None, c=None):
    """A per-entry slab side placed at its columns ``seg`` of a whole-scene
    (k, n_entries) buffer and summed into slots by ``scatter``, plus a row
    term ``rows`` at its columns ``c`` when given."""
    from softbody_tpu_torch.ops import pair_kernels as pk

    buf = torch.zeros((side.shape[0], pk.n_entries(sb)), dtype=side.dtype,
                      device=side.device)
    buf[:, seg] = side
    out = scatter(buf, sb.slab_ptr, sb.slab_idx, sb.n_slots, sb.group)
    if rows is not None:
        out[:, c] += rows
    return out


def whole_scene_held(torch, tag, label, sb, launch, per_bucket, nbytes, stats=None,
                     reps=50):
    """The kernels of ``launch`` (name: its whole-scene call), one launch
    each over every tile of ``sb`` (the sparse or the blocked scene): each
    bucket's columns held against that bucket's plain version, a bitwise
    repeat, ms per evaluation and the work's bound (``nbytes``: name: bytes
    moved).  ``per_bucket(b, c, seg, got)`` gives, for bucket ``b`` with
    row columns ``c`` and slab entries ``seg``, the parts held (name:
    (kernel's, plain's)) and its plain calls ((names, call), each call timed
    once and charged to every name).  Into ``stats`` when given, else
    printed."""
    from softbody_tpu_torch.ops import pair_kernels as pk

    pk.reset_launch_counts()
    got = {k: fn() for k, fn in launch.items()}
    torch.cuda.synchronize()
    counts = pk.launch_counts()
    if any(counts[k] != 1 for k in launch):
        fail(f"{', '.join(launch)} on the {label}: launches {counts}, expected one of each")
    errs = {k: {"max_abs_err": 0.0, "max_rel_err": 0.0} for k in launch}
    plain_ms = dict.fromkeys(launch, 0.0)
    e0 = 0
    for i, b in enumerate(sb.buckets):
        t, slab = b.n_tiles, b.slab_len
        c = slice(b.row_start, b.row_start + t * sb.rows)
        seg = slice(e0, e0 + t * slab)
        e0 += t * slab
        held, plain = per_bucket(b, c, seg, got)
        line = [f"{k} err {record(errs[k], g, w, f'{k} {label} bucket {i}'):.2e}"
                for k, (g, w) in held.items()]
        del held
        times = []
        for names, call in plain:
            times.append(cuda_ms(call, 1))
            for k in names:
                plain_ms[k] += times[-1]
        say(f"      {label} bucket {i}: slab {slab:4d} tiles {t:4d} | " + " | ".join(line)
            + f" (plain {' / '.join(f'{x:.2f}' for x in times)} ms)")

    def flat(outs):
        return [x for v in outs for x in (v if isinstance(v, tuple) else (v,))]

    again = [fn() for fn in launch.values()]
    same = all(torch.equal(x, y) for x, y in zip(flat(got.values()), flat(again)))
    say(f"      second launch of each bitwise equal: {same}")
    if not same:
        fail(f"a kernel of {', '.join(launch)} does not repeat bit for bit on the {label}")
    del got, again
    pairs = sum(b.n_tiles * sb.rows * b.slab_len for b in sb.buckets)
    for k, fn in launch.items():
        st = stats[k] if stats is not None else {}
        st.update(ms=cuda_ms(fn, reps), launch_ms=host_ms(fn, reps), plain_ms=plain_ms[k],
                  flops=FLOPS_PER_PAIR[k] * pairs, bytes=nbytes[k])
        for e in ("max_abs_err", "max_rel_err"):
            st[e] = max(st.get(e, 0.0), errs[k][e])
        summarize(k, st, 1, f"({label}) {tag}")


def v2_whole_scene(torch, tag, label, sb, fmT, srT, dfT, h, stats=None, reps=50):
    """K2 v2 and its two backward passes through ``whole_scene_held`` (the
    slab pass composed with slab_to_slots)."""
    from softbody_tpu_torch.ops import fused_kernels as fk
    from softbody_tpu_torch.ops import pair_kernels as pk

    f32 = fmT.element_size()
    m = sb.n_tiles * sb.rows
    launch = {
        "forces_warp_v2": lambda: fk.forces_warp_v2(sb, fmT, srT, h),
        "forces_warp_v2_bwd_rows": lambda: fk.forces_warp_v2_bwd_rows(sb, fmT, srT, dfT, h),
        "forces_warp_v2_bwd_slab": lambda: fk.forces_warp_v2_bwd_slab(sb, fmT, srT, dfT, h),
    }

    def per_bucket(b, c, seg, got):
        a = (b.restT_rows, b.static_slab, fmT[:, c], srT, b.gidx8)
        p_dfm, p_dsr = fk.forces_warp_v2_bwd_plain(*a, dfT[:, c], h)
        held = {
            "forces_warp_v2": (got["forces_warp_v2"][:, c], fk.forces_warp_v2_plain(*a, h)),
            "forces_warp_v2_bwd_rows": (got["forces_warp_v2_bwd_rows"][:, c], p_dfm),
            "forces_warp_v2_bwd_slab": (
                scene_slots(torch, sb, got["forces_warp_v2_bwd_slab"][:, seg], seg,
                            pk.slab_to_slots),
                scene_slots(torch, sb, p_dsr.permute(1, 0, 2).reshape(15, -1), seg,
                            pk.slab_to_slots_plain)),
        }
        return held, [(("forces_warp_v2",), lambda: fk.forces_warp_v2_plain(*a, h)),
                      (("forces_warp_v2_bwd_rows", "forces_warp_v2_bwd_slab"),
                       lambda: fk.forces_warp_v2_bwd_plain(*a, dfT[:, c], h))]

    n_entries = pk.n_entries(sb)
    uniq = int(torch.unique(sb.gidx_all).numel()) * sb.group   # slots the scene reads
    tiles = (sb.rest_rows.numel() + sb.static_all.numel()) * f32 + sb.gidx_all.numel() * 4
    rows_side = tiles + sb.schedule.numel() * 8
    nbytes = {   # each input read once, each output written once
        "forces_warp_v2": rows_side + (19 * m + 3 * m + 15 * uniq + 3 * m) * f32,
        "forces_warp_v2_bwd_rows": rows_side + (m + 3 * m + 15 * uniq + 3 * m + 19 * m) * f32,
        "forces_warp_v2_bwd_slab": tiles + sb.chunks.numel() * 8
        + (10 * m + 3 * m + 15 * uniq + 15 * n_entries) * f32,
    }
    whole_scene_held(torch, tag, label, sb, launch, per_bucket, nbytes, stats, reps)


def sep_whole_scene(torch, tag, label, sb, gT, vol_m, dfT, h, stats=None, reps=50):
    """The separable K2 and its backward through ``whole_scene_held`` (the
    backward's slab side composed with slab_to_slots, plus its row
    term)."""
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops import separable_kernels as sk

    f32 = gT.element_size()
    m = sb.n_tiles * sb.rows
    launch = {"forces_sep": lambda: sk.forces_sep(sb, gT, vol_m, h),
              "forces_sep_bwd": lambda: sk.forces_sep_bwd(sb, vol_m, dfT, h)}

    def per_bucket(b, c, seg, got):
        a_f = (b.restT_rows, b.static_slab, gT[:, c], gT, vol_m[c], b.gidx8, h)
        a_b = (b.restT_rows, b.static_slab, vol_m[c], dfT[:, c], h)
        p_dgr, p_dgs = sk.forces_sep_bwd_plain(*a_b)
        dgs, dgr = got["forces_sep_bwd"]
        held = {
            "forces_sep": (got["forces_sep"][:, c], sk.forces_sep_plain(*a_f)),
            "forces_sep_bwd": (
                scene_slots(torch, sb, dgs[:, seg], seg, pk.slab_to_slots, dgr[:, c], c),
                scene_slots(torch, sb, p_dgs.permute(1, 0, 2).reshape(9, -1), seg,
                            pk.slab_to_slots_plain, p_dgr, c)),
        }
        return held, [(("forces_sep",), lambda: sk.forces_sep_plain(*a_f)),
                      (("forces_sep_bwd",), lambda: sk.forces_sep_bwd_plain(*a_b))]

    read = torch.zeros(sb.n_slots, dtype=torch.bool, device=gT.device)   # columns read
    read[:m] = True
    read.view(-1, sb.group)[sb.gidx_all.long()] = True
    cols = int(read.sum())
    # the static slab's rest rows (3 of its 5), each input read once
    tiles = (sb.rest_rows.numel() + sb.static_all.numel() * 3 // 5) * f32
    nbytes = {
        "forces_sep": tiles + sb.gidx_all.numel() * 4 + sb.schedule.numel() * 8
        + (9 * cols + m + 3 * m + 3 * m) * f32,
        "forces_sep_bwd": tiles + sb.chunks.numel() * 8
        + (3 * m + m + 3 * m + 9 * pk.n_entries(sb) + 9 * m) * f32,
    }
    whole_scene_held(torch, tag, label, sb, launch, per_bucket, nbytes, stats, reps)


def phase_taichi(torch, np, dev, tag, scene, cfg, x_star, stats, pos, ctx):
    """Phases 21-24: path A, the Taichi pairing (pair_def_grad="j") on the
    sparse scene.  Returns the launch counts of its forward episodes and of
    one gradient."""
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.sim.blocked import mid_section
    from softbody_tpu_torch.sim.sparse import elastic_forces_sparse, slot_rows

    sb = scene.blocked
    m = sb.n_tiles * sb.rows
    n = len(scene.slot_of_particle)
    cfg_j = cfg.replace(pair_def_grad="j")
    ratio = ctx["ratio"]
    rng = np.random.default_rng(21)

    def rand(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32, device=dev)

    # ---- 21 the separable K2 and its backward, one launch each
    say(f"[21] Taichi pairing (path A): forces_sep and forces_sep_bwd, one launch each "
        f"over all {sb.n_tiles} tiles, kernel vs plain per bucket on the card {tag}")
    posT = pos.T.contiguous()
    ayT = pk.moments_all(posT, posT[:, :m], sb, cfg.h, pk.PLAIN)
    A = [[ayT[3 * b + a] for b in range(3)] for a in range(3)]
    Y = [[ayT[9 + 3 * b + a] for b in range(3)] for a in range(3)]
    _, _, _, M, vol_m = mid_section(A, Y, ratio, scene.materials, scene, cfg_j, m)
    gT = slot_rows([vol_m * M[a][b] for a in range(3) for b in range(3)], sb.n_slots)
    sep_whole_scene(torch, tag, "sparse scene", sb, gT, vol_m, rand(3, m), cfg.h,
                    stats)

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
    return {"fwd": counts_fwd, "grad": counts_grad, "steps": steps}


def phase_blocked(torch, np, dev, tag, pts, out_num, scene, cfg, x_star, stats,
                  body, ctx):
    """Phases 25-28: path B, the blocked varcol layout on the pallas
    backend, at the same body.  Returns the launch counts of its forward
    episodes and of one gradient."""
    from softbody_tpu_torch.ops import fused_kernels as fk
    from softbody_tpu_torch.ops import pair_kernels as pk
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
    work = {
        "moments_raw": (
            lambda: fk.moments_raw(rr, st, posT, gi, h),
            lambda: fk.moments_raw_plain(rr, st, posT, gi, h), lambda o, sc: (o,),
            FLOPS_PER_PAIR["moments_raw"] * pairs,
            tile_bytes + gidx_bytes + (3 * uniq + 18 * m) * f32),
        "moments_raw_bwd": (   # one launch over the scene, slab = 15 x 128 + 24
            lambda: fk.moments_raw_bwd(blk, dayT, h)[0],
            lambda: fk.moments_raw_bwd_scene_plain(blk, dayT, h)[0],
            lambda o, sc: (sc(o, *to_slots),), FLOPS_PER_PAIR["moments_raw_bwd"] * pairs,
            tile_bytes + blk.chunks.numel() * 8 + (18 * m + 3 * t * slab) * f32),
    }
    say(f"    per launch on the varcol tiles, kernel vs plain {tag}:")
    for key in work:
        one = {key: work[key]}
        into = stats if key == "moments_raw" else None
        say("      " + held_per_launch(torch, one, "varcol", into, reps=10)[0])
    if stats["moments_raw"]["ms"]:
        summarize("moments_raw", stats["moments_raw"], 1, tag)
    pk.reset_launch_counts()
    fk.moments_raw_bwd(blk, dayT, h)
    if pk.launch_counts()["moments_raw_bwd"] != 1:
        fail("the varcol moments_raw_bwd is not one launch over the scene")
    n_entries = t * slab
    line = []
    for k in (3, 9, 15):
        buf = rand(k, n_entries)
        err = rel_err(pk.slab_to_slots(buf, *to_slots), pk.slab_to_slots_plain(buf, *to_slots))
        if not err <= TOL:
            fail(f"slab_to_slots on the varcol index, k={k}: error {err:.3e}")
        line.append(f"k={k} err {err:.2e} {cuda_ms(lambda: pk.slab_to_slots(buf, *to_slots), 10):.4f} ms")
    say("      slab_to_slots on the varcol index: " + ", ".join(line))
    say(f"    K2 v2 and its backward passes, one launch each over the {t} varcol tiles "
        f"(slab {slab} = {slab // 32} x 32 + {slab % 32} = {slab // 128} x 128 + "
        f"{slab % 128}), kernel vs plain {tag}:")
    v2_whole_scene(torch, tag, "varcol scene", blk, fmT, srT, dfT, h, reps=10)
    say(f"    the separable K2 and its backward, one launch each over the {t} varcol "
        f"tiles, kernel vs plain {tag}:")
    sep_whole_scene(torch, tag, "varcol scene", blk, gT, vol_m, dfT, h, reps=10)

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

        pk.reset_launch_counts()
        k1 = vjp(pk.KERNELS)
        counts = pk.launch_counts()
        pl = vjp(pk.PLAIN)
        k2 = ("forces_sep", "forces_sep_bwd") if pdg == "j" else (
            "forces_warp_v2", "forces_warp_v2_bwd_rows", "forces_warp_v2_bwd_slab")
        once = all(counts[k] == 1 for k in k2)
        errs = [rel_err(a, bb) for a, bb in zip(k1, pl)]
        ignored = (torch.equal(elastic_forces_pallas(pos_b, ratio_b, mats, scene_b,
                                                     c.replace(fused_mid=True)), f_b)
                   if pdg == "i" else True)
        say(f"[26] path B (varcol, pallas) \"{pdg}\": vs the sparse path at the same "
            f"particle positions {cross:.3e} of max |f| (tol 1e-3); kernel vs plain "
            f"{own:.3e}, VJP wrt (pos, x) {errs[0]:.3e}, {errs[1]:.3e} (tol {TOL}); "
            f"bitwise repeat {torch.equal(f_b, f_b2)}; launches in the VJP "
            + ", ".join(f"{k} {counts[k]}" for k in k2) + " (expected 1 each)"
            + ("; fused_mid ignored (bitwise equal forces): " + str(ignored)
               if pdg == "i" else ""))
        if not (cross <= 1e-3 and max([own] + errs) <= TOL and torch.equal(f_b, f_b2)
                and ignored and once and bool(torch.isfinite(f_b).all())
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


def phase_gather(torch, np, dev, tag, pts, out_num, scene, sop, cfg, x_star, body, ctx):
    """Phases 30-32: the gather backend (``build_scene``'s (N, K) tables,
    ``ops/elasticity``) at full width, against the sparse kernel path.
    Returns its f32 scene (phase 33 takes the rest table from it)."""
    from softbody_tpu_torch import warp_parity
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.scenarios import dirichlet_mask
    from softbody_tpu_torch.sim.rollout import (elastic_forces,
                                                episode_value_and_grad_chunked, rollout)
    from softbody_tpu_torch.sim.scene import build_scene, update_materials
    from softbody_tpu_torch.sim.sparse import elastic_forces_sparse

    n = len(pts)
    sop = scene.slot_of_particle
    mask = dirichlet_mask(pts, "stretch")
    # no K-nearest truncation: the gather tables then hold every pair the
    # sparse layout holds
    cfg_g = cfg.replace(backend="gather", max_neighbors=0)
    x_g = x_star[sop]                                       # particle order

    # ---- 30 the gather scene and one force evaluation
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene_g = build_scene(pts, cfg_g, out_num=out_num, dirichlet_mask=mask, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    topo = scene_g.topology
    counts = topo.mask.sum(1)
    pairs = int(counts.sum())
    nbytes = sum(t.numel() * t.element_size() for t in topo)
    say(f"[30] gather scene: N={n}, K={topo.idx.shape[1]} (neighbour counts max "
        f"{int(counts.max())}, mean {pairs / n:.1f}), {pairs} real pairs per "
        f"evaluation; tables {nbytes / 1e9:.3f} GB on the card; build_scene "
        f"{t_build:.1f} s {tag}")
    ratio_s = compute_ratio(x_star, cfg)
    pos_g = torch.as_tensor(body, dtype=torch.float32, device=dev)
    f_s = elastic_forces_sparse(ctx["pos"], ratio_s, scene.materials, scene, cfg)[sop]
    f_g = elastic_forces(pos_g, compute_ratio(x_g, cfg_g), scene_g, cfg_g)
    # the gather forces issue ~2,500 small launches (the polar on
    # components), more than a sleep kernel covers: the profiler's busy
    # time, not CUDA events
    busy_g, acts_g, _ = profile_card(
        torch, lambda: elastic_forces(pos_g, compute_ratio(x_g, cfg_g), scene_g, cfg_g),
        (), 1)
    err32 = rel_err(f_g, f_s)
    scene64, cfg64 = ctx["scene64"], ctx["cfg64"]
    t0 = time.perf_counter()
    scene_g64 = build_scene(pts, cfg_g.replace(dtype="float64"), out_num=out_num,
                            dirichlet_mask=mask, device=dev)
    t_build64 = time.perf_counter() - t0
    pos64 = scene64.rest_position.clone()
    pos64[sop] = torch.as_tensor(body, dtype=torch.float64, device=dev)
    f_s64 = elastic_forces_sparse(pos64, compute_ratio(x_star.double(), cfg64),
                                  scene64.materials, scene64, cfg64)[sop]
    f_g64 = elastic_forces(pos64[sop], compute_ratio(x_g.double(), cfg_g),
                           scene_g64, cfg_g.replace(dtype="float64"))
    err64 = rel_err(f_g64, f_s64)
    say(f"    one gather evaluation vs the sparse kernel path at the same positions: "
        f"f32 {err32:.3e} of max |f| (tol 1e-4), f64 {err64:.3e} (tol 1e-9; f64 "
        f"scene build {t_build64:.1f} s); one gather evaluation keeps the device "
        f"busy {busy_g:.3f} ms in {acts_g:.0f} activities (profiler) {tag}")
    if not (err32 <= 1e-4 and err64 <= 1e-9 and bool(torch.isfinite(f_g).all())):
        fail("the gather forces disagree with the sparse kernel path")

    # ---- 31 the gather forward episode, its quiet body, 300 steps against the
    # sparse kernel path, and the CLI's configuration
    counts_fwd, steps, ms = forward_phase(torch, np, dev, tag, 31, "gather", scene_g,
                                          cfg_g, x_g, NEW_BUDGET_S, 1e-6, ())
    if any(counts_fwd.values()):
        fail(f"a pair kernel ran on the gather path: {counts_fwd}")
    _, fin_g, _ = rollout(x_g, scene_g, cfg_g, n_steps=300, device=dev)
    fin_k = ctx["fin_k"]
    dpos = float(torch.max(torch.abs(fin_g.position - fin_k.position[sop])))
    disp = float(torch.max(torch.abs(fin_k.position - scene.rest_position)))
    say(f"    300-step gather rollout vs the sparse kernel path (phase 6): max|dpos| "
        f"= {dpos:.3e}, max|pos - rest| = {disp:.3e}, ratio {dpos / disp:.3e} "
        f"(tol 1e-3)")
    if not dpos <= 1e-3 * disp:
        fail("the gather rollout drifts from the sparse kernel path")
    # the CLI's configuration (softbody_tpu/cli.py:117-119): warp_parity,
    # trapezoidal, dt 1e-6, ground collision (here with its damper), no
    # clamp; the body's base starts in the ground's contact zone.  The same
    # tables, set through update_materials.
    cfg_w = warp_parity().replace(h=cfg.h, dtype="float32", backend="gather",
                                  max_neighbors=0, dt=1e-6, collision_damping=50.0,
                                  frames=steps)
    scene_w = update_materials(scene_g, cfg_w, youngs_modulus=cfg_w.youngs_modulus,
                               poisson_ratio=cfg_w.poisson_ratio,
                               dirichlet=(1.0, 1.0, 1.0),
                               external_force=cfg_w.external_force)
    shift = torch.tensor([0.0, float(scene_g.rest_position[:, 1].min()) - 5e-5, 0.0],
                         device=dev)
    scene_w = scene_w._replace(rest_position=scene_g.rest_position - shift)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, fin_w, _ = rollout(torch.zeros(n), scene_w, cfg_w, n_steps=steps, device=dev)
    torch.cuda.synchronize()
    ms_w = (time.perf_counter() - t0) * 1e3 / steps
    low = float(fin_w.position[:, 1].min())
    say(f"    warp_parity (the CLI's configuration: trapezoidal, dt 1e-6, ground "
        f"contact with the damper) on the gather path: {steps} steps, {ms_w:.3f} "
        f"ms/step, lowest particle {low:.3e} m {tag}")
    if not bool(torch.isfinite(fin_w.position).all()):
        fail("the warp_parity gather episode is not finite")

    # ---- 32 the gather episode gradient; f64 prefix against the sparse path
    S, P = GRAD_STEPS, PREFIX_STEPS
    every = S // GRAD_FRAMES
    cfg_gg = cfg_g.replace(frames=S, target_frames=GRAD_FRAMES)
    with torch.no_grad():
        _, _, (tp, tv) = rollout(x_g, scene_g, cfg_gg, n_steps=S, record_every=every,
                                 device=dev)
    x0 = torch.zeros(n, device=dev)
    vg = episode_value_and_grad_chunked(scene_g, cfg_gg, EVAL_CHUNKS, S)
    pk.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss1, g1 = vg(x0, tp, tv)
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = pk.launch_counts()
    loss2, g2 = vg(x0, tp, tv)
    ms_grad = t_grad * 1e3 / S
    gmax = float(torch.max(torch.abs(g1)))
    repeat = loss1 == loss2 and torch.equal(g1, g2)
    say(f"[32] gather episode gradient: {S} steps, {GRAD_FRAMES} frames, {EVAL_CHUNKS} "
        f"chunks, x = 0: loss {loss1:.9g}, max |g| {gmax:.3e}; fwd+bwd {t_grad:.1f} s "
        f"= {ms_grad:.3f} ms/step, {n * S / t_grad:.4g} particle-steps/s; peak device "
        f"memory {peak / 2**30:.3f} GiB; second gradient bitwise equal: {repeat} {tag}")
    if not (math.isfinite(loss1) and loss1 > 0 and gmax > 0 and repeat
            and bool(torch.isfinite(g1).all()) and not any(counts.values())):
        fail("the gather gradient is not finite, is zero, does not repeat, or ran "
             f"a pair kernel ({counts})")
    n_tp = P // every
    tp64, tv64 = ctx["tp64"][:n_tp], ctx["tv64"][:n_tp]
    x64 = torch.zeros(scene64.rest_position.shape[0], dtype=torch.float64, device=dev)
    cfg_g64 = cfg_gg.replace(dtype="float64")
    l_s, g_s = episode_value_and_grad_chunked(scene64, cfg64, 1, P)(x64, tp64, tv64)
    l_g, g_g = episode_value_and_grad_chunked(scene_g64, cfg_g64, 1, P)(
        x64[sop], tp64[:, sop], tv64[:, sop])
    dl, dg = abs(l_g - l_s) / l_s, rel_err(g_g, g_s[sop])
    say(f"    first {P} steps in f64, gather vs the sparse kernel path: loss "
        f"{l_g:.12g} vs {l_s:.12g} (rel {dl:.3e}, tol 1e-9); max |dg| / max |g| "
        f"{dg:.3e} (tol 1e-6)")
    if not (dl <= 1e-9 and dg <= 1e-6):
        fail("the gather gradient disagrees with the sparse kernel path in f64")
    short = episode_value_and_grad_chunked(scene_g, cfg_gg, 1, 10)
    busy, acts, _ = profile_card(torch, lambda: short(x0, tp[:3], tv[:3]), (), 10)
    if busy > 0:
        say(f"    profile: device busy {busy:.3f} ms/step of fwd+bwd in {acts:.0f} "
            f"device activities per step; idle share {1 - busy / ms_grad:.3f} of the "
            f"gradient's {ms_grad:.3f} ms/step {tag}")
    else:
        say("    profile: the profiler saw no device time; idle share not measured")
    del scene_g64
    return scene_g


def phase_drop(torch, np, dev, tag, pts, out_num, scene_g, cfg):
    """Phase 33: the DROP scenario on the main (sparse kernel) path with a
    sphere, a plane and a box obstacle and dynamic contact, and a full-size
    DeepSDF obstacle."""
    import dataclasses
    import warnings

    from softbody_tpu_torch import warp_parity
    from softbody_tpu_torch.models import deepsdf
    from softbody_tpu_torch.ops import contact as ct
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.ops import obstacles as obs
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.scenarios import (DROP, drop_gap, scale_mass_for_resolution,
                                              x_star_bands)
    from softbody_tpu_torch.sim import rollout as ro
    from softbody_tpu_torch.sim.sparse import build_sparse_scene

    n = len(pts)
    pts_d = drop_gap(pts, "drop")
    cfg_d = scale_mass_for_resolution(
        warp_parity().replace(h=cfg.h, dtype="float32", backend="pallas",
                              target_frames=FRAMES, **DROP), n, "drop")
    lo, hi = pts_d.min(0), pts_d.max(0)
    c = 0.5 * (lo + hi)
    radius = 0.5 * float(hi[0] - lo[0])

    def base(dx):   # height of the body's base at an offset dx from its axis
        return float(c[1] - np.sqrt(radius**2 - dx * dx))

    # a sphere under the base (its top 0.2 mm below it), a box under the base
    # on the other side (likewise), a wall on -z whose margin the body's side
    # already touches
    obstacles = obs.make(
        obs.sphere((c[0] - 0.01, base(0.01) - 2e-4 - 0.02, c[2]), 0.02),
        obs.box((c[0] + 0.01, base(0.01) - 2e-4 - 0.01, c[2]), (0.008, 0.01, 0.02)),
        obs.plane((0.0, 0.0, 1.0), float(lo[2]) - 5e-5),
        stiffness=cfg_d.collision_stiffness)
    t0 = time.perf_counter()
    scene_d, sop_d = build_sparse_scene(pts_d, cfg_d, out_num=out_num,
                                        obstacles=obstacles, device=dev)
    n_slots = scene_d.blocked.n_slots
    exclude = ct.slot_exclude(scene_g.topology.idx.cpu().numpy(), sop_d, n_slots)
    grid = ct.build_contact_grid(lo - 0.01, hi + 0.01, r_c=cfg.h, cap=16,
                                 stiffness=cfg_d.collision_stiffness, exclude=exclude,
                                 device=dev)
    scene_d = scene_d._replace(contact=grid)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    x_d = torch.as_tensor(x_star_bands(pts_d, n_slots, sop_d), dtype=torch.float32,
                          device=dev)
    occ = ct.max_occupancy(scene_d.rest_position, grid)
    say(f"[33] DROP with obstacles (sphere, box, plane; stiffness "
        f"{cfg_d.collision_stiffness:g}) and dynamic contact (r_c = h = {cfg.h:.4g}, "
        f"cell {grid.cell:.4g}, grid {grid.dims}, cap {grid.cap}, rest occupancy "
        f"{occ}, exclude the rest table in slot space, K={exclude.shape[1]}) on the "
        f"sparse kernel path: N={n}, {n_slots} slots, build {t_build:.1f} s {tag}")
    ratio = compute_ratio(x_d, cfg_d)
    state = ro.initial_state(scene_d, ratio, cfg_d)
    parts = {"step": lambda: ro.step(state, ratio, scene_d, cfg_d),
             "obstacles": lambda: obs.penalty_force(scene_d.obstacles, state.position),
             "contact": lambda: ct.contact_forces(state.position, grid)}
    best = {k: min(host_ms(fn, 3) for _ in range(3)) for k, fn in parts.items()}
    steps, projected = STEPS, STEPS * best["step"] / 1e3
    if projected > NEW_BUDGET_S:
        steps = max(FRAMES, int(STEPS * NEW_BUDGET_S / projected) // FRAMES * FRAMES)
        say(f"    CUT: the DROP episode runs {steps} steps, not {STEPS} (projected "
            f"{projected:.0f} s > {NEW_BUDGET_S:.0f} s)")
    ro._overflow_warned = False
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.no_grad():
            _, fin, (rec_p, rec_v) = ro.rollout(x_d, scene_d, cfg_d, n_steps=steps,
                                                record_every=steps // FRAMES, device=dev)
        torch.cuda.synchronize()
    t_ep = time.perf_counter() - t0
    counts = pk.launch_counts()
    overflow = [w for w in caught if "exceeded cap" in str(w.message)]
    _, ovf_end = ct.contact_forces(fin.position, grid, with_overflow=True)
    ms_d = t_ep * 1e3 / steps
    finite = bool(torch.isfinite(rec_p).all()) and bool(torch.isfinite(rec_v).all())
    touched = int((obs.sdf(scene_d.obstacles, rec_p[-1][scene_d.slot_of_particle])
                   < obstacles.margin).sum())
    say(f"    episode: {steps} steps from x* in {t_ep:.1f} s = {ms_d:.3f} ms/step, "
        f"{n * 1e3 / ms_d:.4g} particle-steps/s; one step {best['step']:.3f} ms wall, "
        f"of which the obstacle penalty {best['obstacles']:.3f} ms and the contact "
        f"forces {best['contact']:.3f} ms (fastest of 3 rounds); {touched} particles "
        f"within an obstacle's margin at the end; every state finite: {finite}; "
        f"contact overflow: {bool(overflow) or bool(ovf_end)}; lowest particle "
        f"{float(rec_p[-1][:, 1].min()):.3e} m {tag}")
    if not finite or overflow or bool(ovf_end):
        fail("the DROP + obstacles + contact episode is not finite or overflowed")
    want = {"moments_v4": steps, "forces_warp_v4": steps}
    if counts != {k: want.get(k, 0) for k in counts}:
        fail(f"DROP episode launches {counts}, expected {want} and 0 for the rest")

    # contact_forces_query on 4,096 rows against the all-pairs law over every
    # particle: once with the grid's exclude table, once without (every rest
    # neighbour within r_c then counts, so the forces are far from zero)
    nq = min(4096, n_slots)
    g0 = max(0, n_slots // 2 - nq // 2)
    rows = torch.arange(g0, g0 + nq, device=dev)
    for label, g in (("with the exclude table", grid),
                     ("no exclude", dataclasses.replace(grid, exclude=None))):
        excl = g.exclude
        f_q = ct.contact_forces_query(fin.position, fin.position[rows], g0, g,
                                      exclude_q=None if excl is None else excl[rows])
        f_o = ct.contact_forces_allpairs(fin.position, g, rows=rows)
        fmax = float(torch.max(torch.abs(f_o)))
        err = float(torch.max(torch.abs(f_q - f_o))) / fmax if fmax > 0 else float(
            torch.max(torch.abs(f_q)))
        say(f"    contact_forces_query on {nq} rows vs the all-pairs law ({label}): "
            f"max |f| {fmax:.3e}, max |df| / max |f| {err:.3e} (tol 1e-5)")
        if not (err <= 1e-5 and (excl is not None or fmax > 0)):
            fail(f"the contact forces ({label}) disagree with the all-pairs law")

    # one 99-step gradient, twice
    S = GRAD_STEPS
    cfg_dg = cfg_d.replace(frames=S, target_frames=GRAD_FRAMES)
    with torch.no_grad():
        _, _, (tp, tv) = ro.rollout(x_d, scene_d, cfg_dg, n_steps=S,
                                    record_every=S // GRAD_FRAMES, device=dev)
    vg = ro.episode_value_and_grad_chunked(scene_d, cfg_dg, EVAL_CHUNKS, S)
    x0 = torch.zeros(n_slots, device=dev)
    pk.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss1, g1 = vg(x0, tp, tv)
    torch.cuda.synchronize()
    t_grad = time.perf_counter() - t0
    counts = pk.launch_counts()
    loss2, g2 = vg(x0, tp, tv)
    repeat = loss1 == loss2 and torch.equal(g1, g2)
    say(f"    gradient: {S} steps, {EVAL_CHUNKS} chunks, x = 0: loss {loss1:.9g}, max "
        f"|g| {float(torch.max(torch.abs(g1))):.3e}, {t_grad * 1e3 / S:.3f} ms/step; "
        f"second gradient bitwise equal: {repeat}; launches {counts} {tag}")
    if not (math.isfinite(loss1) and bool(torch.isfinite(g1).all()) and repeat):
        fail("the DROP + obstacles + contact gradient is not finite or does not repeat")
    per_eval = {"moments_v4": 3 * S, "forces_warp_v4": 3 * S, "moments_v4_bwd": S,
                "forces_warp_v4_bwd_rows": S, "forces_warp_v4_bwd_slab": S,
                "slab_to_slots": 2 * S}
    if counts != {k: per_eval.get(k, 0) for k in counts}:
        fail(f"DROP gradient launches {counts}, expected {per_eval} (phase 13)")

    # a full-size seeded DeepSDF obstacle (3 -> 1024 x 8 -> 1) over every slot
    params = deepsdf.init_params(torch.Generator().manual_seed(0), device=dev)
    o_sdf = obs.make(obs.deepsdf(params, scale=1.0, offset=tuple(c)), stiffness=2e4,
                     margin=1e-4).to(dev)
    p = fin.position.detach().clone().requires_grad_()
    ct_ = torch.ones_like(p)

    def penalty_and_vjp():
        f = obs.penalty_force(o_sdf, p)
        return f, torch.autograd.grad(f, p, ct_)[0]

    f_sdf, g_sdf = (t.detach() for t in penalty_and_vjp())
    ms_f = cuda_ms(lambda: obs.penalty_force(o_sdf, p.detach()), 3)
    ms_v = cuda_ms(penalty_and_vjp, 3)
    inside = int((obs.sdf(o_sdf, p.detach()) < o_sdf.margin).sum())
    say(f"    DeepSDF obstacle (3 -> 1024 x 8 -> 1, seeded) over {n_slots} positions: "
        f"penalty_force {ms_f:.2f} ms, with its VJP {ms_v:.2f} ms (CUDA events); "
        f"{inside} positions inside its margin; max |f| "
        f"{float(torch.max(torch.abs(f_sdf))):.3e}, finite: "
        f"{bool(torch.isfinite(f_sdf).all()) and bool(torch.isfinite(g_sdf).all())} "
        f"{tag}")
    if not (bool(torch.isfinite(f_sdf).all()) and bool(torch.isfinite(g_sdf).all())):
        fail("the DeepSDF obstacle's force or its VJP is not finite")


def phase_adam(torch, np, dev, tag, scene, x_star, ctx):
    """Phase 34: optimize_adam at full width: 3 steps straight; 2 steps, a
    resume and 1 step; the two iterates bitwise equal."""
    from softbody_tpu_torch.opt import driver

    cfg_g, tp, tv = ctx["cfg_g"], ctx["tp_g"], ctx["tv_g"]
    x0 = np.zeros(scene.blocked.n_slots)
    x_t = x_star.cpu().numpy()
    kw = dict(n_steps=GRAD_STEPS, eval_chunks=EVAL_CHUNKS, checkpoint_every=1,
              x_target=x_t)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        x3, hist = driver.optimize_adam(scene, cfg_g, x0, tp, tv, steps=3,
                                        resume_dir=f"{tmp}/a", opt_dir=f"{tmp}/a_out",
                                        **kw)
        t_adam = time.perf_counter() - t0
        distances = json.loads(open(f"{tmp}/a_out/distances.json").read())
        losses = json.loads(open(f"{tmp}/a_out/losses.json").read())
        driver.optimize_adam(scene, cfg_g, x0, tp, tv, steps=2, resume_dir=f"{tmp}/b",
                             **kw)
        x3b, hist_b = driver.optimize_adam(scene, cfg_g, x0, tp, tv, steps=3,
                                           resume_dir=f"{tmp}/b", resume=True, **kw)
    same = torch.equal(x3, x3b) and hist_b == hist
    say(f"[34] Adam at full width: 3 steps of {GRAD_STEPS}-step episodes from x = 0 "
        f"in {t_adam:.1f} s ({t_adam / 3:.1f} s per step): losses {losses}, "
        f"distances {distances}; 2 steps + resume + 1 step bitwise equal to the "
        f"straight run: {same} {tag}")
    if not (same and len(distances) == len(losses) == 3
            and all(math.isfinite(v) for v in losses)):
        fail("Adam's resume is not exact, or its artifacts are wrong")


def phase_counts(a, b):
    """Phase 29: the launch counts of phases 23-24 (path A) and 27-28 (path
    B) against what each path implies; every other kernel 0."""
    S = GRAD_STEPS
    # symplectic: one force evaluation per step, two forward episodes; one
    # gradient runs the forward kernels 3 times per step and the backward
    # ones once (phase 13)
    want = {
        ("A", "fwd"): {"moments_v4": 2 * a["steps"], "forces_sep": 2 * a["steps"]},
        ("A", "grad"): {"moments_v4": 3 * S, "forces_sep": 3 * S, "moments_v4_bwd": S,
                        "forces_sep_bwd": S, "slab_to_slots": 2 * S},
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
    "moments_mid": ("pair_kernels", "pair_kernels.py:602"),
    "forces_warp_v2": ("pair_kernels", "pair_kernels.py:822"),
    "moments_raw_bwd": ("pair_kernels", "pair_kernels.py:335"),
    "forces_warp_v2_bwd_rows": ("pair_kernels", "pair_kernels.py:936"),
    "forces_warp_v2_bwd_slab": ("pair_kernels", "pair_kernels.py:936"),
    "forces_sep": ("pair_kernels", "pair_kernels.py:690"),
    "forces_sep_bwd": ("pair_kernels", "pair_kernels.py:716"),
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
