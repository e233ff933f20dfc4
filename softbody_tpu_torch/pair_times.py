"""Device time per evaluation of the sparse path's K1 (``moments_v4``) and
K2 (``forces_warp_v4``) forward kernels and their backwards
(``moments_v4_bwd``, ``forces_warp_v4_bwd_rows`` and ``_slab``), of the
fused path's K1 + mid-section (``moments_mid``), of the raw K1 backward
(``moments_raw_bwd``: with its row term on the fused path, without on
path B), of K2 v2 (``forces_warp_v2``) and its backward passes on the
fused path's records over the sparse scene and on path B's over the
blocked varcol scene (``varcol_``), and of the Taichi pairing's separable
K2 (``forces_sep``) and its backward (``forces_sep_bwd``; a tree whose
wrappers take a bucket has two passes, ``forces_sep_bwd_rows`` and ``_slab``,
timed together) on G = V M of the same two scenes, and of the
mid-section kernels (``mid_records``, ``mid_records_bwd``, and in a tree
that has them their ring forms ``mid_records_ring``,
``mid_records_bwd_ring``, with their launch plans ``ring_plan``) on both
scenes' strained rows (``chip_smoke.py`` phase 44's operands: the stretched body
after 5 steps, f32, seeded random cotangents; ``varcol_`` with the raw-dot
correction), and of the gather backend's kernels (``gather_moments``,
``gather_forces`` and their backwards, each backward's row pass and source
pass also apart (``*_bwd_rows_ms``, ``*_bwd_src_ms``, from
``torch.profiler``), ``gather_mid_records`` the mid-section on the gather
rows (with the packed source record in a tree that has it),
``j_gather_*`` the Taichi pairing's, ``j_gather_record_merge`` the add
of its record's cotangent into dfmT that its backward makes on one
device) on the same body's (N, K) tables
(``chip_smoke.py`` phase 45's operands), and of the scatters of the
backward's per-entry buffers on both scenes (``slab_to_slots``: K1's 3
fields and K2's 15, its 2 launches an evaluation; ``slab_to_slots_bf16``:
the bf16 K2 slab's 15; each on the slab pass's own output), at the ~112k
stretch scene on one CUDA card, and the steps
they sit in (``g_`` the gather path's), for this checkout or another one
(``--tree``), so that two versions can be compared on one card in one
sitting:

    python softbody_tpu_torch/pair_times.py --tree /path/to/other/checkout
    python softbody_tpu_torch/pair_times.py --kernels 'mid_records' --no-steps
    python softbody_tpu_torch/pair_times.py --against /path/to/parent --rounds 5 \
        --kernels 'mid_records' --no-steps
    python softbody_tpu_torch/pair_times.py --against /path/to/parent --rounds 2 \
        --gather-only
    python softbody_tpu_torch/pair_times.py --against /path/to/parent --rounds 3 \
        --kernels slab_to_slots --no-steps

(``--gather-only``: the gather backend alone, its kernels where the tree
has them and its steps: a tree without the kernels runs the path's eager
ops.)

Run it for each version in turns (A, B, B, A); ``--against`` does so
itself and summarizes the rounds.  The scene and the
operands are those of ``chip_smoke.py`` phases 3, 14 and 25
(``fit_body(100000)``, STRETCH, f32, a stretched and jittered body, the
plain path's F, S, R, M, and the fused path's and path B's fmT / srT), and
seeded random cotangents for the backwards.  A kernel whose wrapper
takes one bucket (found from the wrapper's signature) is timed as its 8
launches back to back (and, as ``chip_smoke.py`` summed them, launch by
launch); one whose wrapper takes the whole scene as its one launch.  CUDA events around
``--reps`` evaluations queued behind a sleep kernel, warm.  Prints one JSON
line: the tree, the card (``nvidia-smi`` name and power limit), the ms per
evaluation and the launches per evaluation of each kernel, and for the
default path, the Taichi pairing (``j_``), the fused path (``f_``),
path B (``b_``) and the default path and path B with the bf16 K2 slab
(``bf16_``, ``b_bf16_``) one forward step's wall ms (fastest of 5 rounds of 5) and
one gradient step's (a 10-step ``episode_value_and_grad_chunked``, fastest
of 3), each with the device's busy ms and activities per step
(``torch.profiler`` over 10 steps, as ``chip_smoke.py`` phases 8 and 11
take them), and each kernel's SASS instructions per pair in f32
(``cuobjdump -sass`` of the built libraries: the innermost loop around the
pair's one ``MUFU.RSQ`` that reads shared memory, its instructions over
its ``MUFU`` count; ``_tail`` names a kernel's ragged-tail
instantiation), the mid-section kernels' SASS instructions per row
(``sass_per_row``: a one-wave kernel thread's body with its Jacobi sweep
loop counted ``SWEEPS`` times; ``_corr`` names the raw-dot correction's instantiation) and the issue
floor they set (``issue_floor_ms``: instructions x rows / 32 / (SMs x 4
schedulers) / the card's highest SM clock), and a digest of
``moments_mid``'s, the mid-section kernels' and the f32 scatter's outputs (``digest``: equal
digests from two trees mean bitwise equal outputs; the ring kernels'
digests equal the one-wave kernels' when their outputs do).  ``--kernels``
times only the kernels whose key matches its regular expression,
``--no-steps`` skips the steps, ``--steps`` runs only those whose prefix
matches its regular expression.  Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

MID_STEPS = 5          # steps from the stretched body to its strained rows

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


def pass_ms(torch, fn, reps):
    """{kernel: device ms per call of ``fn``} of each kernel ``fn`` launches
    (a gather backward's row pass ``*_rows`` and source pass ``*_src``
    apart; each launches them once a call), the mean of its launches in
    ``torch.profiler`` over ``reps`` calls, warm."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"gather_\w+?_(?:rows|src)", e.name)   # demangled or not
            spans.setdefault(m.group(0) if m else e.name, []).append(
                e.time_range.elapsed_us())
    # the mean launch: the profiler may drop events when a process traces a lot
    return {name: sum(us) / len(us) / 1e3 for name, us in spans.items()}


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
    """Forward and gradient step: wall ms, device busy ms, activities; the
    gradient's peak device memory (GiB, the scene's tables included)."""
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
    torch.cuda.reset_peak_memory_stats()
    out["grad_step_ms"] = min(host_ms(torch, grad, 1) for _ in range(3)) / 10
    out["grad_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["grad_busy_ms"], out["grad_activities"] = busy(torch, grad, 10)
    return out


def sass_per_pair(lib_path, names):
    """{name: SASS instructions per pair of the f32 kernel ``name``} (and
    ``name_tail`` for its ragged-tail instantiation, the one whose first
    bool template argument is true, and ``..._bf16`` for the bf16 K2
    slab's): the shortest backward-branch loop
    holding a MUFU and a shared-memory load (the pair loop; not the
    mid-section's Jacobi sweeps), its length over its MUFU count (one
    rsqrt per pair)."""
    out = {}
    for sym, ins in sass_functions(lib_path).items():
        name = next((n for n in names if f"{len(n) + 7}{n}_kernelIf" in sym), None)
        if name is None:
            continue
        if "_kernelIfLb1E" in sym:             # the ragged-tail instantiation
            name += "_tail"
        if "bfloat16" in sym:                  # the bf16 K2 slab's
            name += "_bf16"
        loops = []
        for a, op in ins:
            tgt = re.search(r"BRA\s.*?0x([0-9a-f]+)", op)
            if tgt and int(tgt.group(1), 16) < a:
                body = [o for x, o in ins if int(tgt.group(1), 16) <= x <= a]
                mufu = sum("MUFU" in o for o in body)
                if mufu and any(o.startswith("LDS") for o in body):
                    loops.append((len(body), mufu))
        if loops:
            n, mufu = min(loops)
            out[name] = n / mufu
    return out


def sass_functions(lib_path):
    """{mangled name: [(address, instruction)]} of a built library."""
    from softbody_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    return {fn.split()[0]: [(int(a, 16), op) for a, op in
                            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
            for fn in text.split("Function : ")[1:]}


def sass_per_row(functions, names, sweeps):
    """{name[_corr]: SASS instructions a thread issues per row} of the f32
    kernels ``<name>_kernel<float, corr>``: the body before its closing
    self-branch, with its longest loop that runs a MUFU (the Jacobi sweep
    loop, where it is not unrolled) counted ``sweeps`` times."""
    out = {}
    for sym, ins in functions.items():
        name = next((n for n in names if f"{len(n) + 7}{n}_kernelIf" in sym), None)
        if name is None:
            continue
        end = next((i for i, (a, op) in enumerate(ins)
                    if re.fullmatch(rf"BRA\s+0x{a:x}", op.strip())), len(ins))
        body = ins[:end]
        sweep = 0
        for a, op in body:
            tgt = re.search(r"BRA\s.*?0x([0-9a-f]+)", op)
            if tgt and int(tgt.group(1), 16) < a:
                loop = [o for x, o in body if int(tgt.group(1), 16) <= x <= a]
                if any("MUFU" in o for o in loop):
                    sweep = max(sweep, len(loop))
        out[name + ("_corr" if "_kernelIfLb1E" in sym else "")] = (
            len(body) + (sweeps - 1) * sweep)
    return out


def gather_numbers(torch, np, args, dev, pts, out_num, body, steps):
    """The gather backend on its (N, K) tables of the same body
    (``build_scene``, no K-nearest truncation, f32, STRETCH): in a tree
    that has them, its kernels' ms per call on chip_smoke.py phase 45's
    operands (the stretched body, the plain mid-section's records, seeded
    random cotangents; ``gather_*`` the Warp pairing, ``j_gather_*`` the
    Taichi pairing's forces) and their outputs' digests; with ``steps``
    the gather path's forward and gradient step (``g_``), in any tree."""
    import importlib.util

    from softbody_tpu_torch import warp_parity
    from softbody_tpu_torch.geometry.shapes import suggest_h
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.scenarios import STRETCH, dirichlet_mask, x_star_bands
    from softbody_tpu_torch.sim.scene import build_scene

    cfg = warp_parity().replace(h=suggest_h(pts, 32), dtype="float32", backend="gather",
                                max_neighbors=0, **STRETCH)
    scene = build_scene(pts, cfg, out_num=out_num,
                        dirichlet_mask=dirichlet_mask(pts, "stretch"), device=dev)
    n = len(pts)
    x = torch.as_tensor(x_star_bands(pts, n, np.arange(n)), dtype=torch.float32,
                        device=dev)
    ratio = compute_ratio(x, cfg)
    out, evals = {"gather_K": int(scene.topology.idx.shape[1])}, {}
    if importlib.util.find_spec("softbody_tpu_torch.ops.gather_kernels"):
        from softbody_tpu_torch.ops import gather_kernels as gk
        from softbody_tpu_torch.ops import mid_kernels as mk

        topo = scene.topology
        pos = torch.as_tensor(body, dtype=torch.float32, device=dev)
        rng = np.random.default_rng(45)
        dayT, df = (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                                    device=dev) for shape in ((18, n), (n, 3)))
        mid = (gk.gather_moments_plain(pos, None, topo),
               mk.gather_row_static(scene.materials, topo), cfg.stiffness_scale(ratio),
               cfg.corotated, n)
        fmT, srT = mk.mid_records_plain(*mid)
        evals = {"gather_moments": lambda: gk.gather_moments(pos, None, topo),
                 "gather_moments_bwd": lambda: gk.gather_moments_bwd(pos, None, topo,
                                                                     dayT)}
        packed = hasattr(gk, "packed_record")     # a tree whose forces read it
        for label, sep in (("", False), ("j_", True)):
            if packed:          # the packed record, the rows' own on one device
                a = (fmT, gk.packed_record(fmT, srT, sep), topo, sep)
                b = a + (df,)
                evals[label + "gather_mid_records"] = (
                    lambda sep=sep: mk.mid_records(*mid, rec=gk.REC_W[sep]))
                if sep:         # the Taichi record's cotangent added into dfmT
                    drec = torch.empty((gk.REC_W[sep], n), device=dev).normal_().T
                    evals["j_gather_record_merge"] = (
                        lambda d=torch.randn_like(fmT): mk.add_record_m(d, drec))
            else:               # the strided source: srT.T, or the rows' own
                a = (fmT, None, None, topo, True) if sep else (
                    fmT, srT.T, fmT[18], topo, False)
                b = a + (df,)
                evals[label + "gather_mid_records"] = lambda: mk.mid_records(*mid)
            evals[label + "gather_forces"] = lambda a=a: gk.gather_forces(*a)
            evals[label + "gather_forces_bwd"] = lambda b=b: gk.gather_forces_bwd(*b)
        out["digest"] = {k: digest(torch, fn()) for k, fn in evals.items()}
    if steps:
        out.update({f"g_{k}": v for k, v in step_numbers(
            torch, scene, cfg, ratio, x, dev).items()})
    return out, evals


def digest(torch, res):
    """A short hash of a kernel call's outputs (a tensor or a tuple)."""
    res = res if isinstance(res, (tuple, list)) else (res,)
    torch.cuda.synchronize()
    h = hashlib.sha256()
    for t in res:
        if t is not None:
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def compare(args):
    """``--against``: run this script on the other checkout (A) and on
    ``--tree`` (B) in turns A, B, B, A, ``--rounds`` times, each run its
    own process with the other options, printing each run's JSON line
    (with ``side``), then :func:`summarize`'s line."""
    opts = ["--particles", str(args.particles), "--reps", str(args.reps)]
    opts += ["--kernels", args.kernels] if args.kernels else []
    opts += ["--no-steps"] if args.no_steps else []
    opts += ["--steps", args.steps]
    opts += ["--gather-only"] if args.gather_only else []
    runs = []
    for _ in range(args.rounds):
        for side in "ABBA":
            tree = args.against if side == "A" else args.tree
            res = subprocess.run([sys.executable, __file__, "--tree", tree, *opts],
                                 capture_output=True, text=True)
            if res.returncode:
                sys.exit(f"run {side} on {tree} failed:\n{res.stderr[-4000:]}")
            runs.append({"side": side} | json.loads(res.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    print(json.dumps(summarize(runs)), flush=True)


def summarize(runs):
    """The rounds' summary: for every number ending in ``_ms`` its quartiles
    [q1, median, q3] on each side and, where both sides have it, the
    fraction of runs in which B took less than the A run beside it (the
    pairs A1 B1 and B2 A2 of each round), and whether each digest both
    sides print was the same in every run.  ``runs``: the JSON lines in the
    order they ran, each with its ``side``."""
    import statistics

    side = {s: [r for r in runs if r["side"] == s] for s in "AB"}
    a_runs, b_runs = side["A"], side["B"]
    out = {"card": b_runs[0]["card"], "rounds": len(b_runs) // 2}
    for key in sorted(k for k, v in b_runs[0].items()
                      if k.endswith("_ms") and isinstance(v, float)):
        b = [r[key] for r in b_runs]
        row = {"B": statistics.quantiles(b, n=4, method="inclusive")}
        if key in a_runs[0]:
            a = [r[key] for r in a_runs]
            row["A"] = statistics.quantiles(a, n=4, method="inclusive")
            row["B_faster"] = sum(y < x for x, y in zip(a, b)) / len(a)
        out[key] = row
    shared = set(a_runs[0]["digest"]) & set(b_runs[0]["digest"])
    out["digests_equal"] = {k: len({r["digest"][k] for r in runs}) == 1
                            for k in sorted(shared)}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent),
                    help="root of the checkout whose softbody_tpu_torch is timed")
    ap.add_argument("--particles", type=int, default=100_000)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--kernels", default="",
                    help="time only the kernels whose key matches this regular "
                         "expression")
    ap.add_argument("--no-steps", action="store_true", help="skip the steps")
    ap.add_argument("--steps", default="",
                    help="run only the steps whose prefix matches this regular "
                         "expression ('default' names the unprefixed default path)")
    ap.add_argument("--against", default="",
                    help="another checkout (A): time it and --tree (B) in turns "
                         "A, B, B, A, --rounds times, one process each, then summarize")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--gather-only", action="store_true",
                    help="only the gather backend: its kernels (in a tree that has "
                         "them) and, without --no-steps, its steps")
    args = ap.parse_args()
    if args.against:
        return compare(args)
    sys.path.insert(0, str(Path(args.tree).resolve()))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("pair_times.py needs a CUDA card")
    from softbody_tpu_torch import warp_parity
    from softbody_tpu_torch.geometry.shapes import suggest_h
    from softbody_tpu_torch.ops import fused_kernels as fk
    from softbody_tpu_torch.ops import pair_kernels as pk
    from softbody_tpu_torch.ops.elasticity import compute_ratio
    from softbody_tpu_torch.scenarios import STRETCH, dirichlet_mask, fit_body, x_star_bands
    from softbody_tpu_torch.sim.blocked import build_blocked_scene, mid_section
    from softbody_tpu_torch.sim.sparse import build_sparse_scene, slot_rows

    assert Path(pk.__file__).resolve().is_relative_to(Path(args.tree).resolve())
    dev = torch.device("cuda", torch.cuda.current_device())
    pts, out_num = fit_body(args.particles)
    if args.gather_only:
        rng = np.random.default_rng(0)
        body = pts + 0.05 * suggest_h(pts, 32) * rng.normal(size=pts.shape)
        body[:, 1] = body[:, 1].mean() + 1.05 * (body[:, 1] - body[:, 1].mean())
        out, evals = gather_numbers(torch, np, args, dev, pts, out_num, body,
                                    not args.no_steps)
        out = {"tree": str(Path(args.tree).resolve()), "card": card_line(),
               "digest": {}} | out
        time_evals(torch, pk, args, out, evals, {}, [])
        print(json.dumps(out), flush=True)
        return
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
    R, F, S, M, vol_m = mid_section(A, Y, ratio, scene.materials, scene, cfg, m)
    gT = slot_rows([vol_m * M[a][c] for a in range(3) for c in range(3)], sb.n_slots)
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

    # K2 v2 and its passes: on the fused path's records over the sparse
    # scene, and on path B's over the varcol scene (as chip_smoke.py phase 25)
    rs = fk.row_static(sb, scene.materials, scene.rest_corr)
    fmT, srT_f = fk.moments_mid_all(posT, posT[:, :m], cfg.stiffness_scale(ratio[:m]),
                                    sb, rs, h, cfg.corotated, pk.PLAIN)
    scene_b, sop_b = build_blocked_scene(pts, cfg, out_num=out_num, device=dev,
                                         dirichlet_mask=dirichlet_mask(pts, "stretch"))
    blk = scene_b.blocked
    m_b = blk.n_tiles * blk.rows
    x_b = torch.as_tensor(x_star_bands(pts, blk.n_slots, sop_b), dtype=torch.float32,
                          device=dev)
    ratio_b = compute_ratio(x_b, cfg)
    pos_b = scene_b.rest_position.clone()
    pos_b[scene_b.slot_of_particle] = torch.as_tensor(body, dtype=torch.float32,
                                                      device=dev)
    posT_b = pos_b.T.contiguous()
    ay_b = fk.moments_raw_all(posT_b, blk, h, pk.PLAIN)
    A_b = [[ay_b[3 * c + a] - posT_b[a, :m_b] * blk.rs6T[c] for c in range(3)]
           for a in range(3)]
    Y_b = [[ay_b[9 + 3 * c + a] - posT_b[a, :m_b] * blk.rs6T[3 + c] for c in range(3)]
           for a in range(3)]
    R_b, F_b, S_b, M_b, vol_b = mid_section(A_b, Y_b, ratio_b, scene_b.materials,
                                            scene_b, cfg, m_b)
    fmT_b = torch.stack([F_b[a][c] for a in range(3) for c in range(3)]
                        + [M_b[a][c] for a in range(3) for c in range(3)] + [vol_b])
    srT_b = slot_rows([S_b[0][0], S_b[0][1], S_b[0][2], S_b[1][1], S_b[1][2], S_b[2][2]]
                      + [R_b[a][c] for c in range(3) for a in range(3)], blk.n_slots)
    gT_b = slot_rows([vol_b * M_b[a][c] for a in range(3) for c in range(3)], blk.n_slots)
    dfT_b = torch.as_tensor(rng.normal(size=(3, m_b)), dtype=torch.float32, device=dev)
    del ay_b, A_b, Y_b, R_b, F_b, S_b, M_b
    v2_whole = "sb" in inspect.signature(fk.forces_warp_v2).parameters
    v2_kernels = ("forces_warp_v2", "forces_warp_v2_bwd_rows", "forces_warp_v2_bwd_slab")
    for label, sc_, fm, sr, df in (("", sb, fmT, srT_f, dfT),
                                   ("varcol_", blk, fmT_b, srT_b, dfT_b)):
        for name in v2_kernels:
            wrapper = getattr(fk, name)
            ops = (fm, sr) if name == "forces_warp_v2" else (fm, sr, df)
            if v2_whole:                    # one launch over the scene
                evals[label + name] = (lambda w=wrapper, sc_=sc_, ops=ops:
                                       w(sc_, *ops, h))
                continue
            fns = []                        # one launch per bucket
            for b in sc_.buckets:
                c = slice(b.row_start, b.row_start + b.n_tiles * sc_.rows)
                a = (b.restT_rows, b.static_slab, fm[:, c], sr, b.gidx8) + (
                    (df[:, c],) if name != "forces_warp_v2" else ())
                fns.append(lambda w=wrapper, a=a: w(*a, h))
            evals[label + name] = lambda fns=fns: [f() for f in fns]
            per_launch[label + name] = fns
    # the fused path's K1 + mid-section on the sparse scene, and the raw K1
    # backward with its row term there and without it on the varcol scene
    scale = cfg.stiffness_scale(ratio[:m])
    dayT_b = torch.as_tensor(rng.normal(size=(18, m_b)), dtype=torch.float32, device=dev)
    if "sb" in inspect.signature(fk.moments_mid).parameters:
        evals["moments_mid"] = lambda: fk.moments_mid(sb, posT, posT[:, :m], rs, scale, h,
                                                      cfg.corotated)
    else:
        fns = [lambda b=b: fk.moments_mid(b.restT_rows, b.static_slab, posT,
                                          posT[:, cols(b)], rs.cols(cols(b)),
                                          scale[cols(b)], b.gidx8, h, cfg.corotated)
               for b in sb.buckets]
        evals["moments_mid"] = lambda fns=fns: [f() for f in fns]
        per_launch["moments_mid"] = fns
    raw_whole = "sb" in inspect.signature(fk.moments_raw_bwd).parameters
    for label, sc_, day in (("", sb, dayT), ("varcol_", blk, dayT_b)):
        if raw_whole:
            evals[label + "moments_raw_bwd"] = (lambda sc_=sc_, day=day:
                                                fk.moments_raw_bwd(sc_, day, h, sc_ is sb))
            continue
        fns = [lambda b=b, day=day, c=slice(b.row_start, b.row_start + b.n_tiles * sc_.rows):
               fk.moments_raw_bwd(b.restT_rows, b.static_slab, day[:, c], h)
               for b in sc_.buckets]
        evals[label + "moments_raw_bwd"] = lambda fns=fns: [f() for f in fns]
        per_launch[label + "moments_raw_bwd"] = fns
    # the scatters of one backward evaluation's per-entry buffers on both
    # scenes: the f32 slab_to_slots of K1's 3 fields and K2's 15 (its 2
    # launches), and slab_to_slots_bf16 of the bf16 K2 slab's 15
    srT16, srT_b16 = srT.to(torch.bfloat16), srT_b.to(torch.bfloat16)
    for label, sc_, bufs in (
            ("", sb, lambda: (pk.moments_v4_bwd(sb, dayT, h)[0],
                              pk.forces_warp_v4_bwd_slab(sb, f9T, srT, dfT, h),
                              pk.forces_warp_v4_bwd_slab(sb, f9T, srT16, dfT, h))),
            ("varcol_", blk, lambda: (fk.moments_raw_bwd(blk, dayT_b, h, False)[0],
                                      fk.forces_warp_v2_bwd_slab(blk, fmT_b, srT_b,
                                                                 dfT_b, h),
                                      fk.forces_warp_v2_bwd_slab(blk, fmT_b, srT_b16,
                                                                 dfT_b, h)))):
        if not (raw_whole and v2_whole and hasattr(sc_, "chunks")):
            break                               # a tree whose passes take a bucket
        dps, dsr, dsr16 = bufs()
        csr = (sc_.slab_ptr, sc_.slab_idx, sc_.n_slots, sc_.group)
        evals[label + "slab_to_slots"] = (lambda dps=dps, dsr=dsr, csr=csr: (
            pk.slab_to_slots(dps, *csr), pk.slab_to_slots(dsr, *csr)))
        evals[label + "slab_to_slots_bf16"] = (
            lambda a=(dsr16, sc_.slab_ptr, sc_.slab_idx, sc_.bucket_starts, sc_.n_slots,
                      sc_.group): pk.slab_to_slots_bf16(*a))
    # the separable K2 and its backward on G = V M of both scenes
    from softbody_tpu_torch.ops import separable_kernels as sk

    sep_whole = "sb" in inspect.signature(sk.forces_sep).parameters
    for label, sc_, g, vol, df in (("", sb, gT, vol_m, dfT),
                                   ("varcol_", blk, gT_b, vol_b, dfT_b)):
        if sep_whole:                       # one launch over the scene
            evals[label + "forces_sep"] = lambda sc_=sc_, g=g, vol=vol: sk.forces_sep(
                sc_, g, vol, h)
            evals[label + "forces_sep_bwd"] = (lambda sc_=sc_, vol=vol, df=df:
                                               sk.forces_sep_bwd(sc_, vol, df, h))
            continue
        fwd, bwd = [], []                   # one launch per bucket, two passes
        for b in sc_.buckets:
            c = slice(b.row_start, b.row_start + b.n_tiles * sc_.rows)
            fa = (b.restT_rows, b.static_slab, g[:, c], g, vol[c], b.gidx8, h)
            ba = (b.restT_rows, b.static_slab, vol[c], df[:, c], h)
            fwd.append(lambda fa=fa: sk.forces_sep(*fa))
            bwd += [lambda ba=ba: sk.forces_sep_bwd_rows(*ba),
                    lambda ba=ba: sk.forces_sep_bwd_slab(*ba)]
        for name, fns in (("forces_sep", fwd), ("forces_sep_bwd", bwd)):
            evals[label + name] = lambda fns=fns: [f() for f in fns]
            per_launch[label + name] = fns
    # the mid-section kernels on both scenes' strained rows (phase 44's)
    from softbody_tpu_torch.ops import mid_kernels as mk
    from softbody_tpu_torch.sim.rollout import initial_state, step

    with torch.no_grad():
        st = initial_state(scene, ratio, cfg)._replace(position=posT.T.contiguous())
        for _ in range(MID_STEPS):
            st = step(st, ratio, scene, cfg)
    strained = st.position
    strained_b = scene_b.rest_position.clone()
    strained_b[scene_b.slot_of_particle] = strained[scene.slot_of_particle]
    mid_ops, ring_plans = {}, {}
    for label, sc_, rat, pos_s in (("", scene, ratio, strained),
                                   ("varcol_", scene_b, ratio_b, strained_b)):
        b_ = sc_.blocked
        m_s = b_.n_tiles * b_.rows
        pT = pos_s.T.contiguous()
        raw = label == "varcol_"
        ay = (fk.moments_raw_all(pT, b_, h, pk.PLAIN) if raw
              else pk.moments_all(pT, pT[:, :m_s], b_, h, pk.PLAIN))
        mid_ops[label] = (ay, mk.row_static(b_, sc_.materials, sc_.rest_corr),
                          cfg.stiffness_scale(rat[:m_s]), cfg.corotated, b_.n_slots,
                          pT[:, :m_s] if raw else None, b_.rs6T if raw else None,
                          torch.as_tensor(rng.normal(size=(19, m_s)), dtype=torch.float32,
                                          device=dev),
                          torch.as_tensor(rng.normal(size=(15, m_s)), dtype=torch.float32,
                                          device=dev))
        ay, rs_, sc_s, corot, n_sr, p, r6, dfm, dsr = mid_ops[label]
        evals[label + "mid_records"] = (lambda a=(ay, rs_, sc_s, corot, n_sr, p, r6):
                                        mk.mid_records(*a))
        evals[label + "mid_records_bwd"] = (
            lambda a=(ay, rs_, sc_s, corot, dfm, dsr, p, r6): mk.mid_records_bwd(*a))
        if hasattr(mk, "ring_plan"):        # a tree with the ring kernels
            evals[label + "mid_records_ring"] = (
                lambda a=(ay, rs_, sc_s, corot, n_sr, p, r6): mk.mid_records_ring(*a))
            evals[label + "mid_records_bwd_ring"] = (
                lambda a=(ay, rs_, sc_s, corot, dfm, dsr, p, r6): mk.mid_records_bwd_ring(*a))
            ring_plans.update({label + name: mk.ring_plan(name, torch.float32, m_s)
                               for name in (mk.INSTANCES[1:4:2] if raw
                                            else mk.INSTANCES[0:4:2])})
    g_out, g_evals = gather_numbers(torch, np, args, dev, pts, out_num, body, False)
    evals.update(g_evals)
    out = {"tree": str(Path(args.tree).resolve()), "card": card_line(),
           "sm_clock_max_mhz": float(subprocess.run(
               ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
               capture_output=True, text=True).stdout.split()[0]),
           "buckets": [[b.slab_len, b.n_tiles] for b in sb.buckets]}
    # digests of outputs that must not change bitwise between two trees (and
    # the ring kernels', which must equal the one-wave kernels')
    out["digest"] = {key: digest(torch, evals[key]()) for key in (
        "moments_mid", "mid_records", "mid_records_bwd", "varcol_mid_records",
        "varcol_mid_records_bwd") + tuple(k for k in evals if k.endswith("_ring")
                                          or k.endswith("slab_to_slots"))}
    out["digest"].update(g_out.pop("digest", {}))
    out.update(g_out)
    out["ring_plan"] = ring_plans
    ring_fns = [getattr(mk, n) for n in ("mid_records_ring", "mid_records_bwd_ring")
                if hasattr(mk, n)]
    time_evals(torch, pk, args, out, evals, per_launch, ring_fns)
    from softbody_tpu_torch.ops import _build
    out["sass_per_pair"] = {}
    for source in _build.SOURCES:           # the tree's own sources
        out["sass_per_pair"].update(sass_per_pair(
            _build.library_path(source),
            tuple(per_bucket) + v2_kernels + ("moments_mid", "moments_raw_bwd",
                                              "forces_sep", "forces_sep_bwd",
                                              "forces_sep_bwd_rows",
                                              "forces_sep_bwd_slab")))
    rows = sass_per_row(sass_functions(_build.library_path("mid_kernels")),
                        ("mid_records", "mid_records_bwd"), mk.SWEEPS)
    out["sass_per_row"] = rows
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out["issue_floor_ms"] = {
        key: n * rows_m / 32 / (sms * 4) / (out["sm_clock_max_mhz"] * 1e6) * 1e3
        for key, n in rows.items()
        for rows_m in [m_b if "_corr" in key else m]}
    out["buckets_varcol"] = [[b.slab_len, b.n_tiles] for b in blk.buckets]
    del fmT, srT_f, fmT_b, srT_b, gT, gT_b, mid_ops
    if args.no_steps:
        print(json.dumps(out), flush=True)
        return
    bf16 = cfg.replace(pair_dtype="bfloat16")
    steps = {"": (scene, cfg, ratio, x_star),
             "j_": (scene, cfg.replace(pair_def_grad="j"), ratio, x_star),
             "f_": (scene, cfg.replace(fused_mid=True), ratio, x_star),
             "b_": (scene_b, cfg, ratio_b, x_b),
             "bf16_": (scene, bf16, ratio, x_star),
             "b_bf16_": (scene_b, bf16, ratio_b, x_b)}
    for label, (sc_, c, rat, x) in steps.items():
        if re.search(args.steps, label or "default"):
            out.update({f"{label}{k}": v for k, v in step_numbers(
                torch, sc_, c, rat, x, dev).items()})
    if re.search(args.steps, "g_"):
        out.update(gather_numbers(torch, np, args, dev, pts, out_num, body, True)[0])
    print(json.dumps(out), flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_evals(torch, pk, args, out, evals, per_launch, ring_fns):
    """Each kernel of ``evals`` (those matching ``--kernels``): its launches
    per evaluation and its ms (``<key>_launches``, ``<key>_ms``; a per-bucket
    kernel's launches one by one too)."""
    if args.kernels:
        evals = {k: v for k, v in evals.items() if re.search(args.kernels, k)}
    for key, fn in evals.items():
        pk.reset_launch_counts()
        for f in ring_fns:
            f.launches = 0
        fn()
        torch.cuda.synchronize()
        out[f"{key}_launches"] = (sum(pk.launch_counts().values())
                                  + sum(f.launches for f in ring_fns))
        out[f"{key}_ms"] = cuda_ms(torch, fn, args.reps)
        if key.endswith("gather_moments_bwd") or key.endswith("gather_forces_bwd"):
            label = key[:-len("gather_forces_bwd")] if key.endswith("forces_bwd") else (
                key[:-len("gather_moments_bwd")])
            for name, ms in pass_ms(torch, fn, args.reps).items():
                out[f"{label}{name}_ms"] = ms
        if key in per_launch:
            out[f"{key}_sum_of_launches_ms"] = sum(
                cuda_ms(torch, f, args.reps) for f in per_launch[key])


if __name__ == "__main__":
    main()
