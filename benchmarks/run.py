"""Run one cell of the benchmark once.

    python3 -m benchmarks.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout holding ``BENCHMARK.json``, this package and
the program (``softbody_tpu_torch``).  Set-up (imports, body, the
program's scene build and targets, one warm-up unit that builds or loads
every kernel) runs first and is ``setup_s``; then the window repeats the
cell's unit (one gradient evaluation or one forward episode on a fresh x
drawn from the seed), starting none it could not finish within
``--seconds`` and always at least one, and ends when the last ends.
With ``--trace 1`` the window is one unit under ``torch.profiler`` and the
result carries the per-layer metrics instead of the end-to-end ones.

After the window a unit drawn from the seed is worked out again by the
plain reference and compared (``correct.py``); each number compared is
printed beside its limit as the last lines of standard error and under
``checks`` at the end of the result, the last line of standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks import correct, inputs, spec  # noqa: E402
from benchmarks.metrics import _profile  # noqa: E402
from benchmarks.program import Program, sync  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "softbody_tpu")
RATE = {"value_and_grad": "grad_psteps_per_s", "forward": "fwd_psteps_per_s"}


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """The top-level names in ``sys.modules`` that are JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def finite(out) -> bool:
    """Every number of a unit's output is finite."""
    return all(math.isfinite(float(o)) if not torch.is_tensor(o)
               else bool(torch.isfinite(o).all()) for o in out)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> dict:
    """One run of ``cell``; returns the result line as a dict."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    pts, n_outer, h, mask = inputs.body(cell.config)
    prog = Program(cell, pts, n_outer, h, mask, device)
    say(f"scene: {len(pts)} particles, {prog.n_slots} slots, built in "
        f"{prog.scene_build_s:.3f} s")
    pts_t = torch.as_tensor(pts, dtype=torch.float64, device=device)
    xspec = cell.traffic["x"]
    prog.warm_up(inputs.smooth_field(pts_t, xspec, inputs.seed_generator(~seed, device)))
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    say(f"set-up {setup_s:.3f} s")

    gen = inputs.seed_generator(seed, device)
    outs, xs, durs, trc, launches = [], [], [], None, None
    t_w = time.perf_counter()
    while True:
        x = inputs.smooth_field(pts_t, xspec, gen)
        if trace:
            from softbody_tpu_torch.ops import pair_kernels as pk

            pk.reset_launch_counts()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                out = prog.run(x)
                sync(device)
                d = time.perf_counter() - t0
            launches = pk.launch_counts()
            trc = _profile.from_profiler(prof, d, prog.steps)
            del prof
        else:
            t0 = time.perf_counter()
            out = prog.run(x)
            sync(device)
            d = time.perf_counter() - t0
        outs.append(out)
        xs.append(x)
        durs.append(d)
        if trace or time.perf_counter() - t_w + max(durs) > seconds:
            break
    wall = time.perf_counter() - t_w
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    say(f"window: {len(outs)} units in {wall:.3f} s ({', '.join(f'{d:.3f}' for d in durs)})")

    n = len(pts)
    k = int(np.random.default_rng(seed).integers(len(outs)))
    failed = sum(not finite(o) for o in outs)
    sample, x_k = outs[k], xs[k]
    scene_build_s, entry, steps = prog.scene_build_s, prog.entry, prog.steps
    pair_def_grad, value_bytes = prog.cfg.pair_def_grad, prog.dtype.itemsize
    del prog, outs, xs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ref = correct.Reference(cell, pts, h, mask, device)
    want = ref.run(x_k)
    values = correct.compare(entry, sample, want, ref.rest)
    ok, checks = correct.judge(values, cell.limits)
    say(f"reference: unit {k} worked out again in {time.perf_counter() - t0:.3f} s")

    if trace:
        ctx = SimpleNamespace(entry=entry, trace=trc, launches=launches, trace_steps=steps,
                              scene_build_s=scene_build_s, n_rows=n, n_pairs=ref.st.n_pairs,
                              pair_def_grad=pair_def_grad, value_bytes=value_bytes)
        metrics, readers = {}, cell.readers()
        for m in cell.per_layer:
            v = readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, RATE[entry]: n * steps * len(durs) / wall,
               "peak_mem_gib": window_peak / 2 ** 30 if cuda else None}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if e2e.get(m["name"]) is not None}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": max(setup_peak, window_peak)}
    result = {"correct": bool(ok and not failed), "attempted": len(durs), "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = trc.busy_s()
        dev["window_s"] = trc.window_s
        result["breakdown"] = {"device_ops": trc.top_ops(), "idle_gaps": trc.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        say(f"{args.workload} needs {cell.chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        say(f"the run loaded {', '.join(found)}: the benchmark runs without JAX")
        return 3
    for name, c in result["checks"].items():
        say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
