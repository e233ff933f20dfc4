"""The readings a cell's limits are set from, in one process on the card:
the program's sound runs against the plain reference over many seeds (the
lower reading of each number compared) and the control, the reference in
TF32, on the first few (the upper reading).

    python3 -m benchmarks.calibrate --workload <name> --seeds 12 --control 3 [--first 1]

Seed s draws the x of a run's first unit.  Prints one JSON line a seed and
a summary line: the largest sound reading and the smallest control reading
of each number.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmarks import correct, inputs, spec
from benchmarks.program import Program, sync


def readings(cell, seeds, n_control: int, device, out=print):
    """[(seed, program numbers, control numbers or None)] of ``cell``."""
    pts, n_outer, h, mask = inputs.body(cell.config)
    prog = Program(cell, pts, n_outer, h, mask, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = correct.Reference(cell, pts, h, mask, device)
    ctl = ref.control()
    pts_t = torch.as_tensor(pts, dtype=torch.float64, device=device)
    rows = []
    for i, s in enumerate(seeds):
        x = inputs.smooth_field(pts_t, cell.traffic["x"], inputs.seed_generator(s, device))
        t0 = time.perf_counter()
        o = prog.run(x)
        sync(device)
        t1 = time.perf_counter()
        want = ref.run(x)
        sync(device)
        t2 = time.perf_counter()
        p = correct.compare(prog.entry, o, want, ref.rest)
        c = correct.compare(prog.entry, ctl.run(x), want, ref.rest) if i < n_control else None
        rows.append((s, p, c))
        out(json.dumps({"seed": s, "program": p, "control": c,
                        "program_s": t1 - t0, "reference_s": t2 - t1}))
    return rows


def summary(rows) -> dict:
    names = rows[0][1].keys()
    ctl = [c for _, _, c in rows if c is not None]
    return {k: {"lower": max(p[k] for _, p, _ in rows),
                "upper": min(c[k] for c in ctl) if ctl else None} for k in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration runs on a CUDA card", file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload)
    seeds = [args.first + 1_000_003 * i for i in range(args.seeds)]
    rows = readings(cell, seeds, args.control, torch.device("cuda"),
                    out=lambda s: print(s, flush=True))
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
