"""The program's spans in the traced unit, read against the device's
activities.  A span is a host event of ``Trace.host`` found by its exact
name (``softbody_tpu_torch.utils.profiling.span``): ``grad.forward``, the
no-grad forward of a gradient evaluation; ``grad.recompute``, a chunk's
recompute under autograd; ``grad.backward``, a chunk's backward (and the
initial state's); ``sim.step``, one step.  Each reader returns None where
its cell gives it nothing to read: another entry point, no device
activity, or no such span (a program without spans)."""

from __future__ import annotations

import bisect
import statistics

FORWARD, RECOMPUTE, BACKWARD = "grad.forward", "grad.recompute", "grad.backward"
STEP = "sim.step"


def spans(ctx, name):
    """The [start_ns, end_ns) of every span ``name`` of a gradient unit's
    trace, sorted by start, or None.  Spans of one name follow one another
    on the runner's thread, so they never overlap."""
    t = ctx.trace
    if ctx.entry != "value_and_grad" or t is None or not t.device:
        return None
    return [(s, e) for n, s, e in t.host if n == name] or None


def gaps(trace):
    """(start_ns, length_ns) of the idle gaps between consecutive device
    activities, cut as ``Trace.idle_gaps`` cuts them."""
    dev = trace.device
    if not dev:
        return []
    out, end = [], dev[0][1] + dev[0][2]
    for _, s, d in dev[1:]:
        if s > end:
            out.append((end, s - end))
        end = max(end, s + d)
    return out


def busy_ms_per_step(ctx, name):
    """Device busy time (the union of activities) inside the spans
    ``name``, ms per step."""
    found = spans(ctx, name)
    if found is None:
        return None
    total = 0
    for a, b in found:
        end = a
        for _, s, d in ctx.trace.device:
            if s >= b:
                break
            lo, hi = max(s, end), min(s + d, b)
            if hi > lo:
                total += hi - lo
                end = hi
    return total / 1e6 / ctx.trace_steps


def idle_ms_per_step(ctx, name):
    """The idle gaps between device activities that begin inside a span
    ``name``, ms per step."""
    found = spans(ctx, name)
    if found is None:
        return None
    starts = [a for a, _ in found]
    total = 0
    for t, d in gaps(ctx.trace):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < found[i][1]:
            total += d
    return total / 1e6 / ctx.trace_steps


def step_host_ms(ctx, name):
    """Median host duration, ms, of the ``sim.step`` spans inside the spans
    ``name``."""
    outer, steps = spans(ctx, name), spans(ctx, STEP)
    if outer is None or steps is None:
        return None
    inside = [e - s for s, e in steps if any(a <= s and e <= b for a, b in outer)]
    return statistics.median(inside) / 1e6 if inside else None
