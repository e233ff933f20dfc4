"""Device idle ms per step in gaps that begin inside the no-grad forward
(span grad.forward)."""

from benchmarks.metrics._spans import FORWARD, idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, FORWARD)
