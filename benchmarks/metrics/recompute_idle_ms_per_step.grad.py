"""Device idle ms per step in gaps that begin inside a chunk's recompute
(spans grad.recompute)."""

from benchmarks.metrics._spans import RECOMPUTE, idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, RECOMPUTE)
