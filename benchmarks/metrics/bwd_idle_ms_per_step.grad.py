"""Device idle ms per step in gaps that begin inside a chunk's backward
(spans grad.backward)."""

from benchmarks.metrics._spans import BACKWARD, idle_ms_per_step


def read(ctx):
    return idle_ms_per_step(ctx, BACKWARD)
