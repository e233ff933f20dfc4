"""Device busy ms per step inside the gradient's no-grad forward (span
grad.forward)."""

from benchmarks.metrics._spans import FORWARD, busy_ms_per_step


def read(ctx):
    return busy_ms_per_step(ctx, FORWARD)
