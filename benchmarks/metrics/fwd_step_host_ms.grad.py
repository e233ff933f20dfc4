"""Median host ms of one step (span sim.step) inside the no-grad forward:
the host's cost to issue a step."""

from benchmarks.metrics._spans import FORWARD, step_host_ms


def read(ctx):
    return step_host_ms(ctx, FORWARD)
