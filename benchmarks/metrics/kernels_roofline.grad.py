"""Percent of the step's roofline: its bound over its device time."""

from benchmarks.metrics._readers import kernels_roofline


def read(ctx):
    return kernels_roofline(ctx, "value_and_grad")
