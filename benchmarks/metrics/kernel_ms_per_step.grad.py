"""Device ms per step of the program's own kernels (profiler)."""

from benchmarks.metrics._readers import kernel_ms_per_step


def read(ctx):
    return kernel_ms_per_step(ctx, "value_and_grad")
