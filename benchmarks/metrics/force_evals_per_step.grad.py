"""K1 launches per gradient step (the program's launch counters)."""

from benchmarks.metrics._readers import force_evals_per_step


def read(ctx):
    return force_evals_per_step(ctx, "value_and_grad")
