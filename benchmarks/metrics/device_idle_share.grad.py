"""1 - device busy / wall over the traced window."""

from benchmarks.metrics._readers import device_idle_share


def read(ctx):
    return device_idle_share(ctx, "value_and_grad")
