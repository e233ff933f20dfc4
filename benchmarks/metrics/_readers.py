"""The per-layer readers' shared arithmetic.  Each reader returns None
where its cell gives it nothing to read: another entry point, no trace, no
device activity, or no pair count."""

from __future__ import annotations

from ._work import step_bound_s

# the K1 (moments) entries of every path, as the program counts launches
K1 = ("moments_v4", "moments_raw", "moments_mid", "gather_moments")


def _trace(ctx, entry):
    if ctx.entry != entry or ctx.trace is None or not ctx.trace.device:
        return None
    return ctx.trace


def force_evals_per_step(ctx, entry):
    if ctx.entry != entry or not ctx.launches:
        return None
    k1 = sum(ctx.launches.get(k, 0) for k in K1)
    return k1 / ctx.trace_steps if k1 else None


def kernel_ms_per_step(ctx, entry):
    t = _trace(ctx, entry)
    return None if t is None else t.own_kernel_s() * 1e3 / ctx.trace_steps


def kernels_roofline(ctx, entry):
    """Percent: the bound of the traced steps over their device time."""
    t = _trace(ctx, entry)
    if t is None or not ctx.n_pairs:
        return None
    bound = step_bound_s(ctx.n_rows, ctx.n_pairs, entry == "value_and_grad",
                         ctx.pair_def_grad, ctx.value_bytes)
    return 100.0 * bound * ctx.trace_steps / t.device_s()


def device_idle_share(ctx, entry):
    t = _trace(ctx, entry)
    return None if t is None else 1.0 - t.busy_s() / t.window_s
