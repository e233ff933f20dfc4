"""Profiling / observability on torch (counterpart of
``softbody_tpu/utils/profiling.py``).

A ``torch.profiler`` trace context that writes a Chrome trace, and the
program's spans (:func:`span`), which mark its passes on the profiler's
timeline.  Kernels launch asynchronously on the current stream: a wall clock
reads the device's work only after :func:`sync_point`.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


def sync_point(device=None):
    """Wait for the card's queued work (a no-op without a CUDA device, or
    when ``device`` is a CPU device or tensor)."""
    if isinstance(device, torch.Tensor):
        device = device.device
    if device is not None and torch.device(device).type != "cuda":
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block (CPU activities, and the card's
    where one is present); the Chrome trace lands in
    ``log_dir/trace.json`` (open it in chrome://tracing or Perfetto).
    Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        sync_point()
    prof.export_chrome_trace(str(out / "trace.json"))


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context marking a pass of the program as the host range ``name``
    on the profiler's timeline, beside the device's activities.

    Without an active profiler it is one check and returns a shared no-op
    context.  Under one it is a FUNCTION-scope range
    (``_RecordFunctionFast``): a plain host event.  A ``record_function``
    range would be a user annotation, which the CUDA tracer mirrors as a
    device interval over the kernels launched inside it, so it would show
    among the device's activities."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)
