"""Profiling / observability on torch (counterpart of
``softbody_tpu/utils/profiling.py``).

Wall-clock throughput records (particle-steps/s, the BASELINE.md metric), a
``torch.profiler`` trace context that writes a Chrome trace, and a step timer
on CUDA events.  Kernels launch asynchronously on the current stream: a wall
clock reads the device's work only after :func:`sync_point`.
"""

from __future__ import annotations

import contextlib
import json
import time
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


class Throughput:
    """Particle-steps/sec counter around episode executions."""

    def __init__(self, n_particles: int):
        self.n = n_particles
        self.records = []

    @contextlib.contextmanager
    def measure(self, n_steps: int, label: str = "episode"):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.records.append({
            "label": label,
            "steps": n_steps,
            "seconds": dt,
            "particle_steps_per_sec": self.n * n_steps / dt,
        })

    @property
    def best(self):
        return max((r["particle_steps_per_sec"] for r in self.records), default=0.0)

    def dump(self, path):
        Path(path).write_text(json.dumps(self.records, indent=1))


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


class StepTimer:
    """Per-step timing of a state -> state function."""

    @staticmethod
    def time_step_fn(step_fn, state, iters: int = 50):
        """Seconds per call of ``step_fn(state) -> state`` over ``iters``
        chained calls after one warm-up call: CUDA events on the card, the
        host clock otherwise."""
        state = step_fn(state)
        cuda = torch.cuda.is_available() and _on_cuda(state)
        if not cuda:
            t0 = time.perf_counter()
            for _ in range(iters):
                state = step_fn(state)
            return (time.perf_counter() - t0) / iters
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            state = step_fn(state)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3 / iters


def _on_cuda(state) -> bool:
    """Whether a tensor of ``state`` lies on a CUDA device."""
    if isinstance(state, torch.Tensor):
        return state.is_cuda
    if isinstance(state, (tuple, list)):
        return any(_on_cuda(s) for s in state)
    return False
