"""Reading a ``torch.profiler`` trace in memory: the device's activities,
its busy time (the union of their intervals), the host's operations, and
the idle gaps named by what the host was doing.  The arithmetic of the
program's ``chip_smoke.profile_card`` (device events of the trace summed),
with overlaps counted once."""

from __future__ import annotations

import bisect

# kernels of PyTorch and of the CUDA libraries, not of the program
LIBRARY_MARKS = ("at::", "c10::", "cub::", "cutlass", "cublas", "gemm", "Memcpy",
                 "Memset", "memcpy", "memset")


class Trace:
    """The events of one traced window."""

    def __init__(self, device, host, window_s: float, steps: int):
        self.device = sorted(device, key=lambda e: e[1])   # (name, start_ns, dur_ns)
        self.host = sorted(host, key=lambda e: e[1])       # (name, start_ns, end_ns)
        self.window_s = window_s
        self.steps = steps

    def busy_s(self) -> float:
        """Seconds in which some activity ran on the device."""
        total, end = 0, None
        for _, s, d in self.device:
            e = s + d
            if end is None or s >= end:
                total += d
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e9

    def own_kernel_s(self) -> float:
        """Seconds of the program's own kernels (not a library's)."""
        return sum(d for n, _, d in self.device if not is_library(n)) / 1e9

    def device_s(self) -> float:
        return sum(d for _, _, d in self.device) / 1e9

    def top_ops(self, k: int = 10):
        by = {}
        for n, _, d in self.device:
            n = short(n)
            by[n] = by.get(n, 0) + d
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda t: -t[1])[:k]]

    def idle_gaps(self, k: int = 10):
        """The idle time between device activities, summed by the innermost
        host operation running at each gap's start, largest first."""
        if not self.device:
            return []
        gaps, end = [], self.device[0][1] + self.device[0][2]
        for _, s, d in self.device[1:]:
            if s > end:
                gaps.append((end, s - end))
            end = max(end, s + d)
        starts = [h[1] for h in self.host]
        by = {}
        for t, d in gaps:
            name = self._host_at(t, starts)
            by[name] = by.get(name, 0) + d
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda t: -t[1])[:k]]

    def _host_at(self, t, starts):
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 500, -1), -1):
            name, s, e = self.host[j]
            if e > t:
                return name
        return "(no host operation)"


def short(name: str) -> str:
    """A kernel's name without its parameter list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].rstrip()
    return name


def is_library(name: str) -> bool:
    return any(m in name for m in LIBRARY_MARKS)


def from_profiler(prof, window_s: float, steps: int) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    try:
        events = prof.profiler.kineto_results.events()
        for e in events:
            if e.device_type() == cuda:
                device.append((e.name(), e.start_ns(), e.duration_ns()))
            else:
                host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    except AttributeError:
        for e in prof.events():
            s, d = int(e.time_range.start * 1000), int(e.time_range.elapsed_us() * 1000)
            if e.device_type == cuda:
                device.append((e.name, s, d))
            else:
                host.append((e.name, s, s + d))
    return Trace(device, host, window_s, steps)
