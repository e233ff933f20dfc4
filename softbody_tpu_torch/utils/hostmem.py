"""Host allocator tuning for fault-expensive VMs (the port's own copy of
``enable_heap_reuse`` from ``softbody_tpu/utils/hostmem.py``).

Scene building is vectorized numpy over ~100MB temporaries (~1.4 GB for the
scatter buffer of a 1.16M-particle sparse scene).  glibc serves allocations
over MALLOC_MMAP_THRESHOLD (128KB default) with fresh mmaps and munmaps them
on free, so every large temporary re-faults its pages; on VMs where
anonymous-page faults are slow that turns a sub-second layout build into
minutes.  ``enable_heap_reuse`` routes large allocations through the brk heap
and stops glibc from trimming it, so pages fault once per process and are
reused by every later temporary.

Opt out with SOFTBODY_NO_HEAP_REUSE=1 (e.g. when peak RSS matters more than
build latency).

The JAX module's ``enable_compilation_cache`` and
``compiler_options_from_env`` configure XLA and have no counterpart here:
the port's build cache is ``ops/_build.py``, whose libraries carry a hash of
their sources and flags in their names and are built once per checkout.
"""

from __future__ import annotations

import ctypes
import os
import sys

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_done = False


def enable_heap_reuse() -> bool:
    """Idempotent; returns True when the mallopt calls took effect."""
    global _done
    if _done:
        return True
    if os.environ.get("SOFTBODY_NO_HEAP_REUSE"):
        return False
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30))
        ok = bool(libc.mallopt(_M_TRIM_THRESHOLD, (1 << 31) - 1)) and ok
    except Exception:
        return False
    _done = ok
    return ok
