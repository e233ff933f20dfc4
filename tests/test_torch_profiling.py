"""PyTorch port: ``utils/profiling`` on torch — the Chrome trace of
``trace`` on the CPU, ``Throughput``'s records as the JAX package's, the
step timer and ``sync_point`` without a card; ``utils/hostmem``."""

import json
import time

import torch

from softbody_tpu.utils import profiling as jprofiling
from softbody_tpu_torch.utils import hostmem, profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "tr") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert any("mm" in str(n) for n in names)
    assert prof.key_averages()


def test_throughput_records_as_jax():
    got, want = profiling.Throughput(1000), jprofiling.Throughput(1000)
    for thr in (got, want):
        with thr.measure(50, label="ep"):
            time.sleep(0.01)
    assert [sorted(r) for r in got.records] == [sorted(r) for r in want.records]
    r = got.records[0]
    assert r["label"] == "ep" and r["steps"] == 50 and r["seconds"] >= 0.01
    assert r["particle_steps_per_sec"] == 1000 * 50 / r["seconds"] == got.best
    assert profiling.Throughput(3).best == jprofiling.Throughput(3).best == 0.0


def test_step_timer_and_sync_point_on_cpu(tmp_path):
    calls = []

    def step(x):
        calls.append(1)
        return x + 1

    s = profiling.StepTimer.time_step_fn(step, torch.zeros(3), iters=5)
    assert s >= 0 and len(calls) == 6            # one warm-up, 5 timed
    profiling.sync_point(torch.zeros(1))
    profiling.sync_point("cpu")
    t = profiling.Throughput(10)
    with t.measure(2):
        pass
    t.dump(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text()) == t.records


def test_heap_reuse_is_idempotent(monkeypatch):
    first = hostmem.enable_heap_reuse()
    assert hostmem.enable_heap_reuse() == first
    monkeypatch.setattr(hostmem, "_done", False)
    monkeypatch.setenv("SOFTBODY_NO_HEAP_REUSE", "1")
    assert hostmem.enable_heap_reuse() is False
