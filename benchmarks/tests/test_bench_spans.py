"""The span readers' arithmetic on synthetic traces with known spans and
gaps: device busy time inside ``grad.forward``, the idle gaps by the pass
they begin in, the median host step inside the forward; and None for a
forward unit, a trace without spans, and no trace."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmarks import spec
from benchmarks.metrics import _spans
from benchmarks.metrics._profile import Trace

T = 10
K = "kernel"

# host ns: the forward [0, 1000) with three steps, a recompute [1100, 2000)
# with one, a backward [2000, 2900); cudaLaunchKernel events around them
HOST = [("grad.forward", 0, 1000), ("sim.step", 100, 200), ("sim.step", 300, 400),
        ("sim.step", 500, 700), ("cudaLaunchKernel", 110, 120),
        ("grad.recompute", 1100, 2000), ("sim.step", 1200, 1300),
        ("grad.backward", 2000, 2900)]
# device (name, start, duration): busy in the forward [50, 200) + [300, 500)
# + [900, 1000) = 450; gaps (start, length): (200, 100), (500, 400) in the
# forward; (1200, 100), (1400, 700) in the recompute; (2200, 300),
# (2600, 900) in the backward; (3510, 490) in none
DEVICE = [(K, 50, 100), (K, 120, 80), (K, 300, 200), (K, 900, 300), (K, 1300, 100),
          (K, 2100, 100), (K, 2500, 100), (K, 3500, 10), (K, 4000, 10)]
WANT = {"fwd_pass_ms_per_step.grad": 450 / T / 1e6,
        "fwd_idle_ms_per_step.grad": 500 / T / 1e6,
        "recompute_idle_ms_per_step.grad": 800 / T / 1e6,
        "bwd_idle_ms_per_step.grad": 1200 / T / 1e6,
        "fwd_step_host_ms.grad": 100 / 1e6}
NAMES = sorted(WANT)


def ctx(host=HOST, device=DEVICE, entry="value_and_grad"):
    return SimpleNamespace(entry=entry, trace=Trace(device, host, 5e-6, T), trace_steps=T)


def reader(name):
    return spec.load_reader(spec.HERE / "metrics" / f"{name}.py")


@pytest.mark.parametrize("name", NAMES)
def test_reader_arithmetic(name):
    assert reader(name)(ctx()) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_reader_none_without_spans(name):
    read = reader(name)
    assert read(ctx(entry="forward")) is None
    assert read(ctx(host=[h for h in HOST if "." not in h[0]])) is None
    assert read(ctx(device=[])) is None
    assert read(SimpleNamespace(entry="value_and_grad", trace=None, trace_steps=T)) is None


def test_registered_for_both_grad_cells():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in NAMES:
        m = entries[name]
        assert m["layer"] == "gradient runner" and m["moves"] == "grad_psteps_per_s"
        assert m["workloads"] == ["million.grad", "stretch112k_varcol.grad"]


def test_gaps_match_trace_idle_gaps():
    c = ctx()
    gaps = _spans.gaps(c.trace)
    assert gaps == [(200, 100), (500, 400), (1200, 100), (1400, 700), (2200, 300),
                    (2600, 900), (3510, 490)]
    assert sum(d for _, d in gaps) / 1e9 == pytest.approx(
        sum(v for _, v in c.trace.idle_gaps(k=100)))
    # the three passes' idle and the gap outside every span make the whole
    passes = sum(WANT[n] for n in NAMES if "idle" in n) * T * 1e6
    assert passes + 490 == pytest.approx(sum(d for _, d in gaps), rel=1e-12)
