"""PyTorch port: ``utils/profiling`` on torch — the Chrome trace of
``trace`` on the CPU, ``sync_point`` without a card, the program's spans
(``span``: nothing without a profiler; under one, the gradient runner's
passes and steps as plain host ranges that change no number);
``utils/hostmem``."""

import json

import numpy as np
import pytest
import torch

from softbody_tpu_torch.config import warp_parity
from softbody_tpu_torch.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu_torch.scenarios import STRETCH, dirichlet_mask
from softbody_tpu_torch.sim.rollout import episode_value_and_grad_chunked
from softbody_tpu_torch.sim.sparse import build_sparse_scene
from softbody_tpu_torch.utils import hostmem, profiling

STEPS, CHUNKS = 12, 3
SPANS = ("grad.forward", "grad.recompute", "grad.backward", "sim.step")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "tr") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert any("mm" in str(n) for n in names)
    assert prof.key_averages()


def test_sync_point_on_cpu():
    profiling.sync_point(torch.zeros(1))
    profiling.sync_point("cpu")
    profiling.sync_point(torch.device("cpu"))


def test_span_off_enters_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: entered.append(name))
    assert not torch.autograd._profiler_enabled()
    ctx = profiling.span("sim.step")
    assert ctx is profiling.span("grad.forward") is profiling._OFF
    with ctx as got:
        assert got is None
    assert entered == []


@pytest.fixture(scope="module")
def traced():
    """A 12-step, 3-chunk gradient (remat on) on a few hundred particles,
    once untraced and once under ``torch.profiler``: (untraced (loss,
    grad), traced (loss, grad), {span name: [(start_ns, end_ns), ...]},
    the span events)."""
    pts, out_num = inflatable_sphere(n_outer=120)
    cfg = warp_parity().replace(h=suggest_h(pts, 32), dtype="float64", backend="pallas",
                                frames=STEPS, target_frames=STEPS // 4, remat=True,
                                **STRETCH)
    scene, sop = build_sparse_scene(pts, cfg, out_num=out_num, device="cpu",
                                    dirichlet_mask=dirichlet_mask(pts, "stretch"))
    rng = np.random.default_rng(21)
    x = np.zeros(scene.blocked.n_slots)
    x[sop] = rng.normal(scale=0.5, size=len(sop))
    tp = np.tile(scene.rest_position.numpy(), (STEPS // 4, 1, 1))
    tp[:, sop] += rng.normal(scale=1e-4, size=(STEPS // 4, len(sop), 3))
    tv = np.zeros_like(tp)
    vg = episode_value_and_grad_chunked(scene, cfg, CHUNKS)
    plain = vg(x, tp, tv)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = vg(x, tp, tv)
    events = [e for e in prof.profiler.kineto_results.events() if e.name() in SPANS]
    spans = {n: sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                       for e in events if e.name() == n) for n in SPANS}
    return plain, got, spans, events


def _inside(inner, outer):
    return sum(any(s >= a and e <= b for a, b in outer) for s, e in inner)


def test_gradient_runner_spans(traced):
    (loss, grad), (loss_t, grad_t), spans, _ = traced
    assert [len(spans[n]) for n in SPANS] == [1, CHUNKS, CHUNKS + 1, 3 * STEPS]
    steps = spans["sim.step"]
    assert _inside(steps, spans["grad.forward"]) == STEPS
    assert _inside(steps, spans["grad.recompute"]) == STEPS
    assert _inside(steps, spans["grad.backward"]) == STEPS
    # the passes follow one another: forward, then per chunk recompute and
    # backward, then the initial state's backward
    order = sorted((s, n) for n in SPANS[:3] for s, _ in spans[n])
    assert [n for _, n in order] == (["grad.forward"]
                                     + ["grad.recompute", "grad.backward"] * CHUNKS
                                     + ["grad.backward"])
    assert loss > 0 and float(grad.abs().max()) > 0
    assert loss_t == loss and torch.equal(grad_t, grad)


def test_spans_are_no_user_annotations(traced):
    *_, events = traced
    assert len(events) == 1 + CHUNKS + CHUNKS + 1 + 3 * STEPS
    assert not any(e.is_user_annotation() for e in events)
    assert {e.device_type() for e in events} == {torch.autograd.DeviceType.CPU}


def test_heap_reuse_is_idempotent(monkeypatch):
    first = hostmem.enable_heap_reuse()
    assert hostmem.enable_heap_reuse() == first
    monkeypatch.setattr(hostmem, "_done", False)
    monkeypatch.setenv("SOFTBODY_NO_HEAP_REUSE", "1")
    assert hostmem.enable_heap_reuse() is False
