"""The harness's run without the look for a card: the result line's shape
in both trace modes, its refusal without a card, and the JAX check."""

from __future__ import annotations

import json
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmarks import run
from benchmarks.tests.conftest import small

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line_shape(trace):
    cell = small("million.grad", 1200, 40)
    r = run.run_cell(cell, 2 ** 33 + 5, 0.1, trace, "cpu")
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(r["correct"], bool) and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"loss_rel", "grad_rel", "grad_max"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        assert DEVICE_KEYS | {"busy_s", "window_s"} == set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "scene_build_s" in r["metrics"] and "grad_psteps_per_s" not in r["metrics"]
    else:
        assert DEVICE_KEYS == set(r["device"])
        assert set(r["metrics"]) == {"grad_psteps_per_s", "setup_s"}
    json.dumps(r)


def test_force_evals_per_step_reads_k1_launches():
    from benchmarks.metrics._readers import force_evals_per_step

    ctx = SimpleNamespace(entry="value_and_grad", trace_steps=500,
                          launches={"moments_v4": 1500, "forces_warp_v4": 1500})
    assert force_evals_per_step(ctx, "value_and_grad") == 3.0
    assert force_evals_per_step(ctx, "forward") is None
    none = SimpleNamespace(entry="value_and_grad", launches={}, trace_steps=500)
    assert force_evals_per_step(none, "value_and_grad") is None


def test_forward_cell_reports_its_own_metrics():
    cell = small("million.fwd", 1200, 30)
    r = run.run_cell(cell, 9, 0.1, False, "cpu")
    assert set(r["metrics"]) == {"setup_s"}
    assert set(r["checks"]) == {"pos_rel", "pos_max", "vel_rel"}


def test_main_without_a_card_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.main(["--workload", "million.grad", "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_forbidden_modules_compared_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "softbody_tpu_torch_probe", object())
    assert run.forbidden_modules() == [m for m in ("jax", "jaxlib", "flax", "softbody_tpu")
                                       if m in sys.modules]
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in run.forbidden_modules()
