"""The benchmark's data files parse, and the harness finds a cell, a
configuration, a traffic mix and a per-layer metric added as files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from benchmarks import spec
from benchmarks.run import run_cell
from benchmarks.tests.conftest import small

BENCH = spec.benchmark()


def test_benchmark_json_names_existing_files():
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
    names = [w["name"] for w in BENCH["workloads"]]
    assert names == ["million.grad", "stretch112k_varcol.grad"]
    for w in BENCH["workloads"]:
        cell = spec.Cell(w["name"])
        assert cell.steps() > 0
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
        assert cell.end_to_end and cell.per_layer


@pytest.mark.parametrize("path", sorted((spec.HERE / "configs").glob("*.json"))
                         + sorted((spec.HERE / "traffic").glob("*.json"))
                         + sorted((spec.HERE / "limits").glob("*.json")),
                         ids=lambda p: p.name)
def test_data_file_parses(path):
    assert isinstance(json.loads(path.read_text()), dict)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    read = spec.load_reader(spec.HERE / "metrics" / f"{metric}.py")
    assert callable(read)


def test_new_cell_found_from_files_alone(tmp_path):
    """A configuration, a traffic mix, a limit file and a per-layer metric
    added as files, with an entry in BENCHMARK.json, run with no edit."""
    here = tmp_path / "benchmarks"
    for d in ("configs", "traffic", "limits", "metrics"):
        (here / d).mkdir(parents=True)
    cfg = json.loads((spec.HERE / "configs" / "million.json").read_text())
    cfg["body"]["particles"] = 300
    cfg["frames"] = 12
    (here / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (here / "traffic" / "tiny_forward.json").write_text(json.dumps(
        {"entry": "forward", "steps": 12, "chunk_len": 4,
         "x": {"center": 0.2, "amplitude": 0.1, "modes": 2, "wavelengths": [1.0, 2.0]}}))
    (here / "limits" / "tiny.fwd.json").write_text(json.dumps({"pos_rel": 1.0}))
    (here / "metrics" / "tiny_count.py").write_text(
        "def read(ctx):\n    return ctx.trace_steps\n")
    shutil.copy(spec.HERE / "metrics" / "scene_build_s.py", here / "metrics")
    bench = {"configs": [{"name": "tiny", "file": "benchmarks/configs/tiny.json"}],
             "workloads": [{"name": "tiny.fwd", "config": "tiny", "traffic": "tiny_forward",
                            "chips": 1}],
             "end_to_end": [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"],
             "per_layer": [{"name": "tiny_count", "unit": "steps"},
                           {"name": "scene_build_s", "unit": "s"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell("tiny.fwd", root=tmp_path)
    assert cell.steps() == 12
    r = run_cell(cell, 7, 0.1, True, "cpu")
    assert r["metrics"]["tiny_count"] == {"value": 12.0, "unit": "steps"}
    assert r["metrics"]["scene_build_s"]["value"] > 0
    assert list(r["checks"]) == ["pos_rel"]
    r0 = run_cell(cell, 7, 0.1, False, "cpu")
    assert set(r0["metrics"]) == {"setup_s"}


def test_small_cells_are_cut_copies():
    cell = small("million.grad", 500, 10)
    assert cell.steps() == 10 and cell.config["body"]["particles"] == 500
    assert spec.Cell("million.grad").steps() == 500
