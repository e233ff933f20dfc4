"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the root of the
checkout, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py`` beside this file.

A cell, a configuration, a traffic mix or a per-layer metric is added by
adding its files and its entry in ``BENCHMARK.json``; nothing here names
one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits and the metrics it reports, by trace mode."""

    def __init__(self, name: str, bench: dict | None = None, root: Path = ROOT):
        root = Path(root)
        here = root / HERE.name
        bench = benchmark(root) if bench is None else bench
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        cfg_entry = [c for c in bench["configs"] if c["name"] == self.workload["config"]][0]
        self.config = load_json(root / cfg_entry["file"])
        self.traffic = load_json(here / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(here / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._reports(m)]
        self.here = here

    def _reports(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells

    def steps(self) -> int:
        """The traffic's episode length: a number, or the name of a
        configuration key that holds it."""
        s = self.traffic["steps"]
        return int(self.config[s] if isinstance(s, str) else s)

    def readers(self) -> dict:
        """{metric name: read(ctx) -> float | None} for the per-layer metrics."""
        return {m["name"]: load_reader(self.here / "metrics" / f"{m['name']}.py")
                for m in self.per_layer}


def load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(f"benchmarks_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
