"""Fixtures of the benchmark's own tests: cells of ``BENCHMARK.json`` cut
to a size the CPU runs in seconds."""

from __future__ import annotations

import copy

import pytest

from benchmarks import spec


# a forward cell on the ``million`` configuration (forward_chunked episodes),
# for the tests of the harness's forward entry point
FORWARD = {"entry": "forward", "steps": "frames", "chunk_len": 250,
           "x": {"center": 0.5, "amplitude": 0.1, "modes": 4, "wavelengths": [0.5, 2.0]}}
FORWARD_LIMITS = {"pos_rel": 1e-3, "pos_max": 1e-2, "vel_rel": 1e-3}


def forward_cell() -> spec.Cell:
    cell = spec.Cell("million.grad")
    cell.name = "million.fwd"
    cell.traffic = copy.deepcopy(FORWARD)
    cell.limits = dict(FORWARD_LIMITS)
    cell.end_to_end = [m for m in cell.end_to_end if m["name"] == "setup_s"]
    cell.per_layer = [m for m in cell.per_layer if not m["name"].endswith(".grad")]
    return cell


def small(name: str, particles: int = 2000, steps: int = 60, dtype: str = "float32"):
    """The cell ``name`` (or ``million.fwd``, :func:`forward_cell`) at
    ``particles`` particles and ``steps`` steps, its chunks and frames cut
    to fit."""
    cell = forward_cell() if name == "million.fwd" else spec.Cell(name)
    cell.config["body"]["particles"] = particles
    cell.config["sim"]["dtype"] = dtype
    for k in ("frames", "grad_steps"):
        if k in cell.config:
            cell.config[k] = steps
    t = cell.traffic
    if "chunks" in t:
        t["chunks"] = 3
    if "chunk_len" in t:
        t["chunk_len"] = steps // 3
    if t.get("targets", {}).get("frames", 1) > 1:
        t["targets"]["frames"] = 5
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
