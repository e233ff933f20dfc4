"""The plain reference: its neighbour sets and the bound against hand
counts, and the reference against the program's CPU path on a small
float64 body, forward and gradient, on both layouts."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmarks import correct, inputs
from benchmarks.metrics import _work
from benchmarks.program import Program
from benchmarks.reference import physics as ref
from benchmarks.tests.conftest import small


def test_neighbor_pairs_by_hand():
    X = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [2.5, 0, 0], [0.0, 0.5, 0]],
                     dtype=torch.float64)
    row, col = ref.neighbor_pairs(X, 1.2)
    assert list(zip(row.tolist(), col.tolist())) == [(0, 1), (0, 3), (1, 0), (1, 3),
                                                     (3, 0), (3, 1)]


def test_real_pairs_match_brute_force():
    pts, _ = inputs.fit_body(600, 0.05)
    h = inputs.suggest_h(pts, 32)
    X = torch.as_tensor(pts)
    st = ref.statics(X, torch.full((len(pts),), 1e-4, dtype=torch.float64), h, False,
                     torch.float64)
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    assert st.n_pairs == int(((d < 2 * h) & (d > 0)).sum())


def test_bound_by_hand():
    # forward: 96 + 630 per row ops; 36 values of 4 bytes a row
    f = (5000 * 96 + 100 * 630) / 67e12
    b = 100 * 36 * 4 / 3.35e12
    assert math.isclose(_work.step_bound_s(100, 5000, False), max(f, b))
    assert math.isclose(_work.step_bound_s(100, 5000, True),
                        max(3 * f, 100 * 92 * 4 / 3.35e12))
    # bandwidth-bound when pairs are few
    assert math.isclose(_work.step_bound_s(10 ** 6, 0, False), 10 ** 6 * 144 / 3.35e12)


def test_rest_state_has_no_elastic_force():
    cell = small("million.grad", 500, 10, "float64")
    pts, _, h, mask = inputs.body(cell.config)
    r = correct.Reference(cell, pts, h, mask, "cpu")
    f = ref.elastic_forces(r.rest, ref.stiffness(torch.zeros(len(pts), dtype=torch.float64),
                                                 r.ph), r.st, r.ph, r.ar)
    assert float(f.abs().max()) < 1e-12


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10), 3.0])
    assert ref.tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 3.0]


@pytest.mark.parametrize("name", ["million.grad", "stretch112k_varcol.grad", "million.fwd"])
def test_reference_matches_program_in_float64(name):
    """Both layouts, both entry points: the port's CPU path and the
    reference agree to rounding in float64 over 30 steps."""
    cell = small(name, 300, 20, "float64")
    pts, n_outer, h, mask = inputs.body(cell.config)
    prog = Program(cell, pts, n_outer, h, mask, "cpu")
    r = correct.Reference(cell, pts, h, mask, "cpu")
    x = inputs.smooth_field(torch.as_tensor(pts), cell.traffic["x"],
                            inputs.seed_generator(11, "cpu"))
    values = correct.compare(prog.entry, prog.run(x), r.run(x), r.rest)
    assert all(v < 1e-8 for v in values.values()), values


def test_reference_gradient_matches_finite_differences():
    cell = small("stretch112k_varcol.grad", 300, 20, "float64")
    pts, _, h, mask = inputs.body(cell.config)
    r = correct.Reference(cell, pts, h, mask, "cpu")
    x = inputs.smooth_field(torch.as_tensor(pts), cell.traffic["x"],
                            inputs.seed_generator(3, "cpu"))
    _, g = r.run(x)
    v = torch.randn(len(pts), generator=torch.Generator().manual_seed(0),
                    dtype=torch.float64)
    eps = 1e-5
    fd = (r.run(x + eps * v)[0] - r.run(x - eps * v)[0]) / (2 * eps)
    assert math.isclose(float(g @ v), fd, rel_tol=1e-5)


VARIANTS = {
    "trapezoidal_collision": {"sim": {"integrator": "trapezoidal", "collision": True,
                                      "collision_range": 0.03,
                                      "initial_velocity": [0.0, -0.4, 0.0]}},
    "taichi_pairing": {"sim": {"pair_def_grad": "j", "corotated": False,
                               "self_density": True}},
    "gather_layout": {"layout": "gather", "sim": {"backend": "gather", "max_neighbors": 0}},
    "cells_layout": {"layout": "cells"},
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_reference_follows_the_configuration(variant):
    """The configuration keys a later cell may set (integrator, ground
    contact, pairing, corotation, self density, layout) move the program
    and the reference alike: gradients agree to rounding in float64."""
    cell = small("million.grad", 300, 16, "float64")
    v = VARIANTS[variant]
    cell.config["sim"].update(v.get("sim", {}))
    cell.config["layout"] = v.get("layout", cell.config["layout"])
    pts, n_outer, h, mask = inputs.body(cell.config)
    prog = Program(cell, pts, n_outer, h, mask, "cpu")
    r = correct.Reference(cell, pts, h, mask, "cpu")
    x = inputs.smooth_field(torch.as_tensor(pts), cell.traffic["x"],
                            inputs.seed_generator(5, "cpu"))
    values = correct.compare(prog.entry, prog.run(x), r.run(x), r.rest)
    assert all(val < 1e-8 for val in values.values()), values
