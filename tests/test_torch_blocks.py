"""PyTorch port: its numpy copy of the blocked layouts
(``softbody_tpu_torch/topology/blocks.py``) gives bit-identical output to
the JAX package's ``softbody_tpu/topology/blocks.py``: the varcol layout
(``build_varcol_layout``), the fixed-capacity cell layout
(``build_slot_layout``) and ``validate_layout``'s coverage statistics (the
port walks the C++ CSR neighbour list, JAX its per-particle lists: the same
pairs)."""

import dataclasses

import numpy as np
import pytest

from softbody_tpu.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu.topology import blocks as jblocks
from softbody_tpu_torch.topology import blocks


def _body(kind):
    if kind == "sphere":
        pts, _ = inflatable_sphere(n_outer=120)
    else:   # a slab with a hole: columns with gaps and absent neighbours
        g = np.stack(np.meshgrid(*[np.arange(12.0)] * 2, np.arange(4.0),
                                 indexing="ij"), axis=-1).reshape(-1, 3) * 0.01
        keep = np.linalg.norm(g[:, :2] - 0.055, axis=1) > 0.03
        pts = g[keep] + np.random.default_rng(3).normal(scale=1e-4, size=(keep.sum(), 3))
    return pts, 2.0 * suggest_h(pts, 32)


def _same(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    assert a.slab_len == b.slab_len and a.tile_rows == b.tile_rows


@pytest.mark.parametrize("body", ["sphere", "holed"])
@pytest.mark.parametrize("rows", [32, 16])
def test_varcol_layout_identical(body, rows):
    pts, radius = _body(body)
    got = blocks.build_varcol_layout(pts, radius, rows=rows)
    _same(got, jblocks.build_varcol_layout(pts, radius, rows=rows))
    assert (got.slab_start == got.n_slots - got.run_len).any()   # absent columns


@pytest.mark.parametrize("body", ["sphere", "holed"])
@pytest.mark.parametrize("tz,capacity", [(4, None), (2, 64)])
def test_cell_layout_identical(body, tz, capacity):
    pts, radius = _body(body)
    _same(blocks.build_slot_layout(pts, radius, tz=tz, capacity=capacity),
          jblocks.build_slot_layout(pts, radius, tz=tz, capacity=capacity))


@pytest.mark.parametrize("layout", ["varcol", "cells"])
def test_validate_layout_identical(layout):
    pts, radius = _body("sphere")
    build = {"varcol": "build_varcol_layout", "cells": "build_slot_layout"}[layout]
    lay = getattr(blocks, build)(pts, radius)
    got = blocks.validate_layout(lay, pts, radius)
    assert got == jblocks.validate_layout(lay, pts, radius)
    assert 0 < got["slot_efficiency"] <= 1


def test_validate_layout_reports_a_missed_pair():
    pts, radius = _body("sphere")
    lay = blocks.build_varcol_layout(pts, radius)
    bad = dataclasses.replace(lay, slab_start=np.full_like(lay.slab_start,
                                                           lay.n_slots - lay.run_len))
    with pytest.raises(AssertionError, match="not covered"):
        blocks.validate_layout(bad, pts, radius)
    with pytest.raises(AssertionError, match="not covered"):
        jblocks.validate_layout(bad, pts, radius)


def test_capacity_below_occupancy_is_refused():
    pts, radius = _body("sphere")
    with pytest.raises(ValueError, match="capacity"):
        blocks.build_slot_layout(pts, radius, capacity=1)
