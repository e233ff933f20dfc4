"""PyTorch port: ``topology/sort.py`` (Morton sort and contiguous neighbour
windows, the port's own numpy copy) bit-identical to the JAX package's on
a procedural body, a jittered one and a random cloud."""

import numpy as np
import pytest

from softbody_tpu.topology import sort as jsort
from softbody_tpu_torch.geometry.shapes import inflatable_sphere, suggest_h
from softbody_tpu_torch.topology import sort as tsort


def _bodies():
    pts, _ = inflatable_sphere(n_outer=96, radius=0.05)
    rng = np.random.default_rng(3)
    return {"sphere": pts,
            "jittered": pts + rng.normal(scale=1e-3, size=pts.shape),
            "cloud": rng.uniform(-0.05, 0.05, size=(500, 3))}


@pytest.mark.parametrize("body", ["sphere", "jittered", "cloud"])
def test_sort_is_bit_identical_to_jax(body):
    pts = _bodies()[body]
    h = suggest_h(pts, 14)
    for cell in (h, 2 * h):
        assert np.array_equal(tsort.morton_codes(pts, cell), jsort.morton_codes(pts, cell))
        perm = tsort.morton_sort(pts, cell)
        assert np.array_equal(perm, jsort.morton_sort(pts, cell))
    rs = pts[perm]
    lo, hi = tsort.neighbor_spans(rs, 2 * h)
    jlo, jhi = jsort.neighbor_spans(rs, 2 * h)
    assert np.array_equal(lo, jlo) and np.array_equal(hi, jhi)
    for tile in (32, 64):
        starts, S = tsort.tile_windows(lo, hi, len(rs), tile)
        jstarts, jS = jsort.tile_windows(lo, hi, len(rs), tile)
        assert S == jS and np.array_equal(starts, jstarts) and starts.dtype == jstarts.dtype
    assert tsort.window_stats(pts, 2 * h, 32) == jsort.window_stats(pts, 2 * h, 32)
