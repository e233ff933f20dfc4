"""PyTorch port: its own copies of the host-side configuration, geometry and
scenario helpers give exactly what the JAX package's give."""

import dataclasses

import numpy as np
import pytest

from softbody_tpu import config as jconfig
from softbody_tpu import scenarios as jscen
from softbody_tpu.geometry import shapes as jshapes
from softbody_tpu_torch import config, scenarios
from softbody_tpu_torch.geometry import shapes


@pytest.mark.parametrize("preset", ["warp_parity", "taichi_parity"])
def test_presets_match_jax(preset):
    want = dataclasses.asdict(getattr(jconfig, preset)())
    got = dataclasses.asdict(getattr(config, preset)())
    assert got == want
    assert scenarios.STRETCH == jscen.STRETCH and scenarios.DROP == jscen.DROP


def test_bodies_and_scenario_helpers_match_jax():
    pts, out_num = shapes.inflatable_sphere(n_outer=300)
    pts_j, out_num_j = jshapes.inflatable_sphere(n_outer=300)
    np.testing.assert_array_equal(pts, pts_j)
    assert out_num == out_num_j
    assert shapes.suggest_h(pts, 32) == jshapes.suggest_h(pts_j, 32)

    body, n_out = scenarios.fit_body(3000)
    body_j, n_out_j = jscen.fit_body(3000)
    np.testing.assert_array_equal(body, body_j)
    assert n_out == n_out_j

    for name in ("stretch", "drop"):
        mask, mask_j = scenarios.dirichlet_mask(body, name), jscen.dirichlet_mask(body, name)
        assert (mask is None) == (mask_j is None)
        if mask is not None:
            np.testing.assert_array_equal(mask, mask_j)
        np.testing.assert_array_equal(scenarios.drop_gap(body, name),
                                      jscen.drop_gap(body, name))
        got = scenarios.scale_mass_for_resolution(config.warp_parity(), len(body), name)
        want = jscen.scale_mass_for_resolution(jconfig.warp_parity(), len(body), name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)

    rng = np.random.default_rng(0)
    n_slots = len(body) + 64
    sop = rng.permutation(n_slots)[:len(body)]
    np.testing.assert_array_equal(scenarios.x_star_bands(body, n_slots, sop),
                                  jscen.x_star_bands(body, n_slots, sop))


@pytest.mark.parametrize("argv", [
    [],
    ["--scenario", "drop"],
    ["--scenario", "stretch", "--dt", "2e-5", "--youngs", "500", "--v0y", "-0.1"],
    ["--integrator", "trapezoidal", "--damping", "1e-3", "--mass", "2e-4",
     "--scale-a", "2", "--scale-b", "1", "--collision-stiffness", "1e4",
     "--collision-damping", "5", "--pair-def-grad", "j", "--ext-y", "-0.5"],
])
def test_physics_args_match_jax(argv):
    import argparse

    ap, ap_j = argparse.ArgumentParser(), argparse.ArgumentParser()
    scenarios.add_physics_args(ap)
    jscen.add_physics_args(ap_j)
    args, args_j = ap.parse_args(argv), ap_j.parse_args(argv)
    assert vars(args) == vars(args_j)
    got = scenarios.apply_physics_args(config.warp_parity(), args)
    want = jscen.apply_physics_args(jconfig.warp_parity(), args_j)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if not argv:
        assert got == config.warp_parity()
