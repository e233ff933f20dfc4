"""PyTorch port: the reference asset entry path (sim.py:41-60) through both
CLIs, on the asset fixture of tests/test_reference_assets.py (binary
little-endian PLY clouds, a convex-hull outer.obj, uv.npy and a torch-saved
weight-norm DeepSDF checkpoint without min_loss_index.npy).

Tolerances: --set_target's target files in f64, 1e-10 of their max |value|
(the init x comes from the f32 DeepSDF in both); ``init_x_from_sdf`` on the
raw asset points against the JAX package's, 1e-6 of max |x| (f32 MLPs, two
summation orders)."""

import numpy as np
import torch

from softbody_tpu.cli import main as jmain
from softbody_tpu.geometry.io import load_reference_body as jload_body
from softbody_tpu.models import deepsdf as jdeepsdf
from softbody_tpu_torch.cli import main
from softbody_tpu_torch.geometry.io import load_reference_body
from softbody_tpu_torch.models import deepsdf

from tests.test_reference_assets import NAME, assets  # noqa: F401


def test_set_target_from_assets_matches_jax(assets, tmp_path):
    common = ["-n", NAME, "--asset-dir", assets["asset_dir"], "--model-dir",
              assets["model_dir"], "--backend", "gather", "--frames", "6",
              "--dtype", "float64", "--set_target"]
    jmain(common + ["--out-dir", str(tmp_path / "jax")])
    main(common + ["--out-dir", str(tmp_path / "torch"), "--device", "cpu"])
    for i in range(1, 7):
        for kind in ("position", "velocity"):
            want = np.load(tmp_path / "jax" / "target" / NAME / f"{kind}_{i}.npy")
            got = np.load(tmp_path / "torch" / "target" / NAME / f"{kind}_{i}.npy")
            assert got.shape == (assets["n"], 3)
            assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    p1 = np.load(tmp_path / "torch" / "target" / NAME / "position_1.npy")
    # the reference transform: x0.01 and +0.07 y put the body around (0, 0.07, 0)
    assert np.abs(p1[:, [0, 2]]).max() < 0.2 and 0.0 < p1[:, 1].mean() < 0.2


def test_init_x_from_sdf_matches_jax(assets):
    body = load_reference_body(assets["asset_dir"], NAME)
    body_j = jload_body(assets["asset_dir"], NAME)
    np.testing.assert_array_equal(body["raw_points"], body_j["raw_points"])
    np.testing.assert_array_equal(body["faces"], body_j["faces"])
    pth = f"{assets['model_dir']}/{NAME}/model_10000.pth"
    params = deepsdf.load_pth(pth, device="cpu")
    params_j = jdeepsdf.load_pth(pth)
    for set_target in (True, False):
        x = deepsdf.init_x_from_sdf(params, body["raw_points"], body["out_num"],
                                    set_target=set_target)
        x_j = np.asarray(jdeepsdf.init_x_from_sdf(params_j, body_j["raw_points"],
                                                  body_j["out_num"],
                                                  set_target=set_target))
        assert x.dtype == torch.float32 and x.shape == (assets["n"],)
        assert np.abs(x.numpy() - x_j).max() <= 1e-6 * np.abs(x_j).max()
    assert (x_j == -1.0).all()
    x = deepsdf.init_x_from_sdf(params, body["raw_points"], body["out_num"], True)
    assert (x[:assets["out_num"]] >= 1.0).all()
