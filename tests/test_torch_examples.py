"""PyTorch port: tiny CPU runs of the two examples, ``python -m
softbody_tpu_torch.examples.inflate_demo`` and ``...million_particles``:
their artifacts, their losses falling, the million-particle report's keys
as the JAX example's; and inflate_demo's first Adam loss against the JAX
driver's ``optimize_adam`` on the same gather scene and targets, 3e-3
relative: the demo runs in f32, and its loss sums squares of ~1e-5 m gaps
between trajectories at ~0.07 m, where one f32 step (7.5e-9 m) is ~1e-3 of
a gap."""

import json
from pathlib import Path

import numpy as np

from softbody_tpu import build_scene as jbuild_scene
from softbody_tpu import warp_parity as jwarp_parity
from softbody_tpu.opt import driver as jdriver
from softbody_tpu_torch.examples import inflate_demo, million_particles

REPO = Path(__file__).resolve().parent.parent


def test_inflate_demo_matches_the_jax_driver(tmp_path):
    argv = ["--particles", "300", "--frames", "20", "--adam-steps", "3",
            "--lbfgs-iters", "2", "--backend", "gather", "--device", "cpu",
            "--out", str(tmp_path / "demo")]
    report = inflate_demo.main(argv)
    out = tmp_path / "demo"
    assert json.loads((out / "report.json").read_text()) == report
    for f in ("scene_first.pbrt", "scene_final.pbrt", "opt/x.npy", "opt/losses.json",
              "target/position_10.npy"):
        assert (out / f).exists(), f
    a, lb = report["adam_loss"], report["lbfgs_loss"]
    assert a[1] < a[0] and lb[-1] <= lb[0] < a[1]
    # the JAX driver on the same body, mask, configuration and hidden field
    args = inflate_demo.parse_args(argv)
    pts, out_num, mask, cfg, _, _ = inflate_demo.build(args, "cpu")
    cfg_j = jwarp_parity().replace(h=cfg.h, dt=cfg.dt, frames=cfg.frames,
                                   target_frames=cfg.target_frames,
                                   backend="gather", dtype="float32")
    scene_j = jbuild_scene(pts, cfg_j, out_num=out_num, dirichlet_mask=mask)
    tp, tv = jdriver.generate_targets(inflate_demo.hidden_field(pts), scene_j, cfg_j,
                                      tmp_path / "jax_target")
    _, losses_j = jdriver.optimize_adam(scene_j, cfg_j, np.zeros(len(pts)), tp, tv,
                                        steps=1, learning_rate=0.2)
    np.testing.assert_allclose(a[0], float(losses_j[0]), rtol=3e-3, atol=0)


def test_million_particles_tiny(tmp_path):
    report = million_particles.main([
        "--particles", "2000", "--steps", "20", "--grad-steps", "6",
        "--grad-chunks", "2", "--render-every", "10", "--chunk-steps", "5",
        "--device", "cpu", "--out", str(tmp_path)])
    want = json.loads((REPO / "out" / "million_r5" / "report.json").read_text())
    assert report.keys() == want.keys()
    assert json.loads((tmp_path / "report.json").read_text()) == report
    assert report["compile_seconds"] == report["grad_compile_seconds"] == 0.0
    assert report["frames_exported"] == 2 and report["pairs_per_step"] > 0
    assert np.isfinite(report["grad_loss"]) and report["grad_norm"] > 0
    final = np.load(tmp_path / "final_positions.npy")
    assert final.shape == (report["n_particles"], 3) and np.isfinite(final).all()
    for i in range(2):
        assert (tmp_path / "frames" / f"positions_{i:04d}.npy").exists()
        assert (tmp_path / "frames" / f".pbrt_{i:04d}" / "scene.pbrt").exists()
