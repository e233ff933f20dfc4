"""PyTorch port: ``optimize_adam`` (``torch.optim.Adam``) against the JAX
package's optax path, its exact resume, and ``--optimizer adam`` in the
entry point.

Tolerances: three Adam steps on the small gather body (f64, the top clamped
so that it strains, targets from a random x*) against JAX's
``optimize_adam`` 1e-9 relative, losses and iterates; a killed-and-resumed
run equals the straight run bit for bit, on the single-program and on the
chunked gradient."""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import build_scene as jbuild_scene
from softbody_tpu import warp_parity
from softbody_tpu.opt import driver as jdriver
from softbody_tpu.scenarios import dirichlet_mask
from softbody_tpu_torch import inverse_design
from softbody_tpu_torch.opt import driver
from softbody_tpu_torch.sim.rollout import rollout
from softbody_tpu_torch.sim.scene import build_scene

from tests.test_torch_helpers import small_body

TOL = 1e-9
N_STEPS = 8


@pytest.fixture(scope="module")
def setup():
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", dt=2e-6, frames=N_STEPS,
                                target_frames=4, collision=False)
    mask = dirichlet_mask(pts, "stretch")
    scene_t = build_scene(pts, cfg, out_num=out_num, dirichlet_mask=mask, device="cpu")
    x_true = np.random.default_rng(1).normal(scale=0.8, size=len(pts))
    with torch.no_grad():
        _, _, (tp, tv) = rollout(x_true, scene_t, cfg, n_steps=N_STEPS,
                                 record_every=N_STEPS // 4, device="cpu")
    return pts, out_num, mask, cfg, scene_t, x_true, tp.numpy(), tv.numpy()


def test_three_adam_steps_match_optax(setup):
    pts, out_num, mask, cfg, scene_t, x_true, tp, tv = setup
    scene_j = jbuild_scene(pts, cfg, out_num=out_num, dirichlet_mask=mask)
    x0 = np.zeros(len(pts))
    x_j, losses_j = jdriver.optimize_adam(scene_j, cfg, x0, jnp.asarray(tp),
                                          jnp.asarray(tv), steps=3,
                                          learning_rate=0.05, n_steps=N_STEPS)
    x_t, hist = driver.optimize_adam(scene_t, cfg, x0, tp, tv, steps=3,
                                     learning_rate=0.05, n_steps=N_STEPS,
                                     x_target=x_true)
    losses_j = np.asarray(losses_j)
    assert len(hist["losses"]) == len(hist["distances"]) == 3
    assert losses_j[2] < losses_j[0]
    np.testing.assert_allclose(hist["losses"], losses_j, rtol=TOL, atol=0)
    x_j = np.asarray(x_j)
    assert np.abs(x_t.numpy() - x_j).max() <= TOL * np.abs(x_j).max()
    assert hist["distances"][-1] == driver.ratio_distance(x_t.numpy(), x_true, cfg)


@pytest.mark.parametrize("eval_chunks", [0, 2])
def test_kill_and_resume_is_exact(setup, tmp_path, eval_chunks):
    _, _, _, cfg, scene_t, x_true, tp, tv = setup
    x0 = np.zeros(scene_t.rest_position.shape[0])
    kw = dict(learning_rate=0.05, n_steps=N_STEPS, eval_chunks=eval_chunks,
              x_target=x_true, checkpoint_every=2)
    x_straight, h_straight = driver.optimize_adam(scene_t, cfg, x0, tp, tv, steps=3,
                                                  resume_dir=tmp_path / "a", **kw)
    # "killed" after the checkpoint at step 2, then resumed to step 3
    driver.optimize_adam(scene_t, cfg, x0, tp, tv, steps=2, resume_dir=tmp_path / "b",
                         **kw)
    meta = json.loads((tmp_path / "b" / "meta.json").read_text())
    assert meta["step"] == 2 and (tmp_path / "b" / "opt_state.pt").exists()
    x_resumed, h_resumed = driver.optimize_adam(scene_t, cfg, x0, tp, tv, steps=3,
                                                resume_dir=tmp_path / "b", resume=True,
                                                **kw)
    assert torch.equal(x_resumed, x_straight)
    assert h_resumed == h_straight and len(h_straight["losses"]) == 3
    # a spent budget returns the saved iterate untouched
    x_again, h_again = driver.optimize_adam(scene_t, cfg, x0, tp, tv, steps=3,
                                            resume_dir=tmp_path / "b", resume=True,
                                            **kw)
    assert torch.equal(x_again, x_straight) and h_again == h_straight


def test_inverse_design_with_adam_writes_its_artifacts(tmp_path):
    common = ["--particles", "300", "--steps", "6", "--target-frames", "3",
              "--device", "cpu", "--optimizer", "adam"]
    report = inverse_design.main(common + ["--maxiter", "2", "--eval-chunks", "2",
                                           "--out", str(tmp_path / "a")])
    out = tmp_path / "a"
    losses = json.loads((out / "losses.json").read_text())
    distances = json.loads((out / "distances.json").read_text())
    assert len(losses) == len(distances) == 2 and np.isfinite(losses).all()
    assert np.isfinite(np.load(out / "x.npy")).all()
    saved = json.loads((out / "report.json").read_text())
    assert saved["optimizer"] == "adam" and saved["iterations"] == 2
    assert saved["loss_first"] == losses[0] and saved["distance_last"] == distances[-1]
    # no step at all: the report says so instead of raising
    report = inverse_design.main(common + ["--maxiter", "0", "--out",
                                           str(tmp_path / "b")])
    assert report["iterations"] == 0 and report["loss_first"] is None
    assert json.loads((tmp_path / "b" / "distances.json").read_text()) == []
