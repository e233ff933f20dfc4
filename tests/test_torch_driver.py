"""PyTorch port: the inverse-design driver against the JAX package's, f64 on
the small parity body (``warp_parity`` with the top clamped and no ground,
12 steps of 2e-6 s, 4 target frames from a random x*):

* the first L-BFGS iteration — the loss of each evaluation, x0's first, and
  the iterate it accepts, x0 minus a line-search step along the gradient at
  x0 — equals JAX ``optimize_lbfgs``'s, 1e-9 (the episode gradient itself
  is held against JAX in tests/test_torch_grad_episode.py);
* the reference's artifacts (x.npy, losses.json, distances.json; the plots
  are skipped with one line where matplotlib is missing);
* kill and resume (as tests/test_driver.py:99-133), and resuming a
  directory the JAX driver wrote, and the JAX package reading the port's;
* ``grad_check``, ``ratio_distance``, ``warm_start_x0``, the sim-state
  checkpoints, and the entry point ``python -m
  softbody_tpu_torch.inverse_design`` on the CPU.
"""

import contextlib
import io
import json
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from softbody_tpu import warp_parity
from softbody_tpu.opt import driver as jdriver
from softbody_tpu.utils import checkpoint as jckpt
from softbody_tpu_torch import inverse_design
from softbody_tpu_torch.opt import driver
from softbody_tpu_torch.sim.rollout import rollout
from softbody_tpu_torch.utils import checkpoint as ckpt

from tests.test_torch_helpers import both_scenes, small_body, to_jax

N_STEPS = 12
TOL = 1e-9


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both scenes, targets from x*, and JAX's one-iteration L-BFGS run
    (its result, history and resume directory)."""
    from softbody_tpu.scenarios import dirichlet_mask

    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float64", backend="pallas",
                                dt=2e-6, frames=N_STEPS, target_frames=4,
                                collision=False)
    scene_j, scene_t, sop = both_scenes(
        pts, cfg, out_num=out_num, dirichlet_mask=dirichlet_mask(pts, "stretch"))
    x_true = np.zeros(scene_j.blocked.n_slots)
    x_true[sop] = np.random.default_rng(1).normal(scale=0.8, size=len(sop))
    _, _, (tp, tv) = rollout(x_true, scene_t, cfg, n_steps=N_STEPS,
                             record_every=N_STEPS // 4, device="cpu")
    tp, tv = tp.numpy(), tv.numpy()
    x0 = np.zeros_like(x_true)
    ck_jax = tmp_path_factory.mktemp("jax_resume")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res_j, hist_j = jdriver.optimize_lbfgs(
            scene_j, cfg, x0, to_jax(tp, "float64"), to_jax(tv, "float64"),
            x_target=x_true, maxiter=1, verbose=True, plot=False,
            resume_dir=ck_jax)
    return (cfg, scene_j, scene_t, x_true, x0, tp, tv, res_j, hist_j, ck_jax,
            _evaluated(printed))


def _evaluated(printed):
    """The losses a driver printed, one per evaluation ("loss:  <value>")."""
    return [float(line.split()[1]) for line in printed.getvalue().splitlines()
            if line.startswith("loss:")]


def test_first_lbfgs_iteration_matches_jax(setup):
    cfg, scene_j, scene_t, x_true, x0, tp, tv, res_j, hist_j, _, evals_j = setup
    seen, printed = [], io.StringIO()
    with contextlib.redirect_stdout(printed):
        res, hist = driver.optimize_lbfgs(
            scene_t, cfg, x0, tp, tv, x_target=x_true, maxiter=1, verbose=True,
            plot=False, on_eval=lambda x: seen.append(np.array(x)))
    evals = _evaluated(printed)
    assert len(hist["losses"]) == len(hist_j["losses"]) == 1
    assert res.nfev == res_j.nfev == len(evals) == len(evals_j) >= 2
    np.testing.assert_array_equal(seen[0], x0)
    # every evaluation's loss, the first one at x0 included
    for got, want in zip(evals, evals_j):
        assert abs(got - want) <= TOL * want
    # the accepted iterate x0 - a g: the same line-search step along the
    # same first gradient
    assert abs(hist["losses"][0] - hist_j["losses"][0]) <= TOL * hist_j["losses"][0]
    step_j = hist_j["xk"][0] - x0
    assert np.abs(step_j).max() > 0
    assert np.abs(hist["xk"][0] - hist_j["xk"][0]).max() <= TOL * np.abs(step_j).max()
    assert hist["distances"][0] == pytest.approx(hist_j["distances"][0], rel=TOL)


def test_lbfgs_lowers_the_loss_and_writes_artifacts(setup, tmp_path, monkeypatch,
                                                    capsys):
    cfg, _, scene_t, x_true, x0, tp, tv, *_ = setup
    monkeypatch.setitem(sys.modules, "matplotlib", None)     # not installed
    res, hist = driver.optimize_lbfgs(
        scene_t, cfg, x0, tp, tv, opt_dir=tmp_path, x_target=x_true,
        maxiter=3, verbose=True, plot=True)
    assert "plots skipped" in capsys.readouterr().out
    losses = json.loads((tmp_path / "losses.json").read_text())
    dists = json.loads((tmp_path / "distances.json").read_text())
    assert losses == hist["losses"] and dists == hist["distances"]
    assert len(losses) >= 2 and all(b < a for a, b in zip(losses, losses[1:]))
    np.testing.assert_array_equal(np.load(tmp_path / "x.npy"), res.x)
    assert not (tmp_path / "loss.png").exists()


def test_lbfgs_kill_and_resume(setup, tmp_path):
    """A run killed at iteration k (a maxiter=k budget) continues from the
    saved iterate with its histories and spends only the remaining budget."""
    cfg, _, scene_t, x_true, x0, tp, tv, *_ = setup
    ck = tmp_path / "ckpt"
    _, h1 = driver.optimize_lbfgs(scene_t, cfg, x0, tp, tv, x_target=x_true,
                                  maxiter=2, verbose=False, plot=False,
                                  resume_dir=ck)
    meta = json.loads((ck / "meta.json").read_text())
    assert meta["step"] == len(h1["xk"]) == 2
    assert meta["config"]["dt"] == cfg.dt
    res2, h2 = driver.optimize_lbfgs(scene_t, cfg, x0, tp, tv, x_target=x_true,
                                     maxiter=4, verbose=False, plot=False,
                                     resume_dir=ck, resume=True)
    assert h2["losses"][:2] == h1["losses"] and len(h2["losses"]) > 2
    assert h2["losses"][-1] <= h1["losses"][-1]
    assert res2.nit <= 4 - meta["step"]
    res3, _ = driver.optimize_lbfgs(scene_t, cfg, x0, tp, tv, maxiter=2,
                                    verbose=False, plot=False, resume_dir=ck,
                                    resume=True)
    assert res3.nit == 0 and "budget" in res3.message


def test_resume_directories_cross_between_packages(setup, tmp_path):
    cfg, _, scene_t, x_true, x0, tp, tv, res_j, hist_j, ck_jax, _ = setup
    # the port resumes the JAX driver's directory
    res, hist = driver.optimize_lbfgs(scene_t, cfg, x0, tp, tv, x_target=x_true,
                                      maxiter=2, verbose=False, plot=False,
                                      resume_dir=ck_jax, resume=True)
    assert hist["losses"][0] == hist_j["losses"][0] and len(hist["losses"]) == 2
    assert json.loads((ck_jax / "meta.json").read_text())["step"] == 2
    # and the JAX package reads what the port wrote
    saved = jckpt.load_opt_state(ck_jax)
    np.testing.assert_array_equal(saved["x"], hist["xk"][-1])
    ckpt.save_opt_state(tmp_path, hist["xk"][-1], cfg=cfg, step=7,
                        opt_state={"lr": torch.tensor(0.05)})
    saved = jckpt.load_opt_state(tmp_path)
    assert saved["meta"]["step"] == 7
    assert torch.load(tmp_path / "opt_state.pt")["lr"] == torch.tensor(0.05)
    assert ckpt.load_opt_state(tmp_path)["opt_state"]["lr"] == torch.tensor(0.05)


def test_sim_state_checkpoints_cross_between_packages(setup, tmp_path):
    cfg, _, scene_t, *_ = setup
    _, state, _ = rollout(np.zeros(scene_t.blocked.n_slots), scene_t, cfg,
                          n_steps=2, device="cpu")
    ckpt.save_sim_state(tmp_path, state, 2)
    ckpt.save_sim_state(tmp_path, state, 10)
    assert ckpt.latest_sim_frame(tmp_path) == 10
    back = ckpt.load_sim_state(tmp_path, 2, dtype=torch.float64)
    for a, b in zip(back, state):
        assert torch.equal(a, b)
    j = jckpt.load_sim_state(tmp_path, 2, dtype="float64")
    np.testing.assert_array_equal(np.asarray(j.position), state.position.numpy())


def test_grad_check_ratio_distance_and_warm_start(setup, tmp_path):
    cfg, _, scene_t, x_true, x0, tp, tv, *_ = setup
    out = driver.grad_check(scene_t, cfg, x0, (1e-4, 1e-5), tp, tv,
                            verbose=False)
    for _, ana, num in out:
        assert abs(ana - num) < 2e-4 * max(abs(ana), abs(num))
    x = np.random.default_rng(2).normal(size=50)
    y = np.random.default_rng(3).normal(size=50)
    assert driver.ratio_distance(x, y, cfg) == pytest.approx(
        jdriver.ratio_distance(jnp.asarray(x), jnp.asarray(y), cfg), rel=1e-14)
    np.save(tmp_path / "x.npy", x)
    for path, n in ((tmp_path / "x.npy", 50), (tmp_path / "x.npy", 49),
                    (tmp_path / "missing.npy", 50), (None, 50)):
        np.testing.assert_array_equal(driver.warm_start_x0(n, path, seed=4),
                                      jdriver.warm_start_x0(n, path, seed=4))


def test_inverse_design_entry_point_on_cpu(tmp_path):
    common = ["--particles", "300", "--steps", "6", "--target-frames", "3",
              "--eval-chunks", "2", "--device", "cpu"]
    report = inverse_design.main(common + ["--maxiter", "1", "--out",
                                           str(tmp_path / "a")])
    saved = json.loads((tmp_path / "a" / "report.json").read_text())
    assert saved["n_particles"] == report["n_particles"] > 0
    assert saved["device"] == "cpu" and saved["scenario"] == "stretch"
    for name in ("x.npy", "x_star.npy"):
        assert (tmp_path / "a" / name).exists()
    # no iteration at all: the report says so instead of raising
    report = inverse_design.main(common + ["--maxiter", "0", "--out",
                                           str(tmp_path / "b")])
    assert report["iterations"] == 0 and report["loss_first"] is None
    # Adam: one step, its artifacts (tests/test_torch_adam.py holds the rest)
    report = inverse_design.main(common + ["--optimizer", "adam", "--maxiter", "1",
                                           "--out", str(tmp_path / "c")])
    assert report["iterations"] == 1 and report["optimizer"] == "adam"
    assert len(json.loads((tmp_path / "c" / "distances.json").read_text())) == 1
