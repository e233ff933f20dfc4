"""Inverse-design drivers (counterpart of ``softbody_tpu/opt/driver.py``).

* target generation: a forward episode dumping ``position_i.npy`` /
  ``velocity_i.npy`` for i = 1..target_frames, each (N, 3) (sim.py:363-369);
* scipy L-BFGS-B over the episode's (loss, dloss/dx), writing the
  reference's per-iteration artifacts (x.npy, losses.json, distances.json,
  optional convergence plots) and resuming through utils/checkpoint.py
  (sim.py:449-461);
* Adam (``optimize_adam``, the JAX package's optax path) on
  ``torch.optim.Adam``, one value-and-grad per step, with exact resume;
* the analytic-vs-central-difference gradient check (sim.py:418-436), the
  callback's distance metric and the warm start.

Everything runs on the scene's device.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import SimConfig, resolve_device
from ..core.types import Scene
from ..sim.rollout import (episode_value_and_grad_chunked, loss_fn, rollout,
                           value_and_grad_fn)
from ..utils import checkpoint as ckpt


def generate_targets(x, scene: Scene, cfg: SimConfig, out_dir, n_steps=None,
                     particle_index=None, device=None):
    """Forward episode; dump the sampled frames in the reference layout.

    Frame i (1-based) is the state after ``interval * i`` steps.
    ``particle_index`` (the slot_of_particle map) turns the slot-space frames
    into particle order, the reference file format.  Returns (positions
    (target_frames, N, 3), velocities) as numpy arrays."""
    device = resolve_device(device)
    n_steps = cfg.frames if n_steps is None else n_steps
    if n_steps % cfg.target_frames != 0:
        raise ValueError(
            f"frames={n_steps} must be a multiple of target_frames={cfg.target_frames}"
        )
    interval = n_steps // cfg.target_frames
    _, _, rec = rollout(x, scene, cfg, n_steps=n_steps, record_every=interval,
                        device=device)
    pos, vel = rec[0].cpu().numpy(), rec[1].cpu().numpy()
    if particle_index is not None:
        pos = pos[:, np.asarray(particle_index)]
        vel = vel[:, np.asarray(particle_index)]
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(cfg.target_frames):
        np.save(out / f"position_{i + 1}.npy", pos[i])
        np.save(out / f"velocity_{i + 1}.npy", vel[i])
    return pos, vel


def load_targets(target_dir, target_frames: int):
    """Load target/{name}/*.npy (sim.py:116-121)."""
    d = Path(target_dir)
    pos = np.stack([np.load(d / f"position_{i}.npy") for i in range(1, target_frames + 1)])
    vel = np.stack([np.load(d / f"velocity_{i}.npy") for i in range(1, target_frames + 1)])
    return pos, vel


def ratio_distance(x_opt, x_target, cfg: SimConfig) -> float:
    """||ratio(x) - ratio(x*)||_2 in f64 — the callback's convergence metric
    (sim.py:408-410)."""
    def ratio(x):
        return 0.5 * np.tanh(cfg.tanh_gain * np.asarray(x, np.float64)) + 0.5

    return float(np.linalg.norm(ratio(x_opt) - ratio(x_target)))


class _Budget:
    """The result of a resumed run whose iteration budget is spent."""

    def __init__(self, x):
        self.x = np.asarray(x, np.float64)
        self.nit = 0
        self.nfev = 0
        self.message = "resume: budget exhausted"


def _save_plots(opt_dir: Path, history: dict, verbose: bool):
    """loss.png / distance.png; skipped with one line where matplotlib is
    missing (every json/npy artifact is written regardless)."""
    try:
        import matplotlib
    except ImportError:
        if verbose:
            print("matplotlib is not installed: convergence plots skipped")
        return
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    if history["distances"]:
        plt.plot(history["distances"])
        plt.savefig(opt_dir / "distance.png")
        plt.clf()
    plt.plot(history["losses"])
    plt.savefig(opt_dir / "loss.png")
    plt.clf()


def optimize_lbfgs(
    scene: Scene,
    cfg: SimConfig,
    x0,
    target_p,
    target_v,
    opt_dir=None,
    x_target=None,
    maxiter: int = 1000,
    n_steps=None,
    verbose: bool = True,
    plot: bool = True,
    on_eval=None,
    eval_chunks: int = 0,
    resume_dir=None,
    resume: bool = False,
):
    """scipy L-BFGS-B over the episode's value and gradient (sim.py:449-461:
    maxiter, ftol = gtol = 1e-10, per-iteration x.npy + losses/distances
    json, plots when ``plot`` and matplotlib is installed).

    ``on_eval(x_opt)`` runs after every loss evaluation.  ``eval_chunks > 1``
    takes each gradient from :func:`episode_value_and_grad_chunked`, else
    from :func:`value_and_grad_fn` (cut as ``cfg.remat_chunk`` says).
    ``resume_dir``: every iteration saves (x, iteration count, histories)
    there; with ``resume=True`` and a checkpoint present, the run restarts
    from the saved iterate with the histories preloaded and spends only the
    rest of ``maxiter`` (which counts iterations across restarts).  scipy's
    curvature memory is not saved, so a resumed run rebuilds it.

    Returns (result, history dict)."""
    import scipy.optimize

    dev, dtype = scene.device, scene.dtype
    tp = torch.as_tensor(target_p).to(device=dev, dtype=dtype)
    tv = torch.as_tensor(target_v).to(device=dev, dtype=dtype)
    if eval_chunks and eval_chunks > 1:
        vg = episode_value_and_grad_chunked(scene, cfg, eval_chunks, n_steps)
    else:
        vg = value_and_grad_fn(scene, cfg, n_steps)

    history = {"losses": [], "distances": [], "xk": []}
    state = {"last_loss": 0.0, "last_grad": np.zeros(np.shape(x0))}
    if opt_dir is not None:
        opt_dir = Path(opt_dir)
        opt_dir.mkdir(parents=True, exist_ok=True)

    iters_done = 0
    if resume_dir is not None and resume and (Path(resume_dir) / "x.npy").exists():
        saved = ckpt.load_opt_state(resume_dir)
        x0 = saved["x"]
        iters_done = int(saved["meta"].get("step") or 0)
        hist_file = Path(resume_dir) / "history.json"
        if hist_file.exists():
            h = json.loads(hist_file.read_text())
            history["losses"] = list(h.get("losses", []))
            history["distances"] = list(h.get("distances", []))
        if verbose:
            print(f"resuming from {resume_dir}: iteration {iters_done}, "
                  f"{len(history['losses'])} logged losses")
    if maxiter - iters_done <= 0:
        return _Budget(x0), history

    def loss(x_opt):
        t0 = time.perf_counter()
        val, grad = vg(torch.as_tensor(x_opt).to(device=dev, dtype=dtype), tp, tv)
        state["last_loss"] = float(val)
        state["last_grad"] = grad.detach().cpu().numpy().astype(np.float64)
        if verbose:
            print(f"loss:  {state['last_loss']}   "
                  f"[eval {time.perf_counter() - t0:.1f}s]", flush=True)
        if on_eval is not None:
            on_eval(np.asarray(x_opt))
        return state["last_loss"]

    def jac(x_opt):
        return state["last_grad"]

    def callback(x_opt):
        history["losses"].append(state["last_loss"])
        history["xk"].append(np.asarray(x_opt).copy())
        if x_target is not None:
            d = ratio_distance(x_opt, x_target, cfg)
            history["distances"].append(d)
            if verbose:
                print("distance: ", d)
        if opt_dir is not None:
            np.save(opt_dir / "x.npy", x_opt)
            (opt_dir / "distances.json").write_text(json.dumps(history["distances"]))
            (opt_dir / "losses.json").write_text(json.dumps(history["losses"]))
        if resume_dir is not None:
            step = iters_done + len(history["xk"])
            ckpt.save_opt_state(resume_dir, x_opt, cfg=cfg, step=step)
            (Path(resume_dir) / "history.json").write_text(json.dumps(
                {"losses": history["losses"],
                 "distances": history["distances"]}))

    result = scipy.optimize.minimize(
        loss, np.asarray(x0, np.float64), jac=jac, callback=callback,
        method="L-BFGS-B",
        options={"maxiter": maxiter - iters_done, "ftol": 1e-10, "gtol": 1e-10},
    )
    if opt_dir is not None:
        np.save(opt_dir / "x.npy", result.x)
        if plot:
            _save_plots(opt_dir, history, verbose)
    return result, history


def optimize_adam(
    scene: Scene,
    cfg: SimConfig,
    x0,
    target_p,
    target_v,
    steps: int = 200,
    learning_rate: float = 0.05,
    n_steps=None,
    resume_dir=None,
    resume: bool = False,
    checkpoint_every: int = 50,
    eval_chunks: int = 0,
    opt_dir=None,
    x_target=None,
    verbose: bool = False,
):
    """Adam over the episode's value and gradient (the JAX package's optax
    path, ``softbody_tpu/opt/driver.py:230-336``): ``torch.optim.Adam``
    with optax's defaults (beta 0.9 / 0.999, eps 1e-8, the same update
    formula up to rounding), one value-and-grad per step — chunked
    (:func:`episode_value_and_grad_chunked`) when ``eval_chunks > 1``,
    else :func:`value_and_grad_fn`.  ``steps`` counts steps across
    restarts.

    ``resume_dir``: every ``checkpoint_every`` steps and at the end, x, the
    optimizer's ``state_dict()``, the step and the histories are saved
    there (utils/checkpoint.py); with ``resume=True`` and a checkpoint
    present the run continues from it.  The moments are in the saved
    state, so a killed-and-resumed run computes the uninterrupted run's
    iterates bit for bit (a kill loses the steps since the last save).

    ``opt_dir``: after every step and at the end, the reference's
    artifacts there, as :func:`optimize_lbfgs` writes them per iteration:
    x.npy, losses.json and distances.json, one entry per step (empty lists
    when no step ran).

    Returns (x_final, history): history["losses"] holds each step's loss
    (at the iterate before its update), history["distances"] each step's
    ``ratio_distance`` to ``x_target`` after its update (empty without
    ``x_target``)."""
    dev, dtype = scene.device, scene.dtype
    tp = torch.as_tensor(target_p).to(device=dev, dtype=dtype)
    tv = torch.as_tensor(target_v).to(device=dev, dtype=dtype)
    if eval_chunks and eval_chunks > 1:
        vg = episode_value_and_grad_chunked(scene, cfg, eval_chunks, n_steps)
    else:
        vg = value_and_grad_fn(scene, cfg, n_steps)
    x = torch.as_tensor(x0).to(device=dev, dtype=dtype).clone().requires_grad_()
    opt = torch.optim.Adam([x], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                           foreach=False)
    history = {"losses": [], "distances": []}
    if opt_dir is not None:
        opt_dir = Path(opt_dir)
        opt_dir.mkdir(parents=True, exist_ok=True)
    done = 0
    if resume_dir is not None and resume and (Path(resume_dir) / "x.npy").exists():
        saved = ckpt.load_opt_state(resume_dir)
        with torch.no_grad():
            x.copy_(torch.from_numpy(saved["x"]))
        if "opt_state" in saved:
            opt.load_state_dict(saved["opt_state"])
        done = int(saved["meta"].get("step") or 0)
        hist_file = Path(resume_dir) / "history.json"
        if hist_file.exists():
            h = json.loads(hist_file.read_text())
            history = {k: list(h.get(k, [])) for k in history}
        if verbose:
            print(f"resuming from {resume_dir}: step {done}", flush=True)

    def save():
        ckpt.save_opt_state(resume_dir, x.detach(), opt_state=opt.state_dict(),
                            cfg=cfg, step=done)
        (Path(resume_dir) / "history.json").write_text(json.dumps(history))

    def write_artifacts():
        if opt_dir is not None:
            np.save(opt_dir / "x.npy", x.detach().cpu().numpy())
            (opt_dir / "losses.json").write_text(json.dumps(history["losses"]))
            (opt_dir / "distances.json").write_text(json.dumps(history["distances"]))

    while done < steps:
        t0 = time.perf_counter()
        loss, grad = vg(x.detach(), tp, tv)
        x.grad = grad
        opt.step()
        done += 1
        history["losses"].append(float(loss))
        if x_target is not None:
            history["distances"].append(
                ratio_distance(x.detach().cpu().numpy(), x_target, cfg))
        if verbose:
            print(f"adam loss:  {float(loss)}   "
                  f"[step {time.perf_counter() - t0:.1f}s]", flush=True)
        write_artifacts()
        if resume_dir is not None and (done % checkpoint_every == 0 or done == steps):
            save()
    write_artifacts()
    return x.detach(), history


def grad_check(scene: Scene, cfg: SimConfig, x0, deltas, target_p, target_v,
               index=None, n_steps=None, verbose=True):
    """Analytic vs central finite differences (grad_check, sim.py:418-436),
    at the largest |g| unless ``index`` is given.

    Returns a list of (delta, analytic, numeric)."""
    dev, dtype = scene.device, scene.dtype
    tp = torch.as_tensor(target_p).to(device=dev, dtype=dtype)
    tv = torch.as_tensor(target_v).to(device=dev, dtype=dtype)

    def f(x):
        with torch.no_grad():
            return float(loss_fn(torch.as_tensor(x).to(device=dev, dtype=dtype),
                                 scene, cfg, tp, tv, n_steps))

    _, g = value_and_grad_fn(scene, cfg, n_steps)(
        torch.as_tensor(np.asarray(x0)).to(device=dev, dtype=dtype), tp, tv)
    grad = g.cpu().numpy()
    i = int(np.argmax(np.abs(grad))) if index is None else index
    out = []
    for delta in deltas:
        xp = np.asarray(x0, np.float64).copy()
        xp[i] += delta
        l1 = f(xp)
        xp[i] -= 2 * delta
        l2 = f(xp)
        num = (l1 - l2) / (2 * delta)
        if verbose:
            print("grad ana: ", grad[i], "; grad num: ", num)
        out.append((delta, float(grad[i]), num))
    return out


def warm_start_x0(n: int, warm_path=None, noise: float = 1e-2, seed: int = 0):
    """Reference warm-start semantics (sim.py:454): load a previous x and add
    uniform noise; fall back to zeros when no file exists."""
    rng = np.random.default_rng(seed)
    if warm_path is not None and Path(warm_path).exists():
        x0 = np.load(warm_path)
        if len(x0) == n:
            return x0 + rng.random(n) * noise
    return np.zeros(n)
