"""PyTorch port: ``softbody_tpu_torch.cli.main([... "--device", "cpu"])``
against the JAX package's ``softbody_tpu.cli.main`` with the same flags, in
f64 with a seeded DeepSDF checkpoint in --model-dir, so that --set_target's
targets come from x = sdf(points) (sim.py:98-104).  The gather backend
here; blocked and pallas (JAX in interpret mode) in
tests/test_torch_cli_blocked.py and tests/test_torch_cli_pallas.py.

Two bodies.  The CLI's procedural sphere (--procedural 300: N = 135,
--frames 8) falls freely: nothing strains it, so its trajectories are
compared (targets, the rendered scene, --init) but no loss is, since every
x gives the same trajectory up to rounding (losses ~1e-28).  The flows that
optimize run on a small asset body (ascii PLY, 384 particles, the
reference's transform and constants: h = 0.007, dt = 5e-5) whose lowest
layer starts 1 mm inside the ground plane, so the ground penalty strains
it.  Its DeepSDF's last bias is raised by 2, so the targets' x = sdf ~ 2
(ratio ~1, soft); L-BFGS starts from a warm start of ones.  The stiffest
x = -1 (the CLI's start for Adam on gather, 200x the soft stiffness) is
past these constants' stable step: --debug (at x = 0) and Adam run 2-frame
episodes.

Tolerances: target files (every frame's positions and velocities) 1e-10 of
their max |value|; the rendered .pbrt scene equal token for token, its
numbers 1e-10 of the largest; --init's printed final mean to its print
precision (rtol 1e-6); --debug's analytic gradients 1e-9 relative; the
first L-BFGS iteration's loss (losses.json[0]) 1e-9 relative and x.npy
after two iterations 1e-9 of max |x|; Adam's printed last loss after its
200 steps (2-frame episodes) 1e-9 relative, its x.npy 1e-7 of max |x|.
"""

import contextlib
import io
import json
import re
import shutil

import numpy as np
import pytest
import torch

from softbody_tpu import cli as jcli
from softbody_tpu_torch import cli
from softbody_tpu_torch.geometry.io import write_ply_points
from softbody_tpu_torch.geometry.shapes import fibonacci_sphere

from tests.test_deepsdf import make_torch_model

NAME = "demo"
FRAMES = 8
SPHERE = ["-n", NAME, "--procedural", "300", "--frames", str(FRAMES), "--dtype",
          "float64"]
N_SPHERE = 135
N_BLOB = 384


def run(main, out, backend, base, *extra):
    """One CLI call; returns what it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(base + ["--backend", backend, "--out-dir", str(out), *extra])
    return buf.getvalue()


def both(root, backend, base, *extra):
    """The same flags through both CLIs, into root/jax and root/torch."""
    out_j = run(jcli.main, root / "jax", backend, base, *extra)
    out_t = run(cli.main, root / "torch", backend, base, *extra, "--device", "cpu")
    return out_j, out_t


def write_model(model_dir, name, offset=0.0):
    """A seeded weight-norm DeepSDF checkpoint; ``offset`` is added to its
    last layer's bias."""
    (model_dir / name).mkdir(parents=True)
    state = make_torch_model(network_size=32, seed=5).state_dict()
    last = max((k for k in state if k.endswith("bias")),
               key=lambda k: int(k.split(".")[1]))
    state[last] = state[last] + offset
    torch.save(state, model_dir / name / "model_10000.pth")


def write_blob(asset_dir):
    """An outer sphere of 200 points and inner shells, radius 2.5 in the
    assets' units (2.5 cm after the reference's x0.01), its lowest point
    1 mm below the ground plane after the transform
    (y = 0.01 z + 0.07): the penalty acts from the first step."""
    d = asset_dir / "blob"
    d.mkdir(parents=True)
    outer = fibonacci_sphere(200, 2.5)
    inner = np.vstack([fibonacci_sphere(max(int(200 * (r / 2.5) ** 2), 8), r)
                       for r in np.arange(1.9, 0.3, -0.6)])
    shift = np.array([0.0, 0.0, -4.6])
    write_ply_points(d / "point_cloud_downsampled.ply", outer + shift)
    write_ply_points(d / "blob_inner.ply", inner + shift)


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """The argv heads of the two bodies, with their --model-dir."""
    root = tmp_path_factory.mktemp("inputs")
    write_model(root / "models", NAME)
    write_model(root / "models", "blob", offset=2.0)     # x = sdf ~ 2: soft
    write_blob(root / "assets")
    models = ["--model-dir", str(root / "models")]
    return {"sphere": SPHERE + models,
            "blob": ["-n", "blob", "--asset-dir", str(root / "assets"), "--frames",
                     str(FRAMES), "--dtype", "float64"] + models}


@pytest.fixture(scope="module")
def targets(tmp_path_factory, bases):
    """(body, backend) -> a directory whose jax/ and torch/ hold its
    --set_target targets (written on first use; the sphere's on gather with
    --render)."""
    done = {}

    def get(body, backend):
        if (body, backend) not in done:
            root = tmp_path_factory.mktemp(f"targets_{body}_{backend}")
            extra = ("--render",) if (body, backend) == ("sphere", "gather") else ()
            both(root, backend, bases[body], "--set_target", *extra)
            done[body, backend] = root
        return done[body, backend]

    return get


def fresh(tmp_path, src):
    """tmp_path/{jax,torch} holding copies of src's targets only."""
    for side in ("jax", "torch"):
        shutil.copytree(src / side / "target", tmp_path / side / "target")
    return tmp_path


def assert_close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= rel, f"{what}: {err:.3e} > {rel}"


def split_pbrt(text):
    """(the scene's tokens with every number as '#', the numbers)."""
    words, nums = [], []
    for tok in re.findall(r'"[^"]*"|[^\s\[\]"]+|[\[\]]', text):
        try:
            nums.append(float(tok))
            words.append("#")
        except ValueError:
            words.append(tok)
    return words, np.asarray(nums)


def check_targets(root, name, n_particles):
    tdir = {side: root / side / "target" / name for side in ("jax", "torch")}
    for i in range(1, FRAMES + 1):
        for kind in ("position", "velocity"):
            want = np.load(tdir["jax"] / f"{kind}_{i}.npy")
            got = np.load(tdir["torch"] / f"{kind}_{i}.npy")
            assert got.shape == (n_particles, 3)
            assert_close(got, want, 1e-10, f"{kind}_{i}")


def check_lbfgs(root, name, x0):
    """The two CLIs' L-BFGS artifacts: losses.json[0] and x.npy."""
    opt = {side: root / side / "opt" / name for side in ("jax", "torch")}
    l_j = json.loads((opt["jax"] / "losses.json").read_text())
    l_t = json.loads((opt["torch"] / "losses.json").read_text())
    assert len(l_t) == len(l_j) == 2 and l_t[1] < l_t[0]
    np.testing.assert_allclose(l_t[0], l_j[0], rtol=1e-9, atol=0)
    x_j, x_t = np.load(opt["jax"] / "x.npy"), np.load(opt["torch"] / "x.npy")
    assert np.abs(x_t - x0).max() > 1e-3          # the optimizer moved
    assert_close(x_t, x_j, 1e-9, "x.npy")
    return l_t


def test_set_target_matches_jax(targets):
    root = targets("sphere", "gather")
    check_targets(root, NAME, N_SPHERE)
    check_targets(targets("blob", "gather"), "blob", N_BLOB)
    # --render: the sphere-cloud scene of the last recorded frame
    scenes = {}
    for side in ("jax", "torch"):
        f = root / side / "render" / NAME / ".pbrt" / "scene.pbrt"
        scenes[side] = split_pbrt(f.read_text().replace(str(root / side), "<out>"))
    (w_j, n_j), (w_t, n_t) = scenes["jax"], scenes["torch"]
    assert w_t == w_j and w_t.count('"sphere"') == N_SPHERE + 1
    assert_close(n_t, n_j, 1e-10, "pbrt numbers")


def test_init_and_debug_match_jax(tmp_path, targets, bases):
    root = fresh(tmp_path / "sphere", targets("sphere", "gather"))
    out_j, out_t = both(root, "gather", bases["sphere"], "--init")

    def mean(text):
        return [float(v) for v in re.findall(r"[-+0-9.e]+", text.split("mean:")[-1])]

    m_j, m_t = mean(out_j), mean(out_t)
    assert len(m_t) == 3
    np.testing.assert_allclose(m_t, m_j, rtol=1e-6, atol=0)

    root = fresh(tmp_path / "blob", targets("blob", "gather"))
    out_j, out_t = both(root, "gather", bases["blob"], "--debug", "--frames", "2")
    pat = r"grad ana:\s*(\S+)\s*; grad num:\s*(\S+)"
    d_j = np.asarray(re.findall(pat, out_j), np.float64)
    d_t = np.asarray(re.findall(pat, out_t), np.float64)
    assert d_t.shape == d_j.shape == (5, 2) and np.isfinite(d_t).all()
    assert_close(d_t[:, 0], d_j[:, 0], 1e-9, "--debug analytic gradient")
    # central differences at delta 1e-5 agree with the analytic gradient
    assert abs(d_t[3, 1] - d_t[3, 0]) <= 1e-4 * abs(d_t[3, 0])


def lbfgs_both(tmp_path, targets, bases, backend):
    """--maxiter 2 from a warm start of ones on the blob, both CLIs."""
    root = fresh(tmp_path, targets("blob", backend))
    ones = tmp_path / "ones.npy"
    np.save(ones, np.ones(N_BLOB))
    both(root, backend, bases["blob"], "--maxiter", "2", "--warm-start", str(ones))
    return root, check_lbfgs(root, "blob", 1.0)


def test_lbfgs_matches_jax(tmp_path, targets, bases):
    backend = "gather"
    root, losses = lbfgs_both(tmp_path, targets, bases, backend)
    # --resume: the third iteration continues from the checkpoint
    run(cli.main, root / "torch", backend, bases["blob"], "--maxiter", "3",
        "--resume", "--device", "cpu")
    opt = root / "torch" / "opt" / "blob"
    resumed = json.loads((opt / "losses.json").read_text())
    assert len(resumed) == 3 and resumed[:2] == losses
    assert json.loads((opt / "checkpoint" / "meta.json").read_text())["step"] == 3


def test_adam_matches_jax(tmp_path, targets, bases):
    # gather: Adam starts from the CLI's x = -1 (the warm start goes to
    # L-BFGS only), 200 steps of 2-frame episodes
    root = fresh(tmp_path, targets("blob", "gather"))
    out_j, out_t = both(root, "gather", bases["blob"], "--optimizer", "adam",
                        "--frames", "2")
    last_j = float(out_j.split("adam final loss:")[-1])
    last_t = float(out_t.split("adam final loss:")[-1])
    np.testing.assert_allclose(last_t, last_j, rtol=1e-9, atol=0)
    opt = {side: root / side / "opt" / "blob" for side in ("jax", "torch")}
    hist = json.loads((opt["torch"] / "checkpoint" / "history.json").read_text())
    assert len(hist["losses"]) == 200 and hist["losses"][-1] == last_t
    assert hist["losses"][-1] < hist["losses"][0]
    # Adam's update m / sqrt(v) magnifies the relative error of the small
    # gradient entries
    assert_close(np.load(opt["torch"] / "x.npy"), np.load(opt["jax"] / "x.npy"),
                 1e-7, "x.npy")


def test_cli_flags_match_jax():
    """Every flag and default of the JAX CLI, plus --device."""
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices)
                for a in parser._actions}

    got, want = flags(cli.build_parser()), flags(jcli.build_parser())
    assert got.pop("device") == (("--device",), "cuda", ["cuda", "cpu"])
    assert got == want
