"""PyTorch port: the package imports neither jax nor anything of
softbody_tpu (nor matplotlib or imageio, which its render helpers import
when called), and its entry points run on CUDA unless asked for the CPU."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import softbody_tpu_torch
from softbody_tpu_torch import cli, inverse_design, probe_stability, warp_parity
from softbody_tpu_torch.parallel import dryrun_multichip
from softbody_tpu_torch.examples import inflate_demo, million_particles
from softbody_tpu_torch.config import resolve_device
from softbody_tpu_torch.opt.driver import generate_targets
from softbody_tpu_torch.sim.rollout import rollout
from softbody_tpu_torch.sim.sparse import build_sparse_scene

from tests.test_torch_helpers import small_body

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import softbody_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
for name in ("softbody_tpu_torch.utils.checkpoint",
             "softbody_tpu_torch.inverse_design", "softbody_tpu_torch.opt.driver",
             "softbody_tpu_torch.ops.separable_kernels", "softbody_tpu_torch.ops.blocked",
             "softbody_tpu_torch.topology.blocks", "softbody_tpu_torch.sim.blocked",
             "softbody_tpu_torch.sim.scene", "softbody_tpu_torch.ops.elasticity",
             "softbody_tpu_torch.ops.obstacles", "softbody_tpu_torch.ops.contact",
             "softbody_tpu_torch.models.deepsdf", "softbody_tpu_torch.geometry.compose",
             "softbody_tpu_torch.cli", "softbody_tpu_torch.geometry.io",
             "softbody_tpu_torch.utils.io", "softbody_tpu_torch.utils.hostmem",
             "softbody_tpu_torch.utils.profiling", "softbody_tpu_torch.render.pbrt",
             "softbody_tpu_torch.render.adapters", "softbody_tpu_torch.render.video",
             "softbody_tpu_torch.render.preview",
             "softbody_tpu_torch.examples.inflate_demo",
             "softbody_tpu_torch.examples.million_particles",
             "softbody_tpu_torch.probe_stability", "softbody_tpu_torch.topology.sort",
             "softbody_tpu_torch.parallel.sharding", "softbody_tpu_torch.parallel.halo",
             "softbody_tpu_torch.parallel.sparse_shard",
             "softbody_tpu_torch.parallel.dryrun"):
    assert name in mods, name
# matplotlib and imageio are absent on the card's machine: imported lazily
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "softbody_tpu" or m.startswith("softbody_tpu.")
             or m.split(".")[0] in ("matplotlib", "imageio"))
print(len(mods), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_nothing_of_softbody_tpu():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_mods, bad = out.stdout.split(maxsplit=1)
    assert int(n_mods) >= 20 and bad.strip() == "[]"


def test_entry_points_default_to_cuda():
    pts, out_num, h = small_body()
    cfg = warp_parity().replace(h=h, dtype="float32", backend="pallas",
                                frames=2, target_frames=1)
    scene, sop = build_sparse_scene(pts, cfg, out_num=out_num, device="cpu")
    x = np.zeros(scene.blocked.n_slots)
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        with pytest.raises(ValueError, match="lives on cpu"):
            rollout(x, scene, cfg, n_steps=1)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_sparse_scene(pts, cfg, out_num=out_num)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        softbody_tpu_torch.build_blocked_scene(pts, cfg, out_num=out_num)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        softbody_tpu_torch.build_scene(pts, cfg, out_num=out_num)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rollout(x, scene, cfg, n_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_targets(x, scene, cfg, REPO / "_never_written")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inverse_design.main(["--particles", "300", "--steps", "2",
                             "--target-frames", "1", "--out",
                             str(REPO / "_never_written")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-n", "x", "--procedural", "300", "--frames", "2", "--set_target",
                  "--out-dir", str(REPO / "_never_written")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inflate_demo.main(["--particles", "300", "--frames", "2",
                           "--out", str(REPO / "_never_written")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        million_particles.main(["--particles", "300", "--steps", "2",
                                "--out", str(REPO / "_never_written")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_stability.main(["--particles", "300", "--steps", "2",
                              "--record-every", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)
    assert not (REPO / "_never_written").exists()
    # asked for the CPU, they run there
    _, fin, _ = rollout(x, scene, cfg, n_steps=1, device="cpu")
    assert fin.position.device.type == "cpu"
    assert softbody_tpu_torch.__name__ == "softbody_tpu_torch"
