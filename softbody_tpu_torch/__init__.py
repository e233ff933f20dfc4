"""softbody_tpu_torch — the PyTorch/CUDA port of softbody_tpu.

A second package beside the JAX reference (``softbody_tpu/``), for one NVIDIA
H100.  It imports torch and numpy, never jax and nothing of ``softbody_tpu``:
every host-side helper it needs is its own copy.  Module paths mirror the JAX
package's, so each module's counterpart is found under the same name.

What is ported: stretch inverse design on the sparse backend (Warp pairing),
also with the fused K1 + mid-section path (``cfg.fused_mid``) and with the
Taichi pairing (``pair_def_grad="j"``), on the blocked (varcol / cells)
layout (``build_blocked_scene``; ``backend="pallas"`` runs its pair
kernels, ``backend="blocked"`` its plain torch reference), and on the
gather backend (``build_scene``, ``backend="gather"``); implicit obstacles
(analytic and DeepSDF) and dynamic particle contact on every backend: the
forward episode, its gradient and the L-BFGS and Adam drivers —

  config          — SimConfig + parity presets, torch dtype / device helpers
  geometry        — procedural bodies, multi-body composition
  scenarios       — the stretch / drop scenario constants and helpers
  native          — g++/ctypes CSR neighbour builder
  topology        — rest neighbours and the gather backend's (N, K) tables,
                    sparse candidate-group layout, the blocked column layouts
  models          — the DeepSDF MLP
  ops             — SPH kernels, 3x3 algebra (polar with its clamped VJP),
                    the gather backend's elasticity, collision, obstacles,
                    contact, the pair kernels of both paths forward and
                    backward and their fixed-order scatter (hand-written
                    CUDA in csrc/, plain torch beside)
  sim             — gather, sparse and blocked scene builds, elastic forces,
                    episode runner with remat and the chunked value-and-grad
  opt             — target generation, L-BFGS-B, Adam, grad check
  utils           — checkpoint / resume (the JAX package's file formats)
  convert         — JAX-built scene, obstacles, contact grid and DeepSDF
                    (as numpy) <-> port objects
  inverse_design  — the product entry point (python -m ...)

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

from .config import SimConfig, taichi_parity, warp_parity
from .core.types import Materials, ParticleState, Scene
from .sim.blocked import build_blocked_scene, elastic_forces_pallas
from .sim.rollout import initial_state, rollout, step
from .sim.scene import build_scene, update_materials
from .sim.sparse import build_sparse_scene, elastic_forces_sparse

__all__ = [
    "SimConfig",
    "warp_parity",
    "taichi_parity",
    "Materials",
    "ParticleState",
    "Scene",
    "build_scene",
    "update_materials",
    "build_sparse_scene",
    "build_blocked_scene",
    "elastic_forces_sparse",
    "elastic_forces_pallas",
    "rollout",
    "step",
    "initial_state",
]
