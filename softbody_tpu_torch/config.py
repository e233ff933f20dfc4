"""Scene / simulation configuration.

Replaces the reference's three ad-hoc config mechanisms (argparse flags in
``sim.py:29-35``, module constants in ``options.py:1-9`` and ``sim.py:21-27,63-69``,
hard-coded paths) with one frozen, hashable dataclass.  This is the PyTorch port's own copy of
``softbody_tpu/config.py`` (same fields, same presets), plus the two helpers
that map it onto torch: :func:`torch_dtype` and :func:`resolve_device`.

The reference ships two backends whose *semantics diverge* (SURVEY.md §2
C6/C10/C11/C13/C14).  Rather than silently picking one, every divergence is an
explicit flag here, and two presets reproduce each backend exactly:

* ``warp_parity()``   — reference ``sim.py``   (f32, corotated, trapezoidal,
  stiffness scale ``200 - 199*ratio``, tanh gain 3, self-excluded density,
  ground-plane collision, loss sampled at 100 frames with dt-weighted velocity)
* ``taichi_parity()`` — reference ``sim_taichi.py`` (f64, NON-corotated (R_i is
  overwritten with I at ``sim_taichi.py:129``), symplectic Euler, stiffness scale
  ``1 - ratio``, tanh gain 5, self-included density, no collision, final-frame loss)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static physics + episode configuration (frozen, hashable)."""

    # --- discretization -------------------------------------------------------
    h: float = 0.007                 # SPH support radius (kernel support = 2h). sim.py:25
    dt: float = 5e-5                 # time step. sim.py:65 / sim_taichi.py:29
    frames: int = 3000               # episode length. sim.py:63
    target_frames: int = 100         # number of loss-sampled frames. sim.py:64
    damping: float = 1e-6            # velocity damping coefficient. sim.py:26

    # --- inflation parameterization ------------------------------------------
    tanh_gain: float = 3.0           # ratio = 0.5*tanh(gain*x)+0.5. sim.py:110 (3) vs sim_taichi.py:81 (5)
    # stiffness multiplier = scale_a - scale_b * ratio
    scale_a: float = 200.0           # sim.py:215 -> (200 - 199*ratio)
    scale_b: float = 199.0           # sim_taichi.py:151 -> (1 - ratio) i.e. a=1,b=1

    # --- semantic divergence flags (SURVEY.md §2) -----------------------------
    self_density: bool = False       # include j==i in rho_i? Warp excludes (sim.py:163), Taichi includes (sim_taichi.py:97-98)
    corotated: bool = True           # use R_i from polar(A_pq) in nabla_u/forces; Taichi overwrites R_i=I (sim_taichi.py:129)
    pair_def_grad: str = "i"         # F used in f_ij: "i" (sim.py:233 uses def_grad[i]) or "j" (sim_taichi.py:157)
    integrator: str = "trapezoidal"  # "trapezoidal" (sim.py:246-258) or "symplectic" (sim_taichi.py:167-172)
    loss_mode: str = "sampled"       # "sampled": 100 frames, vel term weighted by dt (sim.py:269-273);
                                     # "final": last frame only, unweighted (sim_taichi.py:210-214)

    # --- collision (ground plane y < range, quadratic penalty) ---------------
    collision: bool = True           # Warp only (sim.py:238-244); Taichi uses Dirichlet walls instead
    collision_stiffness: float = 3e5  # sim.py:68
    collision_range: float = 1e-4    # sim.py:69
    collision_damping: float = 0.0   # beyond-reference Kelvin-Voigt normal
                                     # damper -c*delta*v_y inside the contact
                                     # zone (ops/collision.py); 0 = reference
                                     # penalty exactly

    # --- initial conditions ----------------------------------------------------
    initial_velocity: Tuple[float, float, float] = (0.0, -0.4, 0.0)  # sim.py:261-266
    external_force: Tuple[float, float, float] = (0.0, -1e-3, 0.0)   # sim.py:441

    # --- material defaults -----------------------------------------------------
    youngs_modulus: float = 1.5e5    # sim.py:442
    poisson_ratio: float = 0.4       # sim.py:443
    mass: float = 1e-4               # sim.py:444

    # --- numerics --------------------------------------------------------------
    dtype: str = "float32"           # "float32" | "float64" (oracle / parity checks)
    pair_dtype: str = "float32"      # "bfloat16": K2 pair products + S|R slab in
                                     # bf16 with f32 accumulation (~0.4% force
                                     # noise; see test_sparse bf16 drift test)
    max_neighbors: int = 64          # K: padded neighbor-table width
    fused_mid: bool = False          # sparse/pallas warp mode: fuse the
                                     # mid-section (polar, F, S, M) into the K1
                                     # kernel epilogue (pair_kernels.
                                     # _moments_mid_kernel).  MEASURED 3x
                                     # SLOWER at 100k (26 vs 8.3 ms/step): the
                                     # mid math then runs per-tile on (rows, 1)
                                     # columns (32/1024 of a VPU tile busy)
                                     # instead of one lane-packed XLA pass over
                                     # all m rows.  Kept as an option for
                                     # rows>=128 layouts.
    contact_check: bool = True       # dynamic contact: detect per-cell cap
                                     # overflow (dropped candidates) and warn
                                     # via a debug callback instead of silently
                                     # computing incomplete forces
    remat: bool = True               # checkpoint each step on the gradient path
    remat_chunk: int = -1            # sqrt-nested checkpointing: scan chunks
                                     # of this many steps, each chunk itself
                                     # checkpointed, so backward residuals are
                                     # O(T/c + c) states instead of O(T).
                                     # -1 = auto (chunk ~ sqrt(T) once
                                     # T >= 2048: a 3000-step episode at 100k
                                     # stores ~13 GB of linear-remat carries —
                                     # measured OOM on a 16 GB v5e), 0 = off,
                                     # >0 = explicit chunk length
    backend: str = "gather"          # "gather" (N,K tables) | "blocked" (slot space,
                                     # XLA ref) | "pallas" (slot space, fused kernels)

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    @property
    def sample_interval(self) -> int:
        return self.frames // self.target_frames

    def stiffness_scale(self, ratio):
        """Inflation stiffness multiplier applied to the StVK stress."""
        return self.scale_a - self.scale_b * ratio


def warp_parity(**overrides) -> SimConfig:
    """Semantics of the reference Warp backend (sim.py)."""
    cfg = SimConfig()
    return cfg.replace(**overrides) if overrides else cfg


def taichi_parity(**overrides) -> SimConfig:
    """Semantics of the reference Taichi backend (sim_taichi.py + options.py)."""
    cfg = SimConfig(
        h=0.1,                        # options.py:6
        dt=4e-4,                      # sim_taichi.py:29
        damping=1e-5,                 # options.py:7
        tanh_gain=5.0,                # sim_taichi.py:81
        scale_a=1.0, scale_b=1.0,     # sim_taichi.py:151
        self_density=True,            # sim_taichi.py:97-98
        corotated=False,              # sim_taichi.py:129
        pair_def_grad="j",            # sim_taichi.py:157
        integrator="symplectic",      # sim_taichi.py:167-172
        loss_mode="final",            # sim_taichi.py:210-214
        collision=False,
        initial_velocity=(0.0, 0.0, 0.0),   # sim_taichi.py:203-207
        external_force=(0.0, 0.0, 0.0),
        youngs_modulus=1e5,           # sim_taichi.py:326
        mass=1e-2,                    # sim_taichi.py:328
        dtype="float64",              # options.py:3
    )
    return cfg.replace(**overrides) if overrides else cfg


def torch_dtype(cfg: SimConfig) -> torch.dtype:
    """The torch dtype of ``cfg.dtype`` ("float32" | "float64")."""
    return {"float32": torch.float32, "float64": torch.float64}[cfg.dtype]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another.  Raises when no CUDA device is present and none was named —
    the port never drops to the CPU on its own.  A CUDA device without an
    index resolves to the current one, so it compares equal to the device
    of the tensors made on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
