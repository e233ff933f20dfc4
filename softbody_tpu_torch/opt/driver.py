"""Target generation (counterpart of ``generate_targets`` / ``load_targets``
in ``softbody_tpu/opt/driver.py``; the L-BFGS / Adam drivers and the grad
check are the gradient path, ROADMAP queue 1, item 5).

Targets use the reference's layout: ``position_i.npy`` / ``velocity_i.npy``
for i = 1..target_frames, each (N, 3) (sim.py:363-369).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import SimConfig, resolve_device
from ..core.types import Scene
from ..sim.rollout import rollout


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
