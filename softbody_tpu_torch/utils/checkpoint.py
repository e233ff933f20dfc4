"""Checkpoint / resume: the port's own copy of ``softbody_tpu/utils/checkpoint.py``.

Same file names and formats as the JAX package, so a resume directory written
by either package loads in the other:

* ``x.npy`` — the optimizer's iterate;
* ``meta.json`` — ``{"step": ..., "config": dataclasses.asdict(cfg)}``;
* ``state_XXXXXXXX.npz`` — a mid-episode state (position, velocity,
  elastic_forces).

An optimizer state, where one is saved, goes through ``torch.save`` of its
state dict as ``opt_state.pt`` (the JAX package writes an optax pytree as
``opt_state.npz``; neither reads the other's).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..config import SimConfig
from ..core.types import ParticleState


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_opt_state(path, x, opt_state: dict | None = None,
                   cfg: SimConfig | None = None, step: int | None = None):
    """Save (x, meta and, if given, an optimizer's ``state_dict()``)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.save(path / "x.npy", _host(x))
    meta = {"step": step}
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
    (path / "meta.json").write_text(json.dumps(meta))
    if opt_state is not None:
        torch.save(opt_state, path / "opt_state.pt")


def load_opt_state(path) -> dict:
    """Returns dict(x, meta, opt_state?)."""
    path = Path(path)
    out = {"x": np.load(path / "x.npy")}
    meta_file = path / "meta.json"
    out["meta"] = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    opt_file = path / "opt_state.pt"
    if opt_file.exists():
        out["opt_state"] = torch.load(opt_file, weights_only=True)
    return out


def save_sim_state(path, state: ParticleState, frame: int):
    """Mid-episode snapshot."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez(path / f"state_{frame:08d}.npz",
             position=_host(state.position),
             velocity=_host(state.velocity),
             elastic_forces=_host(state.elastic_forces))


def load_sim_state(path, frame: int, dtype=torch.float32,
                   device="cpu") -> ParticleState:
    data = np.load(Path(path) / f"state_{frame:08d}.npz")
    return ParticleState(*(
        torch.as_tensor(data[k]).to(device=device, dtype=dtype)
        for k in ("position", "velocity", "elastic_forces")))


def latest_sim_frame(path) -> int | None:
    frames = sorted(Path(path).glob("state_*.npz"))
    if not frames:
        return None
    return int(frames[-1].stem.split("_")[1])
