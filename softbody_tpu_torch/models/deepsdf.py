"""DeepSDF implicit geometry as a torch MLP (counterpart of
``softbody_tpu/models/deepsdf.py``).

Reference: ``deepsdf.py:5-41`` — a 9-layer weight-norm MLP 3 -> 1024 (x8)
-> 1 with ReLU (dropout rate 0.0), loaded from per-shape ``model_{idx}.pth``
checkpoints and evaluated over all particles to initialize the design
variable ``x`` (sim.py:55-60,100-104, outer-shell values clipped to >= 1).

Weight norm is folded at load time (W = g v / ||v||), so the forward pass is
9 dense products on (in, out) weights.  They are plain large matrix
products, ``torch.matmul`` (the JAX package computes them with XLA, outside
any Pallas kernel), with TF32 off: true f32, as everywhere in the port.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ops.pair_common import _no_tf32

NETWORK_SIZE = 1024  # deepsdf.py:7
N_LAYERS = 9


class DeepSDFParams(NamedTuple):
    weights: tuple   # 9 x (in, out)
    biases: tuple    # 9 x (out,)


def init_params(generator: torch.Generator, sizes: Sequence[int] | None = None,
                dtype=torch.float32, device="cpu") -> DeepSDFParams:
    """Random init with the reference architecture (3 -> 1024 x 8 -> 1):
    normal weights / sqrt(fan_in), zero biases, drawn on the CPU from
    ``generator`` and moved to ``device``."""
    if sizes is None:
        sizes = [3] + [NETWORK_SIZE] * (N_LAYERS - 1) + [1]
    ws, bs = [], []
    for i in range(len(sizes) - 1):
        w = torch.randn(sizes[i], sizes[i + 1], generator=generator,
                        dtype=dtype) / np.sqrt(sizes[i])
        ws.append(w.to(device))
        bs.append(torch.zeros(sizes[i + 1], dtype=dtype, device=device))
    return DeepSDFParams(tuple(ws), tuple(bs))


def forward(params: DeepSDFParams, coords: torch.Tensor) -> torch.Tensor:
    """SDF values for coords (..., 3) -> (..., 1): ReLU between layers,
    linear head (deepsdf.py:12-38).  The parameters are cast to the
    coordinates' dtype (f64 coordinates see the f32 weights exactly)."""
    _no_tf32()
    h = coords
    n = len(params.weights)
    for i, (w, b) in enumerate(zip(params.weights, params.biases)):
        h = h @ w.to(h.dtype) + b.to(h.dtype)
        if i < n - 1:
            h = torch.relu(h)
    return h


def sdf(params: DeepSDFParams, coords: torch.Tensor) -> torch.Tensor:
    return forward(params, coords)


def fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Effective weight of torch weight_norm: W = g * v / ||v||_row (the
    norm over every dim but the output dim 0)."""
    norm = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1, keepdims=True)
    return (g.reshape(-1, 1) * v.reshape(v.shape[0], -1) / norm).reshape(v.shape)


def convert_state_dict(state_dict, dtype=torch.float32, device="cpu") -> DeepSDFParams:
    """``DeepSDFWithCode().state_dict()`` -> DeepSDFParams.

    Takes the parametrized weight-norm layout
    (``network.{i}.parametrizations.weight.original0/1``), the legacy
    ``weight_g`` / ``weight_v`` names, and plain ``weight``; weights are
    transposed to (in, out) for right-multiplication."""
    layers = {}
    for key, val in state_dict.items():
        if not key.startswith("network."):
            continue
        parts = key.split(".")
        layers.setdefault(int(parts[1]), {})[".".join(parts[2:])] = (
            val.detach().cpu().numpy() if isinstance(val, torch.Tensor)
            else np.asarray(val))
    ws, bs = [], []
    for idx in sorted(layers):
        entry = layers[idx]
        if not any("weight" in k for k in entry):
            continue  # ReLU / Dropout hold no parameters
        if "parametrizations.weight.original0" in entry:
            w = fold_weight_norm(entry["parametrizations.weight.original0"],
                                 entry["parametrizations.weight.original1"])
        elif "weight_g" in entry:
            w = fold_weight_norm(entry["weight_g"], entry["weight_v"])
        else:
            w = entry["weight"]
        ws.append(torch.from_numpy(np.ascontiguousarray(w.T)).to(device=device, dtype=dtype))
        bs.append(torch.from_numpy(np.asarray(entry["bias"])).to(device=device, dtype=dtype))
    return DeepSDFParams(tuple(ws), tuple(bs))


def load_pth(path, dtype=torch.float32, device="cpu") -> DeepSDFParams:
    """Load a reference ``model_{min_loss_index}.pth`` checkpoint (sim.py:60)
    as tensors only (``weights_only=True``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_state_dict(sd, dtype, device)


def init_x_from_sdf(params: DeepSDFParams, points, out_num: int, set_target: bool,
                    n_points: int | None = None, dtype=torch.float32) -> torch.Tensor:
    """The reference's design-variable initialization (sim.py:98-104): x = -1
    everywhere; with ``set_target`` x = sdf(points), the outer shell clipped
    to >= 1.  On the parameters' device.

    The reference evaluates the SDF on the unrotated, unoffset points
    (sim.py:50-52): callers pass those coordinates."""
    device = params.weights[0].device
    n = len(points) if n_points is None else n_points
    if not set_target:
        return torch.full((n,), -1.0, dtype=dtype, device=device)
    with torch.no_grad():
        vals = sdf(params, torch.as_tensor(np.asarray(points)).to(
            device=device, dtype=dtype)).squeeze(-1)
    vals[:out_num] = torch.clamp(vals[:out_num], min=1.0)
    return vals
