"""The comparison that decides ``correct``: the unit the window sampled,
worked out again by the plain reference (``reference/physics.py``) from
the same particles, configuration, x and target specification, and the
program's outputs held against it.

Numbers compared:

* a gradient evaluation: ``loss_rel`` |L - L_ref| / |L_ref|, ``grad_rel``
  ||g - g_ref|| / ||g_ref|| and ``grad_max`` max |g - g_ref| / max |g_ref|
  over the particles;
* a forward episode: ``pos_rel`` ||p - p_ref|| / ||p_ref - X|| (against the
  displacement from rest), ``pos_max`` max |p - p_ref| / max |p_ref - X| and
  ``vel_rel`` ||v - v_ref|| / ||v_ref||.

Each has its limit in ``limits/<workload>.json``.
"""

from __future__ import annotations

import copy
import math

import torch

from . import inputs
from .reference import physics as ref


class Reference:
    """The reference's scene of one cell: statics from the particles, the
    episode's constants, and the traffic's targets."""

    def __init__(self, cell, pts, h, mask, device):
        self.cell = cell
        self.device = torch.device(device)
        self.dtype = {"float32": torch.float32, "float64": torch.float64}[
            cell.config["sim"]["dtype"]]
        self.ar = ref.Arith()
        self.steps = cell.steps()
        self.entry = cell.traffic["entry"]
        X = torch.as_tensor(pts, dtype=torch.float64, device=self.device)
        sim = cell.config["sim"]
        self.st = ref.statics(X, torch.full((len(pts),), sim["mass"], dtype=torch.float64,
                                            device=self.device),
                              h, sim["self_density"], self.dtype)
        self.ph = ref.physics(sim, mask, self.dtype, self.device,
                              cell.traffic.get("loss_mode") == "final")
        self.rest = X.to(self.dtype)
        self.pts = pts
        if self.entry == "value_and_grad":
            self.tp, self.tv = self.targets()

    def control(self) -> "Reference":
        """The control: this reference with its contractions in TF32, its
        rollout targets worked out again in TF32 too."""
        ctl = copy.copy(self)
        ctl.ar = ref.Arith(control=True)
        if ctl.entry == "value_and_grad":
            ctl.tp, ctl.tv = ctl.targets()
        return ctl

    def targets(self):
        spec = self.cell.traffic["targets"]
        n = self.rest.shape[0]
        if spec["kind"] == "inflate":
            c = self.pts.mean(0)
            tp = torch.as_tensor(c + spec["factor"] * (self.pts - c), dtype=self.dtype,
                                 device=self.device)
            return tp[None], self.ph.v0.expand(1, n, 3)
        if spec["kind"] == "rollout":
            x_star = torch.as_tensor(inputs.target_field(self.pts, spec), dtype=self.dtype,
                                     device=self.device)
            _, rp, rv = ref.forward(x_star, self.rest, self.st, self.ph, self.steps,
                                    self.ar, record_every=self.steps // spec["frames"])
            return torch.stack(rp), torch.stack(rv)
        raise ValueError(f"unknown targets {spec['kind']!r}")

    def run(self, x):
        """The unit on x (particles), as :meth:`program.Program.run` returns it."""
        x = x.to(self.dtype)
        if self.entry == "value_and_grad":
            return ref.value_and_grad(x, self.rest, self.tp, self.tv, self.st, self.ph,
                                      self.steps, self.ar)
        (pos, vel, _), _, _ = ref.forward(x, self.rest, self.st, self.ph, self.steps,
                                          self.ar)
        return pos, vel


def _rel(a, b):
    return float(torch.linalg.norm((a - b).double()) / torch.linalg.norm(b.double()))


def _max(a, b, scale):
    return float((a - b).double().abs().max() / scale.double().abs().max())


def compare(entry: str, out, want, rest) -> dict:
    """{name: number} of the program's ``out`` against the reference's ``want``."""
    if entry == "value_and_grad":
        (loss, g), (loss_r, g_r) = out, want
        g = g.to(g_r.dtype)
        return {"loss_rel": abs(loss - loss_r) / abs(loss_r),
                "grad_rel": _rel(g, g_r),
                "grad_max": _max(g, g_r, g_r)}
    (p, v), (p_r, v_r) = out, want
    p, v = p.to(p_r.dtype), v.to(v_r.dtype)
    return {"pos_rel": _rel(p - rest, p_r - rest),
            "pos_max": _max(p, p_r, p_r - rest),
            "vel_rel": _rel(v, v_r)}


def judge(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number finite and at or
    under its limit, and no limit without its number."""
    checks = {k: {"value": values.get(k, math.nan), "limit": lim} for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
