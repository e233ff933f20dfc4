"""Multi-body scene composition (counterpart of ``softbody_tpu/geometry/compose.py``).

The reference simulates one body (outer + inner concatenation,
sim.py:49-53).  Bodies here are concatenated into one particle system: the
meshless model needs no explicit coupling, bodies interact through kernel
support overlap, shared obstacles and dynamic contact.  Per-body slices
address each body's design variables, Dirichlet masks and frames.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Body:
    points: np.ndarray           # (N_b, 3)
    out_num: int                 # outer-shell particle count (first out_num rows)
    name: str = "body"


@dataclasses.dataclass
class Composite:
    points: np.ndarray           # (N, 3) all bodies concatenated
    bodies: list                 # of Body
    offsets: np.ndarray          # (n_bodies + 1,) particle-range prefix

    def body_slice(self, i: int) -> slice:
        return slice(int(self.offsets[i]), int(self.offsets[i + 1]))

    def split(self, arr):
        """Split a per-particle array back into per-body arrays."""
        return [arr[self.body_slice(i)] for i in range(len(self.bodies))]


def compose(bodies) -> Composite:
    bodies = list(bodies)
    pts = np.vstack([np.asarray(b.points, np.float64) for b in bodies])
    offsets = np.concatenate([[0], np.cumsum([len(b.points) for b in bodies])])
    return Composite(points=pts, bodies=bodies, offsets=offsets)


def translated(body: Body, offset) -> Body:
    return Body(points=np.asarray(body.points) + np.asarray(offset, np.float64),
                out_num=body.out_num, name=body.name)
