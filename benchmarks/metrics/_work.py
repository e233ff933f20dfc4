"""The work a step needs, frozen: operations and bytes counted from the
body's real neighbour pairs and its particles, never from a layout's
candidate pairs or slab entries, and the card's published peaks.

Per force evaluation (Warp pairing; operations are floating-point adds and
multiplies of the equations in ``reference/physics.py``):

* per real directed pair: the moments A and Y, 45 (p_j - p_i: 3; the two
  weights: 6; two 3x3 outer-product accumulations: 36), and the pair force
  R_j F_i S_j grad W, 51 (three 3x3 by 3 products: 45; the weight and
  the sum: 6); the Taichi pairing's V_j M_j grad W, 18;
* per particle: the mid-section, 600 (R^T Y, F, F^T F, E, S, M = R F S:
  about 240; a polar rotation by a few Newton iterations: about 360) and
  the step's own update, 30.

A backward pass of a contraction costs twice its forward, so a gradient
step needs 3 times a forward step's operations: one force evaluation and
its reverse, whatever a runner recomputes.

Bytes: each table and state a step needs, read once, and each output
written once, in the configuration's dtype, per particle: position,
velocity (in and out) and force (out), 9; rest position, mass, volume, the
two Lame parameters, the stiffness multiplier, the clamp mask and the
external force, 15; the rest correction C (9) and the row sum of V_j grad W
(3), 12: 36 values.  A gradient step reads and writes them again for the
reverse pass, with the kept state (6) and the cotangents of the state and
of x (2 x 7): 2 x 36 + 20 values.  Neighbour indices are not counted: a
layout may find neighbours without storing them, so the bound stays below
every implementation's time.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12        # H100 SXM, FP32 outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12      # H100 SXM HBM3, bytes/s
FLOPS_PAIR = {"i": 45 + 51, "j": 45 + 18}
FLOPS_ROW = 600 + 30
VALUES_ROW_FWD = 36
VALUES_ROW_GRAD = 2 * 36 + 20


def step_bound_s(n_rows: int, n_pairs: int, grad: bool, pair_def_grad: str = "i",
                 value_bytes: int = 4) -> float:
    """Seconds one step needs at the card's peaks: the larger of its
    operations over the peak rate and its bytes over the peak bandwidth."""
    flops = n_pairs * FLOPS_PAIR[pair_def_grad] + n_rows * FLOPS_ROW
    values = VALUES_ROW_GRAD if grad else VALUES_ROW_FWD
    if grad:
        flops *= 3
    return max(flops / PEAK_FLOPS, n_rows * values * value_bytes / PEAK_BYTES)
