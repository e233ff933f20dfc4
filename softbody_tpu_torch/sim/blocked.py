"""Blocked-layout scene building and elastic forces, and the per-slot
mid-section every path shares (counterpart of ``softbody_tpu/sim/blocked.py``).

:func:`build_blocked_scene` scatters a body into the column-dense slot
space of ``topology/blocks.py`` and returns a standard Scene whose particle
axis is SLOTS (empty slots inert: far-away rest position, zero mass and
volume, Dirichlet frozen) and whose ``blocked`` is a
:class:`~softbody_tpu_torch.core.types.Blocked`.  The episode machinery
(``sim/rollout.py``) runs it unchanged; the force evaluation dispatches on
``cfg.backend``: ``"blocked"`` is :func:`elastic_forces_blocked`, the plain
torch reference (``ops/blocked.py``), ``"pallas"`` is
:func:`elastic_forces_pallas`, the pair kernels:

  posT -> [moments_raw_all: raw K1 moments_raw] -> ayT (18, m) raw dots
    -> [mid_records_all on the raw dots: A, Y = dots - pos_i * rs6 (rs6:
       the same kernel on an all-ones RHS), the polar, F, S and M, one
       launch] -> fmT = [F | M | V] (19, m), srT = [S_6 | R^T_9]
       (15, n_slots)
    -> "i": [forces_v2_all: K2 forces_warp_v2, one launch over every tile];
       "j": [forces_sep_all: the separable K2] on G = V M
       -> forces (n_slots, 3)

The blocked path ignores ``cfg.fused_mid``, as the JAX package's does.

The mid-section on component lists of (k,) tensors (:func:`mid_rows`,
:func:`mid_section`: polar rotation, deformation gradient, StVK stress and
M = R F S) is the plain version of ``ops/mid_kernels``' kernels (which run
it on the card, one launch per evaluation, on every path the pallas
backend takes), and the plain reference's own.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, resolve_device, torch_dtype
from ..core.types import Blocked, DevBucket, Materials, Scene, SparseBlocked
from ..ops import mat3
from ..ops._build import ROWS
from ..ops.blocked import (far_grid, forces_xla, gather_rows, gather_slab,
                           moments_xla)
from ..topology.blocks import build_slot_layout, build_varcol_layout
from ..topology.neighbors import rest_density_and_corr
from .scene import lame_parameters

GROUP = 8   # slots per candidate group of gidx8


def stvk_stress_m3(F, mu, lam, scale):
    """StVK stress S = (2 mu E + lam tr(E) I) * scale, E = 0.5 (F^T F - I),
    on components; mu/lam/scale (m,)."""
    FtF = mat3._mtm(F, F)
    E = [[0.5 * (FtF[i][j] - 1.0) if i == j else 0.5 * FtF[i][j]
          for j in range(3)] for i in range(3)]
    tr = E[0][0] + E[1][1] + E[2][2]
    two_mu = 2.0 * mu
    lam_tr = lam * tr
    return [[(two_mu * E[i][j] + lam_tr if i == j else two_mu * E[i][j]) * scale
             for j in range(3)] for i in range(3)]


def mid_rows(A, Y, rc, mu, lam, scale, corotated: bool):
    """The mid-section on component lists of (k,) tensors: A, Y the K1
    moments, rc[i, j] the static rest correction, mu / lam / scale (k,).
    Returns component lists R, F, S, M: the polar rotation of A (identity
    when not corotated), F = I + (R^T Y - rc)^T, the StVK stress S and
    M = R F S.  The fused kernel's epilogue computes the same, row by row."""
    if corotated:
        R = mat3.polar3_components(A)
        RtY = mat3._mtm(R, Y)
        nab = [[RtY[i][j] - rc[i, j] for j in range(3)] for i in range(3)]
    else:
        R = mat3.eye3(A[0][0])
        nab = [[Y[i][j] - rc[i, j] for j in range(3)] for i in range(3)]
    F = [[1.0 + nab[j][i] if i == j else nab[j][i] for j in range(3)]
         for i in range(3)]
    S = stvk_stress_m3(F, mu, lam, scale)
    M = mat3._mm(R, mat3._mm(F, S))
    return R, F, S, M


def mid_section(A, Y, ratio_slots, mats: Materials, scene: Scene,
                cfg: SimConfig, m: int):
    """A, Y: component lists of (m,) tensors (the K1 moments).  Returns
    component lists R, F, S, M and vol_m (m,).  (The JAX mid-section also
    forms G = V M, which only the pair_def_grad="j" forces read: they form
    it themselves.)"""
    scale = cfg.stiffness_scale(ratio_slots[:m])
    R, F, S, M = mid_rows(A, Y, scene.rest_corr, mats.mu[:m], mats.lam[:m],
                          scale, cfg.corotated)
    return R, F, S, M, mats.volume[:m]


# ------------------------------------------------------------ scene build
def build_blocked_scene(
    points: np.ndarray,
    cfg: SimConfig,
    out_num: int | None = None,
    dirichlet_mask: np.ndarray | None = None,
    external_force: np.ndarray | None = None,
    layout: str = "varcol",
    obstacles=None,
    device=None,
):
    """Returns (scene, slot_of_particle (numpy)); map particle-indexed data
    (x, targets, masks) through ``slot_of_particle``.

    layout: "varcol" (variable-capacity z-sorted columns, low pair waste,
    the default) or "cells" (fixed-capacity cell grid, 4 cells per tile,
    whose tiles of 4 C rows are cut into 32-row tiles sharing their slab).  Host side in numpy f64: the layout, and density, volume and the
    rest correction over the true pair list (``rest_density_and_corr``, as
    the sparse build; the JAX build sums them over the slabs in the scene's
    dtype).  The per-tile arrays are gathered on ``device`` in
    ``cfg.dtype``, and the static row sums rs6 come from one raw-K1 call on
    an all-ones RHS there (the kernel on the card, its plain version on
    the CPU): the forward's - pos_i * rs6 cancels against the raw dots term
    by term, so rs6 must come from the same coefficients, never from a
    host f64 sum.  ``obstacles`` (an ``ops.obstacles.Obstacles``) moves to
    ``device`` too.  ``device=None`` means CUDA, and raises when there is
    none."""
    from ..ops.fused_kernels import moments_raw
    from ..ops.pair_common import slab_slots
    from ..ops.pair_kernels import schedules, slab_inverse

    device = resolve_device(device)
    dtype = torch_dtype(cfg)
    rest = np.asarray(points, dtype=np.float64)
    n = rest.shape[0]
    if layout == "varcol":
        lay = build_varcol_layout(rest, 2.0 * cfg.h, rows=ROWS)
    elif layout == "cells":
        lay = build_slot_layout(rest, 2.0 * cfg.h)
    else:
        raise ValueError(f"unknown blocked layout {layout!r}")
    if lay.tile_rows % ROWS:
        raise ValueError(f"tiles of {lay.tile_rows} rows: the kernels take "
                         f"multiples of {ROWS}")
    split = lay.tile_rows // ROWS
    ns = lay.n_slots
    sop = lay.slot_of_particle
    t = lay.n_tiles * split
    m = t * ROWS
    L = lay.run_len
    slab_start = np.repeat(lay.slab_start.astype(np.int64), split, axis=0)
    if L % GROUP or (slab_start % GROUP).any():
        raise ValueError(f"slab runs must start and end on {GROUP}-slot groups")

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    span = float(np.abs(rest).max()) + 1.0
    rest_slots = far_grid(ns, start=span + 100.0 * cfg.h, spacing=4.0 * cfg.h)
    rest_slots[sop] = rest
    real = lay.particle_of_slot >= 0

    # coefficient mass (0 on empty slots: pair terms vanish) vs integrator
    # mass (1 on empty slots: no 0/0; they are frozen anyway)
    mass = np.where(real, cfg.mass, 0.0)
    mass_integ = np.where(real, cfg.mass, 1.0)
    mu0, lam0 = lame_parameters(cfg.youngs_modulus, cfg.poisson_ratio)
    mu = np.where(real, mu0, 0.0)
    lam = np.where(real, lam0, 0.0)
    free = np.zeros((ns, 3))
    free[sop] = 1.0 if dirichlet_mask is None else np.asarray(dirichlet_mask, np.float64)
    ext = np.zeros((ns, 3))
    ext[sop] = (
        np.asarray(cfg.external_force, np.float64)
        if external_force is None
        else np.asarray(external_force, np.float64)
    )
    _, vol_p, corr_p = rest_density_and_corr(rest, np.full(n, cfg.mass), cfg)
    volume = np.zeros(ns)
    volume[sop] = vol_p
    rest_corr9 = np.zeros((m, 9))
    rest_corr9[sop] = corr_p.reshape(n, 9)   # every particle slot is a tile row

    gidx8 = dev((slab_start[:, :, None] // GROUP
                 + np.arange(L // GROUP)).reshape(t, 9 * L // GROUP), torch.int32)
    rest_d = dev(rest_slots)
    idx = slab_slots(gidx8, 9 * L)                       # (t, slab) on device
    static_slab = torch.cat([rest_d[idx].permute(0, 2, 1), dev(mass)[idx][:, None],
                             dev(volume)[idx][:, None]], dim=1).contiguous()
    restT_rows = rest_d[:m].reshape(t, ROWS, 3).permute(0, 2, 1).contiguous()
    with torch.no_grad():
        ay1 = moments_raw(restT_rows, static_slab,
                          torch.ones((3, ns), dtype=dtype, device=device),
                          gidx8, cfg.h)
    ptr, sidx = slab_inverse([gidx8.cpu().numpy()], ns, GROUP, real)
    sched, chunks = schedules([t], [9 * L], [0], GROUP, device)
    blk = Blocked(
        bucket=DevBucket(gidx8=gidx8, restT_rows=restT_rows, static_slab=static_slab,
                         tile_start=0, rows=ROWS, slab_len=9 * L),
        slab_start=dev(slab_start, torch.int64), rs6T=ay1[0::3].contiguous(),
        run_len=L, n_slots=ns, group=GROUP,
        slab_ptr=dev(ptr, torch.int32), slab_idx=dev(sidx, torch.int32),
        schedule=sched, chunks=chunks)
    mats = Materials(
        mass=dev(mass_integ), volume=dev(volume), mu=dev(mu), lam=dev(lam),
        free=dev(free), external=dev(ext),
    )
    scene = Scene(
        rest_position=rest_d,
        materials=mats,
        out_num=int(out_num if out_num is not None else n),
        blocked=blk,
        rest_corr=dev(rest_corr9.reshape(m, 3, 3)).permute(1, 2, 0).contiguous(),
        slot_of_particle=dev(sop, torch.int64),
        obstacles=None if obstacles is None else obstacles.to(device),
    )
    return scene, sop


# ------------------------------------------------------------ elastic forces
def _comps(X):
    """(m, 3, 3) -> component list X[a][b] of (m,) tensors."""
    return [[X[:, a, b] for b in range(3)] for a in range(3)]


def _stack9(X):
    """Component list -> (m, 9), column 3a+b = X[a][b]."""
    return torch.stack([X[a][b] for a in range(3) for b in range(3)], dim=1)


def elastic_forces_blocked(pos_slots, ratio_slots, mats: Materials, scene: Scene,
                           cfg: SimConfig):
    """Blocked-layout elastic forces over slot space, the plain torch
    reference (``backend="blocked"``): the moments and pair forces of
    ``ops/blocked.py`` on materialized per-pair tensors, differentiable by
    autograd.  Memory-hungry: for small bodies."""
    blk: Blocked = scene.blocked
    t, rows = blk.n_tiles, blk.rows
    m = t * rows
    A4, Y4 = moments_xla(gather_rows(pos_slots, blk), gather_slab(pos_slots, blk),
                         blk, cfg)
    R, F, S, M, vol_m = mid_section(_comps(A4.reshape(m, 3, 3)),
                                    _comps(Y4.reshape(m, 3, 3)),
                                    ratio_slots, mats, scene, cfg, m)
    G = [[vol_m * M[a][b] for b in range(3)] for a in range(3)]

    def slab9(X):
        slots = _stack9(X).new_zeros((blk.n_slots, 9))
        slots[:m] = _stack9(X)
        return gather_slab(slots, blk).reshape(t, blk.slab_len, 3, 3)

    G_rows = _stack9(G).reshape(t, rows, 3, 3)
    vol_rows = vol_m.reshape(t, rows)
    if cfg.pair_def_grad == "j":
        f4 = forces_xla(G_rows, slab9(G), vol_rows, blk, cfg)
    else:
        f4 = forces_xla(G_rows, None, vol_rows, blk, cfg,
                        F_rows=_stack9(F).reshape(t, rows, 3, 3), S_slab=slab9(S),
                        R_slab=slab9(R), vol_slab=blk.bucket.static_slab[:, 4])
    out = torch.zeros_like(pos_slots)
    out[:m] = f4.reshape(m, 3)
    return out


def elastic_forces_pallas(pos_slots, ratio_slots, mats: Materials, scene: Scene,
                          cfg: SimConfig, pair_ops=None):
    """The ``pallas`` backend: the pair kernels on either scene type (a
    sparse scene goes to ``sim/sparse.elastic_forces_sparse``).  On a
    blocked scene (counterpart of ``softbody_tpu/sim/blocked.py:251-328``):
    the raw K1, the mid-section kernel on its raw dots (the - pos_i * rs6
    correction first), then the Warp pairing's K2 v2 on [F | M | V] rows
    and the [S_6 | R^T_9] slot record, or the Taichi pairing's separable
    K2 on G = V M.

    ``pair_ops``: ``ops.pair_kernels.KERNELS`` (the default: kernels on the
    card, plain versions on the CPU) or ``PLAIN``."""
    # the kernel modules import this module's mid_rows: imported here
    from ..ops.fused_kernels import forces_v2_all, moments_raw_all
    from ..ops.mid_kernels import mid_records_all, row_static
    from ..ops.pair_kernels import KERNELS
    from .sparse import elastic_forces_sparse, pair_slab, separable_forces

    pair_ops = KERNELS if pair_ops is None else pair_ops
    if isinstance(scene.blocked, SparseBlocked):
        return elastic_forces_sparse(pos_slots, ratio_slots, mats, scene, cfg,
                                     pair_ops)
    blk: Blocked = scene.blocked
    m = blk.n_tiles * blk.rows
    posT = pos_slots.T.contiguous()
    ayT = moments_raw_all(posT, blk, cfg.h, pair_ops)          # (18, m) raw dots
    # row 3b+a is the raw [a][b] component: the kernel subtracts
    # pos_i[a] * rs6[b] first
    fmT, srT = mid_records_all(ayT, cfg.stiffness_scale(ratio_slots[:m]),
                               row_static(blk, mats, scene.rest_corr), cfg.corotated,
                               blk.n_slots, pair_ops, posT[:, :m], blk.rs6T)
    if cfg.pair_def_grad == "j":
        return separable_forces(pos_slots, fmT, blk, cfg, pair_ops)
    fT = forces_v2_all(fmT, pair_slab(srT, cfg), blk, cfg.h, pair_ops)  # (3, m)
    out = torch.zeros_like(pos_slots)
    out[:m] = fT.T
    return out
