"""Sparse-bucketed scene building and elastic forces (counterpart of
``softbody_tpu/sim/sparse.py``).

Per force evaluation (Warp pairing, ``pair_def_grad="i"``):

  pos (n_slots, 3) -> posT (3, n_slots)
    -> [moments_all: K1 moments_v4, one launch] -> ayT (18, m)
    -> [mid_records_all: the mid-section (polar, F, S, M), one launch]
    -> fmT (19, m) = [F_9 | M_9 | V_i], per-slot record srT (15, n_slots)
       = [S_6 | R^T_9]
    -> [forces_all: K2 forces_warp_v4 on F_9, one launch] -> termjT (3, m)
    -> f_i = 0.5 V_i (termj + M_i rs6T[3:6])  -> forces (n_slots, 3)

With the Taichi pairing (``pair_def_grad="j"``) ``separable_forces`` forms
G = V M per slot from fmT, and the separable K2
(``ops/separable_kernels.py``) applies term_i and the 0.5 V_i scale
itself:

  ayT -> mid_records_all -> fmT -> gT (9, n_slots) = G, row 3a+b
    -> [forces_sep_all: K2 forces_sep, one launch, svnw from rs6T[3:6]]
    -> fT (3, m)

With ``cfg.fused_mid`` (Warp pairing only: with ``"j"`` it runs the
``"j"`` branch above, as the JAX package does) the mid-section moves into
the K1 kernel (``ops/fused_kernels.py``):

  posT -> [moments_mid_all: fused K1 + mid-section, one launch]
    -> fmT (19, m) = [F_9 | M_9 | V_i], srT (15, n_slots)
    -> [forces_v2_all: K2 forces_warp_v2, one launch, term_i and 0.5 V_i in
        the kernel] -> fT (3, m) -> forces (n_slots, 3)

K1 and K2 of the default path, the Taichi pairing's K1 and separable K2
and the fused path's K1 + mid-section and K2 v2 launch once per force
evaluation over every tile of every bucket, in the scene's tile schedule
(``SparseBlocked.schedule``, longest slab first; the JAX path launches
once per bucket).  Tiles are bucket-major, so a bucket's rows are a
contiguous column range of every lane-major array and the per-bucket
plain versions concatenate straight into tile order.  The VJP runs
backwards through the same chain: the K2 backward (its row pass and its
slab pass; the separable K2's is one kernel) and the K1 backward, one
launch each over the whole scene (the slab side over
``SparseBlocked.chunks``), each followed by one fixed-order
``slab_to_slots`` into the slots, and the mid-section's VJP between them
(``ops/mid_kernels.mid_records_bwd``, one launch; the polar through its
clamped analytic VJP).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SimConfig, resolve_device, torch_dtype
from ..core.types import Materials, Scene, SparseBlocked
from ..ops.blocked import far_grid
from ..ops.fused_kernels import forces_v2_all, moments_mid_all
from ..ops.mid_kernels import mid_records_all, row_static
from ..ops.pair_kernels import (KERNELS, PairOps, forces_all, moments_all,
                                sparse_blocked)
from ..ops.separable_kernels import forces_sep_all
from ..topology.neighbors import rest_density_and_corr
from ..topology.sparse import GROUP, build_sparse_layout
from .scene import lame_parameters


def build_sparse_scene(
    points: np.ndarray,
    cfg: SimConfig,
    out_num: int | None = None,
    rows: int = 32,
    max_buckets: int = 8,
    dirichlet_mask: np.ndarray | None = None,
    external_force: np.ndarray | None = None,
    group: int = GROUP,
    obstacles=None,
    device=None,
    n_shards: int = 1,
):
    """Returns (scene, slot_of_particle (numpy)).

    ``n_shards > 1`` builds the shard-major layout the SPMD episode runs on
    (``parallel/sparse_shard.py``; slot groups of 8 only, as in JAX).

    Host side in numpy f64 (layout, rest density, rest correction, static
    row sums), then every array moves to ``device`` in ``cfg.dtype``
    (``obstacles``, an ``ops.obstacles.Obstacles``, too).  ``device=None``
    means CUDA, and raises when there is none."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg)
    rest = np.asarray(points, dtype=np.float64)
    n = rest.shape[0]
    layout = build_sparse_layout(rest, 2.0 * cfg.h, rows=rows,
                                 max_buckets=max_buckets, group=group,
                                 n_shards=n_shards)
    if layout.n_shards > 1 and int(layout.group) != 8:
        raise ValueError("SPMD sparse scenes take group=8: the shard sources "
                         "and halo plans move 8-slot groups")
    rows = layout.rows
    ns = layout.n_slots
    sop = layout.slot_of_particle
    n_tiles = layout.n_tiles
    m = n_tiles * rows

    def dev(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)

    span = float(np.abs(rest).max()) + 1.0
    rest_slots = far_grid(ns, start=span + 100.0 * cfg.h, spacing=4.0 * cfg.h)
    rest_slots[sop] = rest
    real = layout.particle_of_slot >= 0

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

    # density, volume, rest correction Y(rest) and the static row sums over
    # the TRUE pair list (C++ CSR hash grid), host f64
    rho_p, vol_p, corr_p, scx_p, svnw_p = rest_density_and_corr(
        rest, np.full(n, cfg.mass), cfg, rowsums=True)
    volume = np.zeros(ns)
    volume[sop] = vol_p
    rest_corr9 = np.zeros((m, 9))
    rest_corr9[sop] = corr_p.reshape(n, 9)  # sop < m: every particle slot is in a tile
    rs6 = np.zeros((m, 6))
    rs6[sop, 0:3] = scx_p
    rs6[sop, 3:6] = svnw_p

    gsz = int(layout.group)
    parts = []
    for b in layout.buckets:
        sl = (b.group_ids.astype(np.int64)[:, :, None] * gsz
              + np.arange(gsz)[None, None, :]).reshape(b.group_ids.shape[0], -1)
        tid = b.tile_ids.astype(np.int64)                  # contiguous range
        rr = rest_slots[tid[:, None] * rows + np.arange(rows)[None, :]]
        static = np.concatenate([
            np.swapaxes(rest_slots[sl], 1, 2),             # (t_b, 3, S)
            mass[sl][:, None, :],
            volume[sl][:, None, :],
        ], axis=1)
        parts.append((b.group_ids, np.swapaxes(rr, 1, 2), static, int(tid[0])))
    sb = sparse_blocked(parts, rs6.T, ns, gsz, real, device, dtype, rows,
                        layout.n_shards)
    mats = Materials(
        mass=dev(mass_integ), volume=dev(volume), mu=dev(mu), lam=dev(lam),
        free=dev(free), external=dev(ext),
    )
    scene = Scene(
        rest_position=dev(rest_slots),
        materials=mats,
        out_num=int(out_num if out_num is not None else n),
        blocked=sb,
        rest_corr=dev(rest_corr9.reshape(m, 3, 3)).permute(1, 2, 0).contiguous(),
        slot_of_particle=dev(sop, torch.int64),
        obstacles=None if obstacles is None else obstacles.to(device),
    )
    return scene, sop


def pair_slab(srT, cfg: SimConfig):
    """The K2 slot record as K2 reads it: bfloat16 with ``cfg.pair_dtype
    = "bfloat16"`` (storage only: the kernels upcast each value once and do
    all pair arithmetic in the simulation dtype, as the JAX kernels do), else
    as it is."""
    return srT.to(torch.bfloat16) if cfg.pair_dtype == "bfloat16" else srT


def elastic_forces_sparse(pos_slots, ratio_slots, mats: Materials,
                          scene: Scene, cfg: SimConfig,
                          pair_ops: PairOps = KERNELS):
    """Elastic forces (n_slots, 3) of the sparse scene: Warp pairing, the
    Taichi pairing with ``pair_def_grad="j"``; ``cfg.fused_mid`` with the
    Warp pairing takes the fused path (:func:`_fused_forces`).

    ``pair_ops``: :data:`~softbody_tpu_torch.ops.pair_kernels.KERNELS`
    (default: the CUDA kernels on the card, the plain versions on the CPU)
    or ``PLAIN`` (the plain versions on any device — the card-side
    yardstick).  ``cfg.pair_dtype = "bfloat16"`` stores K2's slot record in
    bfloat16 (:func:`pair_slab`); the fused path does not take it and the
    unfused one runs, as in the JAX package (``sim/sparse.py:342-343``)."""
    sb: SparseBlocked = scene.blocked
    m = sb.n_tiles * sb.rows
    posT = pos_slots.T.contiguous()                            # (3, n_slots)
    if cfg.fused_mid and cfg.pair_def_grad == "i" and cfg.pair_dtype != "bfloat16":
        return _fused_forces(pos_slots, posT, ratio_slots, mats, scene, cfg,
                             pair_ops)

    ayT = moments_all(posT, posT[:, :m], sb, cfg.h, pair_ops)  # (18, m)
    fmT, srT = mid_records_all(ayT, cfg.stiffness_scale(ratio_slots[:m]),
                               row_static(sb, mats, scene.rest_corr), cfg.corotated,
                               sb.n_slots, pair_ops)
    if cfg.pair_def_grad == "j":
        return separable_forces(pos_slots, fmT, sb, cfg, pair_ops)
    termjT = forces_all(fmT[:9], pair_slab(srT, cfg), sb, cfg.h, pair_ops)  # (3, m)
    out = torch.zeros_like(pos_slots)
    out[:m] = term_i_forces(fmT, termjT, sb.rs6T).T
    return out


def term_i_forces(fmT, termjT, rs6T):
    """K2 v4's epilogue: f_a = 0.5 V_i (termj_a + sum_b M_i[a][b] svnw_b),
    svnw = rs6T[3:6], from fmT (19, m) = [F_9 | M_9 | V_i] -> (3, m)."""
    M = fmT[9:18].view(3, 3, -1)
    sv = rs6T[3:6]
    return 0.5 * fmT[18] * (termjT + (M[:, 0] * sv[0] + M[:, 1] * sv[1] + M[:, 2] * sv[2]))


def slot_rows(comps, n_slots: int):
    """Component list of (m,) tensors -> (k, n_slots) lane-major, zero past
    the tile rows."""
    rows = torch.stack(comps)
    pad = rows.new_zeros((rows.shape[0], n_slots - rows.shape[1]))
    return torch.cat([rows, pad], dim=1)


def separable_forces(pos_slots, fmT, sb, cfg: SimConfig, pair_ops: PairOps):
    """The Taichi pairing's K2 (``softbody_tpu/sim/sparse.py:398-406``):
    from the mid-section's fmT (19, m) = [F_9 | M_9 | V_i] to the forces
    (n_slots, 3) through the separable kernel on G = V M (gT (9, n_slots),
    zero past the tile rows), term_i and the 0.5 V_i scale in the kernel.
    Shared with the blocked layout (``sim/blocked.elastic_forces_pallas``)
    and the SPMD episode (``parallel/sparse_shard.py``, on the rank's
    source)."""
    m = fmT.shape[1]
    gT = torch.cat([fmT[18] * fmT[9:18], fmT.new_zeros((9, sb.n_slots - m))], dim=1)
    fT = forces_sep_all(gT, fmT[18], sb, cfg.h, pair_ops)      # (3, m)
    out = torch.zeros_like(pos_slots)
    out[:m] = fT.T
    return out


def _fused_forces(pos_slots, posT, ratio_slots, mats: Materials, scene: Scene,
                  cfg: SimConfig, pair_ops: PairOps):
    """The fused path (counterpart of ``softbody_tpu/sim/sparse.py:340-381``):
    one K1 + mid-section launch over the scene emits the K2 records fmT /
    srT, then K2 v2, one launch over the scene, applies term_i and the
    0.5 V_i scale itself."""
    sb: SparseBlocked = scene.blocked
    m = sb.n_tiles * sb.rows
    scale = cfg.stiffness_scale(ratio_slots[:m])
    fmT, srT = moments_mid_all(posT, posT[:, :m], scale, sb,
                               row_static(sb, mats, scene.rest_corr), cfg.h,
                               cfg.corotated, pair_ops)
    fT = forces_v2_all(fmT, srT, sb, cfg.h, pair_ops)          # (3, m)
    out = torch.zeros_like(pos_slots)
    out[:m] = fT.T
    return out
