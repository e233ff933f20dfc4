"""Software preview renderer — rasterized images without a pbrt binary
(the port's own copy of ``softbody_tpu/render/preview.py``; matplotlib is
imported inside the functions only, so the package imports without it).

The reference's render path writes a PBRT-v4 scene file and shells out to a
``pbrt`` binary (pbrt_renderer.py:282-285).  This repo reproduces the scene
writer faithfully (render/pbrt.py), but the build environment ships no pbrt
executable and has no network egress to fetch one — so the PBRT path can only
emit scene files.  This module is the honest fallback: a matplotlib 3-D
scatter rasterizer that turns particle frames into PNGs (and mp4 via
render/video.py), so episode artifacts include actual images.  It is a
PREVIEW — no path tracing, no materials — and is labeled as such everywhere;
the .pbrt scenes remain the production render input.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

# deterministic cap on rendered points: scatter cost is linear and a 1M cloud
# is visually saturated long before that
_MAX_POINTS = 60_000


def render_preview_frame(positions, path, color=None, bounds=None,
                         elev=12.0, azim=35.0, ground_y=None, dpi=110,
                         title=None, cmap="viridis", clim=None):
    """Rasterize one particle frame to a PNG.

    positions: (N, 3) array (y up).  color: optional (N,) scalar field
    (e.g. the inflation ratio) mapped through ``cmap`` — the inverse-design
    result is visible as banding.  bounds: (lo(3,), hi(3,)) fixed axes so an
    episode's frames share a camera.  ground_y: draw the ground plane.
    """
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    p = np.asarray(positions)
    n = len(p)
    if n > _MAX_POINTS:
        stride = -(-n // _MAX_POINTS)
        sel = np.arange(0, n, stride)
        p = p[sel]
        if color is not None:
            color = np.asarray(color)[sel]

    fig = plt.figure(figsize=(6.4, 6.4), dpi=dpi)
    ax = fig.add_subplot(projection="3d")
    # matplotlib's z is up; the sim's y is up -> plot (x, z, y)
    kw = {}
    if color is not None:
        kw = dict(c=np.asarray(color), cmap=cmap)
        if clim is not None:
            kw.update(vmin=clim[0], vmax=clim[1])
    s = max(0.05, 8e4 / max(len(p), 1))
    art = ax.scatter(p[:, 0], p[:, 2], p[:, 1], s=s, linewidths=0, **kw)
    if bounds is not None:
        lo, hi = np.asarray(bounds[0]), np.asarray(bounds[1])
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[2], hi[2])
        ax.set_zlim(lo[1], hi[1])
    if ground_y is not None:
        xl, yl = ax.get_xlim(), ax.get_ylim()
        gx, gy = np.meshgrid(np.linspace(*xl, 2), np.linspace(*yl, 2))
        ax.plot_surface(gx, gy, np.full_like(gx, ground_y), alpha=0.15,
                        color="goldenrod", zorder=0)
    if color is not None:
        fig.colorbar(art, ax=ax, shrink=0.55, pad=0.08)
    if title:
        ax.set_title(title, fontsize=9)
    ax.set_box_aspect((1, 1, 1))
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return str(path)


def render_preview_episode(frames, out_dir, color=None, every=1,
                           ground_y=None, fps=12, label="preview"):
    """Frames (T, N, 3) -> PNGs + mp4 under ``out_dir``.

    Shared camera bounds across the episode (axes locked to the union bbox).
    Returns the list of written PNG paths.  mp4 export degrades gracefully
    when ffmpeg is absent (render/video.py semantics).
    """
    from .video import export_mp4

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    frames = [np.asarray(f) for f in frames[::every]]
    allp = np.concatenate([f for f in frames], axis=0)
    lo, hi = allp.min(0), allp.max(0)
    pad = 0.05 * (hi - lo).max()
    bounds = (lo - pad, hi + pad)
    if ground_y is not None:
        bounds[0][1] = min(bounds[0][1], ground_y)
    names = []
    clim = None
    if color is not None:
        c = np.asarray(color)
        clim = (float(c.min()), float(c.max()))
    for i, f in enumerate(frames):
        names.append(render_preview_frame(
            f, out / f"{label}_{i:04d}.png", color=color, bounds=bounds,
            ground_y=ground_y, clim=clim,
            title=f"{label} frame {i * every}"))
    try:
        export_mp4(out, out / f"{label}.mp4", fps, f"{label}_", ".png")
    except Exception:
        pass  # stills remain
    return names
