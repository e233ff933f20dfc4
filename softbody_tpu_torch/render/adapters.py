"""Simulation frame -> PBRT scene adapters (the reference's ``visualize``,
sim.py:325-339 and sim_taichi.py:300-315); the port's own copy of
``softbody_tpu/render/adapters.py``.  Frames arrive as host numpy arrays:
a caller holding CUDA tensors moves them to the host first."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .pbrt import PbrtScene

GOLD = ("conductor", {
    "spectrum eta": "metal-Au-eta",
    "spectrum k": "metal-Au-k",
    "float roughness": 0.004,
})
GROUND_VERTS = np.array([
    [10.0, 0.0, 10.0], [10.0, 0.0, -10.0], [-10.0, 0.0, 10.0], [-10.0, 0.0, -10.0],
])
GROUND_ELEMS = np.array([[0, 1, 2], [2, 3, 1]])


def mesh_frame_scene(positions, out_num, faces, uv, texture_image,
                     image_name, eye=(0, 1, 8), look_at=(0, 0, 0), zoom=0.1,
                     pixel_samples=64, resolution=(1000, 1000),
                     workdir=".pbrt") -> PbrtScene:
    """Textured deformed outer-shell mesh over a gold ground plane
    (visualize, sim.py:325-339)."""
    r = PbrtScene(workdir=workdir)
    eye = np.asarray(look_at, float) + zoom * (np.asarray(eye, float) - np.asarray(look_at, float))
    r.set_camera(eye=eye, look_at=look_at, up=[0, 1, 0], fov=40)
    r.add_infinite_light({"rgb L": (1.0, 1.0, 1.0)})
    v = np.asarray(positions)
    r.add_triangle_mesh(
        vertices=v[:out_num], elements=faces, texture_coords=uv,
        texture_image=texture_image,
        material=("diffuse", {"rgb reflectance": (1, 1, 1)}),
    )
    r.add_triangle_mesh(
        vertices=GROUND_VERTS, elements=GROUND_ELEMS,
        texture_coords=None, texture_image=None, material=GOLD,
    )
    r.set_image(pixel_samples=pixel_samples, file_name=image_name, resolution=resolution)
    return r


def sphere_cloud_scene(positions, image_name, radius=0.007,
                       eye=(4, 1, 0), look_at=(0, 0, 0),
                       pixel_samples=32, resolution=(1000, 1000),
                       area_light=True, workdir=".pbrt") -> PbrtScene:
    """One sphere per particle (Taichi visualize, sim_taichi.py:300-315)."""
    r = PbrtScene(workdir=workdir)
    r.set_camera(eye=eye, look_at=look_at, up=[0, 1, 0], fov=40)
    r.add_infinite_light({"rgb L": (0.7, 0.7, 0.7)})
    if area_light:
        r.add_spherical_area_light([30, 10, 40], 3, [1, 1, 1], 3e4)
    for p in np.asarray(positions):
        r.add_sphere(p, radius, ("diffuse", {"rgb reflectance": (0.0, 0.0, 0.0)}))
    r.set_image(pixel_samples=pixel_samples, file_name=image_name, resolution=resolution)
    return r


def render_episode(frames_positions, out_num, faces, uv, texture_image,
                   render_folder, every=50, use_gpu=None, fps=25):
    """Render every Nth frame + encode mp4 (main()'s render path,
    sim.py:463-473).  Returns the list of written scene/image names.

    Bodies without a surface mesh (``faces is None``, e.g. procedural point
    clouds) fall back to the sphere-cloud adapter (sim_taichi.py:300-315)."""
    from .video import export_mp4

    folder = Path(render_folder)
    folder.mkdir(parents=True, exist_ok=True)
    names = []
    for f in range(0, len(frames_positions), every):
        name = str(folder / f"sim_{f:04d}.png")
        if faces is None:
            # ALL particles, matching the Taichi reference's sphere cloud
            # (sim_taichi.py:309-311 loops the full particle range; inner
            # filling particles are visible through gaps in the shell)
            scene = sphere_cloud_scene(
                frames_positions[f], name, workdir=folder / ".pbrt",
            )
        else:
            scene = mesh_frame_scene(
                frames_positions[f], out_num, faces, uv, texture_image, name,
                workdir=folder / ".pbrt",
            )
        scene.render(use_gpu=use_gpu)
        names.append(name)
    export_mp4(folder, folder / "sim.mp4", fps, "sim_", ".png")
    return names
