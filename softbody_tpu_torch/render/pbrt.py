"""PBRT-v4 scene writer + offline renderer driver (the port's own copy of
``softbody_tpu/render/pbrt.py``).

Host-side equivalent of the reference's ``PbrtRenderer`` (pbrt_renderer.py:10-288)
with the same capability surface — perspective camera, infinite/distant/
spherical-area lights, sphere/cylinder/plane/curve/triangle-mesh shapes with
optional image textures and per-shape transforms, halton sampler + volpath
integrator, right-to-left handedness flip — redesigned as typed scene elements
with a small directive emitter instead of string-building inline.

Rendering shells out to an external ``pbrt`` binary (the reference keeps pbrt
as a subprocess too, pbrt_renderer.py:282-285); GPU mode is used when the
``PBRT_OPTIX7_PATH`` env var is present.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np


def _fmt(v) -> str:
    """Format one pbrt parameter value."""
    if isinstance(v, (str, Path)):
        return f'"{v}"'
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer, float, np.floating)):
        return str(v)
    arr = np.asarray(v).ravel()
    return "[" + " ".join(str(x) for x in arr.tolist()) + "]"


def _params(d: dict) -> list[str]:
    return [f'    "{k}" {_fmt(v)}' for k, v in d.items()]


@dataclasses.dataclass
class Light:
    kind: str                 # "infinite" | "distant"
    properties: dict

    def emit(self) -> list[str]:
        return [f'LightSource "{self.kind}"'] + _params(self.properties) + [""]


@dataclasses.dataclass
class AreaLight:
    center: np.ndarray
    radius: float
    rgb: Sequence[float]
    power: float
    transforms: list = dataclasses.field(default_factory=list)

    def emit(self) -> list[str]:
        lines = ["AttributeBegin"]
        r, g, b = (float(c) for c in self.rgb)
        lines.append(
            f'    AreaLightSource "diffuse" "rgb L" [{r} {g} {b}] "float power" [ {self.power} ]'
        )
        lines += [f"    {k} {' '.join(str(x) for x in v)}" for k, v in self.transforms]
        cx, cy, cz = (float(c) for c in np.asarray(self.center).ravel())
        lines.append(f"    Translate {cx} {cy} {cz}")
        lines.append(f'    Shape "sphere" "float radius" {float(self.radius)}')
        lines += ["AttributeEnd", ""]
        return lines


@dataclasses.dataclass
class Shape:
    kind: str                 # "sphere" | "cylinder" | "curve" | "trianglemesh"
    properties: dict
    material: tuple           # (type, {props})
    transforms: list = dataclasses.field(default_factory=list)
    texture: Optional[str] = None   # image path for reflectance texture

    def emit(self, index: int) -> list[str]:
        lines = ["AttributeBegin"]
        mat_type, mat_props = self.material
        if self.texture is not None:
            tex = f"texture_{index:08d}"
            lines.append(f'    Texture "{tex}"')
            lines.append(f'        "spectrum" "imagemap" "string filename" "{self.texture}"')
            lines.append(f'    Material "{mat_type}"')
            lines += [
                f'    "{k}" {_fmt(v)}' for k, v in mat_props.items() if "reflectance" not in k
            ]
            lines.append(f'        "texture reflectance" "{tex}"')
        else:
            lines.append(f'    Material "{mat_type}"')
            lines += _params(mat_props)
        lines += [f"    {k} {' '.join(str(x) for x in v)}" for k, v in self.transforms]
        lines.append(f'    Shape "{self.kind}"')
        lines += _params(self.properties)
        lines += ["AttributeEnd", ""]
        return lines


class PbrtScene:
    """Builder with the reference API surface (pbrt_renderer.py:33-176)."""

    def __init__(self, workdir: str | Path = ".pbrt"):
        self.workdir = Path(workdir)
        self._eye = self._look_at = self._up = None
        self._fov = 40.0
        self._pixel_samples = 64
        self._file_name = "out.png"
        self._resolution = (1000, 1000)
        self.lights: list[Light] = []
        self.area_lights: list[AreaLight] = []
        self.shapes: list[Shape] = []

    # ----- camera / image -------------------------------------------------
    def set_camera(self, eye, look_at, up, fov):
        self._eye = np.asarray(eye, float).ravel()
        self._look_at = np.asarray(look_at, float).ravel()
        self._up = np.asarray(up, float).ravel()
        self._fov = float(fov)

    def set_image(self, pixel_samples, file_name, resolution):
        self._pixel_samples = int(pixel_samples)
        self._file_name = str(file_name)
        self._resolution = tuple(int(r) for r in resolution)

    # ----- lights -----------------------------------------------------------
    def add_infinite_light(self, properties: dict):
        self.lights.append(Light("infinite", properties))

    def add_distant_light(self, from_point, to_point, rgb):
        self.lights.append(Light("distant", {
            "point3 from": np.asarray(from_point, float).ravel(),
            "point3 to": np.asarray(to_point, float).ravel(),
            "rgb L": np.asarray(rgb, float).ravel(),
        }))

    def add_spherical_area_light(self, center, radius, rgb, power, transforms=()):
        self.area_lights.append(
            AreaLight(np.asarray(center, float), float(radius), rgb, float(power),
                      list(transforms))
        )

    def clear_lights(self):
        self.lights = []
        self.area_lights = []

    # ----- shapes -----------------------------------------------------------
    def add_sphere(self, center, radius, material, transforms=(), alpha=1.0):
        self.shapes.append(Shape(
            "sphere",
            {"float radius": float(radius), "float alpha": float(alpha)},
            material,
            list(transforms) + [("Translate", np.asarray(center, float).ravel())],
        ))

    def add_cylinder(self, bottom_center, top_center, radius, material,
                     transforms=(), alpha=1.0):
        bottom = np.asarray(bottom_center, float).ravel()
        top = np.asarray(top_center, float).ravel()
        axis = top - bottom
        length = float(np.linalg.norm(axis))
        axis = axis / length
        rot_axis = np.cross([0.0, 0.0, 1.0], axis)
        norm = np.linalg.norm(rot_axis)
        angle = float(np.rad2deg(np.arccos(np.clip(axis[2], -1.0, 1.0))))
        if norm < 1e-6:
            if axis[2] > 0:
                rot_axis, angle = np.array([1.0, 0.0, 0.0]), 0.0
            else:
                rnd = np.random.default_rng(0).normal(size=3)
                rot_axis = np.cross(axis, rnd)
                rot_axis /= np.linalg.norm(rot_axis)
                angle = 180.0
        else:
            rot_axis = rot_axis / norm
        self.shapes.append(Shape(
            "cylinder",
            {"float radius": float(radius), "float zmin": 0.0, "float zmax": length,
             "float alpha": float(alpha)},
            material,
            list(transforms) + [
                ("Translate", bottom),
                ("Rotate", (angle, rot_axis[0], rot_axis[1], rot_axis[2])),
            ],
        ))

    def add_plane(self, center, normal, size, material, texture_image=None,
                  transforms=(), alpha=1.0):
        center = np.asarray(center, float).ravel()
        normal = np.asarray(normal, float).ravel()
        normal = normal / np.linalg.norm(normal)
        # build a deterministic in-plane frame
        helper = np.array([1.0, 0.0, 0.0])
        if abs(normal @ helper) > 0.9:
            helper = np.array([0.0, 1.0, 0.0])
        x = np.cross(normal, helper)
        x /= np.linalg.norm(x)
        y = np.cross(normal, x)
        s = float(size) / 2.0
        verts = np.stack([
            center - x * s - y * s, center - x * s + y * s,
            center + x * s - y * s, center + x * s + y * s,
        ])
        elems = np.array([[0, 2, 1], [1, 2, 3]])
        uv = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]])
        self.add_triangle_mesh(verts, elems, uv, texture_image, material, transforms, alpha)

    def add_curve(self, points, deg, width, material, transforms=(), alpha=1.0):
        self.shapes.append(Shape(
            "curve",
            {"point3 P": np.asarray(points, float).ravel(), "integer degree": int(deg),
             "float width": float(width), "float alpha": float(alpha)},
            material, list(transforms),
        ))

    def add_triangle_mesh(self, vertices, elements, texture_coords, texture_image,
                          material, transforms=(), alpha=1.0):
        props = {
            "integer indices": np.asarray(elements, int).ravel(),
            "point3 P": np.asarray(vertices, float).ravel(),
            "float alpha": float(alpha),
        }
        texture = None
        if texture_coords is not None and texture_image is not None:
            props["point2 uv"] = np.asarray(texture_coords, float).ravel()
            texture = str(texture_image)
        self.shapes.append(Shape("trianglemesh", props, material, list(transforms), texture))

    def clear_shapes(self):
        self.shapes = []

    # ----- emission -----------------------------------------------------------
    def scene_text(self) -> str:
        """The full .pbrt scene file contents (handedness flip as in
        pbrt_renderer.py:185-204: z negated in LookAt, world under Scale 1 1 -1)."""
        assert self._eye is not None, "set_camera first"
        e, l, u = self._eye, self._look_at, self._up
        lines = [
            f"LookAt {e[0]} {e[1]} {-e[2]}",
            f"       {l[0]} {l[1]} {-l[2]}",
            f"       {u[0]} {u[1]} {-u[2]}",
            f'Camera "perspective" "float fov" {self._fov}',
            "",
            f'Sampler "halton" "integer pixelsamples" {self._pixel_samples}',
            'Integrator "volpath"',
            f'Film "rgb" "string filename" "{self._file_name}"',
            f'    "integer xresolution" [{self._resolution[0]}] '
            f'"integer yresolution" [{self._resolution[1]}]',
            "",
            "WorldBegin",
            "",
            "AttributeBegin",
            "Scale 1 1 -1",
            "",
        ]
        for light in self.lights:
            lines += light.emit()
        for al in self.area_lights:
            lines += al.emit()
        for i, shape in enumerate(self.shapes):
            lines += shape.emit(i)
        lines.append("AttributeEnd")
        return "\n".join(lines) + "\n"

    def write(self, path: str | Path | None = None) -> Path:
        path = Path(path) if path else self.workdir / "scene.pbrt"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(self.scene_text())
        return path

    def render(self, use_gpu: bool | None = None, pbrt_binary: str | None = None,
               keep_scene: bool = False) -> bool:
        """Write the scene and invoke pbrt.  Returns False if no binary exists
        (callers can still consume the written scene file)."""
        if use_gpu is None:
            use_gpu = "PBRT_OPTIX7_PATH" in os.environ
        scene = self.write()
        binary = pbrt_binary or os.environ.get("PBRT_BINARY", "pbrt")
        if shutil.which(binary) is None:
            return False
        cmd = [binary] + (["--gpu"] if use_gpu else []) + [str(scene)]
        result = subprocess.run(cmd, check=False)
        if not keep_scene:
            shutil.rmtree(self.workdir, ignore_errors=True)
        return result.returncode == 0


# Back-compat alias matching the reference class name (pbrt_renderer.py:10)
PbrtRenderer = PbrtScene
