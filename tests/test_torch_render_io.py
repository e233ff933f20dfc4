"""PyTorch port: its own copies of the render writers, the frame adapters,
the video helpers, the asset readers and writers, the Eigen binary formats
and ``box_fill`` give what the JAX package's give on the same inputs: the
same scene text and byte-identical files (all of them numpy-only), equal
arrays from the readers."""

import struct

import numpy as np
import pytest

from softbody_tpu.geometry import io as jgio
from softbody_tpu.geometry import shapes as jshapes
from softbody_tpu.render import adapters as jadapters
from softbody_tpu.render import pbrt as jpbrt
from softbody_tpu.render import video as jvideo
from softbody_tpu.utils import io as juio
from softbody_tpu_torch.geometry import io as gio
from softbody_tpu_torch.geometry import shapes
from softbody_tpu_torch.render import adapters, pbrt, preview, video
from softbody_tpu_torch.utils import io as uio


def full_scene(mod, workdir):
    r = mod.PbrtScene(workdir=workdir)
    r.set_camera(eye=[0, 1, 8], look_at=[0, 0, 0], up=[0, 1, 0], fov=40)
    r.set_image(pixel_samples=64, file_name="img.png", resolution=[1000, 800])
    r.add_infinite_light({"rgb L": (1.0, 1.0, 1.0)})
    r.add_distant_light([0, 10, 0], [0, 0, 0], [0.5, 0.5, 0.5])
    r.add_spherical_area_light([30, 10, 40], 3, [1, 1, 1], 3e4)
    r.add_sphere([1, 2, 3], 0.1, ("diffuse", {"rgb reflectance": (1, 0, 0)}))
    r.add_cylinder(np.array([0.0, 0, 0]), np.array([0.0, 1, 0]), 0.05, ("diffuse", {}))
    r.add_cylinder(np.array([0.0, 0, 1]), np.array([0.0, 0, 0]), 0.05, ("diffuse", {}))
    r.add_plane([0, 0, 0], [0, 1, 0], 10, ("diffuse", {"rgb reflectance": [0.2, 0.3, 0.2]}))
    r.add_curve(np.zeros((4, 3)), 3, 0.01, ("diffuse", {}))
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.0]])
    r.add_triangle_mesh(verts, np.array([[0, 1, 2]]), np.array([[0, 0], [1, 0], [0, 1.0]]),
                        "tex.png", ("diffuse", {"rgb reflectance": (1, 1, 1)}))
    return r


def test_pbrt_scene_is_byte_identical(tmp_path):
    got = full_scene(pbrt, tmp_path / "a")
    want = full_scene(jpbrt, tmp_path / "b")
    assert got.scene_text() == want.scene_text()
    assert got.write().read_bytes() == want.write().read_bytes()
    assert got.render(pbrt_binary="definitely-not-a-binary") is False
    assert pbrt.PbrtRenderer is pbrt.PbrtScene


def test_frame_adapters_are_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(20, 3))
    faces = np.array([[0, 1, 2], [2, 3, 4]])
    uv = rng.random((10, 2))
    for mod, side in ((adapters, "t"), (jadapters, "j")):
        mod.mesh_frame_scene(pos, 10, faces, uv, "t.png", "a.png",
                             workdir=tmp_path / side / "mesh").write()
        mod.sphere_cloud_scene(pos, "b.png", workdir=tmp_path / side / "cloud").write()
        mod.render_episode(pos[None].repeat(3, 0), 10, None, None, None,
                           tmp_path / side / "ep", every=2)
    for part in ("mesh", "cloud", "ep/.pbrt"):
        got = (tmp_path / "t" / part / "scene.pbrt").read_text()
        want = (tmp_path / "j" / part / "scene.pbrt").read_text()
        assert got.replace(str(tmp_path / "t"), "") == want.replace(str(tmp_path / "j"), "")
    assert 'Shape "trianglemesh"' in (tmp_path / "t" / "mesh" / "scene.pbrt").read_text()


def test_video_helpers_match(tmp_path):
    for name in ("sim_0003.png", "sim_0001.png", "sim_0002.png", "other.txt"):
        (tmp_path / name).write_bytes(b"x")
    got = video.collect_frames(tmp_path, "sim_", ".png")
    assert got == jvideo.collect_frames(tmp_path, "sim_", ".png")
    assert [f.name for f in got] == ["sim_0001.png", "sim_0002.png", "sim_0003.png"]
    assert video.export_mp4(tmp_path, tmp_path / "o.mp4", 5, "sim_", ".png",
                            ffmpeg_binary="definitely-not-a-binary") is False


def test_preview_imports_matplotlib_only_when_called():
    assert callable(preview.render_preview_frame)
    assert "matplotlib" not in preview.__dict__


def test_ply_and_obj_readers_match(tmp_path):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(17, 3))
    gio.write_ply_points(tmp_path / "t.ply", pts)
    jgio.write_ply_points(tmp_path / "j.ply", pts)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    np.testing.assert_array_equal(gio.read_ply_points(tmp_path / "t.ply"),
                                  jgio.read_ply_points(tmp_path / "t.ply"))
    # binary little-endian with an extra property
    n = 5
    data = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("q", "<u1")])
    ref = rng.normal(size=(n, 3)).astype(np.float32)
    data["x"], data["y"], data["z"] = ref.T
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              "property float x\nproperty float y\nproperty float z\nproperty uchar q\n"
              "end_header\n")
    (tmp_path / "b.ply").write_bytes(header.encode() + data.tobytes())
    got = gio.read_ply_points(tmp_path / "b.ply")
    np.testing.assert_array_equal(got, jgio.read_ply_points(tmp_path / "b.ply"))
    np.testing.assert_array_equal(got, ref.astype(np.float64))
    (tmp_path / "m.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                                    "f 1/1/1 2/2/2 3/3/3 4/4/4\n")
    for a, b in zip(gio.read_obj(tmp_path / "m.obj"), jgio.read_obj(tmp_path / "m.obj")):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not a PLY"):
        gio.read_ply_points(tmp_path / "m.obj")


def test_reference_body_matches(tmp_path):
    d = tmp_path / "pear"
    d.mkdir()
    rng = np.random.default_rng(3)
    outer, inner = rng.normal(size=(30, 3)) * 5, rng.normal(size=(20, 3)) * 3
    with open(d / "point_cloud_downsampled.ply", "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {len(outer)}\n"
                 "property float x\nproperty float y\nproperty float z\nend_header\n"
                 ).encode())
        for p in outer.astype(np.float32):
            f.write(struct.pack("<fff", *p))
    gio.write_ply_points(d / "pear_inner.ply", inner)
    (d / "outer.obj").write_text("".join(f"v {p[0]} {p[1]} {p[2]}\n" for p in outer)
                                 + "f 1 2 3\nf 3 4 5 6\n")
    np.save(d / "uv.npy", rng.random((30, 2)))
    got = gio.load_reference_body(tmp_path, "pear")
    want = jgio.load_reference_body(tmp_path, "pear")
    assert got.keys() == want.keys() and got["out_num"] == want["out_num"] == 30
    for k in ("points", "raw_points", "faces", "uv"):
        np.testing.assert_array_equal(got[k], want[k])
    # x0.01, the rotation, +0.07 y-hat (sim.py:41-53)
    np.testing.assert_allclose(got["points"], got["raw_points"] @ gio.REFERENCE_ROTATION
                               + [0.0, 0.07, 0.0], rtol=0, atol=1e-15)


def test_eigen_binary_io_is_byte_identical(tmp_path):
    v = np.random.default_rng(4).normal(size=31)
    uio.save_real_vector(tmp_path / "t.bin", v)
    juio.save_real_vector(tmp_path / "j.bin", v)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    np.testing.assert_array_equal(uio.load_real_vector(tmp_path / "j.bin"), v)
    trip = [(0, 1, 2.5), (2, 0, -1.0), (2, 3, 4.0)]
    m = uio.triplets_to_sparse_matrix(3, 4, trip)
    uio.save_real_sparse_matrix(tmp_path / "t.mat", m)
    juio.save_real_sparse_matrix(tmp_path / "j.mat", juio.triplets_to_sparse_matrix(3, 4, trip))
    assert (tmp_path / "t.mat").read_bytes() == (tmp_path / "j.mat").read_bytes()
    back = uio.load_real_sparse_matrix(tmp_path / "j.mat")
    assert back.shape == (3, 4)
    assert uio.sparse_matrix_to_triplets(back) == trip
    uio.create_folder(tmp_path / "a" / "b", exist_ok=False)
    assert not uio.file_exist(tmp_path / "a" / "b")
    uio.delete_folder(tmp_path / "a")
    uio.delete_file(tmp_path / "t.bin")
    assert not (tmp_path / "t.bin").exists() and not (tmp_path / "a").exists()


def test_box_fill_matches():
    for lo, hi, s in (((0, 0, 0), (1, 0.5, 0.25), 0.125), ((-0.1, 0.2, -0.3), (0.1, 0.3, 0.0), 0.05)):
        np.testing.assert_array_equal(shapes.box_fill(lo, hi, s), jshapes.box_fill(lo, hi, s))
