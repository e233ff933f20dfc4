"""Frame-sequence -> gif/mp4 export (export_video.py:7-33 capability); the
port's own copy of ``softbody_tpu/render/video.py``.

Uses imageio for gifs and ffmpeg (subprocess) for mp4; both gated so headless
test environments without the binaries degrade gracefully.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path


def collect_frames(folder, prefix: str, suffix: str) -> list[Path]:
    folder = Path(folder)
    frames = [
        p for p in folder.iterdir()
        if p.is_file() and p.name.startswith(prefix) and p.name.endswith(suffix)
    ]
    return sorted(frames)


def export_gif(folder_name, gif_name, fps, name_prefix, name_suffix):
    import imageio

    frames = collect_frames(folder_name, name_prefix, name_suffix)
    images = [imageio.v2.imread(f) for f in frames]
    if fps > 0:
        imageio.mimsave(gif_name, images, fps=fps)
    else:
        imageio.mimsave(gif_name, images)


def export_mp4(folder_name, mp4_name, fps, name_prefix, name_suffix,
               ffmpeg_binary: str | None = None) -> bool:
    """Encode sorted frames to H.264 mp4.  Frames are staged with zero-padded
    names in a temp dir (as export_video.py:24-30 does).  Returns False when
    ffmpeg is unavailable."""
    binary = ffmpeg_binary or os.environ.get("FFMPEG_BINARY", "ffmpeg")
    if shutil.which(binary) is None:
        return False
    frames = collect_frames(folder_name, name_prefix, name_suffix)
    with tempfile.TemporaryDirectory(prefix="_export_mp4") as tmp:
        tmp = Path(tmp)
        for i, f in enumerate(frames):
            shutil.copyfile(f, tmp / f"{i:08d}.png")
        cmd = [
            binary, "-r", str(fps), "-i", str(tmp / "%08d.png"),
            "-vcodec", "libx264", "-y", str(mp4_name),
        ]
        result = subprocess.run(cmd, check=False, capture_output=True)
    return result.returncode == 0
