"""Artifact saving: image grids, videos, meshes, json/npy.

Capability parity with `tetgs_spatial/utils/saving.py:22-668` (SaverMixin):
rgb/grayscale grids, image sequences → mp4/gif, ply/obj meshes, npy/json —
as plain functions (no Lightning mixin).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def _to_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    return img


def _write_png(path: str, img: np.ndarray) -> None:
    """8-bit PNG through the standard library (zlib): the frames of a
    machine without imageio."""
    import struct
    import zlib

    h, w, c = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * c)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    color = {1: 0, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))


def save_image(path: str, img: np.ndarray) -> str:
    """Write an image; imageio's writer, else (no imageio installed) the
    standard library's PNG for a .png path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        import imageio.v2 as imageio
    except ImportError:
        if not path.lower().endswith(".png"):
            raise
        _write_png(path, _to_uint8(img))
        return path
    imageio.imwrite(path, _to_uint8(img))
    return path


def save_image_grid(
    path: str,
    images: Sequence[np.ndarray],
    cols: Optional[int] = None,
) -> str:
    """Tile images (all same shape) into one grid image."""
    imgs = [_to_uint8(i) for i in images]
    n = len(imgs)
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    h, w, c = imgs[0].shape
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i, im in enumerate(imgs):
        r, cc = divmod(i, cols)
        grid[r * h : (r + 1) * h, cc * w : (cc + 1) * w] = im
    return save_image(path, grid)


def save_video(
    path: str, frames: Sequence[np.ndarray], fps: int = 30
) -> str:
    """Image sequence → mp4 (SaverMixin `save_img_sequence`)."""
    import imageio.v2 as imageio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        with imageio.get_writer(path, fps=fps) as w:
            for f in frames:
                w.append_data(_to_uint8(f))
        return path
    except (ValueError, ImportError):
        # No ffmpeg backend in this environment — fall back to GIF.
        gif = os.path.splitext(path)[0] + ".gif"
        imageio.mimsave(gif, [_to_uint8(f) for f in frames],
                        duration=1.0 / fps)
        return gif


def save_ply(
    path: str,
    verts: np.ndarray,
    faces: Optional[np.ndarray] = None,
    colors: Optional[np.ndarray] = None,
) -> str:
    """ASCII PLY mesh/point-cloud writer (no external mesh libs)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    verts = np.asarray(verts, np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\n"
            )
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        if colors is not None:
            cols = _to_uint8(colors)
            for v, c in zip(verts, cols):
                f.write(
                    f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n"
                )
        else:
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for tri in np.asarray(faces):
                f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
    return path


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in np.asarray(faces):
            f.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")
    return path


def save_json(path: str, payload: Dict) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=float)
    return path


def save_npy(path: str, payload) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, payload)
    return path


def save_grayscale(
    path: str,
    img: np.ndarray,
    cmap: str = "jet",
    data_range: tuple | None = None,
) -> str:
    """Colormapped grayscale save (SaverMixin `save_grayscale_image`
    semantics, `utils/saving.py:191-230`): normalize to [0, 1] (optionally
    by a fixed range) and apply a jet/magma colormap without matplotlib."""
    x = np.asarray(img, np.float32)
    if data_range is not None:
        lo, hi = data_range
    else:
        lo, hi = float(x.min()), float(x.max())
    x = np.clip((x - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    if cmap in (None, "none"):
        rgb = np.stack([x] * 3, -1)
    elif cmap == "jet":
        r = np.clip(1.5 - np.abs(4 * x - 3), 0, 1)
        g = np.clip(1.5 - np.abs(4 * x - 2), 0, 1)
        b = np.clip(1.5 - np.abs(4 * x - 1), 0, 1)
        rgb = np.stack([r, g, b], -1)
    elif cmap == "magma":
        r = np.clip(1.6 * x - 0.1, 0, 1) ** 0.9
        g = np.clip(1.4 * x - 0.35, 0, 1) ** 1.2
        b = np.clip(
            0.6 + 1.2 * x - 2.0 * np.maximum(x - 0.6, 0) ** 0.8, 0, 1
        ) * np.clip(4 * x, 0, 1)
        rgb = np.stack([r, g, b], -1)
    else:
        raise ValueError(f"unknown cmap {cmap!r}")
    return save_image(path, rgb)


def save_uv_layout(path: str, v_tex: np.ndarray, t_tex_idx: np.ndarray,
                   size: int = 1024) -> str:
    """Rasterize the UV chart layout as a wireframe image (SaverMixin
    `save_uv_image` role)."""
    img = np.zeros((size, size), np.float32)
    uv = np.clip(np.asarray(v_tex, np.float32), 0, 1) * (size - 1)
    edges = np.concatenate(
        [t_tex_idx[:, (0, 1)], t_tex_idx[:, (1, 2)], t_tex_idx[:, (2, 0)]]
    )
    for a, b in edges:
        pa, pb = uv[a], uv[b]
        n = int(np.linalg.norm(pb - pa)) + 1
        ts = np.linspace(0, 1, n)
        xs = (pa[0] + ts * (pb[0] - pa[0])).astype(int)
        ys = (pa[1] + ts * (pb[1] - pa[1])).astype(int)
        img[ys, xs] = 1.0
    return save_image(path, np.stack([img] * 3, -1))


class WandbLogger:
    """Optional Weights & Biases hook (SaverMixin `create_loggers`,
    `utils/saving.py:56-75`): no-op unless wandb is importable AND enabled,
    so the training loop can call it unconditionally."""

    def __init__(self, enable: bool = False, project: str = "youreditableavatar",
                 name: str | None = None, config: Dict | None = None):
        self._run = None
        if not enable:
            return
        try:
            import wandb

            self._run = wandb.init(project=project, name=name,
                                   config=config or {})
        except Exception:
            self._run = None  # offline image: stay a no-op

    def log(self, metrics: Dict, step: int | None = None) -> None:
        if self._run is not None:
            self._run.log(metrics, step=step)

    def log_image(self, key: str, img: np.ndarray,
                  step: int | None = None) -> None:
        if self._run is not None:
            import wandb

            self._run.log({key: wandb.Image(np.asarray(img))}, step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()


class ProgressFile:
    """Single-line progress file for UI frontends (gradio).

    Equivalent of the reference's `ProgressCallback`
    (`tetgs_spatial/utils/callbacks.py:120-157`): the file always holds ONE
    current status line (truncate + rewrite), e.g.
    "Generation progress: 42.00%".
    """

    def __init__(self, path: str | None):
        self.path = path
        self._fh = None

    def write(self, msg: str) -> None:
        if self.path is None:
            return
        if self._fh is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._fh = open(self.path, "w")
        self._fh.seek(0)
        self._fh.truncate()
        self._fh.write(msg)
        self._fh.flush()

    def step(self, step: int, max_steps: int) -> None:
        pct = 100.0 * step / max(max_steps, 1)
        self.write(f"Generation progress: {pct:.2f}%")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def snapshot_run(out_dir: str, config: Dict | None = None) -> None:
    """Record the invocation + config (ConfigSnapshotCallback + cmd.txt,
    `utils/callbacks.py:97-110`, `train_spatial.py:180-185`)."""
    import sys

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cmd.txt"), "w") as f:
        f.write(" ".join(sys.argv) + "\n")
    if config is not None:
        save_json(os.path.join(out_dir, "parsed_config.json"), config)
