"""Stage 3 — text-prompted 3D region localization.

Counterpart of `youreditableavatar_tpu/stages/localization.py`: render the
probe views' visibility, segment each view with a text-prompted segmenter
(any `Segmenter`; `HeuristicSegmenter` is the weight-free stand-in),
back-project the 2D masks onto the mesh through the rasterizer's
per-pixel face ids, refine the selection with mesh morphology (dilate /
erode), drop floaters, and emit `editing_region_info.npy` (vertex + face
masks).

The visibility pass is `ops/mesh_raster.rasterize_mesh` (its z-buffer
resolve is kernel K5 on the card); the votes, the morphology and the
floater removal are host numpy, the same code as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from youreditableavatar_tpu_torch.models.cameras import GSCamera
from youreditableavatar_tpu_torch.ops.mesh_raster import (
    MeshRasterConfig,
    rasterize_mesh,
)
from youreditableavatar_tpu_torch.ops.morphology import (
    dilate_face_region,
    erode_face_region,
    face_mask_from_vertices,
    vertex_mask_from_faces,
)
from youreditableavatar_tpu_torch.stages.export import (
    export_editing_region_info,
    remove_floaters,
)
from youreditableavatar_tpu_torch.utils.device import resolve_device
from youreditableavatar_tpu_torch.utils.registry import register


class Segmenter(Protocol):
    """Text-prompted image segmentation (LangSAM role)."""

    def segment(self, image: np.ndarray, prompt: str) -> np.ndarray:
        """(H, W, 3) float image + prompt → (H, W) bool mask."""
        ...


class HeuristicSegmenter:
    """Weight-free stand-in: segments by region heuristics for smoke tests.

    Modes: "upper"/"lower"/"center" select image bands over the foreground
    (non-background pixels); real deployments plug a SAM-family backend in.
    """

    def __init__(self, mode: str = "upper", bg_threshold: float = 0.95):
        self.mode = mode
        self.bg_threshold = bg_threshold

    def segment(self, image, prompt: str) -> np.ndarray:
        if torch.is_tensor(image):
            image = image.detach().cpu().numpy()
        img = np.asarray(image)
        fg = ~(img > self.bg_threshold).all(-1)
        band = np.zeros_like(fg)
        rows = np.where(fg.any(1))[0]
        if len(rows) == 0:
            return band
        top, bot = rows[0], rows[-1]
        third = (bot - top) // 3
        if self.mode == "upper":
            band[top : top + third + 1] = True
        elif self.mode == "lower":
            band[bot - third : bot + 1] = True
        else:
            band[top + third : bot - third + 1] = True
        return fg & band


@dataclasses.dataclass(frozen=True)
class LocalizationConfig:
    dilate_iters: int = 8
    erode_iters: int = 10
    min_views: int = 2  # a face must be segmented in ≥ this many views
    floater_min_fraction: float = 0.1
    mesh_cfg: MeshRasterConfig = dataclasses.field(
        default_factory=lambda: MeshRasterConfig()
    )


@register("mesh-localization")
class LocalMeshEditing:
    def __init__(
        self,
        verts: np.ndarray,
        faces: np.ndarray,
        segmenter: Segmenter,
        cfg: LocalizationConfig = LocalizationConfig(),
        device=None,
    ):
        self.device = resolve_device(device)
        self.verts = np.asarray(verts, np.float32)
        self.faces = np.asarray(faces, np.int64)
        self.segmenter = segmenter
        self.cfg = cfg

    def localize(
        self,
        cameras: Sequence[GSCamera],
        images: Sequence[np.ndarray],
        prompt: str,
        output_path: Optional[str] = None,
    ) -> dict:
        """Segment each probe view, back-project, refine, export masks.

        Returns dict(editing_mask (V,), editing_mask_faces (F,)).
        """
        votes = np.zeros(len(self.faces), np.int32)
        seen = np.zeros(len(self.faces), np.int32)
        vt = torch.tensor(self.verts, device=self.device)
        ft = torch.tensor(self.faces.astype(np.int32), device=self.device)
        for cam, img in zip(cameras, images):
            mask2d = np.asarray(self.segmenter.segment(img, prompt), bool)
            out = rasterize_mesh(vt, ft, cam.raster_camera(self.device),
                                 self.cfg.mesh_cfg)
            fid = out.face_id.cpu().numpy()
            vis = fid >= 0
            seen[np.unique(fid[vis])] += 1
            votes[np.unique(fid[vis & mask2d])] += 1

        fmask = votes >= np.minimum(self.cfg.min_views, np.maximum(seen, 1))
        fmask = dilate_face_region(self.faces, fmask, self.cfg.dilate_iters)
        fmask = erode_face_region(self.faces, fmask, self.cfg.erode_iters)

        # Floater removal on the selected sub-mesh.
        sel = np.flatnonzero(fmask)
        if len(sel):
            keep_sel = remove_floaters(
                self.verts, self.faces[sel], self.cfg.floater_min_fraction
            )
            fmask = np.zeros_like(fmask)
            fmask[sel[keep_sel]] = True

        vmask = vertex_mask_from_faces(self.faces, fmask, len(self.verts))
        info = {
            "editing_mask": vmask.astype(np.int64),
            "editing_mask_faces": fmask.astype(np.float64),
        }
        if output_path is not None:
            export_editing_region_info(
                output_path, info["editing_mask"], info["editing_mask_faces"]
            )
        return info


def region_info_to_face_mask(info: dict, faces: np.ndarray) -> np.ndarray:
    """editing_region_info → per-face bool mask (consumers read the vertex
    mask and AND over face vertices where no face mask is stored)."""
    if "editing_mask_faces" in info and len(info["editing_mask_faces"]) == len(
        faces
    ):
        return np.asarray(info["editing_mask_faces"]) > 0.5
    return face_mask_from_vertices(faces, info["editing_mask"] > 0, "all")
