"""Stage 3 — text-prompted 3D region localization.

Counterpart of `youreditableavatar_tpu/stages/localization.py`: render the
probe views' visibility, segment each view with a text-prompted segmenter
(any `Segmenter`; `HeuristicSegmenter` is the weight-free stand-in),
back-project the 2D masks onto the mesh through the rasterizer's
per-pixel face ids, refine the selection with mesh morphology (dilate /
erode), drop floaters, and emit `editing_region_info.npy` (vertex + face
masks).

The visibility pass is `ops/mesh_raster.rasterize_mesh` (its z-buffer
resolve is kernel K5 on the card). The votes (each view's face ids
scattered into a hit mask, where the JAX code takes `np.unique` of them
on the host) and the morphology (over the mesh's face adjacency, built
once) run on the device without waiting for it; the face mask comes to
the host once a call for the floater removal. The results are the JAX
package's.

Spans (`utils/profiling.span`): `localize.call`, the root of one
`localize`, holds per view `localize.segment` (the segmenter) and
`localize.backproject` (the raster and the votes), then
`localize.regions` (morphology, the face mask's download, floaters,
masks). Counters: `localize.views`, and the host ↔ device bytes of the
mesh and the face mask.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from youreditableavatar_tpu_torch.models.cameras import GSCamera
from youreditableavatar_tpu_torch.ops.gaussian_raster.types import (
    RasterCamera)
from youreditableavatar_tpu_torch.ops.mesh_raster import (
    MeshRasterConfig,
    rasterize_mesh,
)
from youreditableavatar_tpu_torch.ops.morphology import (
    dilate_face_region,
    erode_face_region,
    face_adjacency,
    face_mask_from_vertices,
    vertex_mask_from_faces,
)
from youreditableavatar_tpu_torch.stages.export import (
    export_editing_region_info,
    remove_floaters,
)
from youreditableavatar_tpu_torch.utils.device import resolve_device
from youreditableavatar_tpu_torch.utils.profiling import (
    count, span, to_device, to_host)
from youreditableavatar_tpu_torch.utils.registry import register


class Segmenter(Protocol):
    """Text-prompted image segmentation (LangSAM role)."""

    def segment(self, image, prompt: str):
        """(H, W, 3) float image + prompt → (H, W) bool mask, a host array
        or a tensor."""
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
        self.adjacency = torch.as_tensor(face_adjacency(self.faces),
                                         device=self.device).long()

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
        with span("localize.call"):
            votes = torch.zeros(len(self.faces), dtype=torch.int32,
                                device=self.device)
            seen = torch.zeros_like(votes)
            vt = to_device(self.verts, self.device)
            ft = to_device(self.faces.astype(np.int32), self.device)
            # The cameras' uploads each wait for the stream: all at the
            # start, before the views queue their work.
            rcams = [cam.raster_camera(self.device) for cam in cameras]
            for rcam, img in zip(rcams, images):
                count("localize.views")
                with span("localize.segment"):
                    # One upload of the image; the mask, from whichever
                    # side the segmenter made it on, goes to the device,
                    # where the votes are counted.
                    mask2d = torch.as_tensor(
                        self.segmenter.segment(
                            to_device(img, self.device, torch.float32),
                            prompt),
                        device=self.device)
                with span("localize.backproject"):
                    self._backproject(rcam, mask2d, vt, ft, votes, seen)
            with span("localize.regions"):
                return self._regions(votes, seen, output_path)

    def _backproject(self, rcam: RasterCamera, mask2d: torch.Tensor, vt, ft,
                     votes: torch.Tensor, seen: torch.Tensor) -> None:
        """One view's votes, on the device and without waiting for it:
        every face the view shows is seen, every face it shows inside the
        mask is voted for."""
        out = rasterize_mesh(vt, ft, rcam, self.cfg.mesh_cfg)
        # Hits by face id + 1: the background's −1 and the pixels outside
        # the mask land in slot 0.
        ids = out.face_id.reshape(-1).long() + 1
        for counts, pixels in ((seen, ids), (votes, ids * mask2d.reshape(-1))):
            hit = torch.zeros(len(self.faces) + 1, dtype=torch.bool,
                              device=self.device)
            # `index_fill_`, not `hit[pixels] = True`, which uploads the
            # value and waits for the stream.
            counts += hit.index_fill_(0, pixels, True)[1:]

    def _regions(self, votes: torch.Tensor, seen: torch.Tensor,
                 output_path: Optional[str]) -> dict:
        # A face is kept where min(min_views, views that saw it) voted for
        # it; the morphology runs where the votes are.
        fmask = votes >= torch.clamp(seen, min=1, max=self.cfg.min_views)
        fmask = dilate_face_region(self.faces, fmask, self.cfg.dilate_iters,
                                   self.adjacency)
        fmask = to_host(erode_face_region(self.faces, fmask,
                                          self.cfg.erode_iters,
                                          self.adjacency))

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
