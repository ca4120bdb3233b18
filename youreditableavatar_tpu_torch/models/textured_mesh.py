"""Mask/normal projection model for progressive inpainting.

Counterpart of `youreditableavatar_tpu/models/textured_mesh.py`: renders
the editable-vertex mask and normals from a camera, applies the view-angle
cull (faces seen at grazing angles don't count as painted), the
erode/dilate/blur mask algebra for inpainting inputs, and the mask
back-projection that marks newly painted vertices.

Back-projection uses the mesh rasterizer's face ids (pixels → visible faces
→ vertices); the painted set and the face-region morphology are host numpy
on purpose (integer bookkeeping between fits), at one device→host copy of
the face-id image per view.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import Tensor

from youreditableavatar_tpu_torch.ops.gaussian_raster.types import RasterCamera
from youreditableavatar_tpu_torch.ops.mesh_raster import (
    MeshRasterConfig,
    compute_vertex_normals,
    interpolate_attributes,
    rasterize_mesh,
)
from youreditableavatar_tpu_torch.ops.morphology import (
    box_blur,
    dilate,
    dilate_face_region,
    erode,
    erode_face_region,
    vertex_mask_from_faces,
)
from youreditableavatar_tpu_torch.utils.device import resolve_device


class TexturedMeshModel:
    def __init__(
        self,
        verts: np.ndarray,
        faces: np.ndarray,
        editable_verts_mask: np.ndarray,
        mesh_cfg: MeshRasterConfig = MeshRasterConfig(),
        view_angle_thresh_deg: float = 70.0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.verts = torch.as_tensor(np.asarray(verts, np.float32),
                                     device=self.device)
        self.faces_np = np.asarray(faces)
        self.faces = torch.as_tensor(self.faces_np.astype(np.int32),
                                     device=self.device)
        self.editable = np.asarray(editable_verts_mask, bool)
        self.painted = np.zeros_like(self.editable)  # grows view by view
        self.mesh_cfg = mesh_cfg
        self.angle_thresh = view_angle_thresh_deg

    def _vertex_attr(self, mask: np.ndarray) -> Tensor:
        return torch.as_tensor(mask.astype(np.float32),
                               device=self.device)[:, None]

    # ---- per-view rendering ------------------------------------------------

    @torch.no_grad()
    def render_view(self, camera: RasterCamera) -> Dict[str, Tensor]:
        """Raster masks + camera-space normals for one camera."""
        out = rasterize_mesh(self.verts, self.faces, camera, self.mesh_cfg)
        vn = compute_vertex_normals(self.verts, self.faces)
        r = camera.viewmat[:3, :3]
        vn_cam = vn @ r.T
        normal_img = interpolate_attributes(
            out, self.faces, vn_cam, background=0.0, perspective=False
        )
        # View-angle cull: pixels whose surface faces away beyond the
        # threshold never count as painted.
        cos_view = -normal_img[..., 2]  # camera looks down +z
        good_angle = cos_view > np.cos(np.deg2rad(self.angle_thresh))

        editable_img = interpolate_attributes(
            out, self.faces, self._vertex_attr(self.editable), background=0.0,
        )[..., 0]
        painted_img = interpolate_attributes(
            out, self.faces, self._vertex_attr(self.painted), background=0.0,
        )[..., 0]
        mask_cov = out.face_id >= 0
        return {
            "face_id": out.face_id,
            "mask": mask_cov,
            "normal": normal_img,
            "comp_normal": torch.where(
                mask_cov[..., None], normal_img * 0.5 + 0.5,
                torch.ones_like(normal_img),
            ),
            "good_angle": good_angle & mask_cov,
            "editable": editable_img,
            "painted": painted_img,
        }

    def prepare_inpaint_masks(
        self, view: Dict[str, Tensor], blur_size: int = 5
    ) -> Dict[str, Tensor]:
        """Mask algebra for the inpainting input: inpaint = editable ∧
        not-yet-painted, eroded then dilated, and a blurred soft copy; keep
        = complement over coverage."""
        editable = (view["editable"] > 0.5) & view["mask"]
        todo = editable & ~(view["painted"] > 0.5)
        m = erode(todo, 1)
        m = dilate(m, 2)
        soft = box_blur(m, blur_size)
        return {
            "inpaint_mask": m,
            "inpaint_mask_soft": torch.clamp(soft, 0, 1),
            "keep_mask": view["mask"] & ~(m > 0.5),
        }

    # ---- back-projection ---------------------------------------------------

    def back_project(
        self,
        view: Dict[str, Tensor],
        painted_pixels,
        dilate_iters: int = 2,
        erode_iters: int = 3,
    ) -> np.ndarray:
        """Mark vertices under painted pixels as painted.

        Uses the rasterizer's face ids (pixels → faces), refines the face
        region with mesh dilate/erode, intersects with the editable region,
        and folds into the persistent painted set. Returns the face mask of
        NEWLY painted faces.
        """
        def host(x):
            return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

        fid = host(view["face_id"])
        ok = host(painted_pixels) & host(view["good_angle"])
        hit = np.unique(fid[ok & (fid >= 0)])
        fmask = np.zeros(len(self.faces_np), bool)
        fmask[hit] = True
        hit_mask = fmask.copy()
        fmask = dilate_face_region(self.faces_np, torch.as_tensor(fmask),
                                   dilate_iters)
        fmask = erode_face_region(self.faces_np, fmask, erode_iters).numpy()
        fmask = fmask | hit_mask
        vmask = vertex_mask_from_faces(self.faces_np, fmask, len(self.verts))
        vmask = vmask & self.editable
        self.painted = self.painted | vmask
        return fmask

    # ---- blend masks -------------------------------------------------------

    def concat_blend_masks(
        self, camera: RasterCamera, blur_size: int = 9
    ) -> Dict[str, Tensor]:
        """Per-pixel edit/keep blend masks for `prepare_refine_guidance`."""
        view = self.render_view(camera)
        edit = (view["editable"] > 0.5) & view["mask"]
        soft = torch.clamp(box_blur(edit, blur_size), 0, 1)
        return {
            "edit_mask": edit,
            "edit_mask_soft": soft,
            "keep_mask_soft": torch.where(view["mask"], 1.0 - soft,
                                          torch.zeros_like(soft)),
            "coverage": view["mask"],
        }
