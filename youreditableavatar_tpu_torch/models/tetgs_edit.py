"""Edit-region Gaussian models: 2D inpainting disks + 3D refinement.

Counterpart of `youreditableavatar_tpu/models/tetgs_edit.py`:

  * keep Gaussians (extracted from the stage-2 TetGS by tet-id intersection)
    are FROZEN — they live in the binding, not in the learnable params;
  * 2D stage: edit Gaussians are flat disks on the edit-mesh faces —
    quaternion from the face frame (normal, v1, v2 columns), scales
    (ε, d, d) with d = min distance from the anchor point to the face's
    vertices, SH from seed colors; positions fixed at the barycentric
    anchors;
  * 3D stage: edit positions re-parameterized as scalar offsets along the
    interpolated edit-mesh normals, with scales/quats/SH warm-started from
    the finished 2D stage;
  * per-part rendering: keep ∥ edit concatenated for the rasterizer, with
    optional per-part color override and rollback of edit params outside a
    face set.

`EditParams` is an `nn.Module` of `nn.Parameter`s; functions that return
"new" parameters (`promote_to_3d`, `rollback_outside_faces`) build a new
module and leave their inputs untouched, as the JAX functions do.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from youreditableavatar_tpu_torch.models.tetgs import (
    BARY_1,
    BARY_3,
    PARAM_NAMES,
    Device,
    _vertex_normals_np,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster import (
    RasterCamera,
    RasterizeConfig,
    render_gaussians,
)
from youreditableavatar_tpu_torch.ops.quaternion import matrix_to_quat
from youreditableavatar_tpu_torch.ops.sh import rgb_to_sh_dc
from youreditableavatar_tpu_torch.utils.device import resolve_device
from youreditableavatar_tpu_torch.utils.graphics import inverse_sigmoid

EDIT_BINDING_F32 = ("edit_ori", "edit_normals", "edit_mesh_verts", "keep_xyz",
                    "keep_log_scales", "keep_quats", "keep_opacity_raw",
                    "keep_sh_dc", "keep_sh_rest")
EDIT_BINDING_I32 = ("edit_face_indices", "edit_mesh_faces")


class EditParams(nn.Module):
    """Learnable edit-part parameters (the keep part is frozen in the
    binding): delta (Ne, 1), log_scales (Ne, 3), quats (Ne, 4), opacity_raw
    (Ne, 1), sh_dc (Ne, 1, 3), sh_rest (Ne, K−1, 3).

    `delta` is used by the 3D stage only (2D disks have fixed positions);
    it is always present so one optimizer covers both stages.
    """

    def __init__(self, delta: Tensor, log_scales: Tensor, quats: Tensor,
                 opacity_raw: Tensor, sh_dc: Tensor, sh_rest: Tensor):
        super().__init__()
        self.delta = nn.Parameter(delta)
        self.log_scales = nn.Parameter(log_scales)
        self.quats = nn.Parameter(quats)
        self.opacity_raw = nn.Parameter(opacity_raw)
        self.sh_dc = nn.Parameter(sh_dc)
        self.sh_rest = nn.Parameter(sh_rest)

    def copy(self) -> "EditParams":
        """A new module holding detached copies of every leaf."""
        return EditParams(**{name: getattr(self, name).detach().clone()
                             for name in PARAM_NAMES})


@dataclasses.dataclass(frozen=True)
class EditBinding:
    # Edit part anchors
    edit_ori: Tensor  # (Ne, 3)
    edit_normals: Tensor  # (Ne, 3)
    edit_face_indices: Tensor  # (Ne,) int32 into edit-mesh faces
    edit_mesh_verts: Tensor
    edit_mesh_faces: Tensor  # (F, 3) int32
    # Frozen keep Gaussians
    keep_xyz: Tensor
    keep_log_scales: Tensor
    keep_quats: Tensor
    keep_opacity_raw: Tensor
    keep_sh_dc: Tensor
    keep_sh_rest: Tensor
    sh_levels: int
    use_delta: bool  # False = 2D disks (fixed positions), True = 3D refine

    @property
    def n_edit(self) -> int:
        return self.edit_ori.shape[0]

    @property
    def n_keep(self) -> int:
        return self.keep_xyz.shape[0]


def edit_params_from_numpy(d: Mapping[str, np.ndarray],
                           device: Device = None) -> EditParams:
    """EditParams from numpy leaves named as the JAX `EditParams`."""
    dev = resolve_device(device)
    return EditParams(**{
        name: torch.tensor(np.asarray(d[name], np.float32), device=dev)
        for name in PARAM_NAMES
    })


def edit_binding_from_numpy(d: Mapping[str, np.ndarray],
                            device: Device = None) -> EditBinding:
    """EditBinding from numpy arrays named as the JAX `EditBinding` fields,
    `sh_levels` and `use_delta` included."""
    dev = resolve_device(device)
    fields = {k: torch.as_tensor(np.asarray(d[k]).astype(np.float32), device=dev)
              for k in EDIT_BINDING_F32}
    fields.update({k: torch.as_tensor(np.asarray(d[k]).astype(np.int32),
                                      device=dev) for k in EDIT_BINDING_I32})
    return EditBinding(**fields, sh_levels=int(d["sh_levels"]),
                       use_delta=bool(d["use_delta"]))


def _bary_points(
    verts: np.ndarray, faces: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Barycentric anchors + face ids: 1 Gaussian at the centroid of a
    below-mean-area face, the 3-point set otherwise (TetGS's area rule)."""
    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    three = area >= area.mean()
    fa = verts[faces]  # (F, 3, 3)
    one = np.einsum("gk,fkc->fgc", BARY_1, fa)
    trip = np.einsum("gk,fkc->fgc", BARY_3, fa)
    pts = np.concatenate(
        [one[~three].reshape(-1, 3), trip[three].reshape(-1, 3)]
    )
    face_ids = np.concatenate(
        [np.flatnonzero(~three), np.repeat(np.flatnonzero(three), 3)]
    ).astype(np.int32)
    return pts.astype(np.float32), face_ids


def build_edit_tetgs(
    edit_mesh_verts: np.ndarray,
    edit_mesh_faces: np.ndarray,
    keep_gaussians: Dict[str, np.ndarray],
    edit_colors: Optional[np.ndarray] = None,
    sh_levels: int = 1,
    opacity_init: float = 0.9999,
    device: Device = None,
) -> Tuple[EditBinding, EditParams]:
    """2D-disk edit model over the edit mesh + frozen keep Gaussians.

    `keep_gaussians` is the dict from `models.tetgs.extract_keep_gaussians`.
    """
    dev = resolve_device(device)
    verts = np.asarray(edit_mesh_verts, np.float32)
    faces = np.asarray(edit_mesh_faces, np.int64)
    pts, face_ids = _bary_points(verts, faces)
    ne = len(pts)

    tri = verts[faces[face_ids]]  # (Ne, 3, 3)
    eps = 1e-8
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    v0 = n / (np.linalg.norm(n, axis=-1, keepdims=True) + eps)
    v1 = tri[:, 1] - tri[:, 0]
    v1 = v1 / (np.linalg.norm(v1, axis=-1, keepdims=True) + eps)
    v2 = np.cross(v0, v1)
    v2 = v2 / (np.linalg.norm(v2, axis=-1, keepdims=True) + eps)
    rot = np.stack([v0, v1, v2], axis=-1)  # columns = frame
    quats = matrix_to_quat(torch.as_tensor(rot, dtype=torch.float32))

    # Disk radius: min distance from the anchor to the face's vertices.
    d = np.minimum(
        np.minimum(
            np.linalg.norm(pts - tri[:, 0], axis=-1),
            np.linalg.norm(pts - tri[:, 1], axis=-1),
        ),
        np.linalg.norm(pts - tri[:, 2], axis=-1),
    )
    d = np.maximum(d, 1e-7)
    scales = np.stack([np.full(ne, 1e-8, np.float32), d, d], axis=-1)

    if edit_colors is None:
        edit_colors = np.full((ne, 3), 0.5, np.float32)
    elif edit_colors.shape[0] == len(verts):
        # Per-vertex colors → per-gaussian via face mean.
        edit_colors = verts_colors_to_points(
            edit_colors, faces, face_ids, pts, verts
        )

    vn = _vertex_normals_np(verts, faces)
    fnorm = vn[faces[face_ids]].mean(1)
    fnorm /= np.maximum(np.linalg.norm(fnorm, axis=-1, keepdims=True), 1e-12)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    binding = EditBinding(
        edit_ori=f32(pts),
        edit_normals=f32(fnorm),
        edit_face_indices=torch.as_tensor(face_ids, device=dev),
        edit_mesh_verts=f32(verts),
        edit_mesh_faces=torch.as_tensor(faces.astype(np.int32), device=dev),
        keep_xyz=f32(keep_gaussians["xyz"]),
        keep_log_scales=f32(keep_gaussians["log_scales"]),
        keep_quats=f32(keep_gaussians["quats"]),
        keep_opacity_raw=f32(keep_gaussians["opacity_raw"]),
        keep_sh_dc=f32(keep_gaussians["sh_dc"]),
        keep_sh_rest=f32(keep_gaussians["sh_rest"]),
        sh_levels=sh_levels,
        use_delta=False,
    )
    op_raw = float(inverse_sigmoid(torch.tensor(opacity_init,
                                                dtype=torch.float32)))
    params = EditParams(
        delta=torch.zeros((ne, 1), device=dev),
        log_scales=f32(np.log(scales)),
        quats=quats.to(dev),
        opacity_raw=torch.full((ne, 1), op_raw, device=dev),
        sh_dc=rgb_to_sh_dc(f32(np.clip(edit_colors, 0, 1)))[:, None, :],
        sh_rest=torch.zeros((ne, max(sh_levels**2 - 1, 0), 3), device=dev),
    )
    return binding, params


def verts_colors_to_points(vcolors, faces, face_ids, pts, verts):
    fc = vcolors[faces[face_ids]].mean(1)
    return fc.astype(np.float32)


def promote_to_3d(
    binding: EditBinding,
    params: EditParams,
    sh_levels: int = 4,
) -> Tuple[EditBinding, EditParams]:
    """2D inpainted disks → 3D refine model: positions become normal-offset
    deltas from the (unchanged) anchors, scales/quats/SH warm-start from
    the 2D stage, the SH budget grows."""
    ne = binding.n_edit
    old_k = params.sh_rest.shape[1]
    new_k = sh_levels**2 - 1
    sh_rest = torch.zeros((ne, new_k, 3), device=params.sh_rest.device)
    if old_k > 0:
        sh_rest[:, :old_k] = params.sh_rest.detach()
    binding3 = dataclasses.replace(
        binding, use_delta=True, sh_levels=sh_levels
    )
    params3 = EditParams(
        delta=torch.zeros((ne, 1), device=params.delta.device),
        log_scales=params.log_scales.detach().clone(),
        quats=params.quats.detach().clone(),
        opacity_raw=params.opacity_raw.detach().clone(),
        sh_dc=params.sh_dc.detach().clone(),
        sh_rest=sh_rest,
    )
    return binding3, params3


def edit_gaussian_arrays(
    binding: EditBinding, params: EditParams
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Edit-part (means, scales, quats, opac, sh)."""
    if binding.use_delta:
        means = binding.edit_ori + binding.edit_normals * params.delta
    else:
        means = binding.edit_ori
    scales = torch.exp(params.log_scales)
    opac = torch.sigmoid(params.opacity_raw)[:, 0]
    k = binding.sh_levels**2
    sh = torch.cat([params.sh_dc, params.sh_rest[:, : k - 1]], dim=1)
    return means, scales, params.quats, opac, sh


def full_gaussian_arrays(
    binding: EditBinding,
    params: EditParams,
    keep_color_override: Optional[Tensor] = None,
    edit_color_override: Optional[Tensor] = None,
):
    """keep ∥ edit concatenated arrays for the rasterizer.

    Pass (3,) colors to paint each part flat (the per-part color renders
    used for the edit/keep blend masks); they come back as a
    colors_override array, zeros for a part without an override.
    """
    em, es, eq, eo, esh = edit_gaussian_arrays(binding, params)
    dev = em.device
    km = binding.keep_xyz
    ks = torch.exp(binding.keep_log_scales)
    kq = binding.keep_quats
    ko = torch.sigmoid(binding.keep_opacity_raw)[:, 0]
    kk = binding.sh_levels**2
    ksh_rest = binding.keep_sh_rest[:, : kk - 1]
    if ksh_rest.shape[1] < kk - 1:
        pad = torch.zeros((binding.n_keep, kk - 1 - ksh_rest.shape[1], 3),
                          device=dev)
        ksh_rest = torch.cat([ksh_rest, pad], dim=1)
    ksh = torch.cat([binding.keep_sh_dc, ksh_rest], dim=1)

    means = torch.cat([km, em])
    scales = torch.cat([ks, es])
    quats = torch.cat([kq, eq])
    opac = torch.cat([ko, eo])
    sh = torch.cat([ksh, esh])

    colors_override = None
    if keep_color_override is not None or edit_color_override is not None:
        def flat(color, n):
            if color is None:
                return torch.zeros((n, 3), device=dev)
            return torch.as_tensor(color, dtype=torch.float32,
                                   device=dev).expand(n, 3)

        colors_override = torch.cat([flat(keep_color_override, binding.n_keep),
                                     flat(edit_color_override, binding.n_edit)])
    return means, scales, quats, opac, sh, colors_override


def render_edit_tetgs(
    binding: EditBinding,
    params: EditParams,
    camera: RasterCamera,
    cfg: RasterizeConfig,
    bg: Optional[Tensor] = None,
    keep_color_override: Optional[Tensor] = None,
    edit_color_override: Optional[Tensor] = None,
) -> Dict[str, Tensor]:
    means, scales, quats, opac, sh, colors = full_gaussian_arrays(
        binding, params, keep_color_override, edit_color_override
    )
    cfg = dataclasses.replace(cfg, sh_degree=binding.sh_levels - 1)
    return render_gaussians(
        means, scales, quats, opac, sh, camera, cfg, bg,
        colors_override=colors,
    )


def rollback_outside_faces(
    binding: EditBinding,
    params: EditParams,
    prev_params: EditParams,
    painted_faces: Tensor,
) -> EditParams:
    """Revert edit Gaussians whose face is NOT painted: parameters outside
    the painted set return to their pre-fit values.

    Args:
      painted_faces: (F,) bool over edit-mesh faces.
    """
    keep_new = painted_faces[binding.edit_face_indices.long()]  # (Ne,)

    def mix(name):
        new = getattr(params, name).detach()
        old = getattr(prev_params, name).detach()
        mask = keep_new.reshape((-1,) + (1,) * (new.dim() - 1))
        return torch.where(mask, new, old)

    return EditParams(**{name: mix(name) for name in PARAM_NAMES})
