"""TetGS: 3D Gaussians bound to a (tet-extracted) surface mesh.

Counterpart of `youreditableavatar_tpu/models/tetgs.py`: a frozen binding
(barycentric anchors on mesh faces — 1 Gaussian at the centroid of a
below-mean-area face, 3 at the (2/3, 1/6, 1/6) rotations otherwise —
interpolated normals, face ids, circumcircle radii) and learnable
per-Gaussian parameters (normal offset δ, log-scales, quaternions, raw
opacity, SH). Scale init: log of the distance to the nearest of the 3
nearest Gaussians; identity quaternions; opacity inverse_sigmoid(0.1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor, nn

from youreditableavatar_tpu_torch.ops.gaussian_raster import (
    RasterCamera,
    RasterizeConfig,
    render_gaussians,
)
from youreditableavatar_tpu_torch.ops.knn import knn_squared_distances
from youreditableavatar_tpu_torch.ops.sh import rgb_to_sh_dc
from youreditableavatar_tpu_torch.utils.device import resolve_device
from youreditableavatar_tpu_torch.utils.graphics import (
    circumcircle_radius,
    inverse_sigmoid,
)

BARY_1 = np.array([[1 / 3, 1 / 3, 1 / 3]], np.float32)
BARY_3 = np.array(
    [[2 / 3, 1 / 6, 1 / 6], [1 / 6, 2 / 3, 1 / 6], [1 / 6, 1 / 6, 2 / 3]],
    np.float32,
)
PARAM_NAMES = ("delta", "log_scales", "quats", "opacity_raw", "sh_dc", "sh_rest")
BINDING_NAMES = ("ori_points", "normals", "face_indices", "radii",
                 "mesh_verts", "mesh_faces")

Device = Optional[Union[str, torch.device]]


class TetGSParams(nn.Module):
    """Learnable per-Gaussian parameters, one `nn.Parameter` per leaf:
    delta (N, 1), log_scales (N, 3), quats (N, 4) wxyz, opacity_raw (N, 1),
    sh_dc (N, 1, 3), sh_rest (N, K−1, 3)."""

    def __init__(self, delta: Tensor, log_scales: Tensor, quats: Tensor,
                 opacity_raw: Tensor, sh_dc: Tensor, sh_rest: Tensor):
        super().__init__()
        self.delta = nn.Parameter(delta)
        self.log_scales = nn.Parameter(log_scales)
        self.quats = nn.Parameter(quats)
        self.opacity_raw = nn.Parameter(opacity_raw)
        self.sh_dc = nn.Parameter(sh_dc)
        self.sh_rest = nn.Parameter(sh_rest)


@dataclasses.dataclass(frozen=True)
class TetGSBinding:
    """Frozen mesh binding (device constants)."""

    ori_points: Tensor  # (N, 3) barycentric anchor positions
    normals: Tensor  # (N, 3) interpolated unit normals
    face_indices: Tensor  # (N,) int32 face id per gaussian
    radii: Tensor  # (N,) circumcircle radius of the parent face
    mesh_verts: Tensor  # (V, 3)
    mesh_faces: Tensor  # (F, 3) int32
    face_to_global_tet_idx: Optional[Tensor]  # (F,) int32 or None
    sh_levels: int

    @property
    def n_gaussians(self) -> int:
        return self.ori_points.shape[0]


def params_from_numpy(d: Mapping[str, np.ndarray], device: Device = None) -> TetGSParams:
    """TetGSParams from numpy leaves named as the JAX `TetGSParams`."""
    dev = resolve_device(device)
    return TetGSParams(**{
        name: torch.tensor(np.asarray(d[name], np.float32), device=dev)
        for name in PARAM_NAMES
    })


def binding_from_numpy(d: Mapping[str, np.ndarray],
                       device: Device = None) -> TetGSBinding:
    """TetGSBinding from numpy arrays named as the JAX `TetGSBinding`
    fields, `sh_levels` included (`face_to_global_tet_idx` may be missing,
    None or empty)."""
    dev = resolve_device(device)
    f2t = d.get("face_to_global_tet_idx")
    f2t = None if f2t is None or np.asarray(f2t).size == 0 else f2t

    def t(x, dtype):
        return torch.as_tensor(np.asarray(x).astype(dtype), device=dev)

    return TetGSBinding(
        ori_points=t(d["ori_points"], np.float32),
        normals=t(d["normals"], np.float32),
        face_indices=t(d["face_indices"], np.int32),
        radii=t(d["radii"], np.float32),
        mesh_verts=t(d["mesh_verts"], np.float32),
        mesh_faces=t(d["mesh_faces"], np.int32),
        face_to_global_tet_idx=None if f2t is None else t(f2t, np.int32),
        sh_levels=int(d["sh_levels"]),
    )


def _vertex_normals_np(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(p1 - p0, p2 - p0)
    vn = np.zeros_like(verts)
    np.add.at(vn, faces[:, 0], fn)
    np.add.at(vn, faces[:, 1], fn)
    np.add.at(vn, faces[:, 2], fn)
    return vn / np.maximum(np.linalg.norm(vn, axis=-1, keepdims=True), 1e-12)


def build_tetgs(
    mesh_verts: np.ndarray,
    mesh_faces: np.ndarray,
    vertex_colors: Optional[np.ndarray] = None,
    face_to_global_tet_idx: Optional[np.ndarray] = None,
    sh_levels: int = 4,
    opacity_init: float = 0.1,
    device: Device = None,
) -> Tuple[TetGSBinding, TetGSParams]:
    """Bind Gaussians to a surface mesh (host-side binding, device knn)."""
    dev = resolve_device(device)
    verts = np.asarray(mesh_verts, np.float32)
    faces = np.asarray(mesh_faces, np.int64)
    if vertex_colors is None:
        vertex_colors = np.full((len(verts), 3), 0.5, np.float32)
    vertex_colors = np.clip(np.asarray(vertex_colors, np.float32), 0, 1)

    p0, p1, p2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    three = area >= area.mean()  # big faces get 3 gaussians
    vnormals = _vertex_normals_np(verts, faces)

    def bary_attr(attr_per_vertex: np.ndarray) -> np.ndarray:
        fa = attr_per_vertex[faces]  # (F, 3, C)
        one = np.einsum("gk,fkc->fgc", BARY_1, fa)
        trip = np.einsum("gk,fkc->fgc", BARY_3, fa)
        return np.concatenate(
            [one[~three].reshape(-1, fa.shape[-1]),
             trip[three].reshape(-1, fa.shape[-1])]
        )

    face_ids = np.concatenate(
        [np.flatnonzero(~three), np.repeat(np.flatnonzero(three), 3)]
    ).astype(np.int32)
    ori = bary_attr(verts)
    nrm = bary_attr(vnormals)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    colors = bary_attr(vertex_colors)
    n = len(ori)

    ori_t = torch.as_tensor(ori, device=dev)
    d2 = knn_squared_distances(ori_t, k=3)
    r = torch.clamp(torch.sqrt(d2).min(dim=-1).values, min=1e-7)
    log_scales = torch.log(r)[:, None].repeat(1, 3)

    corners = [torch.as_tensor(verts[faces[:, i]], device=dev) for i in range(3)]
    face_radii = circumcircle_radius(*corners)
    face_ids_t = torch.as_tensor(face_ids, device=dev)

    binding = TetGSBinding(
        ori_points=ori_t,
        normals=torch.as_tensor(nrm, device=dev),
        face_indices=face_ids_t,
        radii=face_radii[face_ids_t.long()],
        mesh_verts=torch.as_tensor(verts, device=dev),
        mesh_faces=torch.as_tensor(faces.astype(np.int32), device=dev),
        face_to_global_tet_idx=(
            None if face_to_global_tet_idx is None
            else torch.as_tensor(np.asarray(face_to_global_tet_idx, np.int32),
                                 device=dev)
        ),
        sh_levels=sh_levels,
    )
    op_raw = float(inverse_sigmoid(torch.tensor(opacity_init, dtype=torch.float32)))
    params = TetGSParams(
        delta=torch.zeros((n, 1), device=dev),
        log_scales=log_scales,
        quats=torch.tensor([[1.0, 0, 0, 0]], device=dev).repeat(n, 1),
        opacity_raw=torch.full((n, 1), op_raw, device=dev),
        sh_dc=rgb_to_sh_dc(torch.as_tensor(colors, device=dev))[:, None, :],
        sh_rest=torch.zeros((n, sh_levels**2 - 1, 3), device=dev),
    )
    return binding, params


def gaussian_arrays(binding: TetGSBinding, params: TetGSParams):
    """(means3d, scales, quats, opacities, sh) — differentiable."""
    means = binding.ori_points + binding.normals * params.delta
    scales = torch.exp(params.log_scales)
    opac = torch.sigmoid(params.opacity_raw)[:, 0]
    sh = torch.cat([params.sh_dc, params.sh_rest], dim=1)
    return means, scales, params.quats, opac, sh


def render_tetgs(binding: TetGSBinding, params: TetGSParams,
                 camera: RasterCamera, cfg: RasterizeConfig,
                 bg: Optional[Tensor] = None,
                 sh_degree: Optional[int] = None) -> Dict[str, Tensor]:
    """Render the bound Gaussians."""
    means, scales, quats, opac, sh = gaussian_arrays(binding, params)
    if sh_degree is not None and sh_degree != cfg.sh_degree:
        cfg = dataclasses.replace(cfg, sh_degree=sh_degree)
    return render_gaussians(means, scales, quats, opac, sh, camera, cfg, bg)


def scaling_regularizer(binding: TetGSBinding, params: TetGSParams,
                        ratio_thresh: float = 10.0,
                        radius_mult: float = 1.0) -> Tensor:
    """Mean of the max-scales that exceed the face circumcircle and are
    highly anisotropic (0 if none)."""
    scales = torch.exp(params.log_scales)
    max_v = torch.max(scales, dim=-1).values
    min_v = torch.min(scales, dim=-1).values
    ratio = max_v / torch.clamp(min_v, min=1e-12)
    bad = (max_v > binding.radii * radius_mult) & (ratio > ratio_thresh)
    count = torch.sum(bad)
    return torch.sum(torch.where(bad, max_v, torch.zeros_like(max_v))) / \
        torch.clamp(count, min=1)


def extract_keep_gaussians(
    binding: TetGSBinding,
    params: TetGSParams,
    edit_face_to_global_tet_idx: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Frozen "keep" Gaussians whose parent face maps into the given tet
    set, as host arrays. Runs once between pipeline stages."""
    if binding.face_to_global_tet_idx is None:
        raise ValueError("binding has no face_to_global_tet_idx")

    def host(x):
        return x.detach().cpu().numpy()

    f2t = host(binding.face_to_global_tet_idx)
    face_mask = np.isin(f2t, np.asarray(edit_face_to_global_tet_idx))
    keep_faces = np.flatnonzero(face_mask)
    face_indices = host(binding.face_indices)
    idx = np.flatnonzero(np.isin(face_indices, keep_faces))

    means, _, quats, _, _ = gaussian_arrays(binding, params)
    return {
        "xyz": host(means)[idx],
        "opacity_raw": host(params.opacity_raw)[idx],
        "log_scales": host(params.log_scales)[idx],
        "quats": host(quats)[idx],
        "sh_dc": host(params.sh_dc)[idx],
        "sh_rest": host(params.sh_rest)[idx],
        "face_indices": face_indices[idx],
        "sh_levels": binding.sh_levels,
    }


def save_tetgs(path: str, binding: TetGSBinding, params: TetGSParams,
               **extra) -> None:
    """Checkpoint to npz, with the same keys as the JAX `save_tetgs`."""
    def host(x):
        return x.detach().cpu().numpy()

    np.savez(
        path,
        **{name: host(getattr(binding, name)) for name in BINDING_NAMES},
        face_to_global_tet_idx=(
            host(binding.face_to_global_tet_idx)
            if binding.face_to_global_tet_idx is not None else np.zeros(0)
        ),
        sh_levels=binding.sh_levels,
        **{name: host(getattr(params, name)) for name in PARAM_NAMES},
        **extra,
    )


def load_tetgs(path: str, device: Device = None
               ) -> Tuple[TetGSBinding, TetGSParams, Dict]:
    """Load an npz written by `save_tetgs` (this package's or the JAX one)."""
    z = np.load(path, allow_pickle=False)
    binding = binding_from_numpy(z, device=device)
    params = params_from_numpy(z, device=device)
    known = set(BINDING_NAMES) | set(PARAM_NAMES) | {
        "face_to_global_tet_idx", "sh_levels"}
    extras = {k: z[k] for k in z.files if k not in known}
    return binding, params, extras
