"""Mask morphology: image-space (dilate/erode/blur) + mesh-region variants.

Counterpart of `youreditableavatar_tpu/ops/morphology.py`. The image ops
are pooling windows with "SAME" padding: `max_pool2d` pads with −inf and
`avg_pool2d(count_include_pad=True)` with zeros, as the JAX package's
`reduce_window` calls do. The mesh-region ops are vertex/face adjacency
sweeps with the JAX package's results: the adjacency and the vertex masks
in host numpy, the face dilation and erosion as gathers over a bool
tensor, on the device the mask is on.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor


def dilate(mask: Tensor, iterations: int = 1, size: int = 3) -> Tensor:
    """Binary dilation of an (H, W) mask with a size×size square kernel
    (odd `size`)."""
    m = mask.to(torch.float32)[None, None]
    for _ in range(iterations):
        m = F.max_pool2d(m, size, stride=1, padding=size // 2)
    return m[0, 0]


def erode(mask: Tensor, iterations: int = 1, size: int = 3) -> Tensor:
    m = mask.to(torch.float32)
    return 1.0 - dilate(1.0 - m, iterations, size)


def box_blur(img: Tensor, size: int = 5) -> Tensor:
    """(H, W) or (H, W, C) box blur (odd `size`, zero padding)."""
    img = img.to(torch.float32)
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    x = x.permute(2, 0, 1)[None]
    x = F.avg_pool2d(x, size, stride=1, padding=size // 2,
                     count_include_pad=True)
    x = x[0].permute(1, 2, 0)
    return x[..., 0] if squeeze else x


def face_adjacency(faces: np.ndarray) -> np.ndarray:
    """(F, 3) int32: neighbor face id across each edge (−1 boundary)."""
    f = np.asarray(faces)
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    edges_sorted = np.sort(edges, axis=1)
    keys = edges_sorted[:, 0].astype(np.int64) * (1 << 31) + edges_sorted[:, 1]
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    face_of = order % len(f)
    nbr = np.full(len(keys), -1, np.int64)
    same = ks[1:] == ks[:-1]
    i = np.flatnonzero(same)
    nbr[order[i]] = face_of[i + 1]
    nbr[order[i + 1]] = face_of[i]
    return nbr.reshape(3, len(f)).T.astype(np.int32)


def dilate_face_region(faces: np.ndarray, face_mask: torch.Tensor,
                       iterations: int = 1, adjacency=None) -> torch.Tensor:
    """Grow a (F,) bool tensor selection of faces across shared edges
    (pymeshlab dilate), on the mask's device. `adjacency` is the faces'
    `face_adjacency`, an array or a tensor on that device, where the
    caller keeps it."""
    adj = face_adjacency(faces) if adjacency is None else adjacency
    adj = torch.as_tensor(adj, device=face_mask.device).long()
    m = face_mask
    for _ in range(iterations):
        # A boundary edge's −1 reads the appended slot, never selected.
        m = m | torch.cat([m, m.new_zeros(1)])[adj].any(1)
    return m


def erode_face_region(faces: np.ndarray, face_mask: torch.Tensor,
                      iterations: int = 1, adjacency=None) -> torch.Tensor:
    return ~dilate_face_region(faces, ~face_mask, iterations, adjacency)


def vertex_mask_from_faces(
    faces: np.ndarray, face_mask: np.ndarray, num_verts: int
) -> np.ndarray:
    m = np.zeros(num_verts, bool)
    m[np.asarray(faces)[np.asarray(face_mask, bool)].ravel()] = True
    return m


def face_mask_from_vertices(
    faces: np.ndarray, vert_mask: np.ndarray, mode: str = "any"
) -> np.ndarray:
    vm = np.asarray(vert_mask, bool)[np.asarray(faces)]
    return vm.any(1) if mode == "any" else vm.all(1)
