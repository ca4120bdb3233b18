"""K-nearest-neighbor distances: exact, brute force, in query tiles.

Counterpart of `youreditableavatar_tpu/ops/knn.py` (the 3DGS scale
initialiser): ‖q − p‖² = ‖q‖² + ‖p‖² − 2 q·p through one matrix product
per query tile, self excluded, then the k smallest.
"""

from __future__ import annotations

import torch
from torch import Tensor


def knn_squared_distances(points: Tensor, k: int = 3, tile: int = 2048) -> Tensor:
    """(N, k) ascending squared distances to each point's k nearest
    neighbours (self excluded)."""
    n = points.shape[0]
    sq = torch.sum(points * points, dim=-1)
    out = torch.empty((n, k), dtype=points.dtype, device=points.device)
    cols = torch.arange(n, device=points.device)
    for i0 in range(0, n, tile):
        q = points[i0:i0 + tile]
        qsq = torch.sum(q * q, dim=-1)
        d2 = torch.clamp(qsq[:, None] + sq[None, :] - 2.0 * (q @ points.T),
                         min=0.0)
        qidx = torch.arange(i0, i0 + q.shape[0], device=points.device)
        d2 = torch.where(qidx[:, None] == cols[None, :],
                         torch.full_like(d2, float("inf")), d2)
        out[i0:i0 + tile] = torch.topk(d2, k, dim=1, largest=False).values
    return out


def mean_knn_sq_distance(points: Tensor, k: int = 3) -> Tensor:
    """Mean squared distance to the k nearest neighbours."""
    return torch.mean(knn_squared_distances(points, k=k), dim=-1)
