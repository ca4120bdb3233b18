"""Differentiable triangle rasterization.

Counterpart of `youreditableavatar_tpu/ops/mesh_raster`. Split of labour:
  * visibility — the per-pixel z-buffer resolve over tile-binned faces — is
    the hand-written CUDA kernel `csrc/mesh_resolve.cu` (its plain PyTorch
    version on CPU tensors) and is *not* differentiated;
  * everything differentiable (barycentric recompute, perspective-correct
    attribute interpolation, soft silhouette alpha) is plain PyTorch
    afterwards, indexed by the frozen face ids, so autograd gives exact
    gradients to vertex positions and attributes.
"""

from youreditableavatar_tpu_torch.ops.mesh_raster.raster import (
    MeshRasterConfig,
    rasterize_mesh,
)
from youreditableavatar_tpu_torch.ops.mesh_raster.interpolate import (
    compute_vertex_normals,
    interpolate_attributes,
)

__all__ = [
    "MeshRasterConfig",
    "rasterize_mesh",
    "interpolate_attributes",
    "compute_vertex_normals",
]
