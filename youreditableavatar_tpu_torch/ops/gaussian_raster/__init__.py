"""Differentiable 3D Gaussian splatting on Hopper kernels.

Counterpart of `youreditableavatar_tpu/ops/gaussian_raster`: preprocess
(PyTorch), a sort-free counting pair layout (CUDA kernels K2, K3a, K3b) and
tile compositing with an analytic backward (CUDA kernels K1f, K1b). Every
kernel has a plain PyTorch version beside it that CPU tensors take.
"""

from youreditableavatar_tpu_torch.ops.gaussian_raster.budget import (
    BudgetGovernor,
    PairOverflowError,
    count_pairs,
    fit_pair_budget,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
    RasterizeConfig,
    render_gaussians,
    render_gaussians_checked,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster.types import RasterCamera

__all__ = [
    "BudgetGovernor",
    "PairOverflowError",
    "RasterCamera",
    "RasterizeConfig",
    "count_pairs",
    "fit_pair_budget",
    "render_gaussians",
    "render_gaussians_checked",
]
