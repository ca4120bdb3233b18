"""Shared inputs for the PyTorch-port parity tests (`test_torch_*.py`).

Inputs are made with numpy from fixed seeds and handed to both the JAX
package and the port, which runs on the CPU through its plain versions.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


def random_scene(seed=42, n=300, width=96, height=64, scale_hi=0.08):
    """The 300-Gaussian 96×64 scene of test_raster_pallas.py (numpy)."""
    rng = np.random.default_rng(seed)
    scene = dict(
        means=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        scales=rng.uniform(0.01, scale_hi, (n, 3)).astype(np.float32),
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opac=rng.uniform(0.2, 0.95, n).astype(np.float32),
        colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        bg=np.array([0.1, 0.2, 0.3], np.float32),
    )
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 3.0
    return scene, vm, width, height


def jax_camera(vm, fovx, fovy, width, height):
    from youreditableavatar_tpu.ops.gaussian_raster import RasterCamera

    return RasterCamera.from_fov(vm, fovx, fovy, width, height)


def torch_camera(vm, fovx, fovy, width, height):
    from youreditableavatar_tpu_torch.ops.gaussian_raster import RasterCamera

    return RasterCamera.from_fov(vm, fovx, fovy, width, height, device="cpu")


def to_torch_proj(proj):
    """A JAX GaussiansProjected as the port's (CPU tensors)."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster.types import (
        GaussiansProjected,
    )

    return GaussiansProjected(*(torch.tensor(np.asarray(x)) for x in proj))


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
