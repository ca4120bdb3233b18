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


@pytest.fixture(autouse=True, scope="module")
def single_threaded_torch():
    """Run a test module's CPU tensor work on one thread (import this name
    into the module). The plain versions issue thousands of tiny ops; with
    several test workers on one machine, intra-op thread pools fighting
    over the cores slow them several-fold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where the machine has none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def look_at_viewmat(dist=3.0):
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = dist
    return vm


def sphere_cap_scene(res=10, radius=0.35):
    """The sphere-cap edit scene of test_texture.py as numpy arrays: a
    marching-tets sphere, its faces' tet ids, the faces outside the cap
    z > 0.1 (the keep part) and the cap re-indexed as the edit mesh."""
    import jax.numpy as jnp

    from youreditableavatar_tpu.ops.marching_tets import (
        make_tet_grid, marching_tets,
    )

    gv, gt = make_tet_grid(res)
    pos = jnp.asarray(gv)
    sdf = jnp.linalg.norm(pos, axis=-1) - radius
    mt = marching_tets(pos, sdf, jnp.asarray(gt), 2048, 4096)
    nv, nf = int(mt.num_verts), int(mt.num_faces)
    verts = np.asarray(mt.verts)[:nv]
    valid = np.asarray(mt.faces_valid)
    faces = np.asarray(mt.faces)[valid][:nf]
    f2t = np.asarray(mt.face_to_tet)[valid][:nf]
    fc = verts[faces].mean(1)
    sub_faces = faces[fc[:, 2] > 0.1]
    used = np.unique(sub_faces)
    remap = np.zeros(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    return dict(
        verts=verts, faces=faces, f2t=f2t,
        keep_face_tets=f2t[fc[:, 2] <= 0.1],
        edit_verts=verts[used], edit_faces=remap[sub_faces],
        editable_verts=verts[:, 2] > 0.1,
    )


def leaves(obj, names):
    """{name: numpy array} of a JAX dataclass's or a port module's leaves."""
    out = {}
    for name in names:
        x = getattr(obj, name)
        out[name] = (x.detach().cpu().numpy() if torch.is_tensor(x)
                     else np.asarray(x))
    return out
