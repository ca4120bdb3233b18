"""Shared inputs for the PyTorch-port parity tests (`test_torch_*.py`).

Inputs are made with numpy from fixed seeds and handed to both the JAX
package and the port, which runs on the CPU through its plain versions.
"""

from __future__ import annotations

import pathlib

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


# ---- the spatial stage (slice 3) ---------------------------------------

# tests/test_spatial.py's field and budgets: 4 levels × 2^13, 32 neurons.
SMALL_GRID = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=13,
                  base_resolution=4, per_level_scale=1.5)
SMALL_BUDGETS = dict(mt_verts=4096, mt_faces=8192, compact=2048,
                     subdiv_mid=8192, fine_mt_verts=8192, fine_mt_faces=16384)


def small_fields(sdf_bias_radius=0.4):
    """(JAX SDFField, port SDFField) of test_spatial.py's small field."""
    from youreditableavatar_tpu.models.sdf import SDFField, SDFFieldConfig
    from youreditableavatar_tpu.ops.hashgrid import HashGridConfig
    from youreditableavatar_tpu_torch.models import sdf as tsdf
    from youreditableavatar_tpu_torch.ops import hashgrid as thg

    kw = dict(n_neurons=32, sdf_bias="sphere", sdf_bias_radius=sdf_bias_radius)
    return (SDFField(SDFFieldConfig(grid=HashGridConfig(**SMALL_GRID), **kw)),
            tsdf.SDFField(tsdf.SDFFieldConfig(
                grid=thg.HashGridConfig(**SMALL_GRID), **kw)))


def to_numpy_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def carry_params(jax_params):
    """A JAX field pytree as the port's `SDFParams` on the CPU."""
    from youreditableavatar_tpu_torch.models.sdf import sdf_params_from_numpy

    return sdf_params_from_numpy(to_numpy_tree(jax_params), device="cpu")


def small_geometries(resolution=10):
    """(JAX TetGeometry, port TetGeometry, JAX params, port params) of the
    small field with parameters from PRNGKey(0)."""
    import jax

    from youreditableavatar_tpu.models.geometry import (
        GeometryBudgets as JB, TetGeometry as JG)
    from youreditableavatar_tpu_torch.models.geometry import (
        GeometryBudgets as TB, TetGeometry as TG)

    jf, tf = small_fields()
    jp = jf.init_params(jax.random.PRNGKey(0))
    return (JG(jf, resolution, JB(**SMALL_BUDGETS)),
            TG(tf, resolution, TB(**SMALL_BUDGETS), device="cpu"),
            jp, carry_params(jp))


def partitions(jgeom, tgeom, jp, tp):
    """Both packages' partitions of the cap z > 0.1 of the frozen surface."""
    import jax.numpy as jnp

    mt = jgeom.isosurface(jp)
    fc = np.asarray(mt.verts)[np.asarray(mt.faces)].mean(1)
    edit = np.asarray(jnp.asarray(fc[:, 2] > 0.1) & mt.faces_valid)
    jpart = jgeom.partition_init(jp, jnp.asarray(edit), frozen_mt=mt)
    tpart = tgeom.partition_init(tp, torch.tensor(edit))
    return jpart, tpart, edit


def assert_mesh_close(tm, jm, atol=1e-6, err=""):
    """Budgeted meshes: integer fields equal, vertices to `atol`."""
    for name in jm._fields:
        a = np.asarray(getattr(jm, name))
        b = getattr(tm, name).detach().numpy()
        if name == "verts":
            np.testing.assert_allclose(b, a, rtol=0, atol=atol,
                                       err_msg=f"{err} {name}")
        else:
            np.testing.assert_array_equal(b, a, err_msg=f"{err} {name}")


# ---- spawned worlds of ranks (gloo) --------------------------------------

WORLD_TIMEOUT_S = 240  # a hung collective fails the test instead of the run


def _rank_main(target, rank, world, store, out_dir, args):
    """One spawned rank: join the gloo group through the file store, run
    `target(rank, world, *args)`, pickle its result (or the traceback)."""
    import pickle
    import traceback
    from datetime import timedelta

    import torch.distributed as dist

    from youreditableavatar_tpu_torch.parallel import distributed_init

    torch.set_num_threads(1)
    out = pathlib.Path(out_dir)
    try:
        distributed_init(f"file://{store}", world, rank, device="cpu",
                         timeout=timedelta(seconds=60))
        result = target(rank, world, *args)
        (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(target, world, tmp_path, *args, timeout=WORLD_TIMEOUT_S):
    """Run `target(rank, world, *args)` (a module-level function) on `world`
    spawned CPU processes joined by gloo; returns the ranks' results. A rank
    that fails or a world that outlives `timeout` fails the caller."""
    import multiprocessing as mp
    import pickle
    import time

    out = pathlib.Path(tmp_path) / f"world{world}_{target.__name__}"
    out.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, str(out / "store"), str(out),
                               args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = "".join((out / f"rank{r}.err").read_text()
                     for r in range(world) if (out / f"rank{r}.err").exists())
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"ranks {hung} hung after {timeout} s; exit codes "
                             f"{[p.exitcode for p in procs]}\n{errors}")
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def sharded_step_worker(rank, world, axis_sizes, scene_path, steps):
    """Rank body of the sharded-step tests: the scene from `scene_path`
    (numpy), the port's sharded step `steps` times on a gloo (data, tile)
    mesh. Returns the first step's loss, overflow and all-reduced
    gradients, the parameters after it, every step's loss, and the mesh."""
    from youreditableavatar_tpu_torch.models.optimizer import (
        OptimizationParams, make_tetgs_optimizer)
    from youreditableavatar_tpu_torch.models.tetgs import (
        PARAM_NAMES, binding_from_numpy, params_from_numpy)
    from youreditableavatar_tpu_torch.ops.gaussian_raster import RasterizeConfig
    from youreditableavatar_tpu_torch.parallel import (
        make_mesh, make_sharded_render_train_step)
    from youreditableavatar_tpu_torch.utils.misc import assert_replicated

    z = dict(np.load(scene_path))
    binding = binding_from_numpy(z, device="cpu")
    params = params_from_numpy(z, device="cpu")
    opt = make_tetgs_optimizer(params, OptimizationParams(), 1.0)
    mesh = make_mesh(axis_sizes, device="cpu")
    cfg = RasterizeConfig(pair_budget=int(z["pair_budget"]),
                          tile_capacity=int(z["tile_capacity"]), sh_degree=1)
    h, w = z["images"].shape[1:3]
    step = make_sharded_render_train_step(binding, opt, cfg, mesh, h, w,
                                          bg=torch.zeros(3))
    batch = {k: z[k] for k in ("viewmats", "fx", "fy", "cx", "cy", "images")}
    out = {"losses": []}
    for i in range(steps):
        params, opt, loss, overflow = step(params, batch)
        out["losses"].append(float(loss))
        if i == 0:
            out["overflow"] = int(overflow)
            out["grads"] = {n: getattr(params, n).grad.numpy().copy()
                            for n in PARAM_NAMES}
            out["params"] = {n: getattr(params, n).detach().numpy().copy()
                             for n in PARAM_NAMES}
    assert_replicated(params)
    out["mesh"] = (mesh.mesh.tolist(), mesh.mesh_dim_names,
                   mesh.get_local_rank("data"), mesh.get_local_rank("tile"))
    inferred = make_mesh((axis_sizes[0], -1), device="cpu")
    out["inferred_shape"] = tuple(inferred.mesh.shape)
    return out


def replication_worker(rank, world, perturb_rank):
    """Rank body: equal tensors pass `assert_replicated`; then rank
    `perturb_rank` changes one value by 1e-6 and every rank must raise."""
    from youreditableavatar_tpu_torch.utils.misc import assert_replicated

    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(5, 3, generator=g), "b": [torch.randn(7, generator=g)]}
    assert_replicated(tree)
    if rank == perturb_rank:
        tree["b"][0][3] += 1e-6
    try:
        assert_replicated(tree)
    except AssertionError as err:
        return str(err)
    return None
