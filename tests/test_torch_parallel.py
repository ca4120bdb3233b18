"""PyTorch port vs the JAX package: the sharded TetGS train step.

The scene is `tests/test_parallel.py`'s (a marching-tets sphere, 4 views at
64×64). The JAX reference is its single-device `value_and_grad` of the
mean l1 + D-SSIM loss through the XLA render (tile capacity above every
tile's depth, so nothing is cut). The port's step runs in spawned gloo
worlds of (data, tile) = (2, 2) and (4, 2) CPU ranks on the plain versions
of its kernels; the band render and the projection clip are held in one
process.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    jax_camera,
    random_scene,
    run_world,
    sharded_step_worker,
    single_threaded_torch,  # noqa: F401  (fixture)
    to_torch_proj,
    torch_camera,
)

H = W = 64
BUDGET = 1 << 12
CAPACITY = 1024
PARAMS = ("delta", "log_scales", "quats", "opacity_raw", "sh_dc", "sh_rest")
GRAD_RTOL_OF_MAX = 5e-5


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The scene as an npz for the ranks, with the JAX reference loss and
    gradients of the mean loss over its 4 views."""
    from youreditableavatar_tpu.models.tetgs import build_tetgs, gaussian_arrays
    from youreditableavatar_tpu.ops.gaussian_raster import (
        RasterCamera, RasterizeConfig, render_gaussians)
    from youreditableavatar_tpu.ops.image_losses import l1_dssim
    from youreditableavatar_tpu.ops.marching_tets import (
        make_tet_grid, marching_tets)

    gverts, gtets = make_tet_grid(8)
    pos = jnp.asarray(gverts)
    mt = marching_tets(pos, jnp.linalg.norm(pos, axis=-1) - 0.35,
                       jnp.asarray(gtets), 2048, 4096)
    verts = np.asarray(mt.verts)[: int(mt.num_verts)]
    faces = np.asarray(mt.faces)[: int(mt.num_faces)]
    binding, params = build_tetgs(verts, faces,
                                  np.clip(0.5 + 0.4 * verts / 0.35, 0, 1),
                                  sh_levels=2)
    cfg = RasterizeConfig(backend="xla", pair_budget=BUDGET,
                          tile_capacity=CAPACITY, sh_degree=1)
    cams, images = [], []
    for k in range(4):
        vm = np.eye(4, dtype=np.float32)
        az = k * np.pi / 2
        vm[:3, :3] = [[np.cos(az), 0, np.sin(az)], [0, 1, 0],
                      [-np.sin(az), 0, np.cos(az)]]
        vm[2, 3] = 2.0
        cam = RasterCamera.from_fov(vm, 0.8, 0.8, W, H)
        out = render_gaussians(*gaussian_arrays(binding, params), cam, cfg,
                               jnp.ones(3))
        assert int(out["num_tile_overflow"]) == 0
        cams.append(cam)
        images.append(np.asarray(out["image"]) * 0.7 + 0.1)

    def loss_fn(p):
        arrays = gaussian_arrays(binding, p)
        return jnp.mean(jnp.stack([
            l1_dssim(render_gaussians(*arrays, c, cfg, jnp.zeros(3))["image"],
                     jnp.asarray(gt), 0.2)
            for c, gt in zip(cams, images)]))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    path = tmp_path_factory.mktemp("scene") / "scene.npz"
    fields = ("ori_points", "normals", "face_indices", "radii", "mesh_verts",
              "mesh_faces")
    np.savez(
        path, **{f: np.asarray(getattr(binding, f)) for f in fields},
        sh_levels=binding.sh_levels,
        **{n: np.asarray(getattr(params, n)) for n in PARAMS},
        viewmats=np.stack([np.asarray(c.viewmat) for c in cams]),
        **{k: np.stack([np.asarray(getattr(c, k)) for c in cams])
           for k in ("fx", "fy", "cx", "cy")},
        images=np.stack(images).astype(np.float32),
        pair_budget=BUDGET, tile_capacity=CAPACITY,
    )
    return dict(path=str(path), loss=float(loss),
                grads={n: np.asarray(getattr(grads, n)) for n in PARAMS})


def _port_scene(path):
    from youreditableavatar_tpu_torch.models.tetgs import (
        binding_from_numpy, params_from_numpy)
    from youreditableavatar_tpu_torch.ops.gaussian_raster import RasterizeConfig

    z = dict(np.load(path))
    cfg = RasterizeConfig(pair_budget=BUDGET, tile_capacity=CAPACITY,
                          sh_degree=1)
    return (z, binding_from_numpy(z, device="cpu"),
            params_from_numpy(z, device="cpu"), cfg)


def _cameras(z):
    from youreditableavatar_tpu_torch.ops.gaussian_raster import RasterCamera

    return [RasterCamera(viewmat=torch.tensor(z["viewmats"][i]),
                         **{k: torch.tensor(z[k][i]) for k in
                            ("fx", "fy", "cx", "cy")}, width=W, height=H)
            for i in range(len(z["viewmats"]))]


@pytest.fixture(scope="module")
def single(scene):
    """The port's single-device step on the same scene: loss, gradients
    and the parameters after one Adam step."""
    from youreditableavatar_tpu_torch.models.optimizer import (
        OptimizationParams, make_tetgs_optimizer)
    from youreditableavatar_tpu_torch.models.tetgs import gaussian_arrays
    from youreditableavatar_tpu_torch.ops.gaussian_raster import render_gaussians
    from youreditableavatar_tpu_torch.ops.image_losses import l1_dssim

    z, binding, params, cfg = _port_scene(scene["path"])
    opt = make_tetgs_optimizer(params, OptimizationParams(), 1.0)
    arrays = gaussian_arrays(binding, params)
    loss = torch.stack([
        l1_dssim(render_gaussians(*arrays, c, cfg, torch.zeros(3))["image"],
                 torch.tensor(gt), 0.2)
        for c, gt in zip(_cameras(z), z["images"])]).mean()
    loss.backward()
    grads = {n: getattr(params, n).grad.numpy().copy() for n in PARAMS}
    opt.step()
    return dict(loss=loss.item(), grads=grads,
                params={n: getattr(params, n).detach().numpy() for n in PARAMS})


@pytest.fixture(scope="module")
def world_2x2(scene, tmp_path_factory):
    return run_world(sharded_step_worker, 4, tmp_path_factory.mktemp("w22"),
                     (2, 2), scene["path"], 5)


@pytest.fixture(scope="module")
def world_4x2(scene, tmp_path_factory):
    return run_world(sharded_step_worker, 8, tmp_path_factory.mktemp("w42"),
                     (4, 2), scene["path"], 1)


WORLDS = ["world_2x2", "world_4x2"]


def _assert_grads_close(got, want, err=""):
    for n in PARAMS:
        tol = GRAD_RTOL_OF_MAX * max(np.abs(want[n]).max(), 1e-12)
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=tol,
                                   err_msg=f"{err} {n}")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_loss_and_grads_match_jax(world, scene, request):
    """Every rank: the first step's loss within rtol 1e-5 of JAX's
    single-device loss, the all-reduced gradient within 5e-5·max|g| per
    leaf, no tile over the capacity."""
    for r, out in enumerate(request.getfixturevalue(world)):
        np.testing.assert_allclose(out["losses"][0], scene["loss"], rtol=1e-5)
        _assert_grads_close(out["grads"], scene["grads"], f"rank {r}")
        assert out["overflow"] == 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_params_replicated_and_match_single(world, single, request):
    """Parameters after the step are bit-identical across ranks (and
    `assert_replicated` passed on every rank), and match the port's own
    single-device step at rtol 1e-4 / atol 1e-7 except where
    |g| < 1e-6·max|g|: there Adam's eps 1e-15 makes rounding noise a full
    step of either sign."""
    outs = request.getfixturevalue(world)
    for out in outs[1:]:
        for n in PARAMS:
            np.testing.assert_array_equal(out["params"][n], outs[0]["params"][n])
    for n in PARAMS:
        g = single["grads"][n]
        keep = np.abs(g) >= 1e-6 * np.abs(g).max()
        np.testing.assert_allclose(outs[0]["params"][n][keep],
                                   single["params"][n][keep], rtol=1e-4,
                                   atol=1e-7, err_msg=n)
    np.testing.assert_allclose(outs[0]["losses"][0], single["loss"], rtol=1e-5)


def test_sharded_loss_decreases(world_2x2):
    losses = world_2x2[0]["losses"]
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    for out in world_2x2[1:]:
        assert out["losses"] == losses


@pytest.mark.parametrize("world,sizes", [("world_2x2", (2, 2)),
                                         ("world_4x2", (4, 2))])
def test_mesh_layout(world, sizes, request):
    """The mesh spans the world, trailing axis over neighbouring ranks, and
    (d, −1) infers the tile size."""
    outs = request.getfixturevalue(world)
    grid = np.arange(len(outs)).reshape(sizes)
    for r, out in enumerate(outs):
        ranks, names, data_rank, tile_rank = out["mesh"]
        assert ranks == grid.tolist() and tuple(names) == ("data", "tile")
        assert (data_rank, tile_rank) == (r // sizes[1], r % sizes[1])
        assert out["inferred_shape"] == sizes


def test_make_mesh_errors():
    from youreditableavatar_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="at most one axis"):
        make_mesh((-1, -1), device="cpu")
    with pytest.raises(ValueError, match="1 devices not divisible by 2"):
        make_mesh((2, -1), device="cpu")
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 1"):
        make_mesh((2, 2), device="cpu")
    with pytest.raises(RuntimeError, match="distributed_init"):
        make_mesh((1, -1), device="cpu")


def test_distributed_init_without_cluster(monkeypatch):
    from youreditableavatar_tpu_torch.parallel import distributed_init

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert distributed_init(device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("band,n_bands", [(0, 3), (1, 3), (2, 3), (0, 1)])
def test_shard_proj_rows_matches_jax(band, n_bands):
    """The band clip and shift, bit for bit, on a 96×96 scene (3 tile rows)."""
    from youreditableavatar_tpu.ops.gaussian_raster.preprocess import (
        preprocess_gaussians)
    from youreditableavatar_tpu.parallel.train_step import (
        _shard_proj_rows as jshard)
    from youreditableavatar_tpu_torch.parallel.train_step import _shard_proj_rows

    s, vm, w, h = random_scene(21, 400, 96, 96, scale_hi=0.15)
    proj = preprocess_gaussians(
        *(jnp.asarray(s[k]) for k in ("means", "scales", "quats", "opac")),
        jnp.zeros((400, 1, 3)), jax_camera(vm, 0.8, 0.8, w, h), 0, 32,
        colors_override=jnp.asarray(s["colors"]))
    rows = 3 // n_bands
    want = jshard(proj, jnp.int32(band * rows), rows, 32)
    got = _shard_proj_rows(to_torch_proj(proj), band * rows, rows, 32)
    for name in want._fields:
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert int(got.tiles_touched.sum()) > 0


def test_band_render_matches_unsharded():
    """Two bands rendered in one process, gathered and assembled, equal the
    unsharded render (image to 1e-6), and their summed gradients its
    gradients (5e-5·max|g| per input)."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        RasterizeConfig, render_gaussians)
    from youreditableavatar_tpu_torch.ops.gaussian_raster.composite_xla import (
        assemble_image)
    from youreditableavatar_tpu_torch.parallel.train_step import render_band

    s, vm, _, _ = random_scene(23, 500, 64, 64, scale_hi=0.12)
    cam = torch_camera(vm, 0.8, 0.8, 64, 64)
    cfg = RasterizeConfig(pair_budget=BUDGET, sh_degree=0)
    sh = torch.tensor(np.random.default_rng(2).normal(
        size=(500, 1, 3)).astype(np.float32))
    inputs = [torch.tensor(s[k]) for k in ("means", "scales", "quats", "opac")]
    g_img = torch.tensor(np.random.default_rng(4).normal(
        size=(64, 64, 3)).astype(np.float32))
    bg = torch.tensor(s["bg"])

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in inputs + [sh]]
        img = fn(leaves)
        return img.detach(), torch.autograd.grad((img * g_img).sum(), leaves)

    def banded(leaves):
        parts = [render_band(*leaves, cam, cfg, b, 2) for b in range(2)]
        rgb = torch.cat([p[0] for p in parts])
        t = torch.cat([p[1] for p in parts])
        img, final_t = assemble_image(rgb, t, 2, 2, 32, 64, 64)
        return img + final_t[..., None] * bg

    img_b, g_b = grads(banded)
    img_u, g_u = grads(lambda lv: render_gaussians(*lv, cam, cfg, bg)["image"])
    np.testing.assert_allclose(img_b.numpy(), img_u.numpy(), rtol=0, atol=1e-6)
    for a, b in zip(g_b, g_u):
        tol = GRAD_RTOL_OF_MAX * float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=tol)
    assert float(g_u[0].abs().max()) > 0


def test_render_band_needs_whole_rows():
    from youreditableavatar_tpu_torch.ops.gaussian_raster import RasterizeConfig
    from youreditableavatar_tpu_torch.parallel.train_step import render_band

    s, vm, _, _ = random_scene(1, 10, 64, 96)
    cam = torch_camera(vm, 0.8, 0.8, 64, 96)
    inputs = [torch.tensor(s[k]) for k in ("means", "scales", "quats", "opac")]
    with pytest.raises(ValueError, match="not divisible by 2 bands"):
        render_band(*inputs, torch.zeros(10, 1, 3), cam,
                    RasterizeConfig(pair_budget=1024, sh_degree=0), 0, 2)
