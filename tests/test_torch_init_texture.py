"""PyTorch port vs the JAX package: TetGS binding, optimizer and the
init-texture fit.

Both trainers see the same mesh, views, frames and camera order (numpy,
fixed seeds); the JAX trainer renders through its XLA backend on the CPU,
the port through the plain PyTorch versions of its kernels.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import icosphere

CPU = "cpu"
PARAMS = ("delta", "log_scales", "quats", "opacity_raw", "sh_dc", "sh_rest")


@pytest.fixture(scope="module")
def mesh():
    verts, faces = icosphere(2)  # 320 faces
    colors = np.random.default_rng(4).uniform(0, 1, (len(verts), 3))
    return verts, faces, colors.astype(np.float32)


def test_build_tetgs_matches_jax(mesh):
    from youreditableavatar_tpu.models.tetgs import build_tetgs as jbuild
    from youreditableavatar_tpu_torch.models.tetgs import build_tetgs

    verts, faces, colors = mesh
    f2t = np.arange(len(faces))
    bj, pj = jbuild(verts, faces, colors, f2t, sh_levels=2)
    bt, pt = build_tetgs(verts, faces, colors, f2t, sh_levels=2, device=CPU)
    for name in ("ori_points", "face_indices", "mesh_verts", "mesh_faces",
                 "face_to_global_tet_idx"):
        np.testing.assert_array_equal(getattr(bt, name).numpy(),
                                      np.asarray(getattr(bj, name)), err_msg=name)
    for name in ("normals", "radii"):
        np.testing.assert_allclose(getattr(bt, name).numpy(),
                                   np.asarray(getattr(bj, name)), rtol=1e-6,
                                   atol=1e-7, err_msg=name)
    assert bt.sh_levels == bj.sh_levels and bt.n_gaussians == bj.n_gaussians
    for name in PARAMS:
        np.testing.assert_allclose(getattr(pt, name).detach().numpy(),
                                   np.asarray(getattr(pj, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_expon_lr_schedule_matches_jax():
    from youreditableavatar_tpu.models.optimizer import expon_lr_schedule as js
    from youreditableavatar_tpu_torch.models.optimizer import (
        expon_lr_schedule as ts,
    )

    for kw in ({"lr_init": 3.2e-4, "lr_final": 3.2e-6, "lr_delay_mult": 0.01,
                "max_steps": 30_000},
               {"lr_init": 1e-2, "lr_final": 1e-4, "lr_delay_steps": 500,
                "lr_delay_mult": 0.1, "max_steps": 2000}):
        fj, ft = js(**kw), ts(**kw)
        for step in (0, 1, 7, 250, 999, 1999, 2000, 29_999, 30_000, 45_000):
            np.testing.assert_allclose(ft(step), float(fj(step)), rtol=2e-6)


def test_adam_groups_match_optax(mesh):
    """Three steps on fixed gradients: the port's Adam groups reproduce
    optax.adam per leaf (bias correction, eps 1e-15, scheduled position lr)."""
    import optax

    from youreditableavatar_tpu.models.optimizer import (
        OptimizationParams, make_tetgs_optimizer as jopt,
    )
    from youreditableavatar_tpu.models.tetgs import build_tetgs as jbuild
    from youreditableavatar_tpu_torch.models.optimizer import (
        make_tetgs_optimizer,
    )
    from youreditableavatar_tpu_torch.models.tetgs import params_from_numpy

    verts, faces, colors = mesh
    _, pj = jbuild(verts, faces, colors, sh_levels=2)
    pt = params_from_numpy({k: np.asarray(getattr(pj, k)) for k in PARAMS},
                           device=CPU)
    opt = OptimizationParams()
    tx = jopt(opt, 2.0)
    state = tx.init(pj)
    topt = make_tetgs_optimizer(pt, opt, 2.0)
    rng = np.random.default_rng(8)
    for _ in range(3):
        grads = {k: rng.normal(size=getattr(pj, k).shape).astype(np.float32)
                 for k in PARAMS}
        updates, state = tx.update(
            type(pj)(**{k: jnp.asarray(v) for k, v in grads.items()}), state, pj)
        pj = optax.apply_updates(pj, updates)
        for k, v in grads.items():
            getattr(pt, k).grad = torch.tensor(v)
        topt.step()
    for k in PARAMS:
        np.testing.assert_allclose(getattr(pt, k).detach().numpy(),
                                   np.asarray(getattr(pj, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def _trainers(mesh, steps):
    from youreditableavatar_tpu.models.cameras import (
        sample_ring_cameras as jring,
    )
    from youreditableavatar_tpu.models.tetgs import build_tetgs as jbuild
    from youreditableavatar_tpu.ops.gaussian_raster import (
        RasterizeConfig as JCfg,
    )
    from youreditableavatar_tpu.stages.init_texture import (
        InitTextureConfig as JInit, TetGSInitTrainer as JTrainer,
    )
    from youreditableavatar_tpu_torch.models.cameras import sample_ring_cameras
    from youreditableavatar_tpu_torch.models.tetgs import build_tetgs
    from youreditableavatar_tpu_torch.ops.gaussian_raster import RasterizeConfig
    from youreditableavatar_tpu_torch.stages.init_texture import (
        InitTextureConfig, TetGSInitTrainer,
    )

    verts, faces, _ = mesh
    rng = np.random.default_rng(0)
    ring = dict(radius=2.7, elevations=(10.0,), counts=(3,), height=64,
                width=64)
    frames = [rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
              for _ in range(3)]
    jcams = [dataclasses.replace(c, image=f) for c, f in zip(jring(**ring), frames)]
    tcams = [dataclasses.replace(c, image=f)
             for c, f in zip(sample_ring_cameras(**ring), frames)]
    for a, b in zip(jcams, tcams):
        np.testing.assert_array_equal(a.viewmat, b.viewmat)
    kw = dict(num_iterations=steps, log_every=1, sh_warmup_every=3,
              auto_size_budget=True)
    jt = JTrainer(*jbuild(verts, faces, None, sh_levels=2), jcams,
                  JInit(raster=JCfg(sh_degree=1), **kw))
    tt = TetGSInitTrainer(*build_tetgs(verts, faces, None, sh_levels=2,
                                       device=CPU), tcams,
                          InitTextureConfig(raster=RasterizeConfig(sh_degree=1),
                                            **kw), device=CPU)
    return jt, tt


def test_fit_follows_jax_trainer(mesh):
    """5 steps, same seed and camera order, SH degree raised at step 3.

    First loss at rtol 1e-5, the rest at rtol 1e-3: Adam with eps 1e-15
    turns summation-order noise in near-zero gradients into full-size
    steps, so later losses may drift apart (observed ≤ 3e-7 here).
    """
    jt, tt = _trainers(mesh, steps=5)
    assert tt.cfg.raster.pair_budget == jt.cfg.raster.pair_budget
    assert tt.cfg.raster.tile_capacity == jt.cfg.raster.tile_capacity
    jt.train(seed=0)
    tt.train(seed=0)
    assert len(tt.losses) == len(jt.losses) == 5
    np.testing.assert_allclose(tt.losses[0], jt.losses[0], rtol=1e-5)
    np.testing.assert_allclose(tt.losses, jt.losses, rtol=1e-3)
    assert [s["num_pairs"] for s in tt.stats] == [s["num_pairs"] for s in jt.stats]
    assert set(tt.param_stats()) == set(jt.param_stats())
    img = tt.render_views([tt_cam for tt_cam in _ring_views()])[0]
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()


def _ring_views():
    from youreditableavatar_tpu_torch.models.cameras import sample_ring_cameras

    return sample_ring_cameras(radius=2.7, elevations=(0.0,), counts=(1,),
                               height=64, width=64)


def test_load_tetgs_of_jax_checkpoint_renders_the_same(mesh, tmp_path):
    from youreditableavatar_tpu.models.tetgs import (
        build_tetgs as jbuild, load_tetgs as jload, render_tetgs as jrender,
        save_tetgs as jsave,
    )
    from youreditableavatar_tpu.ops.gaussian_raster import (
        RasterizeConfig as JCfg,
    )
    from youreditableavatar_tpu_torch.models.tetgs import (
        load_tetgs, render_tetgs, save_tetgs,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster import RasterizeConfig

    verts, faces, colors = mesh
    bj, pj = jbuild(verts, faces, colors, np.arange(len(faces)), sh_levels=2)
    rng = np.random.default_rng(5)
    pj = type(pj)(**{k: getattr(pj, k) + jnp.asarray(
        0.05 * rng.normal(size=getattr(pj, k).shape), jnp.float32)
        for k in PARAMS})
    jsave(str(tmp_path / "jax.npz"), bj, pj, step=np.asarray(7))
    bt, pt, extras = load_tetgs(str(tmp_path / "jax.npz"), device=CPU)
    assert int(extras["step"]) == 7

    from youreditableavatar_tpu.models.cameras import sample_ring_cameras

    jcam = sample_ring_cameras(radius=2.7, elevations=(0.0,), counts=(1,),
                               height=64, width=64)[0]
    cam = _ring_views()[0]
    ref = jrender(bj, pj, jcam.raster_camera(),
                  JCfg(backend="xla", pair_budget=1 << 13, tile_capacity=1024,
                       sh_degree=1), jnp.ones(3))
    out = render_tetgs(bt, pt, cam.raster_camera(CPU),
                       RasterizeConfig(pair_budget=1 << 13, sh_degree=1),
                       torch.ones(3))
    np.testing.assert_allclose(out["image"].detach().numpy(),
                               np.asarray(ref["image"]), atol=1e-6)

    # And the port's checkpoint loads back into the JAX package unchanged.
    save_tetgs(str(tmp_path / "port.npz"), bt, pt)
    bj2, pj2, _ = jload(str(tmp_path / "port.npz"))
    for k in PARAMS:
        np.testing.assert_array_equal(np.asarray(getattr(pj2, k)),
                                      np.asarray(getattr(pj, k)))
    np.testing.assert_array_equal(np.asarray(bj2.face_to_global_tet_idx),
                                  np.asarray(bj.face_to_global_tet_idx))


def test_entry_points_default_to_cuda(mesh):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from youreditableavatar_tpu_torch.models.tetgs import build_tetgs

    verts, faces, _ = mesh
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_tetgs(verts, faces)
