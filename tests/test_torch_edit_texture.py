"""PyTorch port vs the JAX package: the edit-Gaussian models, the textured
mesh model, the inpaint → refine stage as a whole, and the host-side camera
/ COLMAP / saving / schedule / config modules.

Both packages see the same numpy inputs (fixed seeds); weights go from the
JAX dataclasses to the port through its `*_from_numpy` carriers. The JAX
side renders through its XLA backends on the CPU, the port through the
plain PyTorch versions of its kernels.
"""

import dataclasses
import filecmp
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_colmap_io import write_colmap_text_dataset
from torch_port_helpers import (
    leaves,
    single_threaded_torch,  # noqa: F401  (fixture)
    sphere_cap_scene,
)

CPU = "cpu"
PARAMS = ("delta", "log_scales", "quats", "opacity_raw", "sh_dc", "sh_rest")
RASTER = dict(pair_budget=1 << 13, tile_capacity=512)
MESH_BUDGET = 1 << 14


def _jcfgs():
    from youreditableavatar_tpu.ops.gaussian_raster import RasterizeConfig
    from youreditableavatar_tpu.ops.mesh_raster import MeshRasterConfig

    return (RasterizeConfig(backend="xla", **RASTER),
            MeshRasterConfig(backend="xla", pair_budget=MESH_BUDGET,
                             tile_capacity=2048))


def _tcfgs():
    from youreditableavatar_tpu_torch.ops.gaussian_raster import RasterizeConfig
    from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig

    return RasterizeConfig(**RASTER), MeshRasterConfig(pair_budget=MESH_BUDGET)


def _cams(mod, azimuths, size=64):
    """Look-at cameras on the 5° ring of test_texture.py."""
    return [mod.c2w_to_gs_camera(mod.spherical_c2w(5.0, az, 1.6), 80.0, size,
                                 size) for az in azimuths]


def _binding_arrays(binding):
    return {f.name: np.asarray(getattr(binding, f.name))
            for f in dataclasses.fields(binding)}


@pytest.fixture(scope="module")
def scene():
    """The sphere-cap scene in both packages: stage-2 TetGS, keep
    Gaussians, the 2D edit model (carried across as numpy)."""
    from youreditableavatar_tpu.models import tetgs as jt, tetgs_edit as je
    from youreditableavatar_tpu_torch.models import tetgs as tt, tetgs_edit as te

    s = sphere_cap_scene()
    bj, pj = jt.build_tetgs(s["verts"], s["faces"], None, s["f2t"], sh_levels=2)
    bt = tt.binding_from_numpy(_binding_arrays(bj), device=CPU)
    pt = tt.params_from_numpy(leaves(pj, PARAMS), device=CPU)
    keep = jt.extract_keep_gaussians(bj, pj, s["keep_face_tets"])
    ebj, epj = je.build_edit_tetgs(s["edit_verts"], s["edit_faces"], keep,
                                   sh_levels=1)
    ebt = te.edit_binding_from_numpy(_binding_arrays(ebj), device=CPU)
    ept = te.edit_params_from_numpy(leaves(epj, PARAMS), device=CPU)
    return dict(s, bj=bj, pj=pj, bt=bt, pt=pt, keep=keep, ebj=ebj, epj=epj,
                ebt=ebt, ept=ept)


def _assert_quats_close(a, b, atol=1e-6):
    sign = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    np.testing.assert_allclose(a * sign, b, atol=atol)


# ---- edit models -----------------------------------------------------------


def test_extract_keep_gaussians_matches_jax(scene):
    from youreditableavatar_tpu_torch.models.tetgs import extract_keep_gaussians

    got = extract_keep_gaussians(scene["bt"], scene["pt"],
                                 scene["keep_face_tets"])
    assert set(got) == set(scene["keep"])
    assert got["sh_levels"] == scene["keep"]["sh_levels"]
    assert len(got["xyz"]) > 0
    for k in set(got) - {"sh_levels"}:
        np.testing.assert_allclose(got[k], np.asarray(scene["keep"][k]),
                                   atol=1e-6, err_msg=k)


def test_build_edit_tetgs_matches_jax(scene):
    from youreditableavatar_tpu.models.tetgs_edit import (
        build_edit_tetgs as jbuild,
    )
    from youreditableavatar_tpu_torch.models.tetgs_edit import build_edit_tetgs

    colors = np.random.default_rng(2).uniform(
        0, 1, (len(scene["edit_verts"]), 3)).astype(np.float32)
    ebj, epj = jbuild(scene["edit_verts"], scene["edit_faces"], scene["keep"],
                      colors, sh_levels=2)
    ebt, ept = build_edit_tetgs(scene["edit_verts"], scene["edit_faces"],
                                scene["keep"], colors, sh_levels=2, device=CPU)
    assert (ebt.n_edit, ebt.n_keep) == (ebj.n_edit, ebj.n_keep)
    assert (ebt.sh_levels, ebt.use_delta) == (2, False)
    ref = _binding_arrays(ebj)
    for k, v in leaves(ebt, [f.name for f in dataclasses.fields(ebt)
                             if f.name not in ("sh_levels", "use_delta")]).items():
        assert v.dtype == (np.int32 if "face" in k else np.float32), k
        if k == "keep_quats":
            _assert_quats_close(v, ref[k])
        else:
            np.testing.assert_allclose(v, ref[k], atol=1e-6, err_msg=k)
    for k, v in leaves(ept, PARAMS).items():
        if k == "quats":
            _assert_quats_close(v, np.asarray(epj.quats))
        else:
            np.testing.assert_allclose(v, np.asarray(getattr(epj, k)),
                                       atol=1e-6, err_msg=k)


def test_edit_carriers_keep_every_leaf(scene):
    for k, v in leaves(scene["ept"], PARAMS).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(scene["epj"], k)))
    ref = _binding_arrays(scene["ebj"])
    for f in dataclasses.fields(scene["ebt"]):
        got = getattr(scene["ebt"], f.name)
        if torch.is_tensor(got):
            np.testing.assert_array_equal(got.numpy(), ref[f.name])
        else:
            assert got == ref[f.name]
    assert scene["ebt"].edit_mesh_faces.dtype == torch.int32


def _perturbed(scene, seed=6, scale=0.05):
    """The 2D edit params with noise on every leaf, in both packages."""
    from youreditableavatar_tpu_torch.models.tetgs_edit import (
        edit_params_from_numpy,
    )

    rng = np.random.default_rng(seed)
    arrays = {k: v + scale * rng.normal(size=v.shape).astype(np.float32)
              for k, v in leaves(scene["epj"], PARAMS).items()}
    pj = type(scene["epj"])(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return pj, edit_params_from_numpy(arrays, device=CPU)


def test_promote_to_3d_matches_jax(scene):
    from youreditableavatar_tpu.models.tetgs_edit import (
        edit_gaussian_arrays as jarrays, promote_to_3d as jp,
    )
    from youreditableavatar_tpu_torch.models.tetgs_edit import (
        edit_gaussian_arrays, promote_to_3d,
    )

    pj, pt = _perturbed(scene)
    b3j, p3j = jp(scene["ebj"], pj, sh_levels=3)
    b3t, p3t = promote_to_3d(scene["ebt"], pt, sh_levels=3)
    assert b3t.use_delta and b3t.sh_levels == 3
    assert p3t.sh_rest.shape == (scene["ebt"].n_edit, 8, 3)
    for k, v in leaves(p3t, PARAMS).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(p3j, k)))
    # The inputs stay as they were (sh_levels 1: no sh_rest).
    assert pt.sh_rest.shape[1] == 0 and not scene["ebt"].use_delta
    # δ moves the means along the normals.
    with torch.no_grad():
        p3t.delta.fill_(0.1)
    p3j = dataclasses.replace(p3j, delta=jnp.full_like(p3j.delta, 0.1))
    for a, b in zip(edit_gaussian_arrays(b3t, p3t), jarrays(b3j, p3j)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("overrides", ["none", "keep", "both"])
def test_full_gaussian_arrays_match_jax(scene, overrides):
    from youreditableavatar_tpu.models.tetgs_edit import (
        full_gaussian_arrays as jfull,
    )
    from youreditableavatar_tpu_torch.models.tetgs_edit import (
        full_gaussian_arrays,
    )

    pj, pt = _perturbed(scene)
    kc = None if overrides == "none" else np.float32([1.0, 0.0, 0.25])
    ec = np.float32([0.0, 1.0, 0.5]) if overrides == "both" else None
    ref = jfull(scene["ebj"], pj,
                None if kc is None else jnp.asarray(kc),
                None if ec is None else jnp.asarray(ec))
    got = full_gaussian_arrays(scene["ebt"], pt,
                               None if kc is None else torch.tensor(kc),
                               None if ec is None else torch.tensor(ec))
    assert (got[5] is None) == (ref[5] is None) == (overrides == "none")
    for a, b in zip(got, ref):
        if a is not None:
            assert a.shape == b.shape
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       atol=1e-6)


def test_rollback_outside_faces_matches_jax(scene):
    from youreditableavatar_tpu.models.tetgs_edit import (
        rollback_outside_faces as jroll,
    )
    from youreditableavatar_tpu_torch.models.tetgs_edit import (
        rollback_outside_faces,
    )

    pj, pt = _perturbed(scene)
    nf = len(scene["edit_faces"])
    painted = np.random.default_rng(1).uniform(size=nf) > 0.5
    ref = jroll(scene["ebj"], pj, scene["epj"], jnp.asarray(painted))
    got = rollback_outside_faces(scene["ebt"], pt, scene["ept"],
                                 torch.tensor(painted))
    assert got is not pt and got is not scene["ept"]
    changed = 0
    for k, v in leaves(got, PARAMS).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(ref, k)), err_msg=k)
        changed += int((v != getattr(scene["ept"], k).detach().numpy()).sum())
    assert changed > 0


def test_render_edit_tetgs_image_and_gradients_match_jax(scene):
    """Image ≤ 1e-6; gradients of all six leaves ≤ 5e-5·max|g| (the
    compositing backward sums per Gaussian in another order)."""
    from youreditableavatar_tpu.models import cameras as jc
    from youreditableavatar_tpu.models.tetgs_edit import (
        promote_to_3d as jp, render_edit_tetgs as jrender,
    )
    from youreditableavatar_tpu_torch.models import cameras as tc
    from youreditableavatar_tpu_torch.models.tetgs_edit import (
        promote_to_3d, render_edit_tetgs,
    )

    pj, pt = _perturbed(scene, scale=0.02)
    b3j, p3j = jp(scene["ebj"], pj, sh_levels=2)
    b3t, p3t = promote_to_3d(scene["ebt"], pt, sh_levels=2)
    rng = np.random.default_rng(9)
    rest = 0.1 * rng.normal(size=p3t.sh_rest.shape).astype(np.float32)
    delta = 0.01 * rng.normal(size=p3t.delta.shape).astype(np.float32)
    p3j = dataclasses.replace(p3j, sh_rest=jnp.asarray(rest),
                              delta=jnp.asarray(delta))
    with torch.no_grad():
        p3t.sh_rest.copy_(torch.tensor(rest))
        p3t.delta.copy_(torch.tensor(delta))
    cot = rng.normal(size=(64, 64, 3)).astype(np.float32)
    jcam = _cams(jc, [30.0])[0].raster_camera()
    tcam = _cams(tc, [30.0])[0].raster_camera(CPU)
    # A tile capacity no tile reaches, so the JAX scan drops nothing.
    jcfg = dataclasses.replace(_jcfgs()[0], tile_capacity=2048)
    tcfg = _tcfgs()[0]

    def jloss(p):
        out = jrender(b3j, p, jcam, jcfg, jnp.ones(3))
        return (jnp.sum(out["image"] * cot) + jnp.mean(out["alpha"]),
                (out["image"], out["num_tile_overflow"]))

    (_, (jimg, overflow)), jg = jax.value_and_grad(jloss, has_aux=True)(p3j)
    assert int(overflow) == 0
    out = render_edit_tetgs(b3t, p3t, tcam, tcfg, torch.ones(3))
    (torch.sum(out["image"] * torch.tensor(cot)) + out["alpha"].mean()).backward()
    np.testing.assert_allclose(out["image"].detach().numpy(), np.asarray(jimg),
                               atol=1e-6)
    for k in PARAMS:
        ref = np.asarray(getattr(jg, k))
        got = getattr(p3t, k).grad.numpy()
        assert np.abs(ref).max() > 0, k
        np.testing.assert_allclose(got, ref, atol=5e-5 * np.abs(ref).max(),
                                   err_msg=k)


# ---- textured mesh model ---------------------------------------------------


def _mesh_models(scene):
    from youreditableavatar_tpu.models.textured_mesh import (
        TexturedMeshModel as JModel,
    )
    from youreditableavatar_tpu_torch.models.textured_mesh import (
        TexturedMeshModel,
    )

    args = (scene["verts"], scene["faces"], scene["editable_verts"])
    return JModel(*args, _jcfgs()[1]), TexturedMeshModel(*args, _tcfgs()[1],
                                                         device=CPU)


def _assert_dicts_match(got, ref, atol=1e-6):
    assert set(got) == set(ref)
    for k, v in got.items():
        r = np.asarray(ref[k])
        assert tuple(v.shape) == r.shape, k
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(v.numpy(), r, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), r, atol=atol, err_msg=k)


def test_textured_mesh_model_matches_jax(scene):
    """Every entry of render_view, prepare_inpaint_masks and
    concat_blend_masks (floats ≤ 1e-6, masks and ids exact), and the face
    mask and painted set of back_project, over two views."""
    from youreditableavatar_tpu.models import cameras as jc
    from youreditableavatar_tpu_torch.models import cameras as tc

    mj, mt = _mesh_models(scene)
    for az in (0.0, 140.0):
        jcam = _cams(jc, [az])[0].raster_camera()
        tcam = _cams(tc, [az])[0].raster_camera(CPU)
        vj, vt = mj.render_view(jcam), mt.render_view(tcam)
        _assert_dicts_match(vt, vj)
        assert bool(vt["mask"].any()) and bool((vt["editable"] > 0.5).any())
        kj, kt = mj.prepare_inpaint_masks(vj), mt.prepare_inpaint_masks(vt)
        _assert_dicts_match(kt, kj)
        before = mt.painted.sum()
        fj = mj.back_project(vj, np.asarray(kj["inpaint_mask"] > 0.5))
        ft = mt.back_project(vt, kt["inpaint_mask"] > 0.5)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_array_equal(mt.painted, mj.painted)
        assert mt.painted.sum() > before and (mt.painted <= mt.editable).all()
        _assert_dicts_match(mt.concat_blend_masks(tcam),
                            mj.concat_blend_masks(jcam))
    # The second view's painted image saw the first view's paint.
    assert float(vt["painted"].max()) > 0.5


@pytest.mark.parametrize("src,dst", [(64, 24), (24, 64), (64, 64)])
def test_bilinear_resize_matches_jax_image_resize(src, dst):
    """Both directions of the joint front/back path: shrinking
    (antialiased) and enlarging, ≤ 2e-6 on values in [0, 1]."""
    from youreditableavatar_tpu_torch.stages.edit_texture import (
        _resize_bilinear,
    )

    rng = np.random.default_rng(src)
    for shape in ((src, src, 3), (src, src)):
        img = rng.uniform(size=shape).astype(np.float32)
        ref = jax.image.resize(jnp.asarray(img), (dst, dst) + shape[2:],
                               "bilinear")
        got = _resize_bilinear(torch.tensor(img), dst, dst)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-6)


@pytest.mark.parametrize("stage", ["inpaint", "refine"])
def test_edit_optimizer_matches_optax(scene, stage):
    """Three steps on fixed gradients: trained leaves follow optax's Adam
    groups; leaves outside the mask do not move."""
    import optax

    from youreditableavatar_tpu.stages import edit_texture as js
    from youreditableavatar_tpu_torch.stages import edit_texture as ts

    kw = {} if stage == "inpaint" else dict(train_positions=True,
                                            train_geometry=True)
    pj, pt = _perturbed(scene)
    start = leaves(pt, PARAMS)
    tx = js.make_edit_optimizer(0.0025, 0.05, js._edit_param_mask(**kw))
    state = tx.init(pj)
    mask = ts._edit_param_mask(**kw)
    opt = ts.make_edit_optimizer(pt, 0.0025, 0.05, mask)
    rng = np.random.default_rng(8)
    for _ in range(3):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in start.items()}
        updates, state = tx.update(
            type(pj)(**{k: jnp.asarray(v) for k, v in grads.items()}), state, pj)
        pj = optax.apply_updates(pj, updates)
        for k, v in grads.items():
            if mask[k]:
                getattr(pt, k).grad = torch.tensor(v)
        opt.step()
    for k, v in leaves(pt, PARAMS).items():
        np.testing.assert_allclose(v, np.asarray(getattr(pj, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        if not mask[k]:
            np.testing.assert_array_equal(v, start[k])
            assert not getattr(pt, k).requires_grad


# ---- the slice as a whole ----------------------------------------------------


@pytest.fixture(scope="module")
def stage4(scene):
    """Inpaint (3 views, ladder 3/2/2) → refine guidance (3 turntable
    views) → refine (4 steps) → validate, through both packages."""
    from youreditableavatar_tpu.guidance.stub import StubInpainter as JStub
    from youreditableavatar_tpu.models import cameras as jc
    from youreditableavatar_tpu.stages import edit_texture as js
    from youreditableavatar_tpu_torch.guidance.stub import StubInpainter
    from youreditableavatar_tpu_torch.models import cameras as tc
    from youreditableavatar_tpu_torch.models.tetgs_edit import (
        edit_params_from_numpy,
    )
    from youreditableavatar_tpu_torch.stages import edit_texture as ts

    mj, mt = _mesh_models(scene)
    kw = dict(iters_first=3, iters_second=2, iters_rest=2, first_group=1,
              second_group=1, fb_res=32)
    ring, turn = (0.0, 180.0, 90.0), (0.0, 120.0, 240.0)
    ji = js.InpaintTrainer(scene["ebj"], scene["epj"], mj, _cams(jc, ring),
                           JStub(), "a red hat", "bad",
                           js.InpaintConfig(raster=_jcfgs()[0], **kw))
    ti = ts.InpaintTrainer(scene["ebt"], scene["ept"].copy(), mt,
                           _cams(tc, ring), StubInpainter(), "a red hat",
                           "bad", ts.InpaintConfig(raster=_tcfgs()[0], **kw),
                           device=CPU)
    pin_j = ji.inpaint_training(jax.random.PRNGKey(0))
    pin_t = ti.inpaint_training()
    blends_j = ji.prepare_refine_guidance(_cams(jc, turn), jax.random.PRNGKey(1))
    blends_t = ti.prepare_refine_guidance(_cams(tc, turn))

    # Both refine trainers start from the JAX inpaint result and its blend
    # images, so the refine comparison does not inherit the inpaint drift.
    rkw = dict(num_iterations=4, key_views=(0,), sh_levels=2)
    jr = js.RefineTrainer(scene["ebj"], pin_j, _cams(jc, turn), blends_j,
                          js.RefineConfig(raster=_jcfgs()[0], **rkw))
    tr = ts.RefineTrainer(scene["ebt"],
                          edit_params_from_numpy(leaves(pin_j, PARAMS), CPU),
                          _cams(tc, turn), blends_j,
                          ts.RefineConfig(raster=_tcfgs()[0], **rkw), device=CPU)
    # Log every step's loss on both sides (the trainers log each 100th).
    jlosses, tlosses = [], []
    jstep, tstep = jr._make_step(64, 64), tr.step
    jr._step = lambda *a: _logged(jstep(*a), jlosses, 2)
    tr.step = lambda vi: _logged(tstep(vi), tlosses, 0)
    jr.refined_editing(seed=0)
    tr.refined_editing(seed=0)
    return dict(ji=ji, ti=ti, mj=mj, mt=mt, pin_j=pin_j, pin_t=pin_t,
                blends_j=blends_j, blends_t=blends_t, jr=jr, tr=tr,
                jlosses=jlosses, tlosses=tlosses,
                val_j=jr.validate(_cams(jc, turn[:2])),
                val_t=tr.validate(_cams(tc, turn[:2])))


def _logged(result, log, loss_index):
    log.append(float(result[loss_index]))
    return result


def test_inpaint_training_follows_jax(scene, stage4):
    """Same budgets, views, iteration ladder and painted set. The first
    view's loss (3 Adam steps from equal weights) agrees to 1e-5 relative;
    later views to 5e-3: Adam with eps 1e-15 turns summation-order noise in
    near-zero gradients into full-size steps of either sign, so weights and
    losses drift (observed ≤ 9e-4)."""
    ji, ti = stage4["ji"], stage4["ti"]
    assert ti.cfg.raster.pair_budget == ji.cfg.raster.pair_budget
    assert ti.cfg.raster.tile_capacity == ji.cfg.raster.tile_capacity
    assert [(h["view"], h["iters"]) for h in ti.history] == \
        [(h["view"], h["iters"]) for h in ji.history] == [(0, 3), (1, 2), (2, 2)]
    lj = [h["loss"] for h in ji.history]
    lt = [h["loss"] for h in ti.history]
    np.testing.assert_allclose(lt[0], lj[0], rtol=1e-5)
    np.testing.assert_allclose(lt, lj, rtol=5e-3)
    np.testing.assert_array_equal(stage4["mt"].painted, stage4["mj"].painted)
    assert stage4["mt"].painted.sum() > 0
    # Untrained leaves stay put; trained ones moved on both sides.
    for k in ("delta", "log_scales", "quats"):
        np.testing.assert_array_equal(
            getattr(stage4["pin_t"], k).detach().numpy(),
            np.asarray(getattr(stage4["pin_j"], k)))
    for k in ("opacity_raw", "sh_dc"):
        moved = np.abs(getattr(stage4["pin_t"], k).detach().numpy()
                       - getattr(scene["ept"], k).detach().numpy()).max()
        assert moved > 1e-3, k


def test_refine_guidance_blends_follow_jax(stage4):
    """3 blend images (64, 64, 3) in [0, 1]; ≤ 5e-3 max and ≤ 1e-4 mean
    from the JAX package's (they inherit the inpaint fit's drift)."""
    bj, bt = stage4["blends_j"], stage4["blends_t"]
    assert len(bt) == len(bj) == 3
    for a, b in zip(bt, bj):
        assert a.shape == b.shape == (64, 64, 3) and a.dtype == np.float32
        assert np.isfinite(a).all() and 0 <= a.min() and a.max() <= 1
        assert np.abs(a - b).max() <= 5e-3 and np.abs(a - b).mean() <= 1e-4


def test_refined_editing_follows_jax(stage4):
    """From equal weights and targets, 4 refine steps over the same views:
    the first loss to 1e-5 relative, all to 1e-3 (the Adam drift again);
    validate images ≤ 5e-3."""
    jl, tl = stage4["jlosses"], stage4["tlosses"]
    assert len(tl) == len(jl) == 4
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert stage4["tr"].losses == [tl[0]] and len(stage4["jr"].losses) == 1
    assert stage4["tr"].binding.use_delta and stage4["tr"].binding.sh_levels == 2
    for a, b in zip(stage4["val_t"], stage4["val_j"]):
        assert a.shape == b.shape == (64, 64, 3)
        assert np.isfinite(a).all() and np.abs(a - b).max() <= 5e-3
    # Every leaf trains in the refine stage.
    start = leaves(stage4["pin_j"], PARAMS)
    for k in ("delta", "log_scales", "quats", "opacity_raw", "sh_dc"):
        got = getattr(stage4["tr"].params, k).detach().numpy()
        ref = start[k] if k != "delta" else np.zeros_like(got)
        assert np.abs(got - ref).max() > 0, k


def test_stubs_match_jax():
    from youreditableavatar_tpu.guidance import stub as js
    from youreditableavatar_tpu_torch.guidance import stub as ts

    np.testing.assert_array_equal(
        ts.StubPromptEncoder(device=CPU).encode(["a hat", "b"]).numpy(),
        np.asarray(js.StubPromptEncoder().encode(["a hat", "b"])))
    rng = np.random.default_rng(0)
    img, ctrl, nrm = (rng.uniform(size=(8, 8, 3)).astype(np.float32)
                      for _ in range(3))
    mask = rng.uniform(size=(8, 8)).astype(np.float32)
    np.testing.assert_allclose(
        ts.StubInpainter().inpaint(torch.tensor(img), torch.tensor(mask),
                                   torch.tensor(nrm), torch.tensor(ctrl),
                                   "a red hat").numpy(),
        np.asarray(js.StubInpainter().inpaint(img, mask, nrm, ctrl, "a red hat")),
        atol=1e-6)
    np.testing.assert_allclose(
        ts.StubInpainter().img2img(torch.tensor(img), None, "x").numpy(),
        np.asarray(js.StubInpainter().img2img(img, None, "x")), atol=1e-6)


# ---- cameras, COLMAP, saving, schedule, config -------------------------------


def test_camera_samplers_and_pose_chain_match_jax():
    from youreditableavatar_tpu.models import cameras as jc
    from youreditableavatar_tpu_torch.models import cameras as tc

    kw = dict(num_views=5, radius=2.2, elevation_deg=7.0, height=96, width=80,
              sample_type="upper")
    for a, b in zip(tc.sample_circle_cameras(**kw), jc.sample_circle_cameras(**kw)):
        np.testing.assert_array_equal(a.viewmat, b.viewmat)
        assert (a.fx, a.fy, a.cx, a.cy, a.width, a.height, a.name) == \
            (b.fx, b.fy, b.cx, b.cy, b.width, b.height, b.name)
        ar, br = a.resized(0.5), b.resized(0.5)
        assert (ar.fx, ar.cx, ar.width, ar.height) == (br.fx, br.cx, br.width, br.height)
    rng = np.random.default_rng(0)
    c2w = jc.spherical_c2w(10.0, 40.0, 2.0)
    np.testing.assert_array_equal(
        tc.tet_to_colmap_pose(c2w, np.float32([0.1, 0.2, 0.3]), 1.7),
        jc.tet_to_colmap_pose(c2w, np.float32([0.1, 0.2, 0.3]), 1.7))
    verts = rng.normal(size=(9, 3))
    w2gt, rot = np.eye(4) + 0.1 * rng.normal(size=(4, 4)), np.eye(4)
    rot[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    np.testing.assert_array_equal(tc.tet_mesh_to_colmap(verts, w2gt, rot),
                                  jc.tet_mesh_to_colmap(verts, w2gt, rot))
    np.testing.assert_array_equal(tc.SDFSTUDIO_TO_COLMAP, jc.SDFSTUDIO_TO_COLMAP)
    img = rng.uniform(size=(10, 14, 3)).astype(np.float32)
    np.testing.assert_array_equal(tc._resize_image(img, 7, 20),
                                  jc._resize_image(img, 7, 20))
    split_t, split_j = tc.train_test_split(list(range(20))), \
        jc.train_test_split(list(range(20)))
    assert split_t == split_j
    sparse = rng.normal(size=(50, 3))
    colors = rng.uniform(size=(50, 3))
    colors[:5] = 0.99  # white points are dropped
    dense = rng.normal(size=(30, 3))
    np.testing.assert_allclose(
        tc.transfer_pcd_color(sparse, colors, dense, k=4, device=CPU),
        jc.transfer_pcd_color(sparse, colors, dense, k=4), atol=1e-6)
    assert tc.transfer_pcd_color(sparse, np.ones((50, 3)), dense,
                                 device=CPU).shape == (30, 3)


def _write_colmap_binary(root, cams, images, xyz, rgb):
    """A COLMAP binary sparse model of the given cameras / images / points."""
    from youreditableavatar_tpu.models.colmap import CAMERA_MODELS

    ids = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, ids[c.model], c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<idddddddi", im.id, *im.qvec, *im.tvec,
                                im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 2) + b"\x01" * 48)  # two 2D points
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i, (p, c) in enumerate(zip(xyz, rgb)):
            f.write(struct.pack("<QdddBBBd", i, *p, *(int(v) for v in c), 0.5))
            f.write(struct.pack("<Q", 1) + b"\x02" * 8)  # one track element


@pytest.mark.parametrize("fmt", ["text", "binary"])
def test_colmap_model_reads_back_equal(tmp_path, fmt):
    """A tiny COLMAP dataset reads back equal through both packages."""
    from youreditableavatar_tpu.models import cameras as jc, colmap as jcol
    from youreditableavatar_tpu_torch.models import cameras as tc, colmap as tcol

    write_colmap_text_dataset(str(tmp_path / "text"))
    root = tmp_path / "text"
    if fmt == "binary":
        cams, images, (xyz, rgb) = jcol.load_sparse_model(
            str(root / "sparse" / "0"))
        root = tmp_path / "binary"
        _write_colmap_binary(root, cams, images, xyz, rgb)
        (root / "images").symlink_to(tmp_path / "text" / "images")
    mj = jcol.load_sparse_model(str(root / "sparse" / "0"))
    mt = tcol.load_sparse_model(str(root / "sparse" / "0"))
    assert set(mt[0]) == set(mj[0]) and set(mt[1]) == set(mj[1]) and len(mt[1]) == 3
    for k in mj[0]:
        assert dataclasses.astuple(mt[0][k])[:4] == dataclasses.astuple(mj[0][k])[:4]
        np.testing.assert_array_equal(mt[0][k].params, mj[0][k].params)
        assert tcol.camera_intrinsics(mt[0][k]) == jcol.camera_intrinsics(mj[0][k])
    for k in mj[1]:
        np.testing.assert_array_equal(mt[1][k].qvec, mj[1][k].qvec)
        np.testing.assert_array_equal(mt[1][k].tvec, mj[1][k].tvec)
        assert (mt[1][k].name, mt[1][k].camera_id) == (mj[1][k].name, mj[1][k].camera_id)
    np.testing.assert_array_equal(mt[2][0], mj[2][0])
    np.testing.assert_array_equal(mt[2][1], mj[2][1])
    gj = jc.load_colmap_cameras(str(root), downscale=2.0)
    gt = tc.load_colmap_cameras(str(root), downscale=2.0)
    assert len(gt) == len(gj) == 3
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a.viewmat, b.viewmat)
        assert (a.fx, a.fy, a.cx, a.cy, a.width, a.height, a.name) == \
            (b.fx, b.fy, b.cx, b.cy, b.width, b.height, b.name)
        assert a.image.shape == (20, 24, 3)
        np.testing.assert_array_equal(a.image, b.image)


def test_saving_writes_the_same_files(tmp_path):
    from youreditableavatar_tpu.utils import saving as js
    from youreditableavatar_tpu_torch.utils import saving as ts

    rng = np.random.default_rng(0)
    verts = rng.normal(size=(6, 3)).astype(np.float32)
    faces = np.int64([[0, 1, 2], [3, 4, 5]])
    colors = rng.uniform(size=(6, 3)).astype(np.float32)
    img = rng.uniform(size=(8, 10, 3)).astype(np.float32)
    for name, mod in (("j", js), ("t", ts)):
        d = tmp_path / name
        mod.save_ply(str(d / "m.ply"), verts, faces, colors)
        mod.save_obj(str(d / "m.obj"), verts, faces)
        mod.save_json(str(d / "a.json"), {"x": np.float32(1.5), "y": [1, 2]})
        mod.save_npy(str(d / "a.npy"), verts)
        mod.save_image(str(d / "i.png"), img)
        mod.save_image_grid(str(d / "g.png"), [img, img, img], cols=2)
        mod.save_grayscale(str(d / "s.png"), img[..., 0])
        progress = mod.ProgressFile(str(d / "progress.txt"))
        progress.step(3, 10)
        progress.close()
    for f in ("m.ply", "m.obj", "a.json", "a.npy", "i.png", "g.png", "s.png",
              "progress.txt"):
        assert filecmp.cmp(tmp_path / "j" / f, tmp_path / "t" / f,
                           shallow=False), f


def test_schedule_and_config_match_jax(tmp_path):
    from youreditableavatar_tpu.utils import config as jcfg, schedule as jsch
    from youreditableavatar_tpu_torch.utils import config as tcfg, schedule as tsch

    for spec in (0.3, 7, [0, 0.98, 0.5, 5000], [100, 1.0, 0.0, 300],
                 ["epoch", 0, 0.0, 1.0, 10]):
        for epoch, step in ((0, 0), (3, 150), (5, 2500), (20, 9000)):
            assert tsch.C(spec, epoch, step) == jsch.C(spec, epoch, step)

    @dataclasses.dataclass
    class Inner:
        lr: float = 0.1
        steps: int = 10
        names: list = dataclasses.field(default_factory=list)

    @dataclasses.dataclass
    class Outer:
        inner: Inner = dataclasses.field(default_factory=Inner)
        flag: bool = False
        weight: float = 1.0

    raw = {"inner": {"lr": "0.5", "steps": 3, "names": ["a"]}, "flag": "yes",
           "weight": [0, 1.0, 0.1, 100]}
    assert tcfg.parse_structured(Outer, raw) == jcfg.parse_structured(Outer, raw)
    with pytest.raises(KeyError):
        tcfg.parse_structured(Outer, {"nope": 1})
    dots = ["inner.lr=0.25", "flag=true", "name=run", "weight=[0, 1, 2, 3]"]
    assert tcfg.apply_dotlist({"inner": {}}, dots) == \
        jcfg.apply_dotlist({"inner": {}}, dots)
    path = tmp_path / "exp.yaml"
    path.write_text("name: demo\nseed: 3\nsystem:\n  lr: 0.1\n")
    a = tcfg.load_config(str(path), ["tag=x", "system.lr=0.2"])
    b = jcfg.load_config(str(path), ["tag=x", "system.lr=0.2"])
    assert tcfg.to_dict(a) == jcfg.to_dict(b) and a.trial_dir == b.trial_dir


def test_entry_points_of_the_edit_stage_default_to_cuda(scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from youreditableavatar_tpu_torch.models.tetgs_edit import build_edit_tetgs
    from youreditableavatar_tpu_torch.models.textured_mesh import (
        TexturedMeshModel,
    )

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_edit_tetgs(scene["edit_verts"], scene["edit_faces"], scene["keep"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TexturedMeshModel(scene["verts"], scene["faces"], scene["editable_verts"])
