"""PyTorch port vs the JAX package: the field, the guidance and the spatial
stage (shape init + SDS geometry edit).

The same numpy inputs and carried weights go through both packages at the
sizes of `tests/test_spatial.py` (4 levels × 2^13, grid 10, 64² images).
The trainers' draws — pool seed and indices, SDS timestep and noise, recon
indices — are recomputed here with the JAX package's own `jax.random`
calls and handed to the port through its one seam per trainer
(`ShapeInitializer.draw`, `HumanEditTrainer.draws`).

Tolerances: field values 1e-6 (absolute, after carrying the weights);
first-step losses and each aux term 1e-5 relative — except normal
consistency, whose 2 − |a+b|²/2 cancels to ~0.017 from terms near 2, so it
is held to 1e-6 absolute (a few f32 ulps of 2); later steps within the Adam
drift of ROADMAP §3 (AdamW eps 1e-15 turns summation-order noise in
near-zero gradients into full-size steps): 2e-3 relative, or 1e-7 absolute
for the recon and control terms, which start from zero; parameters within
two learning-rate steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port_helpers import (
    carry_params,
    partitions,
    single_threaded_torch,  # noqa: F401  (fixture)
    small_fields,
    small_geometries,
    to_numpy_tree,
)

from youreditableavatar_tpu.data import camera_sampler as jcs
from youreditableavatar_tpu.guidance import prompts as jpr
from youreditableavatar_tpu.guidance import sds as jsds
from youreditableavatar_tpu.guidance import stub as jstub
from youreditableavatar_tpu.stages import export as jex
from youreditableavatar_tpu.stages import spatial as jsp
from youreditableavatar_tpu_torch.data import camera_sampler as tcs
from youreditableavatar_tpu_torch.guidance import prompts as tpr
from youreditableavatar_tpu_torch.guidance import sds as tsds
from youreditableavatar_tpu_torch.guidance import stub as tstub
from youreditableavatar_tpu_torch.stages import export as tex
from youreditableavatar_tpu_torch.stages import spatial as tsp

CAM = dict(height=64, width=64, camera_distance_range=(1.6, 1.8),
           elevation_range=(-5, 10), fovy_range=(40, 45))
DRIFT_RTOL = 2e-3
DRIFT_ATOL = 1e-7
NC_ATOL = 1e-6


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _priors():
    jp = jstub.StubDiffusionPrior()
    tp = tstub.stub_prior_from_numpy(
        {k: np.asarray(getattr(jp, k)) for k in ("_w1", "_w2", "_cond_proj")},
        device="cpu")
    return jp, tp


def _prompts(tmp_path, text="a red jacket"):
    jp = jpr.PromptProcessor(text, "low quality", jstub.StubPromptEncoder(),
                             cache_dir=str(tmp_path / "jax"), model_name="stub")
    tp = tpr.PromptProcessor(text, "low quality",
                             tstub.StubPromptEncoder(device="cpu"),
                             cache_dir=str(tmp_path / "torch"),
                             model_name="stub")
    return jp, tp


# ---- field ------------------------------------------------------------


class TestField:
    def test_mlp(self):
        from youreditableavatar_tpu.models import mlp as jm
        from youreditableavatar_tpu_torch.models import mlp as tm
        from youreditableavatar_tpu_torch.models.sdf import sdf_params_from_numpy

        cfg = jm.MLPConfig(dim_in=16, n_neurons=32, n_hidden_layers=2)
        jp = jm.init_mlp_params(jax.random.PRNGKey(0), cfg)
        tp = sdf_params_from_numpy({"grid": np.zeros((1, 64, 2)),
                                    "mlp": to_numpy_tree(jp)}, "cpu").mlp
        x = np.random.default_rng(0).normal(size=(50, 16)).astype(np.float32)
        for act in ("relu", "gelu", "softplus"):
            np.testing.assert_allclose(
                tm.mlp_apply(tp, torch.tensor(x), act).detach().numpy(),
                np.asarray(jm.mlp_apply(jp, jnp.asarray(x), act)),
                rtol=1e-5, atol=1e-6, err_msg=act)

    def test_sphere_init(self):
        from youreditableavatar_tpu_torch.models import mlp as tm

        cfg = tm.MLPConfig(dim_in=16, n_neurons=64, sphere_init=True,
                           sphere_init_radius=0.5)
        p = tm.init_mlp_params(torch.Generator().manual_seed(0), cfg)
        x = torch.tensor(np.random.default_rng(0).normal(size=(256, 16)) * 0.3,
                         dtype=torch.float32)
        out = tm.mlp_apply(p, x)[:, 0].detach().numpy()
        r = np.linalg.norm(x.numpy()[:, :3], axis=-1)
        assert np.corrcoef(out, r - 0.5)[0, 1] > 0.9
        assert float(p[0].w.detach()[3:].abs().max()) == 0.0

    @pytest.mark.parametrize("normal_type", ["finite_difference", "analytic"])
    def test_sdf_field(self, normal_type):
        jf, tf = small_fields()
        if normal_type == "analytic":
            jf = type(jf)(dataclasses.replace(jf.cfg, normal_type="analytic"))
            tf = type(tf)(dataclasses.replace(tf.cfg, normal_type="analytic"))
        jp = jf.init_params(jax.random.PRNGKey(1))
        tp = carry_params(jp)
        pts = np.random.default_rng(1).uniform(-0.9, 0.9, (300, 3)).astype(
            np.float32)
        lm = np.asarray(jf.level_mask(0))
        np.testing.assert_array_equal(tf.level_mask(0).numpy(), lm)
        a = np.asarray(jf.forward_sdf(jp, jnp.asarray(pts), jnp.asarray(lm)))
        b = tf.forward_sdf(tp, torch.tensor(pts), torch.tensor(lm))
        np.testing.assert_allclose(b.detach().numpy(), a, rtol=0, atol=1e-6)
        sj, nj = jf.forward_with_normal(jp, jnp.asarray(pts))
        st, nt = tf.forward_with_normal(tp, torch.tensor(pts))
        np.testing.assert_allclose(_np(st), np.asarray(sj), rtol=0, atol=1e-6)
        # FD normals divide 1e-6 value noise by eps = 0.01.
        np.testing.assert_allclose(_np(nt), np.asarray(nj), rtol=0,
                                   atol=1e-3 if normal_type != "analytic"
                                   else 1e-5)

    def test_chunked_matches_direct(self):
        _, tf = small_fields()
        tp = tf.init_params(3, device="cpu")
        pts = torch.tensor(np.random.default_rng(1).uniform(
            -1, 1, (1000, 3)).astype(np.float32))
        a = tf.forward_sdf(tp, pts)
        b = tf.forward_sdf_chunked(tp, pts, chunk=256)
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   atol=1e-6)

    def test_mesh_sdf(self):
        from youreditableavatar_tpu.native import MeshSDF as JM
        from youreditableavatar_tpu_torch.native import MeshSDF as TM

        from chip_smoke import icosphere

        from youreditableavatar_tpu_torch import native

        v, f = icosphere(2, radius=0.6)
        pts = np.random.default_rng(2).uniform(-1, 1, (4000, 3)).astype(np.float32)
        t = TM(v, f)
        assert t.using_native
        # The port builds and loads its own copy, never the JAX tree's .so.
        lib = native._build_library()
        assert lib.parent.name == "_build"
        assert lib.parent.parent.name == "youreditableavatar_tpu_torch"
        np.testing.assert_array_equal(t(pts), JM(v, f)(pts))
        np.testing.assert_allclose(t._numpy_fallback(pts[:200]), t(pts[:200]),
                                   atol=1e-5)

    def test_align_anchor_mesh(self):
        v = np.random.default_rng(0).normal(size=(100, 3)) * 2 + 5
        a, ma = tsp.align_anchor_mesh(v)
        b, mb = jsp.align_anchor_mesh(v)
        np.testing.assert_array_equal(a, b)
        assert ma["scale"] == mb["scale"]


# ---- cameras, prompts, guidance ----------------------------------------


def test_camera_sampler_same_cameras():
    cfg_j = jcs.RandomCameraConfig(batch_size=3, progressive_until=10, **CAM)
    cfg_t = tcs.RandomCameraConfig(batch_size=3, progressive_until=10, **CAM)
    sj, st = jcs.RandomCameraSampler(cfg_j, 5), tcs.RandomCameraSampler(cfg_t, 5)
    for step in (0, 4, 20):
        bj, bt = sj.sample(step), st.sample(step)
        for k in ("elevation_deg", "azimuth_deg", "camera_distances"):
            np.testing.assert_array_equal(getattr(bt, k), getattr(bj, k))
        for cj, ct in zip(bj.local + bj.global_, bt.local + bt.global_):
            np.testing.assert_array_equal(ct.viewmat, cj.viewmat)
            assert (ct.fx, ct.cx, ct.width) == (cj.fx, cj.cx, cj.width)


def test_prompt_processor(tmp_path):
    jp, tp = _prompts(tmp_path)
    np.testing.assert_array_equal(tp.cond, jp.cond)
    np.testing.assert_array_equal(tp.uncond, jp.uncond)
    e = np.array([0.0, 5.0, 70.0, -3.0])
    a = np.array([0.0, 100.0, 10.0, -170.0])
    np.testing.assert_array_equal(tp.direction_index(e, a),
                                  jp.direction_index(e, a))
    for x, y in zip(tp.get_text_embeddings_perp_neg(e, a),
                    jp.get_text_embeddings_perp_neg(e, a)):
        np.testing.assert_array_equal(x, y)


def test_prompt_library(tmp_path):
    from youreditableavatar_tpu.guidance import prompt_library as jl
    from youreditableavatar_tpu_torch.guidance import prompt_library as tl

    lib = tl.build_library({"x": ["a_bald_eagle.mp4", "b_c.png"]})
    assert lib == jl.build_library({"x": ["a_bald_eagle.mp4", "b_c.png"]})
    path = tl.save_library(str(tmp_path / "lib.json"), lib)
    assert tl.load_library(path) == lib
    assert tl.sample_prompts(lib, "dreamfusion", 3, 1) == jl.sample_prompts(
        lib, "dreamfusion", 3, 1)


def _sds_draws(key, min_t, max_t, latent_shape):
    _, k_t, k_noise = jax.random.split(key, 3)
    t = jax.random.randint(k_t, (latent_shape[0],), min_t, max_t + 1)
    noise = jax.random.normal(k_noise, latent_shape, jnp.float32)
    return torch.tensor(np.asarray(t)).long(), torch.tensor(np.asarray(noise))


@pytest.mark.parametrize("perp_neg", [False, True])
def test_sds_losses_and_image_grads(tmp_path, perp_neg):
    jprior, tprior = _priors()
    img = np.random.default_rng(4).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jpp, tpp = _prompts(tmp_path)
    e, a = np.array([5.0, 2.0]), np.array([30.0, 150.0])
    key = jax.random.PRNGKey(9)
    cfg = dict(guidance_scale=7.5, grad_clip=0.5)
    t, noise = _sds_draws(key, 20, 980, (2, 8, 8, 4))
    if perp_neg:
        pos, unc, neg, wts = jpp.get_text_embeddings_perp_neg(e, a)
        jg = jsds.PerpNegSDSGuidance(jprior, jsds.SDSConfig(**cfg))
        tg = tsds.PerpNegSDSGuidance(tprior, tsds.SDSConfig(**cfg))
        jfun = lambda x: jg(x, jnp.asarray(pos), jnp.asarray(unc), key, 20, 980,
                            jnp.asarray(neg), jnp.asarray(wts))
        targs = (torch.tensor(pos), torch.tensor(unc), None, 20, 980,
                 torch.tensor(neg), torch.tensor(wts))
    else:
        cond, unc = jpp.get_text_embeddings(e, a)
        jg = jsds.SDSGuidance(jprior, jsds.SDSConfig(**cfg))
        tg = tsds.SDSGuidance(tprior, tsds.SDSConfig(**cfg))
        jfun = lambda x: jg(x, jnp.asarray(cond), jnp.asarray(unc), key, 20, 980)
        targs = (torch.tensor(cond), torch.tensor(unc), None, 20, 980)
    (lj, outj), gj = jax.value_and_grad(
        lambda x: (jfun(x)["loss_sds"], jfun(x)), has_aux=True)(jnp.asarray(img))
    x = torch.tensor(img, requires_grad=True)
    out = tg(x, *targs, t=t, noise=noise)
    out["loss_sds"].backward()
    np.testing.assert_array_equal(out["t"].numpy(), np.asarray(outj["t"]))
    np.testing.assert_allclose(float(out["loss_sds"].detach()), float(lj),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["grad_norm"]), float(outj["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-7)


def test_stub_prior_decode_and_edit():
    jprior, tprior = _priors()
    lat = np.random.default_rng(5).normal(size=(1, 4, 5, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tprior.decode_latents(torch.tensor(lat)).numpy(),
        np.asarray(jprior.decode_latents(jnp.asarray(lat))), atol=1e-6)
    emb = np.random.default_rng(6).normal(size=(1, 8, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tprior.edit_latents(torch.tensor(lat), 300, torch.tensor(emb),
                            torch.tensor(emb * 0.5)).numpy(),
        np.asarray(jprior.edit_latents(jnp.asarray(lat), 300, jnp.asarray(emb),
                                       jnp.asarray(emb * 0.5), None)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tprior.alphas_cumprod.numpy(),
                                  np.asarray(jprior.alphas_cumprod))


# ---- optimizers and schedules ------------------------------------------


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "adagrad",
                                  "rmsprop", "lion"])
def test_parse_optimizer_matches_optax(name):
    from youreditableavatar_tpu.utils.optim import parse_optimizer as jpo
    from youreditableavatar_tpu_torch.utils.optim import parse_optimizer as tpo

    rng = np.random.default_rng(7)
    p0 = rng.normal(size=(40,)).astype(np.float32)
    grads = [rng.normal(size=(40,)).astype(np.float32) for _ in range(3)]
    tx = jpo(name, 1e-2, (0.9, 0.99), 1e-8)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    p = torch.nn.Parameter(torch.tensor(p0))
    opt = tpo(name, 1e-2, (0.9, 0.99), 1e-8)([p])
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
        p.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(pj), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("name", ["constant", "exponential", "cosine", "linear"])
def test_parse_scheduler_matches_optax(name):
    from youreditableavatar_tpu.utils.optim import parse_scheduler as jps
    from youreditableavatar_tpu_torch.utils.optim import parse_scheduler as tps

    js, ts = jps(name, 0.1, 10), tps(name, 0.1, 10)
    for step in (0, 1, 3, 10, 12):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6)
    with pytest.raises(ValueError):
        tps("nope", 0.1, 10)


# ---- exports ------------------------------------------------------------


def test_export_round_trips(tmp_path):
    jg, tg, jp, tp = small_geometries()
    jpart, tpart, _ = partitions(jg, tg, jp, tp)
    ju = jg.part_isosurface(jp, jpart)
    tu = tg.part_isosurface(tp, tpart)
    pairs = [
        (jex.export_init_mesh(str(tmp_path / "ji.npy"), jg.isosurface(jp)),
         tex.export_init_mesh(str(tmp_path / "ti.npy"), tg.isosurface(tp)),
         tex.load_init_mesh(str(tmp_path / "ti.npy"))),
        (jex.export_edit_mesh(str(tmp_path / "je.npy"), jpart.keep_mesh, ju),
         tex.export_edit_mesh(str(tmp_path / "te.npy"), tpart.keep_mesh, tu),
         tex.load_edit_mesh(str(tmp_path / "te.npy"))),
    ]
    for dj, dt, loaded in pairs:
        assert set(dt["mesh"]) == set(dj["mesh"]) == set(loaded)
        for k, v in dj["mesh"].items():
            if k == "vertices":
                np.testing.assert_allclose(dt["mesh"][k], v, atol=1e-6)
            else:
                np.testing.assert_array_equal(dt["mesh"][k], v, err_msg=k)
            np.testing.assert_array_equal(loaded[k], dt["mesh"][k])
    assert loaded["editing_mask"].sum() > 0
    info = tex.export_editing_region_info(str(tmp_path / "r.npy"),
                                          np.array([1, 0, 1]), np.array([1.0, 0.0]))
    back = tex.load_editing_region_info(str(tmp_path / "r.npy"))
    np.testing.assert_array_equal(back["editing_mask"], info["editing_mask"])
    faces = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [7, 8, 9]])
    np.testing.assert_array_equal(tex.remove_floaters(np.zeros((10, 3)), faces, 0.3),
                                  jex.remove_floaters(np.zeros((10, 3)), faces, 0.3))


# ---- the trainers --------------------------------------------------------


def _gt_sphere_mesh():
    from youreditableavatar_tpu.ops.marching_tets import (
        make_tet_grid, marching_tets)

    gv, gt = make_tet_grid(10)
    pos = jnp.asarray(gv)
    mt = marching_tets(pos, jnp.linalg.norm(pos, axis=-1) - 0.35,
                       jnp.asarray(gt), 2048, 4096)
    nv, nf = int(mt.num_verts), int(mt.num_faces)
    return (np.asarray(mt.verts)[:nv],
            np.asarray(mt.faces)[np.asarray(mt.faces_valid)][:nf])


def _mesh_cfgs():
    from youreditableavatar_tpu.ops.mesh_raster import MeshRasterConfig as J
    from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig as T

    return (J(pair_budget=1 << 14, tile_capacity=1024, backend="xla"),
            T(pair_budget=1 << 14))


def _assert_params_near(tp, jparams, lr_steps):
    """Parameters within `lr_steps` Adam steps of each other."""
    jt = to_numpy_tree(jparams)
    pairs = [(tp.grid, jt["grid"])] + [
        (getattr(l, k), jt["mlp"][i][k]) for i, l in enumerate(tp.mlp)
        for k in ("w", "b")]
    for t, j in pairs:
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=lr_steps)


def test_shape_initializer_follows_jax():
    verts, faces = _gt_sphere_mesh()
    jf, tf = small_fields()
    jg, tg, _, _ = small_geometries()
    kw = dict(sdf_iters=5, sdf_points_per_iter=4096, sdf_pool_size=50_000,
              normal_iters=2, normal_height=64, normal_width=64,
              normal_points_per_iter=4096)
    jcfg = jsp.ShapeInitConfig(camera=jcs.RandomCameraConfig(
        height=64, width=64, camera_distance_range=(1.6, 1.8),
        elevation_range=(-10, 10), fovy_range=(40, 45)), **kw)
    tcfg = tsp.ShapeInitConfig(camera=tcs.RandomCameraConfig(
        height=64, width=64, camera_distance_range=(1.6, 1.8),
        elevation_range=(-10, 10), fovy_range=(40, 45)), **kw)
    jmc, tmc = _mesh_cfgs()
    key = jax.random.PRNGKey(0)
    jparams, jinfo = jsp.ShapeInitializer(jf, jg, jcfg).run(verts, faces, key,
                                                            jmc)

    # The JAX run's draws, recomputed with its own jax.random calls.
    k_init, k_pool, k_train, k_cam = jax.random.split(key, 4)
    pool_seed = int(jax.random.randint(k_pool, (), 0, 2**31 - 1))
    sdf_keys = jax.random.split(k_train, kw["sdf_iters"])
    cam_keys = jax.random.split(k_cam, kw["normal_iters"])

    class Injected(tsp.ShapeInitializer):
        def draw(self, phase, step):
            if phase == "pool":
                return pool_seed
            k = (sdf_keys if phase == "sdf" else cam_keys)[step]
            return torch.tensor(np.asarray(jax.random.randint(
                k, (4096,), 0, kw["sdf_pool_size"]))).long()

    init = Injected(tf, tg, tcfg, device="cpu")
    tparams, tinfo = init.run(verts, faces, 0, tmc,
                              params=carry_params(jf.init_params(k_init)))
    assert init.using_native
    assert len(init.trace["sdf"]) == 5 and len(init.trace["normal"]) == 2
    assert len(tinfo["losses"]) == len(jinfo["losses"]) == 2
    # sdf step 0 from equal weights; normal step 0 after 5 Adam steps.
    np.testing.assert_allclose(tinfo["losses"][0], jinfo["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(tinfo["losses"][1], jinfo["losses"][1],
                               rtol=DRIFT_RTOL)
    _assert_params_near(tparams, jparams, 2 * (5 * 1e-3 + 2 * 5e-5))


@pytest.fixture(scope="module")
def edit_pair(tmp_path_factory):
    """Both trainers, 4 steps across start_sdf_loss_step = 2, logging every
    step, the port's draws injected from the JAX trainer's keys."""
    tmp = tmp_path_factory.mktemp("prompts")
    jg, tg, jp, tp = small_geometries()
    jpart, tpart, _ = partitions(jg, tg, jp, tp)
    jprior, tprior = _priors()
    jpp, tpp = _prompts(tmp)
    kw = dict(max_steps=4, recon_points=2048, start_sdf_loss_step=2,
              log_every=1)
    jcfg = jsp.HumanEditConfig(camera=jcs.RandomCameraConfig(**CAM), **kw)
    tcfg = tsp.HumanEditConfig(camera=tcs.RandomCameraConfig(**CAM), **kw)
    jmc, tmc = _mesh_cfgs()
    jt = jsp.HumanEditTrainer(
        jg.field, jg, jpart, jp,
        jsds.SDSGuidance(jprior, jsds.SDSConfig(guidance_scale=7.5)),
        jpp, jpp, jcfg, jmc)
    key = jax.random.PRNGKey(1)
    jt.train(key, num_steps=4)
    nv = int(tg.grid_pos.shape[0])
    guidance = tsds.SDSGuidance(tprior, tsds.SDSConfig(guidance_scale=7.5))

    class Injected(tsp.HumanEditTrainer):
        def draws(self, seed, step):
            key_sds, key_pts = jax.random.split(jax.random.fold_in(key, step))
            t, noise = _sds_draws(key_sds, *guidance.timestep_range(0, step),
                                  (1, 8, 8, 4))
            recon = jax.random.randint(key_pts, (2048,), 0, nv)
            return {"t": t, "noise": noise,
                    "recon_idx": torch.tensor(np.asarray(recon)).long()}

    tt = Injected(tg.field, tg, tpart, tp, guidance, tpp, tpp, tcfg, tmc,
                  device="cpu")
    tt.train(0, num_steps=4)
    return jt, tt


class TestHumanEdit:
    def test_first_step(self, edit_pair):
        jt, tt = edit_pair
        rj, rt = jt.metrics[0], tt.metrics[0]
        assert set(rt) == set(rj)
        for k in rj:
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5,
                                       atol=NC_ATOL if k == "nc" else 1e-9,
                                       err_msg=k)
        assert rt["sds"] > 0 and rt["nc"] > 0 and rt["mesh_pairs"] > 0

    def test_later_steps_and_params(self, edit_pair):
        jt, tt = edit_pair
        assert tt.global_step == jt.global_step == 4
        assert [m["step"] for m in tt.metrics] == [0, 1, 2, 3]
        for rj, rt in zip(jt.metrics[1:], tt.metrics[1:]):
            for k in rj:
                np.testing.assert_allclose(rt[k], rj[k], rtol=DRIFT_RTOL,
                                           atol=DRIFT_ATOL,
                                           err_msg=f"{rj['step']} {k}")
        # The control term engages at start_sdf_loss_step.
        assert tt.metrics[1]["control"] == 0.0 and tt.control_sdf is not None
        np.testing.assert_allclose(_np(tt.control_sdf), np.asarray(jt.control_sdf),
                                   atol=1e-4)
        _assert_params_near(tt.params, jt.params, 2 * 4 * 2e-5)
        moved = float((tt.params.grid.detach() - tt.frozen_params.grid).abs().sum())
        assert np.isfinite(moved) and moved > 0

    def test_selection_cache(self, edit_pair):
        jt, tt = edit_pair
        np.testing.assert_allclose(_np(tt._sdf_cache), np.asarray(jt._sdf_cache),
                                   atol=1e-4)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card default")
    from youreditableavatar_tpu_torch.models.geometry import TetGeometry
    from youreditableavatar_tpu_torch.models.mesh import Mesh
    from youreditableavatar_tpu_torch.models.sdf import sdf_params_from_numpy
    from youreditableavatar_tpu_torch.ops.lpips import LPIPS
    from youreditableavatar_tpu_torch.ops.shape_loss import ShapeLoss
    from youreditableavatar_tpu_torch.stages.localization import (
        HeuristicSegmenter, LocalMeshEditing)

    tet = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    faces = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])

    _, tf = small_fields()
    cam = tcs.RandomCameraSampler(tcs.RandomCameraConfig(**CAM)).sample()
    calls = [
        lambda: tf.init_params(0),
        lambda: TetGeometry(tf, 4),
        lambda: tstub.StubDiffusionPrior(),
        lambda: tsp.ShapeInitializer(tf, None),
        lambda: cam.local[0].raster_camera(),
        lambda: sdf_params_from_numpy({"grid": np.zeros((1, 64, 2)), "mlp": []}),
        lambda: LPIPS(),
        lambda: ShapeLoss(tet, faces, proximal_surface=0.0),
        lambda: LocalMeshEditing(tet, faces, HeuristicSegmenter()),
        lambda: Mesh(tet, faces).normal_consistency(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_registry_names():
    from youreditableavatar_tpu_torch.utils.registry import find

    assert find("human-init") is tsp.ShapeInitializer
    assert find("human-edit") is tsp.HumanEditTrainer
    from youreditableavatar_tpu_torch.models.sdf import SDFField

    assert find("implicit-sdf") is SDFField
