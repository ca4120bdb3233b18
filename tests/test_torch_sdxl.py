"""PyTorch port vs the JAX package: the SDXL + ControlNet-Union guidance —
`guidance/sdxl_controlnet.py`, `sdxl_pipeline.py` — and the texture edit
(`InpaintTrainer`, `prepare_refine_guidance(upscale_to_2048=True)`) on the
tiny random-weight SDXL pipeline.

Weights come from the JAX package's inits (with every zero-initialised
ControlNet weight randomized, so the controls act) and are carried to the
port as numpy. Every random draw — the VAE's posterior sample, the
initial noise, each pinned step's noise, per crop and per view — is made
here with the JAX code's own `jax.random` calls and handed to the port
through `draws(name, shape)`.

Tolerances: the ControlNet residuals 1e-5 of the largest entry (f32,
another summation order); the pipelines' images, after a VAE encode,
several ControlNet + UNet steps and a decode, 1e-4 of their largest entry
(1e-5 observed); the converter exactly. The texture stage as
`test_torch_edit_texture.py` holds it: the first view's fit loss 1e-5
relative, later views 5e-3 (the Adam drift), the blend images 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_edit_texture import (
    CPU,
    _cams,
    _jcfgs,
    _mesh_models,
    _tcfgs,
    scene,  # noqa: F401  (fixture)
)
from test_torch_sd import (
    T,
    TrackingDict,
    _synth,
    assert_close,
    assert_trees_equal,
    carry,
    np_tree,
)
from torch_port_helpers import single_threaded_torch  # noqa: F401  (fixture)

from youreditableavatar_tpu.guidance import manifests as jm
from youreditableavatar_tpu.guidance import sdxl_controlnet as jcn
from youreditableavatar_tpu.guidance import sdxl_pipeline as jp
from youreditableavatar_tpu_torch.guidance import clip_text as tc
from youreditableavatar_tpu_torch.guidance import sd15 as t15
from youreditableavatar_tpu_torch.guidance import sd_unet as tu
from youreditableavatar_tpu_torch.guidance import sdxl_controlnet as tcn
from youreditableavatar_tpu_torch.guidance import sdxl_pipeline as tp

IMAGE_RTOL_OF_MAX = 1e-4


def _randomize_zero_inits(p, seed=3):
    """The ControlNet tree with every zero-initialised weight (task
    embedding, conditioning conv_out, zero convs) drawn at random."""
    rng = np.random.default_rng(seed)

    def rand_like(a):
        return jnp.asarray(rng.normal(0, 0.05, np.shape(a)).astype(np.float32))

    p = dict(p)
    p["task_emb"] = rand_like(p["task_emb"])
    p["cond_embed"] = dict(p["cond_embed"], conv_out={
        k: rand_like(v) for k, v in p["cond_embed"]["conv_out"].items()})
    p["zero_convs"] = [{k: rand_like(v) for k, v in zc.items()}
                       for zc in p["zero_convs"]]
    p["mid_zero"] = {k: rand_like(v) for k, v in p["mid_zero"].items()}
    return p


# ---- ControlNet-Union -------------------------------------------------------


@pytest.fixture(scope="module")
def union():
    pj = _randomize_zero_inits(jcn.init_controlnet_union_params(
        jax.random.PRNGKey(11), jcn.TEST_CONTROLNET_UNION))
    return pj, tcn.controlnet_params_from_numpy(np_tree(pj))


def _union_both(pj, pt, batch, controls, scale=1.0, seed=7):
    rng = np.random.default_rng(seed)
    u = jcn.TEST_CONTROLNET_UNION.unet
    z = rng.normal(size=(batch, 8, 8, 4)).astype(np.float32)
    t = np.asarray([42] * batch, np.int32)
    ctx = rng.normal(size=(batch, 6, u.ctx_dim)).astype(np.float32)
    add = (rng.normal(size=(batch, u.pooled_dim)).astype(np.float32),
           rng.normal(size=(batch, 6)).astype(np.float32))
    ref = jcn.apply_controlnet_union(
        pj, z, t, ctx, [(i, jnp.asarray(im)) for i, im in controls],
        jcn.TEST_CONTROLNET_UNION, add, conditioning_scale=scale)
    got = tcn.apply_controlnet_union(
        pt, T(z), T(t), T(ctx), [(i, T(im)) for i, im in controls],
        tcn.TEST_CONTROLNET_UNION, tuple(T(a) for a in add),
        conditioning_scale=scale)
    return ref, got


@pytest.mark.parametrize("batch,n_controls", [(1, 2), (2, 2), (1, 1)])
def test_controlnet_union_matches_jax(union, batch, n_controls):
    rng = np.random.default_rng(5)
    controls = [(c, rng.uniform(0, 1, (batch, 16, 16, 3)).astype(np.float32))
                for c in (jp.CTRL_NORMAL, jp.CTRL_REPAINT)[:n_controls]]
    (dj, mj), (dt, mt) = _union_both(*union, batch, controls, scale=0.75)
    assert len(dt) == len(dj) == 4
    for a, b in zip(dt, dj):
        assert_close(a, b)
    assert_close(mt, mj)


def test_fuser_attends_across_the_batch(union):
    """The vendored fuser's attention runs over the batch axis: with batch
    2, changing sample 0's control changes sample 1's residuals, in the
    port as in JAX."""
    rng = np.random.default_rng(8)
    c1 = rng.uniform(0, 1, (2, 16, 16, 3)).astype(np.float32)
    c2 = c1.copy()
    c2[0] += 0.5
    (dj1, _), (dt1, _) = _union_both(*union, 2, [(jp.CTRL_NORMAL, c1)])
    (dj2, _), (dt2, _) = _union_both(*union, 2, [(jp.CTRL_NORMAL, c2)])
    port_shift = float((dt1[0][1] - dt2[0][1]).abs().max())
    jax_shift = float(jnp.abs(dj1[0][1] - dj2[0][1]).max())
    assert port_shift > 1e-5 and jax_shift > 1e-5
    np.testing.assert_allclose(port_shift, jax_shift, rtol=1e-3)


def test_zero_init_leaves_the_unet_unchanged():
    gen = torch.Generator().manual_seed(0)
    cn = tcn.init_controlnet_union_params(gen, tcn.TEST_CONTROLNET_UNION)
    un = tu.init_unet_params(gen, tu.TEST_SDXL_UNET)
    z = torch.randn((1, 8, 8, 4), generator=gen)
    t = torch.tensor([42])
    ctx = torch.randn((1, 6, 32), generator=gen)
    add = (torch.zeros((1, 32)), torch.zeros((1, 6)))
    down, mid = tcn.apply_controlnet_union(
        cn, z, t, ctx, [(jp.CTRL_NORMAL, torch.rand((1, 16, 16, 3)))],
        tcn.TEST_CONTROLNET_UNION, add)
    assert all(float(r.abs().max()) == 0.0 for r in down + [mid])
    np.testing.assert_array_equal(
        tu.apply_unet(un, z, t, ctx, tu.TEST_SDXL_UNET, add).numpy(),
        tu.apply_unet(un, z, t, ctx, tu.TEST_SDXL_UNET, add,
                      (down, mid)).numpy())


def test_controlnet_converter_tree_equals_jax_and_reads_every_key():
    sd = TrackingDict(_synth(jm.controlnet_union_manifest(
        jcn.TEST_CONTROLNET_UNION), seed=2))
    got = tcn.convert_torch_controlnet_union(sd)
    assert sd.accessed == set(sd), sorted(set(sd) - sd.accessed)[:5]
    assert_trees_equal(got, np_tree(jcn.convert_torch_controlnet_union(
        dict(sd))))


# ---- the pipeline -----------------------------------------------------------


def jax_draws(key):
    """`draws(name, shape)` reproducing one JAX inpaint / img2img call's
    draws from `key`: the encode from the first split, the initial noise
    from the second, pinned step i from fold_in(second, i)."""
    k_enc, k_noise = jax.random.split(key)

    def draws(name, shape):
        if name == "encode":
            k = k_enc
        elif name == "noise":
            k = k_noise
        else:
            k = jax.random.fold_in(k_noise, int(name.split("/")[1]))
        return T(jax.random.normal(k, shape, jnp.float32))

    return draws


def crop_draws(key):
    """`sdxl_tile_refine`'s crop q draws from fold_in(key, q)."""
    def draws(name, shape):
        crop, rest = name.split("/", 1)
        return jax_draws(jax.random.fold_in(key, int(crop[4:])))(rest, shape)

    return draws


@pytest.fixture(scope="module")
def pipes():
    """The JAX tiny pipeline (ControlNet zero inits randomized) and the
    port's on the same weights and text projections."""
    jpipe = jp.SDXLControlNetUnionPipeline.random_init(jax.random.PRNGKey(0))
    jpipe.controlnet_params = _randomize_zero_inits(jpipe.controlnet_params)
    jte = jpipe.text_encoder
    clip = t15.CLIPPromptEncoder(tc.clip_params_from_numpy(np_tree(
        jte.clip.params)), tc.TEST_CLIP, device=CPU)
    text = tp._ProjectedTextEncoder(clip, tu.TEST_SDXL_UNET,
                                    ctx_proj=np.array(jte.ctx_proj),
                                    pool_proj=np.array(jte.pool_proj))
    tpipe = tp.SDXLControlNetUnionPipeline(
        carry(jpipe.unet_params), carry(jpipe.vae_params),
        carry(jpipe.controlnet_params), text, tp.TEST_SDXL_PIPELINE,
        device=CPU)
    return jpipe, tpipe


def test_text_encoding_matches_jax(pipes):
    jpipe, tpipe = pipes
    for a, b in zip(tpipe.text_encoder.encode_with_pooled(["a red jacket"]),
                    jpipe.text_encoder.encode_with_pooled(["a red jacket"])):
        assert_close(a, b)


def _mask(kind):
    if kind == "half":
        m = np.zeros((16, 16), np.float32)
        m[:, 8:] = 1.0
        return m
    # Odd columns only: a half-pixel-centre nearest resize to 8 × 8 takes
    # column 2j + 1 (all painted), mode="nearest" would take 2j (none).
    m = np.zeros((16, 16), np.float32)
    m[:, 1::2] = 1.0
    exact = F.interpolate(T(m)[None, None], size=(8, 8), mode="nearest-exact")
    floor = F.interpolate(T(m)[None, None], size=(8, 8), mode="nearest")
    assert float(exact.min()) == 1.0 and float(floor.max()) == 0.0
    return m


@pytest.mark.parametrize("mask_kind,strength", [("half", 1.0),
                                                ("odd_columns", 0.7)])
def test_inpaint_matches_jax(pipes, mask_kind, strength):
    jpipe, tpipe = pipes
    rng = np.random.default_rng(3)
    img, normal = (rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
                   for _ in range(2))
    mask = _mask(mask_kind)
    key = jax.random.PRNGKey(3)
    ref = jpipe.inpaint(img, mask, normal, img, "a red jacket", key=key,
                        strength=strength, steps=3)
    got = tpipe.inpaint(img, mask, normal, img, "a red jacket",
                        strength=strength, steps=3, draws=jax_draws(key))
    assert got.shape == (16, 16, 3)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    assert_close(got, ref, IMAGE_RTOL_OF_MAX)
    if mask_kind == "half":  # the unmasked half stays near the original
        assert float((got[:, :8] - T(img)[:, :8]).abs().mean()) < 0.5


def test_img2img_matches_jax(pipes):
    jpipe, tpipe = pipes
    img = np.random.default_rng(5).uniform(0, 1, (16, 16, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    assert list(tpipe._timesteps(4, 0.3)) == list(jpipe._timesteps(4, 0.3))
    ref = jpipe.img2img(img, img, "clean texture", key=key, strength=0.3,
                        steps=4)
    got = tpipe.img2img(img, img, "clean texture", strength=0.3, steps=4,
                        draws=jax_draws(key))
    assert_close(got, ref, IMAGE_RTOL_OF_MAX)


def test_tile_refine_upscale_matches_jax(pipes):
    jpipe, tpipe = pipes
    img = np.random.default_rng(6).uniform(0, 1, (16, 16, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    ref = jp.sdxl_tile_refine(jpipe, jnp.asarray(img), "texture", key,
                              strength=0.3, steps=2, upscale_to_2048=True)
    got = tp.sdxl_tile_refine(tpipe, T(img), "texture", None, strength=0.3,
                              steps=2, upscale_to_2048=True,
                              draws=crop_draws(key))
    assert got.shape == (32, 32, 3)
    assert_close(got, ref, IMAGE_RTOL_OF_MAX)


def test_generator_draws_repeat():
    """Without draws the pipeline draws from the generator: one seed, one
    result."""
    pipe = tp.SDXLControlNetUnionPipeline.random_init(
        torch.Generator().manual_seed(0), device=CPU)
    img = torch.rand((16, 16, 3), generator=torch.Generator().manual_seed(1))
    a, b, c = (pipe.img2img(img, img, "p", torch.Generator().manual_seed(s),
                            strength=0.5, steps=2) for s in (4, 4, 5))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float((a - c).abs().max()) > 0


# ---- the texture edit on the tiny SDXL ------------------------------------


@pytest.fixture(scope="module")
def sdxl_stage(scene, pipes):  # noqa: F811
    """InpaintTrainer (3 ring views, ladder 3/2/2, 4 inpaint steps) and
    prepare_refine_guidance(upscale_to_2048=True) on 2 turntable views,
    through both packages on the same tiny pipeline; the port's draws
    come from the JAX stage's keys (one split per call, in call order)."""
    from youreditableavatar_tpu.models import cameras as jc
    from youreditableavatar_tpu.stages import edit_texture as js
    from youreditableavatar_tpu_torch.models import cameras as tcam
    from youreditableavatar_tpu_torch.stages import edit_texture as ts

    jpipe, tpipe = pipes
    mj, mt = _mesh_models(scene)
    kw = dict(iters_first=3, iters_second=2, iters_rest=2, first_group=1,
              second_group=1, fb_res=32, inpaint_steps=4)
    ring, turn = (0.0, 180.0, 90.0), (0.0, 120.0)
    key = jax.random.PRNGKey(0)
    guid_j, guid_t = [], []

    class JLogged(jp.SDXLControlNetUnionPipeline):
        def inpaint(self, *a, **k):
            out = super().inpaint(*a, **k)
            guid_j.append(np.asarray(out))
            return out

    # The JAX stage's inpaint keys, in call order: the joint front/back
    # call, then view 2 (views 0 and 1 take the joint result).
    key, k_fb = jax.random.split(key)
    call_keys = [k_fb]
    for _ in ring:
        key, k_inp = jax.random.split(key)
        call_keys.append(k_inp)
    call_keys = [call_keys[0], call_keys[3]]

    class TInjected(tp.SDXLControlNetUnionPipeline):
        def inpaint(self, *a, **k):
            k["draws"] = jax_draws(call_keys[len(guid_t)])
            out = super().inpaint(*a, **k)
            guid_t.append(out.numpy())
            return out

    jlog = JLogged.__new__(JLogged)
    jlog.__dict__.update(jpipe.__dict__)
    tinj = TInjected.__new__(TInjected)
    tinj.__dict__.update(tpipe.__dict__)
    ji = js.InpaintTrainer(scene["ebj"], scene["epj"], mj, _cams(jc, ring),
                           jlog, "a red hat", "bad",
                           js.InpaintConfig(raster=_jcfgs()[0], **kw))
    ti = ts.InpaintTrainer(scene["ebt"], scene["ept"].copy(), mt,
                           _cams(tcam, ring), tinj, "a red hat", "bad",
                           ts.InpaintConfig(raster=_tcfgs()[0], **kw),
                           device=CPU)
    pin_j = ji.inpaint_training(jax.random.PRNGKey(0))
    pin_t = ti.inpaint_training()

    rkey = jax.random.PRNGKey(1)
    view_keys = []
    for _ in turn:
        rkey, k = jax.random.split(rkey)
        view_keys.append(k)

    def view_draws(name, shape):
        view, rest = name.split("/", 1)
        return crop_draws(view_keys[int(view[4:])])(rest, shape)

    blends_j = ji.prepare_refine_guidance(_cams(jc, turn),
                                          jax.random.PRNGKey(1),
                                          upscale_to_2048=True)
    blends_t = ti.prepare_refine_guidance(_cams(tcam, turn),
                                          upscale_to_2048=True,
                                          draws=view_draws)
    return dict(ji=ji, ti=ti, mj=mj, mt=mt, pin_j=pin_j, pin_t=pin_t,
                start=scene["ept"], guid_j=guid_j, guid_t=guid_t, blends_j=blends_j,
                blends_t=blends_t)


def test_inpaint_training_on_sdxl_follows_jax(sdxl_stage):
    st = sdxl_stage
    assert len(st["guid_t"]) == len(st["guid_j"]) == 2
    assert st["guid_t"][0].shape == (32, 64, 3)  # the joint front|back
    for a, b in zip(st["guid_t"], st["guid_j"]):
        assert_close(a, b, IMAGE_RTOL_OF_MAX)
    lj = [h["loss"] for h in st["ji"].history]
    lt = [h["loss"] for h in st["ti"].history]
    assert [h["iters"] for h in st["ti"].history] == [3, 2, 2]
    np.testing.assert_allclose(lt[0], lj[0], rtol=1e-5)
    np.testing.assert_allclose(lt, lj, rtol=5e-3)
    np.testing.assert_array_equal(st["mt"].painted, st["mj"].painted)
    assert st["mt"].painted.sum() > 0
    # Untrained leaves stay put; trained ones moved on both sides.
    for k in ("delta", "log_scales", "quats"):
        np.testing.assert_array_equal(getattr(st["pin_t"], k).detach().numpy(),
                                      np.asarray(getattr(st["pin_j"], k)))
    for k in ("opacity_raw", "sh_dc"):
        start = np.asarray(getattr(st["start"], k).detach())
        for got in (getattr(st["pin_t"], k).detach().numpy(),
                    np.asarray(getattr(st["pin_j"], k))):
            assert np.abs(got - start).max() > 1e-3, k


def test_refine_guidance_upscale_on_sdxl_follows_jax(sdxl_stage):
    """The 2×2-crop refine of each view's 2× upscale, resized back: the
    render's shape, in [0, 1], within 5e-3 of the JAX stage's."""
    bj, bt = sdxl_stage["blends_j"], sdxl_stage["blends_t"]
    assert len(bt) == len(bj) == 2
    for a, b in zip(bt, bj):
        assert a.shape == b.shape == (64, 64, 3) and a.dtype == np.float32
        assert np.isfinite(a).all() and 0 <= a.min() and a.max() <= 1
        assert np.abs(a - b).max() <= 5e-3
