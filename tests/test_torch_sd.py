"""PyTorch port vs the JAX package: the SD1.5 guidance networks —
`guidance/sd_layers.py`, `sd_unet.py`, `sd_vae.py`, `clip_text.py`,
`sd15.py` — the manifests and the factory, and the spatial stage's SDS and
du edits on the tiny random-weight SD1.5.

Weights are drawn by the JAX package's inits and carried to the port as
numpy (`*_params_from_numpy`); every random draw (the VAE's posterior
sample, the du edit's noise, the trainers' draws) is made here with the
JAX code's own `jax.random` calls and handed to the port.

Tolerances: each block and network 1e-5 of the largest entry of the JAX
output (f32, convolutions and matmuls summed in another order), the
sinusoid features 1e-5 absolute (their arguments reach 999 rad, where one
f32 rounding of the argument is 6e-5 rad; 1.7e-6 observed); the trainers' first step 1e-5 relative
(normal consistency 1e-6 absolute, as `test_torch_spatial.py`), the
second within its Adam drift (2e-3 relative). Converters, manifests and
tokenizer ids are held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    partitions,
    single_threaded_torch,  # noqa: F401  (fixture)
    small_geometries,
)

from youreditableavatar_tpu.guidance import clip_text as jc
from youreditableavatar_tpu.guidance import manifests as jm
from youreditableavatar_tpu.guidance import sd15 as j15
from youreditableavatar_tpu.guidance import sd_layers as jl
from youreditableavatar_tpu.guidance import sd_unet as ju
from youreditableavatar_tpu.guidance import sd_vae as jv
from youreditableavatar_tpu_torch.guidance import clip_text as tc
from youreditableavatar_tpu_torch.guidance import manifests as tm
from youreditableavatar_tpu_torch.guidance import sd15 as t15
from youreditableavatar_tpu_torch.guidance import sd_layers as tl
from youreditableavatar_tpu_torch.guidance import sd_unet as tu
from youreditableavatar_tpu_torch.guidance import sd_vae as tv

RTOL_OF_MAX = 1e-5


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def carry(tree):
    """A JAX parameter tree → the port's (CPU tensors)."""
    return tl.params_from_numpy(np_tree(tree))


def T(x):
    return torch.tensor(np.asarray(x))


def assert_close(got, ref, rtol_of_max=RTOL_OF_MAX, err=""):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (err, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    assert np.abs(got - ref).max() <= rtol_of_max * scale, (
        err, float(np.abs(got - ref).max()), scale)


def assert_trees_equal(got, ref, path="root"):
    """Same structure, and every leaf bit-equal."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), path
        for k in ref:
            assert_trees_equal(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_trees_equal(g, r, f"{path}[{i}]")
    else:
        assert torch.is_tensor(got) and got.dtype == torch.float32, path
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=path)


# ---- sd_layers ----------------------------------------------------------


def _block_case(name):
    """(JAX output, port output) of one sd_layers function on the same
    inputs and carried weights."""
    rng = np.random.default_rng(hash(name) % 2**32)
    key = jax.random.PRNGKey(3)

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)

    if name.startswith("conv"):
        k, s, pad, h = {
            "conv3_same": (3, 1, "SAME", 17),
            "conv3_stride2_sym": (3, 2, ((1, 1), (1, 1)), 16),
            "conv3_stride2_asym": (3, 2, ((0, 1), (0, 1)), 16),
            "conv1_same": (1, 1, "SAME", 9),
            "conv_patch_valid": (4, 4, "VALID", 16),
            "conv3_stride2_same_odd": (3, 2, "SAME", 15),
        }[name]
        x = a(2, h, h, 6)
        p = {"w": a(k, k, 6, 8), "b": a(8)}
        return (jl.conv2d(x, jax.tree_util.tree_map(jnp.asarray, p), s, pad),
                tl.conv2d(T(x), carry(p), s, pad))
    if name == "linear":
        x, p = a(2, 5, 12), {"w": a(12, 7), "b": a(7)}
        return jl.linear(x, p), tl.linear(T(x), carry(p))
    if name in ("group_norm_4d", "group_norm_3d"):
        x = a(2, 5, 7, 16) if name.endswith("4d") else a(2, 9, 16)
        p = {"scale": a(16), "bias": a(16)}
        return (jl.group_norm(x, p, groups=8, eps=1e-6),
                tl.group_norm(T(x), carry(p), groups=8, eps=1e-6))
    if name == "layer_norm":
        x, p = a(3, 4, 24) * 3 + 1, {"scale": a(24), "bias": a(24)}
        return jl.layer_norm(x, p), tl.layer_norm(T(x), carry(p))
    if name == "attention":
        q, k, v = a(2, 6, 16), a(2, 9, 16), a(2, 9, 16)
        return jl.attention(q, k, v, 4), tl.attention(T(q), T(k), T(v), 4)
    if name in ("resnet_temb_shortcut", "resnet_plain"):
        cin, cout = (8, 16) if name == "resnet_temb_shortcut" else (16, 16)
        temb_dim = 12 if name == "resnet_temb_shortcut" else None
        p = jl.init_resnet(key, cin, cout, temb_dim)
        x = a(2, 6, 6, cin)
        temb = a(2, 12) if temb_dim else None
        return (jl.resnet_block(x, temb, p, 4),
                tl.resnet_block(T(x), None if temb is None else T(temb),
                                carry(p), 4))
    if name == "transformer_block":
        p = jl.init_transformer_block(key, 16, 12)
        x, ctx = a(2, 10, 16), a(2, 5, 12)
        return (jl.transformer_block(x, ctx, p, 4),
                tl.transformer_block(T(x), T(ctx), carry(p), 4))
    if name == "spatial_transformer":
        p = jl.init_spatial_transformer(key, 16, 12, depth=2)
        x, ctx = a(2, 4, 5, 16), a(2, 5, 12)
        return (jl.spatial_transformer(x, ctx, p, 4, groups=4),
                tl.spatial_transformer(T(x), T(ctx), carry(p), 4, groups=4))
    if name == "self_attention_2d":
        p = jl.init_self_attention_2d(key, 16)
        x = a(2, 4, 5, 16)
        return (jl.self_attention_2d(x, p, 4, eps=1e-6),
                tl.self_attention_2d(T(x), carry(p), 4, eps=1e-6))
    raise KeyError(name)


BLOCKS = ["conv3_same", "conv3_stride2_sym", "conv3_stride2_asym",
          "conv1_same", "conv_patch_valid", "conv3_stride2_same_odd",
          "linear", "group_norm_4d", "group_norm_3d", "layer_norm",
          "attention", "resnet_temb_shortcut", "resnet_plain",
          "transformer_block", "spatial_transformer", "self_attention_2d"]


@pytest.mark.parametrize("name", BLOCKS)
def test_layer_matches_jax(name):
    ref, got = _block_case(name)
    assert_close(got, ref, err=name)


@pytest.mark.parametrize("flip", [True, False])
def test_timestep_embedding_matches_jax(flip):
    t = np.array([0, 10, 999, 500], np.int32)
    ref = jl.timestep_embedding(jnp.asarray(t), 32, flip=flip)
    got = tl.timestep_embedding(torch.tensor(t), 32, flip=flip)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("fn", ["init_resnet", "init_transformer_block",
                                "init_spatial_transformer",
                                "init_self_attention_2d"])
def test_inits_have_the_jax_tree_and_scales(fn):
    """The port's inits draw from a torch.Generator: the same tree and
    shapes as the JAX inits, zero biases, unit norms, weights of the JAX
    scale (std within 10 % of 1/√fan_in)."""
    args = {"init_resnet": (8, 16, 12), "init_transformer_block": (16, 12),
            "init_spatial_transformer": (16, 12, 2),
            "init_self_attention_2d": (16,)}[fn]
    ref = getattr(jl, fn)(jax.random.PRNGKey(0), *args)
    got = getattr(tl, fn)(torch.Generator().manual_seed(0), *args)
    flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_r] == \
        [jax.tree_util.keystr(p) for p, _ in flat_g]
    for (path, r), (_, g) in zip(flat_r, flat_g):
        key = jax.tree_util.keystr(path)
        assert tuple(g.shape) == r.shape, key
        if key.endswith("['b']") or key.endswith("['bias']"):
            assert float(g.abs().max()) == 0.0, key
        elif key.endswith("['scale']"):
            assert bool((g == 1).all()), key
        elif g.numel() > 500:
            fan_in = int(np.prod(r.shape[:-1]))
            np.testing.assert_allclose(float(g.std()), 1 / np.sqrt(fan_in),
                                       rtol=0.1, err_msg=key)


# ---- UNet -----------------------------------------------------------------


def _unet_inputs(cfg, b=2, hw=16, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(b, hw, hw, 4)).astype(np.float32)
    t = np.array([10, 500, 999, 1][:b], np.int32)
    ctx = rng.normal(size=(b, 8, cfg.ctx_dim)).astype(np.float32)
    add = None
    if cfg.add_embed:
        add = (rng.normal(size=(b, cfg.pooled_dim)).astype(np.float32),
               rng.uniform(0, 1024, (b, 6)).astype(np.float32))
    return z, t, ctx, add


def _residuals(params, z, seed=1):
    """Random ControlNet-style residuals of every skip's shape."""
    rng = np.random.default_rng(seed)
    _, skips, _ = ju.apply_unet_down(params, *z)
    down = [rng.normal(size=s.shape).astype(np.float32) * 0.1 for s in skips]
    h = ju.apply_unet_down(params, *z)[0]
    return down, rng.normal(size=h.shape).astype(np.float32) * 0.1


@pytest.mark.parametrize("which", ["sd15", "sdxl", "sdxl_residuals"])
def test_apply_unet_matches_jax(which):
    cfg_j = ju.TEST_UNET if which == "sd15" else ju.TEST_SDXL_UNET
    cfg_t = tu.TEST_UNET if which == "sd15" else tu.TEST_SDXL_UNET
    params = ju.init_unet_params(jax.random.PRNGKey(1), cfg_j)
    z, t, ctx, add = _unet_inputs(cfg_j)
    res = None
    if which == "sdxl_residuals":
        res = _residuals(params, (z, t, ctx, cfg_j, add))
    ref = ju.apply_unet(params, z, t, ctx, cfg_j, add, res)
    tadd = None if add is None else tuple(T(x) for x in add)
    tres = None if res is None else ([T(r) for r in res[0]], T(res[1]))
    got = tu.apply_unet(tu.unet_params_from_numpy(np_tree(params)), T(z),
                        T(t), T(ctx), cfg_t, tadd, tres)
    assert_close(got, ref)
    if res is not None:  # the residuals move the output
        plain = ju.apply_unet(params, z, t, ctx, cfg_j, add)
        assert float(jnp.abs(plain - ref).max()) > 1e-3


def test_unet_stagewise_split_matches_apply_unet_and_jax():
    """conv_in + per-level down + mid + per-level up + out, composed by
    hand, is apply_unet (bit for bit in the port) and JAX's."""
    cfg = tu.TEST_UNET
    params = ju.init_unet_params(jax.random.PRNGKey(3), ju.TEST_UNET)
    pt = carry(params)
    z, t, ctx, _ = _unet_inputs(cfg, b=1)
    z, t, ctx = T(z), T(t), T(ctx)
    h, temb = tu.apply_unet_conv_in(pt, z, t, cfg)
    skips = [h]
    for lvl in range(len(pt["down"])):
        h, lvl_skips = tu.apply_unet_down_level(pt, lvl, h, temb, ctx, cfg)
        skips.extend(lvl_skips)
    h = tu.apply_unet_mid(pt, h, temb, ctx, cfg)
    for i in range(len(pt["up"])):
        k = len(pt["up"][i]["resnets"])
        h = tu.apply_unet_up_level(pt, i, h, tuple(skips[-k:]), temb, ctx,
                                   cfg)
        del skips[-k:]
    out = tu.apply_unet_out(pt, h, cfg)
    np.testing.assert_array_equal(out.numpy(),
                                  tu.apply_unet(pt, z, t, ctx, cfg).numpy())
    ref = ju.apply_unet(params, z.numpy(), t.numpy(), ctx.numpy(),
                        ju.TEST_UNET)
    assert_close(out, ref)


def test_unet_time_embedding_matches_jax():
    cfg_j, cfg_t = ju.TEST_SDXL_UNET, tu.TEST_SDXL_UNET
    params = ju.init_unet_params(jax.random.PRNGKey(2), cfg_j)
    _, t, _, add = _unet_inputs(cfg_j)
    ref = ju.unet_time_embedding(params, t, cfg_j, add)
    got = tu.unet_time_embedding(carry(params), T(t), cfg_t,
                                 tuple(T(x) for x in add))
    assert_close(got, ref)


def test_init_unet_params_has_the_jax_tree():
    for cj, ct in ((ju.TEST_UNET, tu.TEST_UNET),
                   (ju.TEST_SDXL_UNET, tu.TEST_SDXL_UNET)):
        ref = ju.init_unet_params(jax.random.PRNGKey(0), cj)
        got = tu.init_unet_params(torch.Generator().manual_seed(0), ct)
        assert jax.tree_util.tree_structure(np_tree(ref)) == \
            jax.tree_util.tree_structure(got)
        for r, g in zip(jax.tree_util.tree_leaves(ref),
                        jax.tree_util.tree_leaves(got)):
            assert tuple(g.shape) == r.shape


# ---- VAE ------------------------------------------------------------------


@pytest.fixture(scope="module")
def vae():
    params = jv.init_vae_params(jax.random.PRNGKey(4), jv.TEST_VAE)
    return params, tv.vae_params_from_numpy(np_tree(params))


def test_vae_moments_sample_and_decode_match_jax(vae):
    pj, pt = vae
    img = np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    mj, lj = jv.vae_encode_moments(pj, img, jv.TEST_VAE)
    mt, lt = tv.vae_encode_moments(pt, T(img), tv.TEST_VAE)
    assert_close(mt, mj)
    assert_close(lt, lj)
    key = jax.random.PRNGKey(6)
    zj = jv.vae_encode(pj, img, key, jv.TEST_VAE)
    eps = jax.random.normal(key, mj.shape, mj.dtype)  # vae_encode's draw
    zt = tv.vae_encode(pt, T(img), None, tv.TEST_VAE, noise=T(eps))
    assert_close(zt, zj)
    assert_close(tv.vae_decode(pt, zt, tv.TEST_VAE),
                 jv.vae_decode(pj, zj, jv.TEST_VAE))


def test_vae_encode_is_differentiable(vae):
    pj, pt = vae
    img = np.random.default_rng(7).uniform(0, 1, (1, 16, 16, 3)).astype(
        np.float32)
    gj = jax.grad(lambda x: jnp.sum(
        jv.vae_encode_moments(pj, x, jv.TEST_VAE)[0] ** 2))(img)
    x = T(img).requires_grad_()
    (tv.vae_encode_moments(pt, x, tv.TEST_VAE)[0] ** 2).sum().backward()
    assert_close(x.grad, gj, 1e-4)


# ---- CLIP -----------------------------------------------------------------


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("penultimate", [False, True])
def test_apply_clip_text_matches_jax(act, penultimate):
    import dataclasses

    cj = dataclasses.replace(jc.TEST_CLIP, act=act)
    ct = dataclasses.replace(tc.TEST_CLIP, act=act)
    params = jc.init_clip_text_params(jax.random.PRNGKey(8), cj)
    tokens = np.array([[98, 5, 17, 42, 99, 99, 99, 99],
                       [98, 1, 2, 3, 4, 5, 6, 99]], np.int32)
    ref = jc.apply_clip_text(params, tokens, cj, penultimate)
    got = tc.apply_clip_text(tc.clip_params_from_numpy(np_tree(params)),
                             T(tokens), ct, penultimate)
    assert_close(got, ref)


PROMPTS = ["a red jacket", "", "A Photo of   a man wearing a very long "
           "striped woollen scarf and a hat in the snow", "x" * 40]


@pytest.mark.parametrize("cfg", ["TEST_CLIP", "SD15_CLIP"])
def test_hash_tokenizer_ids_equal_jax(cfg):
    ref = jc.CLIPTokenizerWrapper(getattr(jc, cfg))(PROMPTS)
    got = tc.CLIPTokenizerWrapper(getattr(tc, cfg))(PROMPTS)
    assert got.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_clip_prompt_encoder_matches_jax():
    ej = j15.CLIPPromptEncoder.random_init(jax.random.PRNGKey(9))
    et = t15.CLIPPromptEncoder(tc.clip_params_from_numpy(np_tree(ej.params)),
                               tc.TEST_CLIP, device="cpu")
    assert_close(et.encode(PROMPTS[:2]), ej.encode(PROMPTS[:2]))
    (ht, kt), (hj, kj) = (e.encode_penultimate(PROMPTS[:2]) for e in (et, ej))
    assert_close(ht, hj)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert_close(et.encode_pooled(PROMPTS), ej.encode_pooled(PROMPTS))
    assert not et.encode(["a"]).requires_grad


def test_clip_from_torch_file_demands_a_tokenizer(tmp_path):
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        t15.CLIPPromptEncoder.from_torch_file(str(tmp_path / "none.bin"))


# ---- the SD1.5 prior --------------------------------------------------------


@pytest.fixture(scope="module")
def priors():
    jp = j15.SD15Prior.random_init(jax.random.PRNGKey(0))
    tp = t15.SD15Prior(tu.unet_params_from_numpy(np_tree(jp.unet_params)),
                       tv.vae_params_from_numpy(np_tree(jp.vae_params)),
                       tu.TEST_UNET, tv.TEST_VAE, device="cpu")
    return jp, tp


def test_schedule_matches_jax():
    np.testing.assert_array_equal(t15.ddpm_alphas_cumprod().numpy(),
                                  np.asarray(j15.ddpm_alphas_cumprod()))


def test_prior_encode_predict_decode_match_jax(priors):
    jp, tp = priors
    rng = np.random.default_rng(10)
    img = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    lj = jp.encode_images(jnp.asarray(img), key)
    eps = jax.random.normal(key, lj.shape)
    x = T(img).requires_grad_()
    lt = tp.encode_images(x, None, noise=T(eps))
    assert_close(lt, lj)
    lt.square().sum().backward()  # the encode stays differentiable
    assert x.grad is not None and float(x.grad.abs().max()) > 0
    t = np.array([20, 700], np.int64)
    cond = rng.normal(size=(2, 8, 32)).astype(np.float32)
    unc = rng.normal(size=(2, 8, 32)).astype(np.float32)
    ej = jp.predict_noise(lj, jnp.asarray(t), cond, unc)
    et = tp.predict_noise(lt, T(t), T(cond), T(unc))
    for a, b in zip(et, ej):
        assert_close(a, b)
        assert not a.requires_grad  # no graph through the denoiser
    assert_close(tp.decode_latents(lt.detach()), jp.decode_latents(lj))
    for leaf in jax.tree_util.tree_leaves(tp.unet_params) + \
            jax.tree_util.tree_leaves(tp.vae_params):
        assert not leaf.requires_grad and leaf.grad is None


@pytest.mark.parametrize("t", [0, 60, 130])
def test_prior_edit_latents_match_jax(priors, t):
    jp, tp = priors
    rng = np.random.default_rng(12)
    lat = rng.normal(size=(1, 16, 16, 4)).astype(np.float32)
    cond = rng.normal(size=(1, 8, 32)).astype(np.float32)
    unc = rng.normal(size=(1, 8, 32)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    ref = jp.edit_latents(jnp.asarray(lat), t, cond, unc, key,
                          steps_divisor=50)
    noise = jax.random.normal(key, lat.shape, jnp.float32)
    got = tp.edit_latents(T(lat), t, T(cond), T(unc), None,
                          steps_divisor=50, noise=T(noise))
    assert_close(got, ref)


def test_random_init_at_a_config_and_generator_seam():
    """random_init takes the configs; with no noise given, the encode draws
    from the generator (the same generator state, the same latents)."""
    gen = torch.Generator().manual_seed(0)
    prior = t15.SD15Prior.random_init(gen, device="cpu")
    assert prior.unet_cfg == tu.TEST_UNET and prior.latent_downscale == 2
    img = torch.rand((1, 16, 16, 3), generator=gen)
    a = prior.encode_images(img, torch.Generator().manual_seed(5))
    b = prior.encode_images(img, torch.Generator().manual_seed(5))
    c = prior.encode_images(img, torch.Generator().manual_seed(6))
    np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    assert float((a - c).abs().max()) > 0


# ---- converters and checkpoint files ---------------------------------------


class TrackingDict(dict):
    """Records the keys a converter reads (membership probes do not
    count)."""

    def __init__(self, data):
        super().__init__(data)
        self.accessed = set()

    def __getitem__(self, k):
        self.accessed.add(k)
        return super().__getitem__(k)


def _synth(manifest, seed=0, rename=None):
    rng = np.random.default_rng(seed)
    sd = {k: rng.normal(size=s).astype(np.float32)
          for k, s in manifest.items()}
    if rename:
        sd = {rename(k): v for k, v in sd.items()}
    return sd


def _old_vae_names(k):
    for new, old in ((".group_norm.", ".norm."), (".to_q.", ".query."),
                     (".to_k.", ".key."), (".to_v.", ".value."),
                     (".to_out.0.", ".proj_attn.")):
        if "attentions" in k:
            k = k.replace(new, old)
    return k


CONVERTERS = {
    "unet_sd15": lambda: (jm.unet_manifest(ju.TEST_UNET), None,
                          lambda sd: ju.convert_torch_unet(sd, ju.TEST_UNET),
                          lambda sd: tu.convert_torch_unet(sd, tu.TEST_UNET)),
    "unet_sdxl": lambda: (jm.unet_manifest(ju.TEST_SDXL_UNET), None,
                          lambda sd: ju.convert_torch_unet(sd, ju.TEST_SDXL_UNET),
                          lambda sd: tu.convert_torch_unet(sd, tu.TEST_SDXL_UNET)),
    "vae": lambda: (jm.vae_manifest(jv.TEST_VAE), None,
                    lambda sd: jv.convert_torch_vae(sd, jv.TEST_VAE),
                    lambda sd: tv.convert_torch_vae(sd, tv.TEST_VAE)),
    "vae_old_names": lambda: (jm.vae_manifest(jv.TEST_VAE), _old_vae_names,
                              lambda sd: jv.convert_torch_vae(sd, jv.TEST_VAE),
                              lambda sd: tv.convert_torch_vae(sd, tv.TEST_VAE)),
    "clip": lambda: (jm.clip_text_manifest(jc.TEST_CLIP), None,
                     jc.convert_torch_clip_text, tc.convert_torch_clip_text),
}


@pytest.mark.parametrize("family", list(CONVERTERS))
def test_converter_tree_equals_jax_and_reads_every_key(family):
    manifest, rename, jconv, tconv = CONVERTERS[family]()
    sd = TrackingDict(_synth(manifest, rename=rename))
    got = tconv(sd)
    assert sd.accessed == set(sd), sorted(set(sd) - sd.accessed)[:5]
    assert_trees_equal(got, np_tree(jconv(dict(sd))))


def test_converter_rejects_a_wrong_config():
    sd = _synth(tm.unet_manifest(tu.TEST_UNET))
    with pytest.raises(ValueError, match="down levels"):
        tu.convert_torch_unet(sd, tu.SD15_UNET)


@pytest.mark.parametrize("fmt", ["bin", "pt", "safetensors"])
def test_load_state_dict_and_unet_file(tmp_path, fmt):
    """A half-precision checkpoint file loads as f32 and converts to the
    JAX loader's tree."""
    sd = _synth(tm.unet_manifest(tu.TEST_UNET), seed=1)
    half = {k: torch.tensor(v).half() for k, v in sd.items()}
    path = str(tmp_path / f"unet.{fmt}")
    if fmt == "safetensors":
        from safetensors.torch import save_file

        save_file(half, path)
    else:
        torch.save({"state_dict": half} if fmt == "pt" else half, path)
    got = tu._load_torch_state_dict(path)
    ref = ju._load_torch_state_dict(path)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    assert_trees_equal(tu.load_unet_params(path, tu.TEST_UNET),
                       np_tree(ju.load_unet_params(path, ju.TEST_UNET)))


def test_safetensors_without_the_package_raises(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors not available"):
        tu._load_torch_state_dict(str(tmp_path / "w.safetensors"))


# ---- manifests ------------------------------------------------------------


def _bigg(mod):
    return mod.CLIPTextConfig(dim=1280, layers=32, heads=20, mlp_dim=5120,
                              act="gelu")


def _manifest_pair(name):
    from youreditableavatar_tpu.guidance import sam as jsam
    from youreditableavatar_tpu.guidance import sdxl_controlnet as jcn
    from youreditableavatar_tpu_torch.guidance import sdxl_controlnet as tcn

    fam, cfg = name.split(":")
    if fam == "unet":
        return (jm.unet_manifest(getattr(ju, cfg)),
                tm.unet_manifest(getattr(tu, cfg)))
    if fam == "vae":
        return (jm.vae_manifest(getattr(jv, cfg)),
                tm.vae_manifest(getattr(tv, cfg)))
    if fam == "clip":
        cj, ct = ((_bigg(jc), _bigg(tc)) if cfg == "bigG"
                  else (getattr(jc, cfg), getattr(tc, cfg)))
        return jm.clip_text_manifest(cj), tm.clip_text_manifest(ct)
    if fam == "controlnet":
        return (jm.controlnet_union_manifest(getattr(jcn, cfg)),
                tm.controlnet_union_manifest(getattr(tcn, cfg)))
    sam_cfg = getattr(jsam, cfg)  # SAM's configs come with the next slice
    return jm.sam_manifest(sam_cfg), tm.sam_manifest(sam_cfg)


MANIFESTS = ["unet:SD15_UNET", "unet:SDXL_UNET", "unet:TEST_UNET",
             "unet:TEST_SDXL_UNET", "vae:SD_VAE", "vae:SDXL_VAE",
             "vae:TEST_VAE", "clip:SD15_CLIP", "clip:TEST_CLIP", "clip:bigG",
             "controlnet:SDXL_CONTROLNET_UNION",
             "controlnet:TEST_CONTROLNET_UNION", "sam:SAM_VIT_H",
             "sam:SAM_VIT_B"]


@pytest.mark.parametrize("name", MANIFESTS)
def test_manifest_equals_jax(name):
    ref, got = _manifest_pair(name)
    assert list(got.items()) == list(ref.items())


@pytest.mark.parametrize("name,n_tensors,n_params", [
    ("unet:SD15_UNET", 686, 859_520_964),
    ("unet:SDXL_UNET", 1680, 2_567_463_684),
    ("vae:SD_VAE", 248, 83_653_863),
    ("clip:SD15_CLIP", 196, 123_060_480),
    ("clip:bigG", 516, 693_021_440),
    ("controlnet:SDXL_CONTROLNET_UNION", None, 1_262_779_600),
])
def test_manifest_official_totals(name, n_tensors, n_params):
    _, got = _manifest_pair(name)
    if n_tensors is not None:
        assert len(got) == n_tensors
    assert sum(int(np.prod(s)) for s in got.values()) == n_params
    assert tm.IGNORABLE_KEYS == jm.IGNORABLE_KEYS


def test_manifest_counts_the_random_init():
    """The full-width trees the port draws hold the manifests' counts
    (shapes only: the TEST configs' trees are drawn and counted)."""
    for ct, man in ((tu.TEST_UNET, tm.unet_manifest(tu.TEST_UNET)),
                    (tu.TEST_SDXL_UNET, tm.unet_manifest(tu.TEST_SDXL_UNET))):
        tree = tu.init_unet_params(torch.Generator().manual_seed(0), ct)
        assert tl.tree_numel(tree) == sum(int(np.prod(s))
                                          for s in man.values())
    tree = tv.init_vae_params(torch.Generator().manual_seed(0), tv.TEST_VAE)
    assert tl.tree_numel(tree) == sum(
        int(np.prod(s)) for s in tm.vae_manifest(tv.TEST_VAE).values())


# ---- factory ---------------------------------------------------------------


def test_guidance_factory_names_and_errors(tmp_path):
    from youreditableavatar_tpu.guidance import factory as jf
    from youreditableavatar_tpu_torch.guidance import factory as tf
    from youreditableavatar_tpu_torch.guidance.stub import (
        StubDiffusionPrior, StubPromptEncoder)

    prior, enc = tf.make_guidance_backend("stub", device="cpu")
    assert isinstance(prior, StubDiffusionPrior)
    assert isinstance(enc, StubPromptEncoder)
    prior, enc = tf.make_guidance_backend("sd15-random", device="cpu")
    assert isinstance(prior, t15.SD15Prior)
    assert isinstance(enc, t15.CLIPPromptEncoder)
    assert enc.encode(["a"]).shape == (1, 16, prior.unet_cfg.ctx_dim)
    for name, wd in (("sd15", None), ("sd15", str(tmp_path / "missing")),
                     ("sd15", str(tmp_path))):
        with pytest.raises(FileNotFoundError):
            jf.make_guidance_backend(name, wd)
        with pytest.raises(FileNotFoundError):
            tf.make_guidance_backend(name, wd, device="cpu")
    for mod in (jf, tf):
        with pytest.raises(ValueError, match="unknown guidance backend"):
            mod.make_guidance_backend("sd21")


def test_inpainter_factory_names_and_errors(tmp_path):
    from youreditableavatar_tpu.guidance import factory as jf
    from youreditableavatar_tpu_torch.guidance import factory as tf
    from youreditableavatar_tpu_torch.guidance.sdxl_pipeline import (
        SDXLControlNetUnionPipeline)
    from youreditableavatar_tpu_torch.guidance.stub import StubInpainter

    assert isinstance(tf.make_inpainter_backend("stub"), StubInpainter)
    pipe = tf.make_inpainter_backend("sdxl-random", device="cpu")
    assert isinstance(pipe, SDXLControlNetUnionPipeline)
    ctx, pooled = pipe.text_encoder.encode_with_pooled(["a"])
    assert ctx.shape[-1] == pipe.cfg.unet.ctx_dim
    assert pooled.shape == (1, pipe.cfg.unet.pooled_dim)
    for wd in (None, str(tmp_path / "missing"), str(tmp_path)):
        with pytest.raises(FileNotFoundError):
            jf.make_inpainter_backend("sdxl", wd)
        with pytest.raises(FileNotFoundError):
            tf.make_inpainter_backend("sdxl", wd, device="cpu")
    for mod in (jf, tf):
        with pytest.raises(ValueError, match="unknown inpainter backend"):
            mod.make_inpainter_backend("sd3")
    assert tf.BIGG_CLIP == _bigg(tc)
    # The segmenter half of the factory: its names and errors are held in
    # tests/test_torch_gdino.py.
    assert callable(tf.make_segmenter_backend)


def test_entry_points_default_to_cuda():
    from youreditableavatar_tpu_torch.guidance import factory as tf

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t15.SD15Prior.random_init(gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t15.CLIPPromptEncoder.random_init(gen)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.make_inpainter_backend("sdxl-random")


# ---- the spatial stage on the tiny SD1.5 ------------------------------------


CAM = dict(height=64, width=64, camera_distance_range=(1.6, 1.8),
           elevation_range=(-5, 10), fovy_range=(40, 45))


def _sd_prompts(tmp, jenc, tenc):
    from youreditableavatar_tpu.guidance import prompts as jpr
    from youreditableavatar_tpu_torch.guidance import prompts as tpr

    return (jpr.PromptProcessor("a red jacket", "low quality", jenc,
                                cache_dir=str(tmp / "jax"), model_name="clip"),
            tpr.PromptProcessor("a red jacket", "low quality", tenc,
                                cache_dir=str(tmp / "torch"),
                                model_name="clip"))


def _trainer_pair(tmp, use_sds):
    """Both HumanEditTrainers on the tiny SD1.5 (TEST configs, CLIP
    conditioning), 2 steps; the port's draws — SDS timestep and noise,
    recon indices, the encoder's sample, the du refresh's timestep and
    edit noise — come from the JAX trainer's keys."""
    from test_torch_spatial import _mesh_cfgs, _sds_draws
    from youreditableavatar_tpu.data import camera_sampler as jcs
    from youreditableavatar_tpu.guidance import sds as jsds
    from youreditableavatar_tpu.stages import spatial as jsp
    from youreditableavatar_tpu_torch.data import camera_sampler as tcs
    from youreditableavatar_tpu_torch.guidance import sds as tsds
    from youreditableavatar_tpu_torch.stages import spatial as tsp

    jg, tg, jp, tp = small_geometries()
    jpart, tpart, _ = partitions(jg, tg, jp, tp)
    jprior = j15.SD15Prior.random_init(jax.random.PRNGKey(0))
    tprior = t15.SD15Prior(tu.unet_params_from_numpy(np_tree(jprior.unet_params)),
                           tv.vae_params_from_numpy(np_tree(jprior.vae_params)),
                           tu.TEST_UNET, tv.TEST_VAE, device="cpu")
    jenc = j15.CLIPPromptEncoder.random_init(jax.random.PRNGKey(1))
    tenc = t15.CLIPPromptEncoder(tc.clip_params_from_numpy(np_tree(jenc.params)),
                                 tc.TEST_CLIP, device="cpu")
    jpp, tpp = _sd_prompts(tmp, jenc, tenc)
    if use_sds:
        jgd = jsds.SDSGuidance(jprior, jsds.SDSConfig(guidance_scale=7.5))
        tgd = tsds.SDSGuidance(tprior, tsds.SDSConfig(guidance_scale=7.5))
    else:
        kw = dict(guidance_scale=7.5, per_editing_step=2, steps_divisor=100)
        jgd = jsds.SDSDUGuidance(jprior, jsds.SDSDUConfig(**kw))
        tgd = tsds.SDSDUGuidance(tprior, tsds.SDSDUConfig(**kw))
    kw = dict(max_steps=2, recon_points=2048, log_every=1, use_sds=use_sds)
    jcfg = jsp.HumanEditConfig(camera=jcs.RandomCameraConfig(**CAM), **kw)
    tcfg = tsp.HumanEditConfig(camera=tcs.RandomCameraConfig(**CAM), **kw)
    jmc, tmc = _mesh_cfgs()
    jt = jsp.HumanEditTrainer(jg.field, jg, jpart, jp, jgd, jpp, jpp, jcfg,
                              jmc)
    key = jax.random.PRNGKey(1)
    jt.train(key, num_steps=2)
    nv = int(tg.grid_pos.shape[0])
    shape = (1, 32, 32, 4)  # 64² through TEST_VAE's ×2

    class Injected(tsp.HumanEditTrainer):
        def draws(self, seed, step):
            key_sds, key_pts = jax.random.split(jax.random.fold_in(key, step))
            min_t, max_t = self.guidance.timestep_range(0, step)
            t, noise = _sds_draws(key_sds, min_t, max_t, shape)
            k_enc, k_t, k_edit = jax.random.split(key_sds, 3)
            out = {"t": t, "noise": noise,
                   "recon_idx": T(jax.random.randint(key_pts, (2048,), 0,
                                                     nv)).long(),
                   "enc_noise": T(jax.random.normal(k_enc, shape))}
            if not use_sds:
                out["du_t"] = int(jax.random.randint(k_t, (), min_t,
                                                     max_t + 1))
                out["edit_noise"] = T(jax.random.normal(k_edit, shape))
            return out

    tt = Injected(tg.field, tg, tpart, tp, tgd, tpp, tpp, tcfg, tmc,
                  device="cpu")
    tt.train(0, num_steps=2)
    return jt, tt


@pytest.mark.parametrize("use_sds", [True, False], ids=["sds", "du"])
def test_human_edit_on_tiny_sd15_follows_jax(tmp_path, use_sds):
    jt, tt = _trainer_pair(tmp_path, use_sds)
    assert len(tt.metrics) == len(jt.metrics) == 2
    rj, rt = jt.metrics[0], tt.metrics[0]
    assert set(rt) == set(rj)
    assert ("sds" in rt) == use_sds and ("du_f" in rt) != use_sds
    for k in rj:
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5,
                                   atol=1e-6 if k == "nc" else 1e-9,
                                   err_msg=k)
    for k in jt.metrics[1]:
        np.testing.assert_allclose(tt.metrics[1][k], jt.metrics[1][k],
                                   rtol=2e-3, atol=1e-7, err_msg=k)
    moved = float((tt.params.grid.detach() - tt.frozen_params.grid).abs().sum())
    assert np.isfinite(moved) and moved > 0
    prior = tt.guidance.prior
    for leaf in jax.tree_util.tree_leaves(prior.unet_params):
        assert leaf.grad is None
    if not use_sds:
        tc_, jc_ = tt.guidance.edited_images, jt.guidance.edited_images
        assert sorted(tc_) == sorted(jc_) and len(tc_) >= 1
        for k in tc_:
            assert_close(tc_[k], jc_[k], 1e-4)
