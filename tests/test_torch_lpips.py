"""PyTorch port vs the JAX package: LPIPS (`ops/lpips.py`) and the
perceptual refine of the edit-texture stage (`RefineConfig.lambda_perceptual
> 0`).

The JAX package's random VGG16 and heads are carried to the port with
`lpips_params_from_numpy` (HWIO → OIHW), so both compute the same network.
Tolerances: features 1e-5 of each layer's largest activation and the LPIPS
value 1e-5 relative (f32 convolutions summed in another order); the
gradient with respect to `pred` 1e-4 of its largest entry. The refine's
first loss 1e-5 relative, later ones within the Adam drift of
`test_torch_edit_texture.py` (1e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    leaves,
    single_threaded_torch,  # noqa: F401  (fixture)
)
from test_torch_edit_texture import (  # noqa: F401  (fixture)
    PARAMS,
    _cams,
    _jcfgs,
    _logged,
    _tcfgs,
    scene,
)

from youreditableavatar_tpu.ops import lpips as jl
from youreditableavatar_tpu_torch.ops import lpips as tl

CPU = "cpu"


@pytest.fixture(scope="module")
def nets():
    """The JAX LPIPS (seed 0) and the port's on its weights."""
    j = jl.LPIPS(seed=0)
    vgg, heads = tl.lpips_params_from_numpy(
        [{k: np.asarray(v) for k, v in p.items()} for p in j.vgg],
        [np.asarray(h) for h in j.heads], device=CPU)
    t = tl.LPIPS(seed=0, device=CPU)
    t.vgg, t.heads = vgg, heads
    return j, t


def _images(seed, b=2, size=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32)


def test_vgg16_features_match_jax(nets):
    j, t = nets
    x = _images(0) * 2 - 1
    fj = jl.vgg16_features(j.vgg, jnp.asarray(x))
    ft = tl.vgg16_features(t.vgg, torch.tensor(x))
    assert [tuple(f.shape) for f in ft] == [f.shape for f in fj] == [
        (2, 64, 64, 64), (2, 32, 32, 128), (2, 16, 16, 256), (2, 8, 8, 512),
        (2, 4, 4, 512)]
    for a, b in zip(ft, fj):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_lpips_value_and_pred_gradient_match_jax(nets):
    j, t = nets
    pred, target = _images(1), _images(2)
    lj, gj = jax.value_and_grad(
        lambda x: jl.lpips(j.vgg, j.heads, x, jnp.asarray(target)))(
            jnp.asarray(pred))
    x = torch.tensor(pred, requires_grad=True)
    lt = tl.lpips(t.vgg, t.heads, x, torch.tensor(target))
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    gj = np.asarray(gj)
    np.testing.assert_allclose(x.grad.numpy(), gj, rtol=0,
                               atol=1e-4 * np.abs(gj).max())
    # The class takes single images too; equal images are at distance 0.
    one = torch.tensor(pred[0])
    np.testing.assert_allclose(float(t(one, torch.tensor(target[0]))),
                               float(j(jnp.asarray(pred[0]),
                                       jnp.asarray(target[0]))), rtol=1e-5)
    assert float(t(one, one)) == 0.0


def test_torch_state_dict_converters():
    """A torchvision-layout state dict loads as it is (OIHW), and the
    heads are the rectified lin weights, as the JAX converters read
    them."""
    rng = np.random.default_rng(3)
    sd, cin, idx = {}, 3, 0
    for cout, n in tl.VGG_BLOCKS:
        for _ in range(n):
            sd[f"features.{idx}.weight"] = rng.normal(
                size=(cout, cin, 3, 3)).astype(np.float32)
            sd[f"features.{idx}.bias"] = rng.normal(size=cout).astype(np.float32)
            cin, idx = cout, idx + 2  # a ReLU between convs
    lin = {f"lin{i}.model.1.weight": rng.normal(size=(c, 1, 1, 1)).astype(
        np.float32) for i, (c, _) in enumerate(tl.VGG_BLOCKS)}
    t = tl.LPIPS(sd, lin, device=CPU)
    j = jl.LPIPS(sd, lin)
    assert t.pretrained and len(t.vgg) == len(j.vgg) == 13
    for a, b in zip(t.vgg, j.vgg):
        np.testing.assert_array_equal(
            a["w"].numpy(), np.transpose(np.asarray(b["w"]), (3, 2, 0, 1)))
        np.testing.assert_array_equal(a["b"].numpy(), np.asarray(b["b"]))
    for a, b in zip(t.heads, j.heads):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_random_init_shapes():
    t = tl.LPIPS(seed=4, device=CPU)
    assert not t.pretrained
    assert [tuple(p["w"].shape) for p in t.vgg][:3] == [
        (64, 3, 3, 3), (64, 64, 3, 3), (128, 64, 3, 3)]
    assert [h.shape[0] for h in t.heads] == [64, 128, 256, 512, 512]
    assert all(float(h.min()) > 0 for h in t.heads)  # softplus


def test_perceptual_refine_follows_jax(scene, nets):
    """RefineTrainer with lambda_perceptual = 0.5 on both packages, the
    port's LPIPS on the JAX trainer's weights: 3 steps from equal weights
    and targets, the first loss to 1e-5 relative, the rest to 1e-3; the
    LPIPS term moves the loss away from the plain refine's."""
    from youreditableavatar_tpu.stages import edit_texture as js
    from youreditableavatar_tpu_torch.models.tetgs_edit import (
        edit_params_from_numpy,
    )
    from youreditableavatar_tpu.models import cameras as jc
    from youreditableavatar_tpu_torch.models import cameras as tc
    from youreditableavatar_tpu_torch.stages import edit_texture as ts

    turn = (0.0, 120.0)
    rng = np.random.default_rng(8)
    targets = [rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
               for _ in turn]
    rkw = dict(num_iterations=3, key_views=(0,), sh_levels=2)
    losses = {}
    for lam in (0.5, 0.0):
        jr = js.RefineTrainer(scene["ebj"], scene["epj"], _cams(jc, turn),
                              targets, js.RefineConfig(
                                  raster=_jcfgs()[0], lambda_perceptual=lam,
                                  **rkw))
        tr = ts.RefineTrainer(
            scene["ebt"], edit_params_from_numpy(leaves(scene["epj"], PARAMS),
                                                 CPU),
            _cams(tc, turn), targets,
            ts.RefineConfig(raster=_tcfgs()[0], lambda_perceptual=lam, **rkw),
            device=CPU)
        if lam > 0:
            assert tr._lpips is not None
            tr._lpips.vgg, tr._lpips.heads = nets[1].vgg, nets[1].heads
        else:
            assert tr._lpips is None
        jlosses, tlosses = [], []
        jstep, tstep = jr._make_step(64, 64), tr.step
        jr._step = lambda *a: _logged(jstep(*a), jlosses, 2)
        tr.step = lambda vi: _logged(tstep(vi), tlosses, 0)
        jr.refined_editing(seed=0)
        tr.refined_editing(seed=0)
        assert len(tlosses) == len(jlosses) == 3
        np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
        np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
        losses[lam] = tlosses[0]
    assert losses[0.5] > losses[0.0] + 1e-3
