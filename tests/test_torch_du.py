"""PyTorch port vs the JAX package: the multi-step "du" edit mode —
`guidance/sds.py` `SDSDUGuidance` and `HumanEditTrainer(use_sds=False)`.

Both packages get the same randomness: the refresh timestep is drawn here
with the JAX code's own `jax.random` calls and handed to the port (the
`t=` argument, and the trainer's `draws` seam). The stub prior's weights
are carried across (`stub_prior_from_numpy`).

Tolerances: the refreshed edit images 1e-6 (the stub's encode, edit and
bilinear decode in f32); the comparison losses 1e-5 relative and their
image gradients 1e-5 of the largest entry (1e-4 with the perceptual term,
whose VGG convolutions sum in another order); the trainer as in
`test_torch_spatial.py`: the first step's terms 1e-5 relative (normal
consistency 1e-6 absolute), later steps within the Adam drift (2e-3
relative), parameters within two learning-rate steps.
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
from test_torch_spatial import (
    CAM,
    DRIFT_ATOL,
    DRIFT_RTOL,
    NC_ATOL,
    _assert_params_near,
    _mesh_cfgs,
    _np,
    _priors,
    _prompts,
    _sds_draws,
)

from youreditableavatar_tpu.data import camera_sampler as jcs
from youreditableavatar_tpu.guidance import sds as jsds
from youreditableavatar_tpu.ops import lpips as jl
from youreditableavatar_tpu.stages import spatial as jsp
from youreditableavatar_tpu_torch.data import camera_sampler as tcs
from youreditableavatar_tpu_torch.guidance import sds as tsds
from youreditableavatar_tpu_torch.ops import lpips as tl
from youreditableavatar_tpu_torch.stages import spatial as tsp


def _refresh_t(key, min_t, max_t):
    """The timestep JAX's `maybe_refresh` draws from `key`."""
    _, k_t, _ = jax.random.split(key, 3)
    return int(jax.random.randint(k_t, (), min_t, max_t + 1))


def _guidances(per_editing_step=2, perceptual=None):
    jprior, tprior = _priors()
    cfg = dict(guidance_scale=7.5, per_editing_step=per_editing_step)
    jp = tp = None
    if perceptual:
        jp = jl.LPIPS(seed=0)
        tp = tl.LPIPS(seed=0, device="cpu")
        tp.vgg, tp.heads = tl.lpips_params_from_numpy(
            [{k: np.asarray(v) for k, v in p.items()} for p in jp.vgg],
            [np.asarray(h) for h in jp.heads], device="cpu")
    return (jsds.SDSDUGuidance(jprior, jsds.SDSDUConfig(**cfg), jp),
            tsds.SDSDUGuidance(tprior, tsds.SDSDUConfig(**cfg), tp))


def test_maybe_refresh_cadence_cache_and_edit(tmp_path):
    """The cache fills per view index, refreshes on the per_editing_step
    cadence (and for a view not seen yet), and holds the resized edit —
    at 64² (the stub's decode is the render's size) and at 60², where the
    decoded 56² edit is resized bilinearly."""
    jg, tg = _guidances(per_editing_step=3)
    jpp, _ = _prompts(tmp_path)
    cond, unc = (np.asarray(x) for x in jpp.get_text_embeddings(
        np.array([5.0]), np.array([30.0])))
    rng = np.random.default_rng(3)
    steps = [(0, 0), (1, 0), (2, 1), (3, 0), (4, 1), (6, 2)]  # (step, view)
    refreshed = []
    for size in (64, 60):
        for step, view in steps:
            img = rng.uniform(0, 1, (1, size, size, 3)).astype(np.float32)
            key = jax.random.PRNGKey(step)
            before = {k: np.array(v) for k, v in jg.edited_images.items()}
            gj = jg.maybe_refresh(jnp.asarray(img), jnp.asarray(cond),
                                  jnp.asarray(unc), key, 20, 980, view, step)
            gt = tg.maybe_refresh(torch.tensor(img), torch.tensor(cond),
                                  torch.tensor(unc), None, 20, 980, view, step,
                                  t=_refresh_t(key, 20, 980))
            assert tuple(gt.shape) == gj.shape == img.shape
            np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-6)
            refreshed.append(view not in before
                             or not np.array_equal(before[view], np.asarray(gj)))
        assert sorted(tg.edited_images) == sorted(jg.edited_images) == [0, 1, 2]
        for k in tg.edited_images:
            np.testing.assert_allclose(tg.edited_images[k].numpy(),
                                       np.asarray(jg.edited_images[k]),
                                       atol=1e-6)
        jg.edited_images.clear()
        tg.edited_images.clear()
    # Steps 0 and 3 and 6 are on the cadence; step 1 sees view 0 cached,
    # steps 2 and 4 view 1 first then cached.
    assert refreshed == [True, False, True, True, False, True] * 2


@pytest.mark.parametrize("perceptual", [False, True])
def test_du_loss_terms_and_gradients_match_jax(perceptual):
    jg, tg = _guidances(perceptual=perceptual)
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)

    def jloss(x):
        d = jg.du_loss_terms(x, jnp.asarray(gt), jax.random.PRNGKey(0))
        return d["loss_f"] + 10.0 * d["loss_l1"] + 10.0 * d.get("loss_p", 0.0), d

    (lj, dj), gj = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(img))
    x = torch.tensor(img, requires_grad=True)
    dt = tg.du_loss_terms(x, torch.tensor(gt))
    assert set(dt) == set(dj) == ({"loss_f", "loss_l1", "loss_p"} if perceptual
                                   else {"loss_f", "loss_l1"})
    lt = dt["loss_f"] + 10.0 * dt["loss_l1"] + 10.0 * dt.get("loss_p", 0.0)
    lt.backward()
    for k in dj:
        np.testing.assert_allclose(float(dt[k].detach()), float(dj[k]),
                                   rtol=1e-5, err_msg=k)
    gj = np.asarray(gj)
    np.testing.assert_allclose(x.grad.numpy(), gj, rtol=0,
                               atol=(1e-4 if perceptual else 1e-5)
                               * np.abs(gj).max())


def test_du_losses_refresh_then_pull(tmp_path):
    """`du_losses` = refresh (on the cadence) + the comparison terms."""
    jg, tg = _guidances()
    jpp, _ = _prompts(tmp_path)
    cond, unc = (np.asarray(x) for x in jpp.get_text_embeddings(
        np.array([5.0]), np.array([30.0])))
    img = np.random.default_rng(5).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    dj = jg.du_losses(jnp.asarray(img), jnp.asarray(cond), jnp.asarray(unc),
                      key, 20, 980, 4, 0)
    dt = tg.du_losses(torch.tensor(img), torch.tensor(cond), torch.tensor(unc),
                      None, 20, 980, 4, 0, t=_refresh_t(key, 20, 980))
    assert list(tg.edited_images) == [4]
    for k in dj:
        np.testing.assert_allclose(float(dt[k]), float(dj[k]), rtol=1e-5,
                                   err_msg=k)


@pytest.fixture(scope="module")
def du_pair(tmp_path_factory):
    """Both trainers in the du mode, 4 steps (per_editing_step 2, across
    start_sdf_loss_step = 2), logging every step; the port's draws come
    from the JAX trainer's keys."""
    tmp = tmp_path_factory.mktemp("prompts")
    jg, tg, jp, tp = small_geometries()
    jpart, tpart, _ = partitions(jg, tg, jp, tp)
    jpp, tpp = _prompts(tmp)
    jgd, tgd = _guidances()
    kw = dict(max_steps=4, recon_points=2048, start_sdf_loss_step=2,
              log_every=1, use_sds=False)
    jcfg = jsp.HumanEditConfig(camera=jcs.RandomCameraConfig(**CAM), **kw)
    tcfg = tsp.HumanEditConfig(camera=tcs.RandomCameraConfig(**CAM), **kw)
    jmc, tmc = _mesh_cfgs()
    jt = jsp.HumanEditTrainer(jg.field, jg, jpart, jp, jgd, jpp, jpp, jcfg,
                              jmc)
    key = jax.random.PRNGKey(1)
    jt.train(key, num_steps=4)
    nv = int(tg.grid_pos.shape[0])

    class Injected(tsp.HumanEditTrainer):
        def draws(self, seed, step):
            key_sds, key_pts = jax.random.split(jax.random.fold_in(key, step))
            min_t, max_t = self.guidance.timestep_range(0, step)
            t, noise = _sds_draws(key_sds, min_t, max_t, (1, 8, 8, 4))
            recon = jax.random.randint(key_pts, (2048,), 0, nv)
            return {"t": t, "noise": noise,
                    "recon_idx": torch.tensor(np.asarray(recon)).long(),
                    "du_t": _refresh_t(key_sds, min_t, max_t)}

    tt = Injected(tg.field, tg, tpart, tp, tgd, tpp, tpp, tcfg, tmc,
                  device="cpu")
    tt.train(0, num_steps=4)
    return jt, tt


class TestDuMode:
    def test_first_step(self, du_pair):
        jt, tt = du_pair
        rj, rt = jt.metrics[0], tt.metrics[0]
        assert set(rt) == set(rj) and "sds" not in rt
        assert {"du_f", "du_l1"} <= set(rt)
        for k in rj:
            np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5,
                                       atol=NC_ATOL if k == "nc" else 1e-9,
                                       err_msg=k)
        # The cached edit differs from the render it came from.
        assert rt["du_l1"] > 0 and rt["du_f"] > 0

    def test_later_steps_and_params(self, du_pair):
        jt, tt = du_pair
        assert tt.global_step == jt.global_step == 4
        for rj, rt in zip(jt.metrics[1:], tt.metrics[1:]):
            for k in rj:
                np.testing.assert_allclose(rt[k], rj[k], rtol=DRIFT_RTOL,
                                           atol=DRIFT_ATOL,
                                           err_msg=f"{rj['step']} {k}")
        _assert_params_near(tt.params, jt.params, 2 * 4 * 2e-5)
        moved = float((tt.params.grid.detach()
                       - tt.frozen_params.grid).abs().sum())
        assert np.isfinite(moved) and moved > 0

    def test_edit_cache(self, du_pair):
        """One cache entry per azimuth bucket visited, the same buckets and
        (to the trainers' drift) the same edits."""
        jt, tt = du_pair
        tc, jc = tt.guidance.edited_images, jt.guidance.edited_images
        assert sorted(tc) == sorted(jc) and len(tc) >= 1
        for k in tc:
            assert tuple(tc[k].shape) == (1, 64, 64, 3)
            np.testing.assert_allclose(_np(tc[k]), np.asarray(jc[k]),
                                       atol=1e-4)
