"""PyTorch port vs the JAX package: the differentiable render.

The port renders through the plain PyTorch versions of its kernels on the
CPU; the JAX side through its Pallas compositing kernel interpreted on the
CPU (`pallas_interpret=True`, as `test_raster_pallas.py`), its XLA backend,
and the float64 NumPy oracle. Tolerances are the JAX suite's own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    cuda_device,  # noqa: F401  (fixture)
    jax_camera,
    random_scene,
    torch_camera,
)

KEYS = ("means", "scales", "quats", "opac", "colors")


@pytest.fixture(scope="module")
def scene():
    return random_scene()


def _jax_render(scene, cfg, sh=None, sh_degree=None):
    from youreditableavatar_tpu.ops.gaussian_raster import render_gaussians

    s, vm, w, h = scene
    args = [jnp.asarray(s[k]) for k in KEYS]
    return render_gaussians(
        *args[:4], None if sh is None else jnp.asarray(sh),
        jax_camera(vm, 0.8, 0.6, w, h), cfg, jnp.asarray(s["bg"]),
        colors_override=None if sh is not None else args[4])


def _torch_render(scene, budget=1 << 13, leaves=None, sh=None, **kw):
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        RasterizeConfig, render_gaussians,
    )

    s, vm, w, h = scene
    leaves = leaves or [torch.as_tensor(s[k]) for k in KEYS]
    return render_gaussians(
        *leaves[:4], None if sh is None else torch.as_tensor(sh),
        torch_camera(vm, 0.8, 0.6, w, h),
        RasterizeConfig(pair_budget=budget, **kw), torch.as_tensor(s["bg"]),
        colors_override=None if sh is not None else leaves[4])


def _pallas_cfg(**kw):
    from youreditableavatar_tpu.ops.gaussian_raster import RasterizeConfig

    return RasterizeConfig(backend="pallas", pair_budget=1 << 13,
                           pallas_interpret=True, **kw)


def _xla_cfg(**kw):
    from youreditableavatar_tpu.ops.gaussian_raster import RasterizeConfig

    return RasterizeConfig(backend="xla", pair_budget=1 << 13,
                           tile_capacity=512, **kw)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_forward_matches_jax(scene, backend):
    ref = _jax_render(scene, _pallas_cfg() if backend == "pallas" else _xla_cfg())
    out = _torch_render(scene)
    for key in ("image", "final_t", "alpha"):
        np.testing.assert_allclose(out[key].detach().numpy(),
                                   np.asarray(ref[key]), atol=1e-6, err_msg=key)
    for key in ("n_contrib", "radii"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
    assert int(out["num_pairs"]) == int(ref["num_pairs"]) > 0
    assert int(out["num_tile_overflow"]) == 0
    np.testing.assert_allclose(out["mean2d"].detach().numpy(),
                               np.asarray(ref["mean2d"]), rtol=1e-5, atol=1e-5)


def test_sh_render_matches_jax(scene):
    """Colour from SH degree 3 through the whole render."""
    s, *_ = scene
    sh = np.random.default_rng(9).normal(
        size=(len(s["opac"]), 16, 3)).astype(np.float32) * 0.4
    ref = _jax_render(scene, _xla_cfg(sh_degree=3), sh=sh)
    out = _torch_render(scene, sh=sh, sh_degree=3)
    np.testing.assert_allclose(out["image"].detach().numpy(),
                               np.asarray(ref["image"]), atol=1e-5)


def test_gradients_match_jax(scene):
    """Gradients of all five inputs against the Pallas (interpreted) and
    XLA backends, at the JAX suite's 5e-5·max(max|g|, 1e-3)."""
    s, vm, w, h = scene
    cam = jax_camera(vm, 0.8, 0.6, w, h)

    def jax_grads(cfg):
        from youreditableavatar_tpu.ops.gaussian_raster import render_gaussians

        def loss(m, sc, q, o, c):
            out = render_gaussians(m, sc, q, o, None, cam, cfg,
                                   jnp.asarray(s["bg"]), colors_override=c)
            return jnp.mean(out["image"] ** 2) + 0.1 * jnp.mean(out["alpha"])

        return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(s[k]) for k in KEYS))

    leaves = [torch.tensor(s[k], requires_grad=True) for k in KEYS]
    out = _torch_render(scene, leaves=leaves)
    ((out["image"] ** 2).mean() + 0.1 * out["alpha"].mean()).backward()
    for cfg in (_pallas_cfg(), _xla_cfg()):
        for ref, leaf in zip(jax_grads(cfg), leaves):
            ref = np.asarray(ref)
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(leaf.grad.numpy(), ref,
                                       atol=5e-5 * max(scale, 1e-3))


@pytest.mark.parametrize("rect_mode,atol", [("support", 2e-4), ("3sigma", 1e-5)])
def test_matches_f64_oracle(rect_mode, atol):
    """The 500-Gaussian 128×96 scene of test_raster_xla.py vs the oracle."""
    from youreditableavatar_tpu.ops.gaussian_raster.oracle import render_oracle

    scene = random_scene(42, 500, 128, 96)
    s, vm, w, h = scene
    cam = jax_camera(vm, 0.8, 0.6, w, h)
    ref = render_oracle(
        *(s[k].astype(np.float64) for k in KEYS), vm.astype(np.float64),
        float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy), w, h,
        s["bg"], rect_mode=rect_mode)
    out = _torch_render(scene, budget=1 << 14, rect_mode=rect_mode)
    np.testing.assert_array_equal(out["radii"].numpy(), ref["radii"])
    np.testing.assert_allclose(out["image"].detach().numpy(), ref["image"],
                               atol=atol, rtol=1e-4)
    np.testing.assert_allclose(out["final_t"].detach().numpy(),
                               ref["final_t"], atol=atol, rtol=1e-4)


def test_count_pairs_bench_scene():
    """bench.py's 100k-Gaussian 512² scene: the port counts the same pairs
    (preprocess only, so cheap on the CPU)."""
    import bench
    from youreditableavatar_tpu.ops.gaussian_raster import (
        RasterizeConfig, count_pairs,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        RasterCamera, RasterizeConfig as TCfg, count_pairs as tcount,
    )

    means, scales, quats, opac, sh, cam = bench.make_scene()
    n_jax = int(count_pairs(means, scales, quats, opac, sh, cam,
                            RasterizeConfig(sh_degree=3)))
    tcam = RasterCamera.from_fov(np.asarray(cam.viewmat), 0.9, 0.9, 512, 512,
                                 device="cpu")
    n_port = int(tcount(*(torch.tensor(np.asarray(x))
                          for x in (means, scales, quats, opac, sh)),
                        tcam, TCfg(sh_degree=3)))
    assert n_port == n_jax == 182_110


def test_fit_pair_budget_matches_jax():
    from youreditableavatar_tpu.ops.gaussian_raster.budget import (
        fit_pair_budget as jfit,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        PairOverflowError, fit_pair_budget,
    )

    for n in (0, 1, 4095, 4096, 5000, 49_152, 182_110, 1 << 20, 12_000_000):
        for headroom in (1.0, 1.2, 1.3):
            assert fit_pair_budget(n, headroom=headroom) == jfit(
                n, headroom=headroom), (n, headroom)
    with pytest.raises(PairOverflowError):
        fit_pair_budget(1 << 24)


@pytest.mark.parametrize("policy", ["grow", "raise", "warn"])
def test_budget_governor_matches_jax(policy):
    """The same diagnostics give the same configs, errors and warnings."""
    import warnings

    from youreditableavatar_tpu.ops.gaussian_raster import (
        RasterizeConfig as JCfg,
    )
    from youreditableavatar_tpu.ops.gaussian_raster.budget import (
        BudgetGovernor as JGov,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        BudgetGovernor, RasterizeConfig,
    )

    def outcomes(gov, cfg):
        seen = []
        for step, (pairs, over) in enumerate(
                ((100, 0), (9000, 0), (9000, 3), (100, 2))):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                try:
                    new = gov.check(cfg, pairs, over, step=step)
                except RuntimeError as e:  # each package's PairOverflowError
                    seen.append((type(e).__name__, str(e)))
                    continue
            got = None if new is None else (new.pair_budget, new.tile_capacity)
            seen.append((got, [str(w.message) for w in caught]))
        return seen, gov.events

    ref = outcomes(JGov(policy=policy), JCfg(pair_budget=8192,
                                             tile_capacity=256))
    got = outcomes(BudgetGovernor(policy=policy),
                   RasterizeConfig(pair_budget=8192, tile_capacity=256))
    assert got == ref
    assert len(got[1]) == 3


def test_empty_scene_and_checked_snapshot(scene, tmp_path):
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        RasterizeConfig, render_gaussians, render_gaussians_checked,
    )

    s, vm, w, h = scene
    cam = torch_camera(vm, 0.8, 0.6, w, h)
    bg = torch.as_tensor(s["bg"])
    out = render_gaussians(torch.full((4, 3), 100.0), torch.full((4, 3), 0.05),
                           torch.tensor([[1.0, 0, 0, 0]] * 4), torch.ones(4),
                           None, cam, RasterizeConfig(pair_budget=1024), bg,
                           colors_override=torch.ones(4, 3))
    np.testing.assert_allclose(out["image"].numpy(),
                               np.broadcast_to(s["bg"], (h, w, 3)))
    assert int(out["num_pairs"]) == 0

    colors = torch.as_tensor(s["colors"]).clone()
    colors[0] = float("nan")
    leaves = [torch.as_tensor(s[k]) for k in KEYS[:4]]
    with pytest.raises(RuntimeError, match="snapshot"):
        render_gaussians_checked(*leaves, None, cam,
                                 RasterizeConfig(pair_budget=1 << 13), bg,
                                 colors_override=colors,
                                 snapshot_path=str(tmp_path / "snap.npz"))
    snap = np.load(tmp_path / "snap.npz")
    assert snap["means3d"].shape == s["means"].shape


def test_cpu_entry_points_need_a_device_when_no_card():
    """Entry points default to CUDA and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from youreditableavatar_tpu_torch.ops.gaussian_raster import RasterCamera

    with pytest.raises(RuntimeError, match="device='cpu'"):
        RasterCamera.from_fov(np.eye(4), 0.8, 0.6, 64, 64)


class TestMathOps:
    """The port's small math modules against their JAX counterparts."""

    def test_quaternion(self):
        from youreditableavatar_tpu.ops import quaternion as jq
        from youreditableavatar_tpu_torch.ops import quaternion as tq

        rng = np.random.default_rng(1)
        a = rng.normal(size=(64, 4)).astype(np.float32)
        b = rng.normal(size=(64, 4)).astype(np.float32)
        m = np.asarray(jq.quat_to_matrix(jnp.asarray(a)))
        np.testing.assert_allclose(tq.quat_to_matrix(torch.tensor(a)).numpy(),
                                   m, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tq.matrix_to_quat(torch.tensor(m)).numpy(),
                                   np.asarray(jq.matrix_to_quat(jnp.asarray(m))),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tq.quat_multiply(torch.tensor(a), torch.tensor(b)).numpy(),
            np.asarray(jq.quat_multiply(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-5, atol=1e-6)

    def test_sh_and_graphics(self):
        from youreditableavatar_tpu.ops import sh as jsh
        from youreditableavatar_tpu.utils import graphics as jg
        from youreditableavatar_tpu_torch.ops import sh as tsh
        from youreditableavatar_tpu_torch.utils import graphics as tg

        rng = np.random.default_rng(2)
        dirs = rng.normal(size=(50, 3)).astype(np.float32)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
        coeffs = rng.normal(size=(50, 16, 3)).astype(np.float32)
        for deg in range(4):
            np.testing.assert_allclose(
                tsh.eval_sh_basis(deg, torch.tensor(dirs)).numpy(),
                np.asarray(jsh.eval_sh_basis(deg, jnp.asarray(dirs))),
                rtol=1e-5, atol=1e-6)
        pts = rng.normal(size=(50, 3)).astype(np.float32)
        cam = np.array([0.1, 0.2, -3.0], np.float32)
        np.testing.assert_allclose(
            tsh.sh_to_color(3, torch.tensor(coeffs), torch.tensor(pts),
                            torch.tensor(cam)).numpy(),
            np.asarray(jsh.sh_to_color(3, jnp.asarray(coeffs), jnp.asarray(pts),
                                       jnp.asarray(cam))), rtol=1e-5, atol=1e-5)
        rgb = rng.uniform(0, 1, (50, 3)).astype(np.float32)
        np.testing.assert_allclose(
            tsh.sh_dc_to_rgb(tsh.rgb_to_sh_dc(torch.tensor(rgb))).numpy(), rgb,
            atol=1e-6)
        tri = [rng.normal(size=(20, 3)).astype(np.float32) for _ in range(3)]
        for name in ("triangle_area", "circumcircle_radius"):
            np.testing.assert_allclose(
                getattr(tg, name)(*map(torch.tensor, tri)).numpy(),
                np.asarray(getattr(jg, name)(*map(jnp.asarray, tri))),
                rtol=1e-5)
        assert tg.focal2fov(tg.fov2focal(0.7, 512), 512) == pytest.approx(0.7)
        assert tg.fov2focal(0.7, 512) == jg.fov2focal(0.7, 512)
        np.testing.assert_allclose(float(tg.inverse_sigmoid(torch.tensor(0.1))),
                                   float(jg.inverse_sigmoid(jnp.asarray(0.1))),
                                   rtol=1e-6)

    def test_image_losses_and_knn(self):
        from youreditableavatar_tpu.ops import image_losses as jl, knn as jk
        from youreditableavatar_tpu_torch.ops import image_losses as tl, knn as tk

        rng = np.random.default_rng(3)
        a = rng.uniform(0, 1, (40, 56, 3)).astype(np.float32)
        b = np.clip(a + 0.1 * rng.normal(size=a.shape), 0, 1).astype(np.float32)
        for name in ("l1_loss", "l2_loss", "ssim", "dssim", "l1_dssim", "psnr"):
            np.testing.assert_allclose(
                float(getattr(tl, name)(torch.tensor(a), torch.tensor(b))),
                float(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b))),
                rtol=1e-5, err_msg=name)
        pts = rng.normal(size=(300, 3)).astype(np.float32)
        np.testing.assert_allclose(
            tk.knn_squared_distances(torch.tensor(pts), k=3, tile=128).numpy(),
            np.asarray(jk.knn_squared_distances(jnp.asarray(pts), k=3, tile=128)),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            tk.mean_knn_sq_distance(torch.tensor(pts)).numpy(),
            np.asarray(jk.mean_knn_sq_distance(jnp.asarray(pts))),
            rtol=1e-5, atol=1e-6)

    def test_registry(self):
        from youreditableavatar_tpu_torch.stages.init_texture import (
            TetGSInitTrainer,
        )
        from youreditableavatar_tpu_torch.utils import registry

        assert registry.find("tetgs-init-trainer") is TetGSInitTrainer
        assert "tetgs-init-trainer" in registry.names()
        with pytest.raises(KeyError):
            registry.find("no-such-component")
        with pytest.raises(ValueError):
            registry.register("tetgs-init-trainer")(type("Other", (), {}))


def test_plain_composite_counts_evaluations(scene):
    """`return_evals` leaves the plain compositing's outputs as they are and
    counts (pair, pixel) evaluations of live pixels: every slot of every
    pixel when no pixel stops (this sparse scene; a faint copy), fewer but
    no fewer than the contributions once opaque pairs stop pixels early."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        composite_cuda as comp,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster.preprocess import (
        preprocess_gaussians,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        build_pair_layout_counting,
    )

    s, vm, w, h = scene
    leaves = [torch.as_tensor(s[k]) for k in KEYS]
    proj = preprocess_gaussians(*leaves[:4], None, torch_camera(vm, 0.8, 0.6, w, h),
                                0, 32, colors_override=leaves[4])
    fields, pg, astart, count, _ = build_pair_layout_counting(proj, 3, 2,
                                                              1 << 13, 32)
    rgb, t, cnt = comp.composite_tiles_plain(fields, pg, astart, count, 3, 2)
    rgb2, t2, cnt2, evals = comp.composite_tiles_plain(
        fields, pg, astart, count, 3, 2, return_evals=True)
    assert torch.equal(rgb, rgb2) and torch.equal(t, t2) and torch.equal(cnt, cnt2)
    every_slot = 1024 * int(count.sum())
    assert evals == every_slot
    faint, opaque = fields.clone(), fields.clone()
    faint[:, 5] *= 1e-3
    opaque[:, 5] *= 50.0  # α clamps at 0.99 over most of each footprint
    *_, evals_faint = comp.composite_tiles_plain(
        faint, pg, astart, count, 3, 2, return_evals=True)
    assert evals_faint == every_slot
    *_, cnt_opaque, evals_opaque = comp.composite_tiles_plain(
        opaque, pg, astart, count, 3, 2, return_evals=True)
    assert int(cnt_opaque.sum()) <= evals_opaque < every_slot


@pytest.mark.cuda
def test_composite_kernels_match_plain_on_card(scene, cuda_device):
    """K1f bit for bit, K1b within 5e-5·max|g|, on the card."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        composite_cuda as comp,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster.preprocess import (
        preprocess_gaussians,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        build_pair_layout_counting,
    )

    s, vm, w, h = scene
    leaves = [torch.as_tensor(s[k], device=cuda_device) for k in KEYS]
    cam = torch_camera(vm, 0.8, 0.6, w, h)
    cam = type(cam)(*(x.to(cuda_device) if torch.is_tensor(x) else x for x in cam))
    proj = preprocess_gaussians(*leaves[:4], None, cam, 0, 32,
                                colors_override=leaves[4])
    fields, pg, astart, count, _ = build_pair_layout_counting(proj, 3, 2,
                                                              1 << 13, 32)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    wr = torch.randn((6, 3, 1024), generator=gen, device=cuda_device)
    outs, grads = [], []
    for fn in (comp.composite_tiles_fused, comp.composite_tiles_plain):
        f = fields.detach().requires_grad_()
        rgb, t, cnt = fn(f, pg, astart, count, 3, 2)
        outs.append((rgb, t, cnt))
        grads.append(torch.autograd.grad((rgb * wr).sum() + t.sum(), f)[0])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    scale = max(float(grads[1].abs().max()), 1e-3)
    assert float((grads[0] - grads[1]).abs().max()) <= 5e-5 * scale
