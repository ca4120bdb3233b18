"""PyTorch port: the batch-parallel compositing backward (K1b / K6) and the
forward checkpoints it resumes from, on the CPU.

The kernels save each pixel's state at the start of every 128-slot batch a
tile sweeps, and run the backward as one CTA per batch with a per-warp box
cull. Their plain versions live beside them in `composite_cuda.py`:
`composite_tiles_plain(return_checkpoints=True)`, `composite_resume_plain`,
`cull_box_plain` and `composite_backward_plain`. Here they are held against
the plain scan itself, its autograd, and the JAX package (its XLA scan and
its Pallas kernels, interpreted on the CPU). The kernel-vs-plain test at
the end needs a CUDA card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import adversarial_layout
from torch_port_helpers import (
    cuda_device,  # noqa: F401  (fixture)
    jax_camera,
    random_scene,
    single_threaded_torch,  # noqa: F401  (fixture)
    to_torch_proj,
)
from youreditableavatar_tpu_torch.ops.gaussian_raster import composite_cuda as cc

W = H = 64
BUDGET = 4096
GRAD_RTOL_OF_MAX = 5e-5  # per column, as the JAX suite holds its backends
FWD_ATOL = 1e-6  # the JAX suite's forward tolerance against the port


def _project(n, scale_hi, opac_scale):
    """The JAX projection of a 64×64 random scene of n Gaussians (that of
    test_torch_composite_pairs.py at 700, 0.1, 1); `opac_scale` multiplies
    the opacities (large: most α clamp at 0.99 and pixels stop early)."""
    from youreditableavatar_tpu.ops.gaussian_raster.preprocess import (
        preprocess_gaussians,
    )

    scene, vm, _, _ = random_scene(11, n, W, H, scale_hi=scale_hi)
    opac = np.minimum(scene["opac"] * opac_scale, 1.0)
    return preprocess_gaussians(
        *(jnp.asarray(scene[k]) for k in ("means", "scales", "quats")),
        jnp.asarray(opac), jnp.zeros((n, 1, 3)),
        jax_camera(vm, 0.8, 0.8, W, H), 0, 32,
        colors_override=jnp.asarray(scene["colors"]))


@pytest.fixture(scope="module", params=["sparse", "opaque"])
def layout(request):
    """(jax proj, fields_ext, pg_padded, starts, counts) of the counting
    layout: "sparse" (700 Gaussians, 200–270 pairs a tile) sweeps every
    batch; "opaque" (1,200 wider Gaussians, opacities × 30; 640–730 pairs
    a tile) stops a tile after 3 of its 6 batches."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        build_pair_layout_counting,
    )

    proj = (_project(700, 0.1, 1.0) if request.param == "sparse"
            else _project(1200, 0.3, 30.0))
    fields, pg, starts, counts, _ = build_pair_layout_counting(
        to_torch_proj(proj), 2, 2, BUDGET, 32)
    return proj, fields, pg, starts, counts


def _cotangents(num_t, seed=3):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.normal(size=(num_t, 3, 1024)).astype(np.float32)),
            torch.tensor(rng.normal(size=(num_t, 1024)).astype(np.float32)))


# (a) checkpoints and resume ------------------------------------------------


def test_checkpoints_leave_outputs_and_count_swept_batches(layout):
    """The outputs are those of the plain scan, bit for bit; a tile sweeps
    its batches up to the first that leaves no pixel live, and the state
    at each swept batch is consistent (T in (0, 1], a live pixel at the
    start of every batch after the first)."""
    _, fields, pg, starts, counts = layout
    plain = cc.composite_tiles_plain(fields, pg, starts, counts, 2, 2)
    rgb, t, cnt, ckpt = cc.composite_tiles_plain(
        fields, pg, starts, counts, 2, 2, return_checkpoints=True)
    for a, b in zip(plain, (rgb, t, cnt)):
        assert torch.equal(a, b)
    nb = (counts + cc.CHUNK - 1) // cc.CHUNK
    assert ckpt.state.shape == (pg.shape[0] // cc.CHUNK, 4, 1024)
    assert bool((ckpt.swept >= (counts > 0).int()).all())
    assert bool((ckpt.swept <= nb).all())
    # The sparse scene sweeps every batch; the opaque one stops tiles early.
    stopped = int((ckpt.swept < nb).sum())
    assert stopped == 0 if float(fields[:, 5].max()) < 0.99 else stopped > 0
    tile, lb, b = cc.swept_batches(ckpt, starts)
    first = lb == 0
    assert torch.equal(ckpt.state[b[first], 0], torch.ones(int(first.sum()), 1024))
    assert int(ckpt.packed[b[first]].abs().sum()) == 0
    trans = ckpt.state[b, 0]
    assert bool(((trans > 0) & (trans <= 1)).all())
    assert bool((~(ckpt.packed[b[lb > 0]] & 1).bool()).any(dim=1).all())


def test_resume_from_any_checkpoint_is_bit_exact(layout):
    """The plain scan resumed from each tile's checkpoint at any swept
    batch gives rgb, final_t and n_contrib bit for bit."""
    _, fields, pg, starts, counts = layout
    rgb, t, cnt, ckpt = cc.composite_tiles_plain(
        fields, pg, starts, counts, 2, 2, return_checkpoints=True)
    for lb in range(int(ckpt.swept.max())):
        batch = torch.minimum(torch.full_like(ckpt.swept, lb),
                              (ckpt.swept - 1).clamp(min=0))
        out = cc.composite_resume_plain(fields, pg, starts, counts, 2, 2,
                                        ckpt, batch, chunk=48)
        for a, b in zip(out, (rgb, t, cnt)):
            assert torch.equal(a, b), f"resumed at batch {lb}"


def test_checkpoints_match_jax_scan(layout):
    """The state at each swept batch equals the JAX XLA scan over the same
    layout cut at that batch's first slot, to the forward tolerance."""
    from youreditableavatar_tpu.ops.gaussian_raster.composite_xla import (
        composite_tiles_xla,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        gather_pair_rows,
    )

    _, fields, pg, starts, counts = layout
    *_, ckpt = cc.composite_tiles_plain(fields, pg, starts, counts, 2, 2,
                                        return_checkpoints=True)
    rows = gather_pair_rows(fields, pg).numpy()
    cap = int(counts.max() + 31) // 32 * 32
    checked = 0
    for lb in range(1, int(ckpt.swept.max())):
        cut = np.zeros((4, 16, cap), np.float32)
        for ti in range(4):
            keep = min(int(counts[ti]), lb * cc.CHUNK)
            s = int(starts[ti])
            cut[ti, :, :keep] = rows[s:s + keep].T
        rgb, t, cnt = composite_tiles_xla(jnp.asarray(cut), 2, 2, 32, chunk=32)
        for ti in range(4):
            if lb >= int(ckpt.swept[ti]):
                continue
            b = int(starts[ti]) // cc.CHUNK + lb
            np.testing.assert_allclose(ckpt.state[b, 0].numpy(),
                                       np.asarray(t[ti]), atol=FWD_ATOL)
            np.testing.assert_allclose(ckpt.state[b, 1:].numpy(),
                                       np.asarray(rgb[ti]), atol=FWD_ATOL)
            np.testing.assert_array_equal(ckpt.packed[b].numpy() >> 1,
                                          np.asarray(cnt[ti]))
            checked += 1
    assert checked >= 4


# (b) the cull box ------------------------------------------------------------


def _ok_plain(mx, my, ca, cb, cc_, op, px, py):
    """`blend`'s ok for f32 tensors, in the kernels' op order."""
    dx = px - mx
    dy = py - my
    power = -0.5 * (ca * dx * dx + cc_ * dy * dy) - cb * dx * dy
    raw = op * torch.exp(power)
    alpha = torch.where(raw < cc.ALPHA_CLAMP, raw,
                        torch.full_like(raw, cc.ALPHA_CLAMP))
    return (power <= 0.0) & (alpha >= cc.ALPHA_MIN)


ALPHA_MIN_F32 = float(np.float32(1.0 / 255.0))


@st.composite
def gaussians(draw):
    s1 = draw(st.floats(0.3, 300.0))
    s2 = s1 * draw(st.floats(0.003, 1.0))
    th = draw(st.floats(0.0, np.pi))
    op = draw(st.one_of(
        st.floats(1e-6, 0.05).map(lambda e: ALPHA_MIN_F32 * (1 + e)),
        st.just(float(np.nextafter(np.float32(ALPHA_MIN_F32), np.float32(1)))),
        st.floats(0.004, 1.0),
        st.just(0.99)))
    mx = draw(st.floats(-600.0, 600.0))
    my = draw(st.floats(-600.0, 600.0))
    c, s = np.cos(th), np.sin(th)
    i1, i2 = 1 / s1 ** 2, 1 / s2 ** 2
    return np.array([mx, my, c * c * i1 + s * s * i2, c * s * (i1 - i2),
                     s * s * i1 + c * c * i2, op], np.float32)


def _edge_pixels(g, extra):
    """Integer pixels around the ellipse dᵀQd = 2·ln(255·op) (the α cutoff)
    and just outside its exact bounding box, ±`extra` px."""
    mx, my, a, b, c, op = (float(v) for v in g)
    t = max(2 * np.log(255 * op), 0.0)
    det = a * c - b * b
    phi = np.linspace(0, 2 * np.pi, 256, endpoint=False)
    # Points of the ellipse: d = L⁻ᵀ (cos, sin) √t for Q = L Lᵀ.
    q = np.array([[a, b], [b, c]], np.float64)
    lo = np.linalg.cholesky(q)
    d = np.linalg.solve(lo.T, np.stack([np.cos(phi), np.sin(phi)]) * np.sqrt(t))
    hx, hy = np.sqrt(t * c / det), np.sqrt(t * a / det)
    pts = [np.stack([mx + d[0], my + d[1]], 1),
           np.array([[mx + hx, my], [mx - hx, my], [mx, my + hy], [mx, my - hy]])]
    base = np.floor(np.concatenate(pts))
    offs = np.array([(i, j) for i in range(-extra, extra + 2)
                     for j in range(-extra, extra + 2)], np.float64)
    return torch.tensor((base[:, None, :] + offs[None]).reshape(-1, 2),
                        dtype=torch.float32)


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(gaussians(), st.integers(1, 2))
def test_cull_box_is_conservative(g, extra):
    """Every pixel where `blend` gives ok lies inside the pair's box: on
    and around the α cutoff's ellipse and its exact bounding box, for thin
    and wide Gaussians, opacities at and just above 1/255, far means."""
    row = torch.tensor(g)[None]
    box = cc.cull_box_plain(row)[0]
    pix = _edge_pixels(g, extra)
    ok = _ok_plain(*(row[0, i] for i in range(6)), pix[:, 0], pix[:, 1])
    inside = ((pix[:, 0] >= box[0]) & (pix[:, 0] <= box[1])
              & (pix[:, 1] >= box[2]) & (pix[:, 1] <= box[3]))
    assert bool((inside | ~ok).all()), (g, box, pix[ok & ~inside][:4])


def test_cull_box_is_tight_and_never_culls_the_undecidable():
    """A finite box is at most 1 px + 1% wider than the exact ellipse for a
    well-shaped Gaussian; det ≤ 0, op ≤ 1/255 (exactly at the cutoff too)
    and non-finite rows get an infinite box (evaluated, never culled)."""
    rows = torch.tensor([
        [10.0, 20.0, 0.25, 0.0, 0.04, 0.8],     # σ 2 × 5 px
        [10.0, 20.0, 0.25, 0.5, 0.04, 0.8],     # indefinite
        [10.0, 20.0, 0.25, 0.0, 0.04, ALPHA_MIN_F32],
        [10.0, 20.0, 0.25, 0.0, 0.04, 1e-3],
        [10.0, 20.0, -0.25, 0.0, -0.04, 0.8],   # negative definite
        [10.0, 20.0, float("nan"), 0.0, 0.04, 0.8],
    ])
    box = cc.cull_box_plain(rows)
    t = 2 * np.log(255 * 0.8)
    hx, hy = np.sqrt(t / 0.25), np.sqrt(t / 0.04)
    assert hx + 1 <= float(box[0, 1]) - 10 <= 1.01 * hx + 1.01
    assert hy + 1 <= float(box[0, 3]) - 20 <= 1.01 * hy + 1.01
    inf = torch.tensor([-np.inf, np.inf, -np.inf, np.inf])
    for i in range(1, 6):
        assert torch.equal(box[i], inf), i


def test_cull_skips_most_warp_sweeps(layout):
    """On the scene's layout the box leaves a minority of the (pair, warp)
    sweeps: small Gaussians against a 32-px tile."""
    _, fields, pg, starts, counts = layout
    rows = fields[pg.long()]
    box = cc.cull_box_plain(rows)
    x0, x1, y0, y1 = cc._warp_blocks(2, 2, "cpu")
    hits = total = 0
    for ti in range(4):
        s, n = int(starts[ti]), int(counts[ti])
        bb = box[s:s + n]
        for p in range(0, 1024, 32 * 4):  # one pixel of each warp's block
            miss = ((bb[:, 1] < x0[ti, p]) | (bb[:, 0] > x1[ti, p])
                    | (bb[:, 3] < y0[ti, p]) | (bb[:, 2] > y1[ti, p]))
            hits += int((~miss).sum())
            total += n
    assert total == 8 * int(counts.sum())
    assert hits < 0.6 * total


# (c) the segmented backward --------------------------------------------------


def _assert_columns(got, want, cols, what):
    for col in cols:
        tol = GRAD_RTOL_OF_MAX * max(float(want[:, col].abs().max()), 1e-6)
        err = float((got[:, col] - want[:, col]).abs().max())
        assert err <= tol, f"{what} column {col}: {err} > {tol}"


def _segmented(fields, pg, starts, counts, ntx, nty, drgb, dt):
    rgb, t, _, ckpt = cc.composite_tiles_plain(
        fields, pg, starts, counts, ntx, nty, return_checkpoints=True)
    return cc.composite_backward_plain(fields, pg, starts, counts, ntx, nty,
                                       rgb, t, drgb, dt, ckpt)


def _autograd(fn, x, *args, cot):
    x = x.detach().clone().requires_grad_()
    rgb, t, _ = fn(x, *args)
    return torch.autograd.grad((rgb * cot[0]).sum() + (t * cot[1]).sum(), x)[0]


def test_segmented_backward_matches_autograd(layout):
    """K1b's per-Gaussian and K6's per-pair outputs of the plain segmented
    backward (resumed from the checkpoints, with the box cull) against
    autograd of the plain scan, 5e-5·max|g| per column."""
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        gather_pair_rows,
    )

    _, fields, pg, starts, counts = layout
    cot = _cotangents(4)
    sums = _segmented(fields, pg, starts, counts, 2, 2, *cot)
    got = cc.dfields_from_raw(fields, cc.backward_raw_plain(fields, pg, sums))
    want = _autograd(cc.composite_tiles_plain, fields, pg, starts, counts, 2,
                     2, cot=cot)
    _assert_columns(got, want, range(9), "per-Gaussian")
    np.testing.assert_array_equal(got[:, 9:].numpy(), 0.0)

    rows = gather_pair_rows(fields, pg).detach()
    got = cc.backward_pairs_plain(rows, sums)
    want = _autograd(cc.composite_tiles_pairs_plain, rows, starts, counts, 2,
                     2, cot=cot)
    _assert_columns(got, want, range(9), "per-pair")
    np.testing.assert_array_equal(got[pg == 0].numpy(), 0.0)
    np.testing.assert_array_equal(got[:, 9:].numpy(), 0.0)


@pytest.mark.parametrize("seed", [5, 6])
def test_segmented_backward_on_adversarial_layout(seed):
    """The same on the layout built against the cull: σ up to 120 px
    across tile edges, opacities just above and at 1/255, opaque pairs,
    indefinite conics (chip_smoke.py's check, at 3 × 2 tiles)."""
    fields, pg, starts, counts = adversarial_layout("cpu", seed, 3, 2, 300)
    cot = _cotangents(6, seed=seed)
    sums = _segmented(fields, pg, starts, counts, 3, 2, *cot)
    got = cc.dfields_from_raw(fields, cc.backward_raw_plain(fields, pg, sums))
    want = _autograd(cc.composite_tiles_plain, fields, pg, starts, counts, 3,
                     2, cot=cot)
    _assert_columns(got, want, range(9), "per-Gaussian")
    rows = fields[pg.long()]
    _assert_columns(cc.backward_pairs_plain(rows, sums),
                    _autograd(cc.composite_tiles_pairs_plain, rows, starts,
                              counts, 3, 2, cot=cot), range(9), "per-pair")


def test_segmented_backward_matches_jax(layout):
    """The segmented backward against the JAX Pallas kernels (interpreted):
    per pair through `composite_tiles_pallas`, per Gaussian through
    `composite_tiles_pallas_fused`, 5e-5·max|g| per column on real pairs."""
    from youreditableavatar_tpu.ops.gaussian_raster.composite_pallas import (
        composite_tiles_pallas,
        composite_tiles_pallas_fused,
    )
    from youreditableavatar_tpu_torch.ops.gaussian_raster.render import (
        gather_pair_rows,
    )

    _, fields, pg, starts, counts = layout
    cot = _cotangents(4, seed=9)
    sums = _segmented(fields, pg, starts, counts, 2, 2, *cot)
    jcot = tuple(jnp.asarray(c.numpy()) for c in cot)
    js, jc = jnp.asarray(starts.numpy()), jnp.asarray(counts.numpy())

    rows = gather_pair_rows(fields, pg).detach()
    _, vjp = jax.vjp(lambda r: composite_tiles_pallas(r, js, jc, 2, 2, 32,
                                                      True)[:2],
                     jnp.asarray(rows.numpy()))
    real = (pg > 0).numpy()
    _assert_columns(cc.backward_pairs_plain(rows, sums)[real],
                    torch.tensor(np.asarray(vjp(jcot)[0]))[real], range(9),
                    "per-pair vs JAX")

    jpg = jnp.asarray(pg.numpy())
    _, vjp = jax.vjp(lambda f: composite_tiles_pallas_fused(
        f, jpg, js, jc, 2, 2, 32, True)[:2], jnp.asarray(fields.numpy()))
    got = cc.dfields_from_raw(fields, cc.backward_raw_plain(fields, pg, sums))
    _assert_columns(got, torch.tensor(np.asarray(vjp(jcot)[0])), range(9),
                    "per-Gaussian vs JAX")


# On the card -----------------------------------------------------------------


@pytest.mark.cuda
def test_kernel_checkpoints_and_backwards_on_card(layout, cuda_device):
    """K1f's checkpoints bit-equal to the plain ones; K1b and K6 against
    the plain segmented backward at 5e-5·max|g| per column."""
    _, fields, pg, starts, counts = layout
    args = [x.to(cuda_device) for x in (fields, pg, starts, counts)]
    cot = [c.to(cuda_device) for c in _cotangents(4)]
    rgb, t, _, ck = cc._forward(*args, 2, True)
    _, _, _, ck_plain = cc.composite_tiles_plain(*args, 2, 2,
                                                 return_checkpoints=True)
    _, _, b = cc.swept_batches(ck_plain, args[2])
    assert torch.equal(ck.swept, ck_plain.swept)
    assert torch.equal(ck.state[b], ck_plain.state[b])
    assert torch.equal(ck.packed[b], ck_plain.packed[b])
    sums = cc.composite_backward_plain(*args, 2, 2, rgb, t, *cot, ck)
    raw = cc._backward_raw(*args, rgb, t, *cot, 2, ck)
    _assert_columns(raw[:, :9], cc.backward_raw_plain(args[0], args[1], sums),
                    range(9), "K1b")
    rows = args[0][args[1].long()]
    drows = cc.backward_pairs(rows, args[2], args[3], rgb, t, *cot, 2, ck)
    _assert_columns(drows, cc.backward_pairs_plain(rows, sums), range(9), "K6")
