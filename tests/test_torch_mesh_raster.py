"""PyTorch port vs the JAX package: the mesh visibility rasterizer (K5's
module), the differentiable interpolation over it, and mask morphology.

Inputs are numpy, made from fixed seeds. The JAX rasterizer runs its Pallas
z-buffer kernel in interpret mode and, separately, its XLA scan with a tile
capacity no tile reaches; the port runs on the CPU through the plain
PyTorch version of its CUDA kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import icosphere
from torch_port_helpers import (
    cuda_device,  # noqa: F401  (fixture)
    jax_camera,
    look_at_viewmat,
    single_threaded_torch,  # noqa: F401  (fixture)
    torch_camera,
)

BUDGET = 1 << 12
# Covered pixels' barycentrics and depth, and the projected vertices: both
# packages do the same f32 arithmetic, XLA may fuse differently.
ATOL = 1e-6


def _sphere(scale=1.0):
    verts, faces = icosphere(2, 0.8)  # 320 faces
    return verts * scale, faces


def _case(name):
    """(verts, faces, faces_valid, camera kwargs, config kwargs)."""
    verts, faces = _sphere()
    cam = dict(vm=look_at_viewmat(3.0), width=64, height=64)
    valid, cfg = None, {}
    if name == "sphere_80x48":
        cam.update(width=80, height=48)
    elif name == "faces_valid":
        valid = np.random.default_rng(0).uniform(size=len(faces)) > 0.4
    elif name == "backface_cull":
        cfg["backface_cull"] = True
    elif name == "behind_camera":
        # The camera sits inside the sphere: half the faces are behind it.
        cam["vm"] = look_at_viewmat(0.1)
    elif name == "offscreen":
        verts = np.concatenate([verts, verts + np.float32([5.0, 0, 0])])
        faces = np.concatenate([faces, faces + len(verts) // 2])
    elif name == "degenerate":
        faces = faces.copy()
        faces[::7, 2] = faces[::7, 1]  # zero-area faces
    elif name == "coplanar_tie":
        # Three coincident quads: 6 coplanar faces over the same pixels,
        # equal in depth everywhere. The quad is skewed so that no pixel
        # centre lies exactly on the shared diagonal, where l1 == 0 and
        # XLA's fused multiply-adds may decide the inside test differently.
        q = np.float32([[-.5, -.47, 0], [.52, -.5, 0], [.5, .53, 0],
                        [-.51, .5, 0]])
        verts = np.concatenate([q, q, q])
        faces = np.int64([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7],
                          [8, 9, 10], [8, 10, 11]])
    elif name == "small_budget":
        cfg["pair_budget"] = 128  # fewer slots than (face, tile) pairs
    elif name != "sphere_64":
        raise KeyError(name)
    return verts.astype(np.float32), faces, valid, cam, cfg


CASES = ["sphere_64", "sphere_80x48", "faces_valid", "backface_cull",
         "behind_camera", "offscreen", "degenerate", "coplanar_tie",
         "small_budget"]


def _rasterize_jax(case, backend):
    from youreditableavatar_tpu.ops.mesh_raster.raster import (
        MeshRasterConfig, rasterize_mesh,
    )

    verts, faces, valid, cam, cfg = _case(case)
    kw = {"pair_budget": BUDGET, **cfg}
    if backend == "pallas":
        mcfg = MeshRasterConfig(backend="pallas", pallas_interpret=True, **kw)
    else:
        mcfg = MeshRasterConfig(backend="xla", tile_capacity=BUDGET, **kw)
    return rasterize_mesh(
        jnp.asarray(verts), jnp.asarray(faces, jnp.int32),
        jax_camera(cam["vm"], 0.8, 0.8, cam["width"], cam["height"]), mcfg,
        None if valid is None else jnp.asarray(valid))


def _rasterize_port(case):
    from youreditableavatar_tpu_torch.ops.mesh_raster.raster import (
        MeshRasterConfig, rasterize_mesh,
    )

    verts, faces, valid, cam, cfg = _case(case)
    return rasterize_mesh(
        torch.tensor(verts), torch.tensor(faces, dtype=torch.int32),
        torch_camera(cam["vm"], 0.8, 0.8, cam["width"], cam["height"]),
        MeshRasterConfig(**{"pair_budget": BUDGET, **cfg}),
        None if valid is None else torch.tensor(valid))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("case", CASES)
def test_rasterize_mesh_matches_jax(case, backend):
    """face_id and num_pairs exact; bary/depth on covered pixels and the
    projected vertices to ATOL."""
    ref = _rasterize_jax(case, backend)
    out = _rasterize_port(case)
    fid = np.asarray(ref.face_id)
    np.testing.assert_array_equal(out.face_id.numpy(), fid)
    assert out.face_id.dtype == torch.int32
    assert int(out.num_pairs) == int(ref.num_pairs)
    covered = fid >= 0
    np.testing.assert_allclose(out.bary.numpy()[covered],
                               np.asarray(ref.bary)[covered], atol=ATOL)
    np.testing.assert_allclose(out.depth.numpy()[covered],
                               np.asarray(ref.depth)[covered], atol=ATOL)
    np.testing.assert_array_equal(out.depth.numpy()[~covered],
                                  np.asarray(ref.depth)[~covered])
    np.testing.assert_allclose(out.verts_screen.numpy(),
                               np.asarray(ref.verts_screen), atol=ATOL,
                               rtol=1e-6)
    np.testing.assert_allclose(out.verts_zw.numpy(),
                               np.asarray(ref.verts_zw), atol=ATOL, rtol=1e-6)
    if case == "coplanar_tie":
        # The earliest pair wins a tie: only the first two faces are seen.
        assert set(np.unique(fid)) == {-1, 0, 1}
    elif case == "small_budget":
        # As in the JAX package, num_pairs saturates at the budget.
        assert int(out.num_pairs) == 128
    elif case == "sphere_64":
        assert 0.2 < covered.mean() < 0.8 and int(out.num_pairs) < BUDGET
    elif case == "backface_cull":
        # Only one winding survives: fewer pairs, the same silhouette.
        full = _rasterize_port("sphere_64")
        assert int(out.num_pairs) < int(full.num_pairs)
        np.testing.assert_array_equal(covered, full.face_id.numpy() >= 0)


def test_resolve_rejects_what_the_kernel_does_not_take():
    from youreditableavatar_tpu_torch.ops.mesh_raster import raster

    # CPU tensors never reach the kernel's checks; the checks themselves
    # need no card.
    rows = torch.zeros((4, raster.ROW_FLOATS))
    with pytest.raises(ValueError, match="CUDA tensor"):
        raster._kernels.check_cuda("rows", rows, torch.float32, 2)
    out = raster.resolve_tiles(rows, torch.zeros(8, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32),
                               1, 1, 32, 20, 10)
    assert out[0].shape == (10, 20) and bool((out[1] == -1).all())
    assert float(out[0].max()) == np.float32(raster.Z_FAR)


def test_empty_mesh_is_background():
    from youreditableavatar_tpu_torch.ops.mesh_raster.raster import (
        MeshRasterConfig, rasterize_mesh,
    )

    out = rasterize_mesh(torch.zeros((0, 3)), torch.zeros((0, 3), dtype=torch.int32),
                         torch_camera(look_at_viewmat(), 0.8, 0.8, 40, 40),
                         MeshRasterConfig(pair_budget=1024))
    assert bool((out.face_id == -1).all()) and int(out.num_pairs) == 0


# ---- differentiable interpolation ------------------------------------------


def _interp_inputs():
    verts, faces = _sphere()
    rng = np.random.default_rng(3)
    attrs = rng.normal(size=(len(verts), 3)).astype(np.float32)
    cot = rng.normal(size=(64, 64, 3)).astype(np.float32)
    return verts, faces, attrs, cot


def _interp_loss(mod, rast, xp, name):
    """loss(verts, attrs) for interpolation function `name` of module set
    (`mod` = interpolate module, `rast` = rasterize closure)."""
    _, faces, _, cot = _interp_inputs()

    def loss(verts, attrs):
        out = rast(verts)
        f = xp.asarray(faces).astype(xp.int32) if xp is jnp else \
            torch.tensor(faces, dtype=torch.int32)
        c = xp.asarray(cot) if xp is jnp else torch.tensor(cot)
        if name == "persp":
            img = mod.interpolate_attributes(out, f, attrs, background=0.25)
        elif name == "affine":
            img = mod.interpolate_attributes(out, f, attrs, perspective=False)
        elif name == "silhouette":
            img = mod.silhouette_alpha(out, f, 0.7)[..., None] * (attrs ** 2).mean()
        else:  # normals
            vn = mod.compute_vertex_normals(verts, f)
            img = mod.interpolate_attributes(out, f, vn * attrs)
        return (img * c).sum(), img

    return loss


@pytest.mark.parametrize("name", ["persp", "affine", "silhouette", "normals"])
def test_interpolation_values_and_gradients_match_jax(name):
    """Values ≤ 1e-6; gradients w.r.t. verts and attrs ≤ 1e-5·max|g|."""
    from youreditableavatar_tpu.ops.mesh_raster import interpolate as ji
    from youreditableavatar_tpu.ops.mesh_raster.raster import (
        MeshRasterConfig as JCfg, rasterize_mesh as jrast,
    )
    from youreditableavatar_tpu_torch.ops.mesh_raster import interpolate as ti
    from youreditableavatar_tpu_torch.ops.mesh_raster.raster import (
        MeshRasterConfig, rasterize_mesh,
    )

    verts, faces, attrs, _ = _interp_inputs()
    vm = look_at_viewmat(3.0)
    jcam, tcam = jax_camera(vm, 0.8, 0.8, 64, 64), torch_camera(vm, 0.8, 0.8, 64, 64)
    jcfg = JCfg(pair_budget=BUDGET, backend="xla", tile_capacity=BUDGET)
    jloss = _interp_loss(
        ji, lambda v: jrast(v, jnp.asarray(faces, jnp.int32), jcam, jcfg),
        jnp, name)
    tloss = _interp_loss(
        ti, lambda v: rasterize_mesh(v, torch.tensor(faces, dtype=torch.int32),
                                     tcam, MeshRasterConfig(pair_budget=BUDGET)),
        torch, name)
    (_, jimg), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(verts), jnp.asarray(attrs))
    tv = torch.tensor(verts, requires_grad=True)
    ta = torch.tensor(attrs, requires_grad=True)
    loss, timg = tloss(tv, ta)
    loss.backward()
    np.testing.assert_allclose(timg.detach().numpy(), np.asarray(jimg),
                               atol=1e-6, rtol=1e-6)
    for got, ref in zip((tv.grad, ta.grad), jg):
        ref = np.asarray(ref)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), ref,
                                   atol=1e-5 * max(np.abs(ref).max(), 1e-3))


# ---- morphology ----------------------------------------------------------------


def _binary_mask(seed=0, shape=(40, 56)):
    rng = np.random.default_rng(seed)
    m = rng.uniform(size=shape) > 0.8
    m[10:25, 20:40] = True
    return m


@pytest.mark.parametrize("size", [3, 5, 9, 15])
@pytest.mark.parametrize("op", ["dilate", "erode"])
def test_image_morphology_matches_jax(op, size):
    from youreditableavatar_tpu.ops import morphology as jm
    from youreditableavatar_tpu_torch.ops import morphology as tm

    m = _binary_mask()
    iters = 2 if size == 3 else 1
    ref = getattr(jm, op)(jnp.asarray(m), iters, size)
    out = getattr(tm, op)(torch.tensor(m), iters, size)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(40, 56), (40, 56, 3)])
@pytest.mark.parametrize("size", [5, 9])
def test_box_blur_matches_jax(size, shape):
    from youreditableavatar_tpu.ops.morphology import box_blur as jblur
    from youreditableavatar_tpu_torch.ops.morphology import box_blur

    img = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    np.testing.assert_allclose(box_blur(torch.tensor(img), size).numpy(),
                               np.asarray(jblur(jnp.asarray(img), size)),
                               atol=1e-6)


def test_face_region_functions_match_jax():
    from youreditableavatar_tpu.ops import morphology as jm
    from youreditableavatar_tpu_torch.ops import morphology as tm

    verts, faces = _sphere()
    faces = faces[:-20]  # an open mesh: boundary edges have no neighbour
    fmask = verts[faces].mean(1)[:, 2] > 0.3
    np.testing.assert_array_equal(tm.face_adjacency(faces),
                                  jm.face_adjacency(faces))
    for fn in ("dilate_face_region", "erode_face_region"):
        got = getattr(tm, fn)(faces, torch.as_tensor(fmask), 2)
        np.testing.assert_array_equal(got.numpy(),
                                      getattr(jm, fn)(faces, fmask, 2))
    np.testing.assert_array_equal(
        tm.vertex_mask_from_faces(faces, fmask, len(verts)),
        jm.vertex_mask_from_faces(faces, fmask, len(verts)))
    vmask = verts[:, 2] > 0.3
    for mode in ("any", "all"):
        np.testing.assert_array_equal(
            tm.face_mask_from_vertices(faces, vmask, mode),
            jm.face_mask_from_vertices(faces, vmask, mode))


# ---- on the card -----------------------------------------------------------------


@pytest.mark.cuda
def test_resolve_kernel_matches_plain_on_card(cuda_device):
    """K5 against its plain version on the card, bit for bit."""
    from youreditableavatar_tpu_torch.ops.mesh_raster import raster

    verts, faces, _, cam, _ = _case("coplanar_tie")
    v2, f2 = _sphere()
    verts = np.concatenate([verts, v2])
    faces = np.concatenate([faces, f2 + 12])
    camera = torch_camera(cam["vm"], 0.8, 0.8, 80, 48)
    camera = type(camera)(*(x.to(cuda_device) if torch.is_tensor(x) else x
                            for x in camera))
    cfg = raster.MeshRasterConfig(pair_budget=BUDGET)
    _, _, args = raster.tile_face_lists(
        torch.tensor(verts, device=cuda_device),
        torch.tensor(faces, dtype=torch.int32, device=cuda_device), camera, cfg)
    for a, b in zip(raster.resolve_tiles(*args),
                    raster.resolve_tiles_plain(*args)):
        assert torch.equal(a, b)


# ---- K5's conservative face box ------------------------------------------------


@st.composite
def _slivers(draw):
    """One face row at 64² that is thin, long or grazes pixel centres:
    vertices on or off the pixel grid, any angle or an axis / diagonal,
    1e-7 to 2 px across (or a well-shaped triangle), 0.5 to 300 px long."""
    x0, y0 = draw(st.floats(0.0, 64.0)), draw(st.floats(0.0, 64.0))
    if draw(st.booleans()):
        x0, y0 = float(round(x0)), float(round(y0))
    ang = draw(st.one_of(st.floats(0.0, 2 * np.pi),
                         st.sampled_from([k * np.pi / 4 for k in range(8)])))
    length = draw(st.floats(0.5, 300.0))
    across = draw(st.one_of(st.floats(1e-7, 2.0), st.floats(2.0, 40.0)))
    t = draw(st.floats(-0.5, 1.5))
    e = np.array([np.cos(ang), np.sin(ang)])
    p0 = np.array([x0, y0])
    p1 = p0 + length * e
    p2 = p0 + t * length * e + across * np.array([-e[1], e[0]])
    return np.concatenate([p0, p1, p2, [0.5, 0.5, 0.5]]).astype(np.float32)[None]


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(_slivers())
def test_face_box_is_conservative(row):
    """Every pixel that `resolve_tiles_plain` finds inside a face lies in the
    face's box (`face_box_plain`, the kernel's `face_box`), slivers too."""
    from chip_smoke import mesh_resolve_layout
    from youreditableavatar_tpu_torch.ops.mesh_raster import raster

    args = mesh_resolve_layout(row, 64, 64, 1 << 10, "cpu")
    _, face_id, _ = raster.resolve_tiles_plain(*args)
    box = raster.face_box_plain(torch.tensor(row))[0]
    ys, xs = torch.nonzero(face_id == 0, as_tuple=True)
    inside = ((xs >= box[0]) & (xs <= box[1]) & (ys >= box[2]) & (ys <= box[3]))
    assert bool(inside.all()), (row, box, xs[~inside][:4], ys[~inside][:4])


def test_face_box_is_tight_and_infinite_where_unbounded():
    """A well-shaped face's box is its bounding box widened by under 0.01 px;
    degenerate and non-finite faces get an infinite box, a 2e-3-px sliver
    8,000 px long one wider than the image by far."""
    from youreditableavatar_tpu_torch.ops.mesh_raster import raster

    rows = torch.tensor([
        [10.0, 20.0, 40.0, 22.0, 25.0, 50.0, 0.5, 0.5, 0.5],
        [10.0, 20.0, 20.0, 30.0, 30.0, 40.0, 0.5, 0.5, 0.5],  # d == 0
        [10.0, float("nan"), 20.0, 30.0, 30.0, 41.0, 0.5, 0.5, 0.5],
        [0.0, 0.0, 4000.0, 1.0, 8000.0, 2.0 + 1e-3, 0.5, 0.5, 0.5],
    ])
    box = raster.face_box_plain(rows)
    want = torch.tensor([10.0, 40.0, 20.0, 50.0])
    assert bool(((box[0] - want).abs() < 0.01).all())
    assert bool((box[0, [0, 2]] <= want[[0, 2]]).all())
    assert bool((box[0, [1, 3]] >= want[[1, 3]]).all())
    inf = torch.tensor([-np.inf, np.inf, -np.inf, np.inf])
    for i in (1, 2):
        assert torch.equal(box[i], inf), i
    assert float(box[3, 0]) < -1e5 and float(box[3, 1]) > 1e5


def test_binned_rows_match_the_mesh_binning():
    """`chip_smoke.mesh_resolve_layout` bins screen rows as `tile_face_lists`
    bins a mesh: the same pair lists for the sphere case's rows."""
    from chip_smoke import mesh_resolve_layout
    from youreditableavatar_tpu_torch.ops.mesh_raster import raster

    verts, faces, _, cam, _ = _case("sphere_80x48")
    camera = torch_camera(cam["vm"], 0.8, 0.8, 80, 48)
    cfg = raster.MeshRasterConfig(pair_budget=BUDGET)
    _, _, args = raster.tile_face_lists(
        torch.tensor(verts), torch.tensor(faces, dtype=torch.int32), camera, cfg)
    again = mesh_resolve_layout(args[0], 80, 48, BUDGET, "cpu")
    for a, b in zip(args[1:4], again[1:4]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_resolve_kernel_matches_plain_on_slivers_and_ties(cuda_device):
    """K5 bit-equal to its plain version on slivers listed twice at 500×300:
    the cull box, ties (the first copy wins) and a ragged edge."""
    from chip_smoke import mesh_resolve_layout, sliver_rows
    from youreditableavatar_tpu_torch.ops.mesh_raster import raster

    rows = sliver_rows(n=1500)
    args = mesh_resolve_layout(rows, 500, 300, 1 << 20, cuda_device)
    got = raster.resolve_tiles(*args)
    for a, b in zip(got, raster.resolve_tiles_plain(*args)):
        assert torch.equal(a, b)
    assert int(got[1].max()) < len(rows) // 2
