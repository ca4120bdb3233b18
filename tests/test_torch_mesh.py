"""PyTorch port vs the JAX package: `models/mesh.py` (normals, the UV
atlas, tangents, outlier removal, normal consistency) and
`ops/shape_loss.py` (winding numbers, `ShapeLoss`), on the marching-tets
sphere of `tests/test_mesh_utils.py`.

The host NumPy parts are the same code in both packages and are held
bit-equal. Tolerances: normal consistency 1e-6 absolute (f32 cancellation,
as in `test_torch_spatial.py`); winding numbers 1e-5 absolute (solid
angles summed over 600-odd faces in another order); the BCE loss 1e-5
relative; the proximity weight bit-equal (both call `meshsdf.cpp`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    single_threaded_torch,  # noqa: F401  (fixture)
    sphere_cap_scene,
)

from youreditableavatar_tpu.models import mesh as jm
from youreditableavatar_tpu.ops import shape_loss as jsl
from youreditableavatar_tpu_torch.models import mesh as tm
from youreditableavatar_tpu_torch.ops import shape_loss as tsl

CPU = "cpu"


@pytest.fixture(scope="module")
def sphere():
    s = sphere_cap_scene()
    return s["verts"], s["faces"].astype(np.int64)


def test_normals_atlas_and_tangents_match_jax(sphere):
    verts, faces = sphere
    mj, mt = jm.Mesh(verts, faces), tm.Mesh(verts, faces)
    np.testing.assert_array_equal(mt.v_nrm, mj.v_nrm)
    np.testing.assert_array_equal(mt.v_tex, mj.v_tex)
    np.testing.assert_array_equal(mt.t_tex_idx, mj.t_tex_idx)
    np.testing.assert_array_equal(mt.v_tng, mj.v_tng)
    uv = mt.v_tex
    assert uv.min() >= 0.0 and uv.max() <= 1.0
    assert mt.t_tex_idx.shape == faces.shape
    assert not tm._chart_self_overlaps(uv.astype(np.float64), mt.t_tex_idx,
                                       res=768)
    dots = np.abs(np.sum(mt.v_tng * mt.v_nrm, -1))
    assert dots.max() < 1e-3


def test_unwrap_options_and_shelf_pack_match_jax(sphere):
    verts, faces = sphere
    for kw in (dict(padding=0.02, cone_angle_deg=40.0),
               dict(max_chart_faces=50)):
        mj, mt = jm.Mesh(verts, faces), tm.Mesh(verts, faces)
        mj.unwrap_uv(**kw)
        mt.unwrap_uv(**kw)
        np.testing.assert_array_equal(mt.v_tex, mj.v_tex)
        np.testing.assert_array_equal(mt.t_tex_idx, mj.t_tex_idx)
    sizes = np.random.default_rng(0).uniform(0.05, 0.3, (20, 2))
    np.testing.assert_array_equal(tm._shelf_pack(sizes, 0.01),
                                  jm._shelf_pack(sizes, 0.01))
    assert tm._shelf_pack_scale(sizes, 0.01) == jm._shelf_pack_scale(sizes, 0.01)


def test_remove_outliers_and_normal_consistency_match_jax(sphere):
    verts, faces = sphere
    v2 = np.concatenate([verts, np.array([[2, 2, 2], [2.1, 2, 2], [2, 2.1, 2]],
                                         np.float32)])
    f2 = np.concatenate([faces, np.array([[len(verts), len(verts) + 1,
                                           len(verts) + 2]])])
    cj, ct = jm.Mesh(v2, f2).remove_outliers(), tm.Mesh(v2, f2).remove_outliers()
    assert len(ct.t_pos_idx) == len(faces)
    np.testing.assert_array_equal(ct.v_pos, cj.v_pos)
    np.testing.assert_array_equal(ct.t_pos_idx, cj.t_pos_idx)
    nc_t = ct.normal_consistency(device=CPU)
    assert nc_t.device.type == "cpu" and nc_t.dim() == 0
    np.testing.assert_allclose(float(nc_t), float(cj.normal_consistency()),
                               atol=1e-6)


def test_winding_number_matches_jax_for_every_chunk(sphere):
    verts, faces = sphere
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.uniform(-0.6, 0.6, (500, 3)),
                          [[0, 0, 0], [0.9, 0.9, 0.9], [0.2, 0, 0]]]).astype(
        np.float32)
    wj = np.asarray(jsl.winding_number(jnp.asarray(pts), jnp.asarray(verts),
                                       jnp.asarray(faces, jnp.int32)))
    vt, ft = torch.tensor(verts), torch.tensor(faces.astype(np.int32))
    w = {c: tsl.winding_number(torch.tensor(pts), vt, ft, chunk=c).numpy()
         for c in (None, 2048, 97, 1)}
    for c, wt in w.items():
        np.testing.assert_allclose(wt, wj, atol=1e-5, err_msg=str(c))
        np.testing.assert_array_equal(wt > 0.5, wj > 0.5)
    assert w[None][-3] > 0.9 and abs(w[None][-2]) < 0.1 and w[None][-1] > 0.9
    assert tsl.default_chunk(len(faces)) == 2048
    assert tsl.default_chunk(81_920) == (1 << 30) // (80 * 81_920)
    assert tsl.winding_number(torch.zeros((0, 3)), vt, ft).shape == (0,)


@pytest.mark.parametrize("proximal", [0.0, 0.3])
def test_shape_loss_matches_jax(sphere, proximal):
    verts, faces = sphere
    sj = jsl.ShapeLoss(verts, faces, proximal_surface=proximal)
    st = tsl.ShapeLoss(verts, faces, proximal_surface=proximal, device=CPU)
    np.testing.assert_array_equal(st.verts.numpy(), np.asarray(sj.verts))
    rng = np.random.default_rng(2)
    pts = rng.uniform(-0.5, 0.5, (256, 3)).astype(np.float32)
    sig = rng.uniform(0, 60, 256).astype(np.float32)
    wgt = st.proximity_weight(pts)
    np.testing.assert_array_equal(wgt, sj.proximity_weight(pts))
    if proximal == 0.0:
        assert (wgt == 1).all()
    x = torch.tensor(sig, requires_grad=True)
    lt = st(torch.tensor(pts), x, torch.tensor(wgt))
    lj = sj(jnp.asarray(pts), jnp.asarray(sig), jnp.asarray(wgt))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    lt.backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0
    # Occupancy that matches the winding indicator scores lower.
    inside = tsl.winding_number(torch.tensor(pts), st.verts, st.faces) > 0.5
    good = torch.where(inside, 50.0, 0.0)
    bad = torch.where(inside, 0.0, 50.0)
    assert float(st(torch.tensor(pts), good)) < float(st(torch.tensor(pts), bad))
