"""PyTorch port vs the JAX package: `stages/localization.py` and the
segmenter edge fix of the inpaint stage.

The scene is `tests/test_texture.py`'s localization test: the marching-tets
sphere of radius 0.35, three 96² probe views at azimuths 0 / 120 / 240,
white background and grey foreground from each package's own mesh
rasterizer. The segmenter masks, the votes' face mask and the vertex mask
are held bit-equal. The edge-fixed inpaint runs on the sphere-cap scene of
`test_torch_edit_texture.py`, with its tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    single_threaded_torch,  # noqa: F401  (fixture)
    sphere_cap_scene,
)
from test_torch_edit_texture import (  # noqa: F401  (fixture)
    _cams,
    _jcfgs,
    _mesh_models,
    _tcfgs,
    scene,
)

from youreditableavatar_tpu.models import cameras as jc
from youreditableavatar_tpu.ops.mesh_raster import rasterize_mesh as jraster
from youreditableavatar_tpu.stages import localization as jloc
from youreditableavatar_tpu_torch.models import cameras as tc
from youreditableavatar_tpu_torch.stages import localization as tloc

CPU = "cpu"
AZIMUTHS = (0.0, 120.0, 240.0)


@pytest.fixture(scope="module")
def probes():
    """The sphere, its three probe cameras (both packages) and the
    coverage images (from the JAX rasterizer, handed to both)."""
    s = sphere_cap_scene()
    verts, faces = s["verts"], s["faces"]
    jcams, tcams = _cams(jc, AZIMUTHS, 96), _cams(tc, AZIMUTHS, 96)
    images = []
    for c in jcams:
        out = jraster(jnp.asarray(verts), jnp.asarray(faces, jnp.int32),
                      c.raster_camera(), _jcfgs()[1])
        img = np.ones((96, 96, 3), np.float32)
        img[np.asarray(out.face_id) >= 0] = 0.5
        images.append(img)
    return verts, faces, jcams, tcams, images


@pytest.mark.parametrize("mode", ["upper", "lower", "center"])
def test_heuristic_segmenter_matches_jax(probes, mode):
    images = probes[4] + [np.ones((96, 96, 3), np.float32)]  # + empty
    js, ts = jloc.HeuristicSegmenter(mode), tloc.HeuristicSegmenter(mode)
    for img in images:
        mj = js.segment(img, "the hat")
        np.testing.assert_array_equal(ts.segment(img, "the hat"), mj)
        np.testing.assert_array_equal(ts.segment(torch.tensor(img), "x"), mj)
    assert ts.segment(images[0], "x").any() and not ts.segment(images[-1],
                                                               "x").any()


@pytest.mark.parametrize("mode", ["upper", "center"])
def test_localize_matches_jax(probes, tmp_path, mode):
    """Votes over the three views, dilate / erode 2, floaters dropped: the
    face and vertex masks bit-equal, the exported file equal."""
    verts, faces, jcams, tcams, images = probes
    kw = dict(dilate_iters=2, erode_iters=2, min_views=2)
    jl = jloc.LocalMeshEditing(verts, faces, jloc.HeuristicSegmenter(mode),
                               jloc.LocalizationConfig(mesh_cfg=_jcfgs()[1],
                                                       **kw))
    tl = tloc.LocalMeshEditing(verts, faces, tloc.HeuristicSegmenter(mode),
                               tloc.LocalizationConfig(mesh_cfg=_tcfgs()[1],
                                                       **kw), device=CPU)
    ij = jl.localize(jcams, images, "the hat", str(tmp_path / "j.npy"))
    it = tl.localize(tcams, images, "the hat", str(tmp_path / "t.npy"))
    assert set(it) == set(ij)
    for k in ij:
        assert it[k].dtype == ij[k].dtype
        np.testing.assert_array_equal(it[k], ij[k], err_msg=k)
    fmask = it["editing_mask_faces"] > 0.5
    assert 0 < fmask.sum() < len(faces)
    if mode == "upper":  # the selection sits in the upper band
        fc = verts[faces].mean(1)
        assert fc[fmask][:, 2].mean() > fc[:, 2].mean()
    back = np.load(tmp_path / "t.npy", allow_pickle=True).item()
    np.testing.assert_array_equal(back["editing_mask"], ij["editing_mask"])
    for info in (it, {"editing_mask": it["editing_mask"]}):
        np.testing.assert_array_equal(
            tloc.region_info_to_face_mask(info, faces),
            jloc.region_info_to_face_mask(info, faces))


def test_registry_name():
    from youreditableavatar_tpu_torch.utils.registry import find

    assert find("mesh-localization") is tloc.LocalMeshEditing


class _Recording:
    """A segmenter that records what it was asked and what it answered."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def segment(self, image, prompt):
        mask = self.inner.segment(image, prompt)
        img = image.detach().numpy() if torch.is_tensor(image) else image
        self.calls.append((np.asarray(img), np.asarray(mask), prompt))
        return mask


def test_inpaint_edge_fix_follows_jax(scene):
    """InpaintTrainer with a segmenter: the joint front/back views (0 and
    1) blend their guidance only inside the painted mask ∩ the "person"
    mask, dilated 15 px. Both packages ask the segmenter the same
    questions (guidance images to 1e-5, masks equal) and fit to the same
    composites (1e-6, every view's targets recorded at its fit steps);
    the first view's loss — one step from equal weights — agrees to 1e-5
    relative, the others to 5e-3 (the Adam drift); the painted sets are
    equal; without the segmenter the composites of views 0 and 1
    differ."""
    from youreditableavatar_tpu.guidance.stub import StubInpainter as JStub
    from youreditableavatar_tpu.stages import edit_texture as js
    from youreditableavatar_tpu_torch.guidance.stub import StubInpainter
    from youreditableavatar_tpu_torch.stages import edit_texture as ts

    kw = dict(iters_first=1, iters_second=2, iters_rest=2, first_group=1,
              second_group=1, fb_res=32)
    ring = (0.0, 180.0, 90.0)
    targets = {}
    for with_seg in (True, False):
        mj, mt = _mesh_models(scene)
        segj = _Recording(jloc.HeuristicSegmenter("center", 0.9))
        segt = _Recording(tloc.HeuristicSegmenter("center", 0.9))
        ji = js.InpaintTrainer(scene["ebj"], scene["epj"], mj, _cams(jc, ring),
                               JStub(), "a red hat", "bad",
                               js.InpaintConfig(raster=_jcfgs()[0], **kw),
                               segmenter=segj if with_seg else None)
        ti = ts.InpaintTrainer(scene["ebt"], scene["ept"].copy(), mt,
                               _cams(tc, ring), StubInpainter(), "a red hat",
                               "bad", ts.InpaintConfig(raster=_tcfgs()[0], **kw),
                               segmenter=segt if with_seg else None,
                               device=CPU)
        tj, tt = [], []
        jfit, tfit = ji._make_fit_step(64, 64), ti._fit_step

        def jstep(params, opt, cam, target, weight):
            tj.append(np.asarray(target))
            return jfit(params, opt, cam, target, weight)

        def tstep(params, opt, cam, target, weight):
            tt.append(target.detach().numpy().copy())
            return tfit(params, opt, cam, target, weight)

        ji._fit_step, ti._fit_step = jstep, tstep
        ji.inpaint_training(jax.random.PRNGKey(0))
        ti.inpaint_training()
        assert len(tt) == len(tj) == 5
        for a, b in zip(tt[:3], tj[:3]):  # views 0 and 1
            np.testing.assert_allclose(a, b, atol=1e-6)
        targets[with_seg] = tt
        if with_seg:
            assert len(segt.calls) == len(segj.calls) == 2  # views 0 and 1
            for (it, mtk, pt), (ij, mjk, pj) in zip(segt.calls, segj.calls):
                assert pt == pj == "person"
                np.testing.assert_allclose(it, ij, atol=1e-5)
                np.testing.assert_array_equal(mtk, mjk)
            assert any(m.any() and not m.all() for _, m, _ in segt.calls)
        lj = [h["loss"] for h in ji.history]
        lt = [h["loss"] for h in ti.history]
        np.testing.assert_allclose(lt[0], lj[0], rtol=1e-5)
        np.testing.assert_allclose(lt, lj, rtol=5e-3)
        np.testing.assert_array_equal(mt.painted, mj.painted)
    for i in (0, 1):  # view 0's target and view 1's first
        assert np.abs(targets[True][i] - targets[False][i]).max() > 1e-3
