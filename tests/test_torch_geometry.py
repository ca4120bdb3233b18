"""PyTorch port vs the JAX package: marching tets, the partitioned tet
geometry and the part renderer.

Both packages get the same numpy inputs (grid 10, the small field of
`tests/test_spatial.py`, its JAX parameters carried across). Integer
outputs — tet grids, edge slots, compactions, partitions, face lists —
must agree bit for bit; vertices to 1e-6; the partitioned surface's
parameter gradients at `test_spatial.py::test_sparse_grad_matches_dense`'s
tolerance (rtol 1e-4, atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    assert_mesh_close,
    partitions,
    single_threaded_torch,  # noqa: F401  (fixture)
    small_geometries,
)

from youreditableavatar_tpu.ops import marching_tets as jmt
from youreditableavatar_tpu_torch.ops import marching_tets as tmt


def _sphere_sdf(res, radius=0.35, noise=0.01, seed=0):
    gv, gt = jmt.make_tet_grid(res)
    rng = np.random.default_rng(seed)
    sdf = (np.linalg.norm(gv, axis=-1) - radius
           + noise * rng.normal(size=len(gv))).astype(np.float32)
    return gv, gt, sdf


@pytest.fixture(scope="module")
def geoms():
    jg, tg, jp, tp = small_geometries()
    jpart, tpart, edit = partitions(jg, tg, jp, tp)
    return dict(jg=jg, tg=tg, jp=jp, tp=tp, jpart=jpart, tpart=tpart,
                edit=edit)


class TestTetGrid:
    @pytest.mark.parametrize("res", [1, 4, 10])
    def test_make_tet_grid(self, res):
        for a, b in zip(tmt.make_tet_grid(res), jmt.make_tet_grid(res)):
            np.testing.assert_array_equal(a, b)

    def test_build_tet_grid(self):
        verts, faces = _sphere_mesh()
        a = tmt.build_tet_grid(verts * 3.0 + 1.0, faces, resolution=12)
        b = jmt.build_tet_grid(verts * 3.0 + 1.0, faces, resolution=12)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert 0 < len(a[1]) < 6 * 12 ** 3


def _sphere_mesh(res=10):
    gv, gt, sdf = _sphere_sdf(res, noise=0.0)
    mt = jmt.marching_tets(jnp.asarray(gv), jnp.asarray(sdf), jnp.asarray(gt),
                           2048, 4096)
    nv, nf = int(mt.num_verts), int(mt.num_faces)
    faces = np.asarray(mt.faces)[np.asarray(mt.faces_valid)][:nf]
    return np.asarray(mt.verts)[:nv], faces


class TestMarchingTets:
    @pytest.mark.parametrize("restricted", [False, True])
    def test_matches_jax(self, restricted):
        gv, gt, sdf = _sphere_sdf(10)
        tv = (np.random.default_rng(1).random(len(gt)) < 0.7
              if restricted else None)
        mj = jmt.marching_tets(jnp.asarray(gv), jnp.asarray(sdf),
                               jnp.asarray(gt), 2048, 4096,
                               None if tv is None else jnp.asarray(tv))
        mt = tmt.marching_tets(torch.tensor(gv), torch.tensor(sdf),
                               torch.tensor(gt), 2048, 4096,
                               None if tv is None else torch.tensor(tv))
        assert_mesh_close(mt, mj)
        assert int(mt.num_faces) > 100

    def test_overflowing_budgets(self):
        gv, gt, sdf = _sphere_sdf(10)
        mj = jmt.marching_tets(jnp.asarray(gv), jnp.asarray(sdf),
                               jnp.asarray(gt), 256, 300)
        mt = tmt.marching_tets(torch.tensor(gv), torch.tensor(sdf),
                               torch.tensor(gt), 256, 300)
        assert_mesh_close(mt, mj)
        assert int(mt.num_verts) > 256 and int(mt.num_faces) > 300

    def test_vertex_gradient(self):
        """d(Σ|v|²)/d sdf through the edge interpolation."""
        gv, gt, sdf = _sphere_sdf(8)

        def jloss(s):
            m = jmt.marching_tets(jnp.asarray(gv), s, jnp.asarray(gt), 1024, 2048)
            return jnp.sum(jnp.where(m.verts_valid[:, None], m.verts ** 2, 0.0))

        gj = jax.grad(jloss)(jnp.asarray(sdf))
        s = torch.tensor(sdf, requires_grad=True)
        m = tmt.marching_tets(torch.tensor(gv), s, torch.tensor(gt), 1024, 2048)
        torch.sum(torch.where(m.verts_valid[:, None], m.verts ** 2,
                              torch.zeros_like(m.verts))).backward()
        np.testing.assert_allclose(s.grad.numpy(), np.asarray(gj), rtol=1e-5,
                                   atol=1e-6)

    @pytest.mark.parametrize("budget", [64, 4096])
    def test_unique_edge_slots(self, budget):
        rng = np.random.default_rng(2)
        a = rng.integers(0, 300, (700, 6))
        b = rng.integers(0, 300, (700, 6))
        lo, hi = np.minimum(a, b).astype(np.int32), np.maximum(a, b).astype(np.int32)
        valid = rng.random((700, 6)) < 0.8
        out_j = jmt.unique_edge_slots(jnp.asarray(lo), jnp.asarray(hi),
                                      jnp.asarray(valid), budget)
        out_t = tmt.unique_edge_slots(torch.tensor(lo), torch.tensor(hi),
                                      torch.tensor(valid), budget)
        for x, y in zip(out_t, out_j):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


class TestCompactSubdivide:
    @pytest.mark.parametrize("corner", [0.0, 0.2])
    def test_compact(self, corner):
        gv, gt, sdf = _sphere_sdf(10, seed=3)
        mask = np.random.default_rng(4).random(len(gt)) < 0.5
        for tm in (None, mask):
            kw = dict(corner_threshold=corner,
                      tet_mask=None if tm is None else jnp.asarray(tm))
            kt = dict(corner_threshold=corner,
                      tet_mask=None if tm is None else torch.tensor(tm))
            j1 = jmt.compact_tets(jnp.asarray(gv), jnp.asarray(sdf),
                                  jnp.asarray(gt), 512, **kw)
            t1 = tmt.compact_tets(torch.tensor(gv), torch.tensor(sdf),
                                  torch.tensor(gt), 512, **kt)
            j2 = jmt.compact_tets_lattice(jnp.asarray(sdf), 10, 512, **kw)
            t2 = tmt.compact_tets_lattice(torch.tensor(sdf), 10, 512, **kt)
            for x, y in zip(t1 + t2, j1 + j2):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            assert int(t1[2]) > 0

    def test_subdivide(self):
        gv, gt, sdf = _sphere_sdf(10, seed=5)
        idx, valid, _ = jmt.compact_tets(jnp.asarray(gv), jnp.asarray(sdf),
                                         jnp.asarray(gt), 512)
        sub = np.asarray(gt)[np.asarray(idx)]
        out_j = jmt.subdivide_tets(jnp.asarray(gv), jnp.asarray(sdf),
                                   jnp.asarray(sub), valid, 2048)
        out_t = tmt.subdivide_tets(torch.tensor(gv), torch.tensor(sdf),
                                   torch.tensor(sub), torch.tensor(
                                       np.asarray(valid)), 2048)
        for x, y in zip(out_t, out_j):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))

    def test_mark_part_and_overlap(self):
        gv, gt, sdf = _sphere_sdf(10, seed=6)
        mj = jmt.marching_tets(jnp.asarray(gv), jnp.asarray(sdf),
                               jnp.asarray(gt), 2048, 4096)
        fc = np.asarray(mj.verts)[np.asarray(mj.faces)].mean(1)
        edit = (fc[:, 2] > 0.1) & np.asarray(mj.faces_valid)
        uj, kj = jmt.mark_part_tets(jnp.asarray(gt), mj.face_to_tet,
                                    mj.faces_valid, jnp.asarray(edit))
        ut, kt = tmt.mark_part_tets(
            torch.tensor(gt), torch.tensor(np.asarray(mj.face_to_tet)),
            torch.tensor(np.asarray(mj.faces_valid)), torch.tensor(edit))
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        # Vertex 0 inside the update set, then outside it.
        for upd in (np.asarray(uj), np.asarray(uj) & (np.arange(len(gt)) > 5)):
            oj = jmt.overlap_vertex_mask(jnp.asarray(gt), jnp.asarray(upd),
                                         len(gv))
            ot = tmt.overlap_vertex_mask(torch.tensor(gt), torch.tensor(upd),
                                         len(gv))
            np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


class TestPartition:
    def test_partition_init(self, geoms):
        jpart, tpart = geoms["jpart"], geoms["tpart"]
        for name in ("update_tet_mask", "keep_tet_mask", "overlap_verts",
                     "live_vert_mask", "live_vert_idx", "update_tet_idx"):
            np.testing.assert_array_equal(
                getattr(tpart, name).numpy(), np.asarray(getattr(jpart, name)),
                err_msg=name)
        for name in ("frozen_sdf", "keep_fine_pos", "keep_fine_sdf"):
            np.testing.assert_allclose(
                getattr(tpart, name).numpy(), np.asarray(getattr(jpart, name)),
                rtol=0, atol=1e-6, err_msg=name)
        assert_mesh_close(tpart.keep_mesh, jpart.keep_mesh, err="keep_mesh")
        assert int(tpart.keep_mesh.num_faces) > 0
        assert bool(tpart.update_tet_mask.any() and tpart.keep_tet_mask.any())

    @pytest.mark.parametrize("cached", [False, True])
    def test_part_isosurface_values_and_grads(self, geoms, cached):
        from torch_port_helpers import carry_params

        jg, tg, jp = geoms["jg"], geoms["tg"], geoms["jp"]
        jpart, tpart = geoms["jpart"], geoms["tpart"]
        live = np.asarray(jpart.live_vert_idx)
        refresh = live[::3].astype(np.int32)
        # A perturbed cache: stale far-field values must not matter.
        cache = np.asarray(jpart.frozen_sdf) + 0.003

        def jiso(p):
            if cached:
                return jg.part_isosurface_cached(
                    p, jpart, jnp.asarray(cache), jnp.asarray(refresh))[0]
            return jg.part_isosurface(p, jpart)

        def tiso(p):
            if cached:
                return tg.part_isosurface_cached(
                    p, tpart, torch.tensor(cache), torch.tensor(refresh))[0]
            return tg.part_isosurface(p, tpart)

        def jloss(p):
            m = jiso(p)
            r = jnp.linalg.norm(m.verts, axis=-1)
            return jnp.sum(jnp.where(m.verts_valid, r * r, 0.0))

        lj, gj = jax.value_and_grad(jloss)(jp)
        tp = carry_params(jp)
        mt = tiso(tp)
        r = torch.linalg.norm(mt.verts, dim=-1)
        lt = torch.sum(torch.where(mt.verts_valid, r * r, torch.zeros_like(r)))
        lt.backward()
        assert_mesh_close(mt, jiso(jp), err="update mesh")
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-6)
        np.testing.assert_allclose(tp.grid.grad.numpy(), np.asarray(gj["grid"]),
                                   rtol=1e-4, atol=1e-6, err_msg="grid")
        for i, layer in enumerate(tp.mlp):
            for k in ("w", "b"):
                np.testing.assert_allclose(
                    getattr(layer, k).grad.numpy(), np.asarray(gj["mlp"][i][k]),
                    rtol=1e-4, atol=1e-6, err_msg=f"mlp {i} {k}")
        assert float(tp.grid.grad.abs().sum()) > 0

    def test_new_cache(self, geoms):
        jg, tg = geoms["jg"], geoms["tg"]
        jpart, tpart = geoms["jpart"], geoms["tpart"]
        refresh = np.asarray(jpart.live_vert_idx)[1::4].astype(np.int32)
        _, cj = jg.part_isosurface_cached(geoms["jp"], jpart,
                                          jpart.frozen_sdf, jnp.asarray(refresh))
        _, ct = tg.part_isosurface_cached(geoms["tp"], tpart,
                                          tpart.frozen_sdf, torch.tensor(refresh))
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
        assert not ct.requires_grad


class TestPartRenderer:
    def test_render_part_maps(self, geoms):
        """Local and global maps over keep ∥ update. Pixel centres that lie
        on an edge two faces share may go to either face (ROADMAP §3,
        "Pixel centres on a shared edge"): face ids must agree on all but
        0.5% of the pixels, and the maps where they agree."""
        from youreditableavatar_tpu.data.camera_sampler import (
            RandomCameraConfig, RandomCameraSampler)
        from youreditableavatar_tpu.models.part_renderer import (
            render_part_maps as jrender)
        from youreditableavatar_tpu.ops.mesh_raster import (
            MeshRasterConfig as JMC)
        from youreditableavatar_tpu_torch.models.part_renderer import (
            render_part_maps as trender)
        from youreditableavatar_tpu_torch.ops.mesh_raster import (
            MeshRasterConfig as TMC)

        jg, tg = geoms["jg"], geoms["tg"]
        jpart, tpart = geoms["jpart"], geoms["tpart"]
        cfg = RandomCameraConfig(height=64, width=64,
                                 camera_distance_range=(1.6, 1.8),
                                 elevation_range=(-5, 10), fovy_range=(40, 45))
        batch = RandomCameraSampler(cfg, seed=3).sample()
        jl, jgl = (batch.local[0].raster_camera(), batch.global_[0].raster_camera())
        from youreditableavatar_tpu_torch.data.camera_sampler import (
            RandomCameraSampler as TS)
        tb = TS(cfg, seed=3).sample()
        tl, tgl = (tb.local[0].raster_camera("cpu"),
                   tb.global_[0].raster_camera("cpu"))
        ju = jg.part_isosurface(geoms["jp"], jpart)
        tu = tg.part_isosurface(geoms["tp"], tpart)
        mj = jrender(jpart.keep_mesh, ju, jl, jgl,
                     JMC(pair_budget=1 << 14, tile_capacity=1024, backend="xla"))
        mt = trender(tpart.keep_mesh, tu, tl, tgl, TMC(pair_budget=1 << 14))
        assert set(mt) == set(mj)
        for view in ("local", "global"):
            fj = np.asarray(mj[f"{view}_face_id"])
            ft = mt[f"{view}_face_id"].numpy()
            same = fj == ft
            assert (~same).mean() <= 0.005, view
            assert (fj >= 0).sum() > 100
            for k in ("comp_normal", "normal", "opacity", "mask", "depth"):
                a = np.asarray(mj[f"{view}_{k}"])
                b = mt[f"{view}_{k}"].detach().numpy()
                np.testing.assert_allclose(b[same], a[same], rtol=1e-4,
                                           atol=1e-5, err_msg=f"{view} {k}")
            assert int(mt[f"{view}_num_pairs"]) == int(mj[f"{view}_num_pairs"])
        np.testing.assert_array_equal(
            mt["local_update_mask"].numpy()[same],
            np.asarray(mj["local_update_mask"])[same])

    def test_normal_consistency(self, geoms):
        from youreditableavatar_tpu.models.part_renderer import (
            normal_consistency as jnc)
        from youreditableavatar_tpu_torch.models.part_renderer import (
            normal_consistency as tnc)

        ju = geoms["jg"].part_isosurface(geoms["jp"], geoms["jpart"])
        vj, gj = jax.value_and_grad(lambda v: jnc(ju._replace(verts=v)))(ju.verts)
        tu = geoms["tg"].part_isosurface(geoms["tp"], geoms["tpart"])
        v = tu.verts.detach().clone().requires_grad_()
        vt = tnc(tu._replace(verts=v))
        vt.backward()
        np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=1e-5)
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(gj), rtol=1e-4,
                                   atol=1e-6)
        assert float(vt.detach()) > 0
