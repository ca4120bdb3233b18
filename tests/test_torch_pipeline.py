"""PyTorch port vs the JAX package: `cli/pipeline.py`, the three CLI entry
modules, `ops/covariance.cov3d_to_matrix`, and `chip_smoke.py`'s busy-time
interval merge.

The port's `run_synthetic_pipeline` runs once on the CPU at
`PipelineScale.tiny()` (the JAX `test_synthetic_pipeline` is not run again:
the two packages draw different random streams, so their pipelines are not
byte-equal; each stage module's parity is held by its own
`test_torch_*.py`). Every artifact it writes is read back with the JAX
package's own loaders and held to the schema the JAX writers produce: the
same keys, dtypes and ranks. The CLI modules' `main(argv)` run once each at
`--tiny` (the edit-texture run at a shallower depth) and the spatial one's
`--validate` on the pipeline's checkpoint. `cov3d_to_matrix` is held to the
JAX function exactly; the interval merge to hand-counted lengths.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_colmap_io import write_colmap_text_dataset
from torch_port_helpers import single_threaded_torch  # noqa: F401  (fixture)

import chip_smoke
from youreditableavatar_tpu.cli import pipeline as jpl
from youreditableavatar_tpu.models import tetgs as jtetgs
from youreditableavatar_tpu.ops import covariance as jcov
from youreditableavatar_tpu.ops.marching_tets import (
    make_tet_grid,
    marching_tets,
)
from youreditableavatar_tpu.stages import export as jexport
from youreditableavatar_tpu_torch.cli import pipeline as tpl
from youreditableavatar_tpu_torch.cli import (
    train_edit_texture,
    train_init_texture,
    train_spatial,
)
from youreditableavatar_tpu_torch.ops import covariance as tcov

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipeline"))
    return out, tpl.run_synthetic_pipeline(out, device=CPU)


@pytest.fixture(scope="module")
def jax_schemas(tmp_path_factory):
    """The JAX writers' artifacts on a small marching-tets sphere."""
    d = tmp_path_factory.mktemp("jax_artifacts")
    gv, gt = make_tet_grid(6)
    pos = jnp.asarray(gv)
    mt = marching_tets(pos, jnp.linalg.norm(pos, axis=-1) - 0.3,
                       jnp.asarray(gt), 2048, 4096)
    paths = {k: str(d / n) for k, n in (
        ("init_mesh", "init_mesh.npy"), ("edit_mesh", "edit_mesh.npy"),
        ("editing_region_info", "editing_region_info.npy"),
        ("tetgs_init", "tetgs_init_last.npz"))}
    data = jexport.export_init_mesh(paths["init_mesh"], mt)
    jexport.export_edit_mesh(paths["edit_mesh"], mt, mt)
    nv = len(data["mesh"]["vertices"])
    nf = len(data["mesh"]["faces"])
    jexport.export_editing_region_info(paths["editing_region_info"],
                                       np.arange(nv) % 2, np.arange(nf) % 3)
    binding, params = jtetgs.build_tetgs(
        np.asarray(data["mesh"]["vertices"], np.float32),
        data["mesh"]["faces"], None, data["mesh"]["face_to_global_tet_idx"],
        sh_levels=2)
    jtetgs.save_tetgs(paths["tetgs_init"], binding, params)
    return paths


def _schema(d):
    """{key: (type name, dtype, ndim)} of a loaded artifact."""
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        out[k] = (type(v).__name__ if np.isscalar(v) else "array",
                  str(a.dtype), a.ndim)
    return out


@pytest.mark.parametrize("name,loader", [
    ("init_mesh", jexport.load_init_mesh),
    ("edit_mesh", jexport.load_edit_mesh),
    ("editing_region_info", jexport.load_editing_region_info),
])
def test_npy_artifacts_load_with_jax_loaders(run, jax_schemas, name, loader):
    _, arts = run
    got = loader(arts[name])
    assert _schema(got) == _schema(loader(jax_schemas[name]))
    if name == "edit_mesh":
        assert got["keep_vertices_num"] > 0 and got["editing_mask"].sum() > 0
        assert got["faces"].max() < len(got["vertices"])
    if name == "init_mesh":
        assert got["faces"].max() < len(got["vertices"])
        assert len(got["face_to_global_tet_idx"]) == len(got["faces"])


def test_tetgs_checkpoint_loads_with_jax_loader(run, jax_schemas):
    _, arts = run
    z, zj = np.load(arts["tetgs_init"]), np.load(jax_schemas["tetgs_init"])
    assert sorted(z.files) == sorted(zj.files)
    for k in zj.files:
        assert (z[k].dtype, z[k].ndim) == (zj[k].dtype, zj[k].ndim), k
    binding, params, extras = jtetgs.load_tetgs(arts["tetgs_init"])
    n = params.delta.shape[0]
    assert n > 0 and binding.sh_levels == 2 and not extras
    assert np.isfinite(np.asarray(params.sh_dc)).all()
    assert binding.ori_points.shape == (n, 3)


def test_other_artifacts(run):
    out, arts = run
    with open(arts["init_mesh_coarse"]) as fh:
        assert fh.readline().strip() == "ply"
    finals = sorted(os.listdir(arts["final_dir"]))
    blends = sorted(os.listdir(arts["blend_dir"]))
    scale = tpl.PipelineScale.tiny()
    assert len(finals) == len(blends) == scale.turntable_views
    import imageio.v2 as imageio

    img = imageio.imread(os.path.join(arts["final_dir"], finals[0]))
    assert img.shape == (scale.image_hw, scale.image_hw, 3)
    for ck in ("initial_checkpoint", "edited_checkpoint"):
        assert os.path.isfile(os.path.join(out, "spatial", ck))
    assert os.path.isfile(os.path.join(out, "spatial", "metrics.jsonl"))
    assert float(arts["elapsed_s"]) > 0


def test_spatial_validate_on_port_checkpoint(run):
    out, arts = run
    vdir = tpl.run_spatial_validate(os.path.join(out, "val"), arts["ckpt"],
                                    tpl.PipelineScale.tiny(), num_views=2,
                                    device=CPU)
    frames = sorted(f for f in os.listdir(vdir) if f.endswith(".png"))
    assert frames == ["frame0000.png", "frame0001.png"]


def test_pipeline_scale_and_configs_match_jax():
    """`tiny()` keeps every JAX field but the backends; the field and the
    camera configs equal JAX's."""
    t, j = tpl.PipelineScale.tiny(), jpl.PipelineScale.tiny()
    for f in ("grid_res", "image_hw", "sdf_iters", "normal_iters",
              "edit_steps", "fit_iters", "inpaint_views", "turntable_views",
              "refine_iters"):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(t.budgets) == dataclasses.asdict(j.budgets)
    assert dataclasses.asdict(t.hashgrid) == dataclasses.asdict(j.hashgrid)
    assert (t.raster.pair_budget, t.raster.tile_capacity) == (
        j.raster.pair_budget, j.raster.tile_capacity)
    assert t.mesh_raster.pair_budget == j.mesh_raster.pair_budget
    assert dataclasses.asdict(tpl._cam_cfg(t)) == dataclasses.asdict(
        jpl._cam_cfg(j))
    tf, jf = tpl._field(t).cfg, jpl._field(j).cfg
    for f in ("sdf_bias", "sdf_bias_radius", "n_neurons", "n_hidden_layers"):
        assert getattr(tf, f) == getattr(jf, f), f


def test_synthetic_body_matches_jax():
    verts, faces, nv, nf = tpl.synthetic_body(10, device=CPU)
    gv, gt = make_tet_grid(10)
    pos = jnp.asarray(gv)
    mt = marching_tets(
        pos, jnp.linalg.norm(pos * jnp.asarray([1.0, 1.0, 0.7]), axis=-1)
        - 0.3, jnp.asarray(gt), 8192, 16384)
    assert (nv, nf) == (int(mt.num_verts), int(mt.num_faces))
    np.testing.assert_allclose(verts, np.asarray(mt.verts)[:nv], atol=1e-6)
    np.testing.assert_array_equal(
        faces, np.asarray(mt.faces)[np.asarray(mt.faces_valid)][:nf])


@pytest.fixture(scope="module")
def body_npy(tmp_path_factory):
    verts, faces, _, _ = tpl.synthetic_body(10, device=CPU)
    path = str(tmp_path_factory.mktemp("body") / "body.npy")
    np.save(path, {"vertices": verts.astype(np.float64), "faces": faces})
    return path


def test_train_spatial_cli(body_npy, tmp_path):
    """--train (shape init + init_mesh export, --typecheck on), then
    --validate on its checkpoint; an unknown system.scale key is an
    error."""
    cfg = os.path.join(REPO, "configs", "geometry-init.yaml")
    out = str(tmp_path / "spatial")
    scale = ["system.scale.tiny=true", "system.scale.grid_res=10",
             "system.scale.sdf_iters=20",
             "system.scale.normal_iters=1"]
    try:
        train_spatial.main(["--config", cfg, "--train", "--mesh", body_npy,
                            "--out", out, "--device", CPU, "--typecheck",
                            *scale])
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert os.path.isfile(os.path.join(out, "init_mesh.npy"))
    assert os.path.isfile(os.path.join(out, "cmd.txt"))
    train_spatial.main(["--config", cfg, "--validate", "--ckpt",
                        os.path.join(out, "initial_checkpoint"), "--out",
                        out, "--device", CPU, *scale])
    frames = [f for f in os.listdir(os.path.join(out, "validation"))
              if f.endswith(".png")]
    assert len(frames) == 8
    with pytest.raises(SystemExit):
        train_spatial.main(["--config", cfg, "--validate", "--ckpt", "x",
                            "--out", out, "--device", CPU,
                            "system.scale.grid=3"])
    with pytest.raises(SystemExit):
        train_spatial.main(["--config", cfg, "--validate", "--out", out,
                            "--device", CPU])


def test_train_init_texture_cli(run, tmp_path):
    """The stage-2 CLI on a COLMAP text dataset, localizing through the
    random-weight LangSAM chain."""
    _, arts = run
    root = str(tmp_path / "colmap")
    write_colmap_text_dataset(root, n_views=3, wh=(48, 40))
    out = str(tmp_path / "init_texture")
    train_init_texture.main(["--init_mesh", arts["init_mesh"],
                             "--source_path", root, "--out", out, "--tiny",
                             "--iters", "3", "--segmenter", "langsam-random",
                             "--device", CPU])
    info = jexport.load_editing_region_info(
        os.path.join(out, "editing_region_info.npy"))
    assert len(info["editing_mask"]) == len(
        jexport.load_init_mesh(arts["init_mesh"])["vertices"])
    assert os.path.isfile(os.path.join(out, "tetgs_init_last.npz"))


def test_train_edit_texture_cli(run, tmp_path, monkeypatch):
    """The stage-4 CLI on the pipeline's edit mesh and stage-2 checkpoint,
    at `--tiny` cut to two views and a few steps."""
    _, arts = run
    small = dataclasses.replace(tpl.PipelineScale.tiny(), fit_iters=4,
                                inpaint_views=2, turntable_views=2,
                                refine_iters=2)
    monkeypatch.setattr(tpl.PipelineScale, "tiny", staticmethod(lambda: small))
    out = str(tmp_path / "edit_texture")
    train_edit_texture.main(["--edit_mesh", arts["edit_mesh"],
                             "--tetgs_init", arts["tetgs_init"],
                             "--prompt", "a red jacket", "--out", out,
                             "--tiny", "--sample-type", "upper",
                             "--device", CPU])
    frames = os.listdir(os.path.join(out, "validation_refine"))
    assert len(frames) == 2


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card default")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.run_spatial_validate(str(tmp_path), "x", tpl.PipelineScale.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.run_synthetic_pipeline(str(tmp_path))


def test_cov3d_to_matrix_matches_jax():
    cov6 = np.random.default_rng(0).normal(size=(5, 7, 6)).astype(np.float32)
    got = tcov.cov3d_to_matrix(torch.tensor(cov6))
    ref = np.asarray(jcov.cov3d_to_matrix(jnp.asarray(cov6)))
    assert tuple(got.shape) == ref.shape == (5, 7, 3, 3)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), got.numpy().swapaxes(-1, -2))


@pytest.mark.parametrize("intervals,length", [
    ([], 0.0),
    ([(0.0, 2.0)], 2.0),
    ([(0.0, 2.0), (1.0, 3.0)], 3.0),  # overlapping
    ([(0.0, 5.0), (1.0, 2.0), (3.0, 4.0)], 5.0),  # nested
    ([(4.0, 6.0), (0.0, 1.0), (1.0, 2.0)], 4.0),  # unsorted, touching
    ([(1.0, 3.0), (1.0, 3.0), (1.0, 3.0)], 2.0),  # repeated
    ([(0.0, 1.0), (2.0, 3.0), (2.5, 2.75), (10.0, 10.5)], 2.5),
])
def test_busy_union_length(intervals, length):
    assert chip_smoke.union_length(intervals) == length
    assert chip_smoke.union_length(intervals) <= sum(
        b - a for a, b in intervals)


def test_busy_overlap_attribution():
    """Each event's time under an earlier-starting event's interval, by
    name: the part of the kernel-time sum that the union does not count."""
    events = [("gemm", 0.0, 4.0), ("copy", 1.0, 2.0), ("gemm", 3.0, 6.0),
              ("fft", 7.0, 8.0), ("fft", 7.0, 8.0)]
    over = chip_smoke.overlapped_by_name(events)
    assert over == {"copy": 1.0, "gemm": 1.0, "fft": 1.0}
    total = sum(b - a for _, a, b in events)
    assert total - sum(over.values()) == chip_smoke.union_length(
        [(a, b) for _, a, b in events])


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 6), (3, 2, 3)])
def test_png_without_imageio(tmp_path, monkeypatch, shape):
    """Where imageio is not installed, `save_image` writes a .png through
    the standard library; imageio reads the same pixels back."""
    import sys

    import imageio.v2 as imageio

    from youreditableavatar_tpu_torch.utils import saving

    img = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    path = str(tmp_path / "frame.png")
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    saving.save_image(path, img)
    with pytest.raises(ImportError):
        saving.save_image(str(tmp_path / "frame.jpg"), img)
    monkeypatch.undo()
    np.testing.assert_array_equal(imageio.imread(path), saving._to_uint8(img))
