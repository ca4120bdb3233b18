"""The SDS edit step's geometry as CUDA graph replays (`stages/spatial.py`,
`utils/cuda_graphs.py`), and the device constants the graphs need.

No JAX here: the `cuda` tests run on a card, from the repository root,
with `python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_edit_graph.py`. On the CPU the trainer runs its geometry
eagerly; the CPU tests hold its graph key, its counter and the constants
hoisted out of the per-call paths against what those paths built before.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import (  # noqa: F401  (fixture)
    SMALL_BUDGETS,
    SMALL_GRID,
    cuda_device,
    single_threaded_torch,
)
from youreditableavatar_tpu_torch import _kernels
from youreditableavatar_tpu_torch.ops import hashgrid, marching_tets, segments
from youreditableavatar_tpu_torch.ops.mesh_raster import (
    interpolate_attributes,
    rasterize_mesh,
    raster,
)

CAM = dict(height=64, width=64, camera_distance_range=(1.6, 1.8),
           elevation_range=(-5, 10), fovy_range=(40, 45))
# Steps 0–3 of trainer seed 1 draw use_global False, True, True, False.
SEED = 1
STEPS = 4
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device(name)


def _trainer(device, tmp_path, **cfg):
    """A test-width edit trainer: the 4-level field of the parity tests on
    a grid of 10, the cap z > 0.1 of its sphere editable, the stub prior,
    64×64 views; the control term on from step 2."""
    from youreditableavatar_tpu_torch.data.camera_sampler import (
        RandomCameraConfig)
    from youreditableavatar_tpu_torch.guidance.prompts import PromptProcessor
    from youreditableavatar_tpu_torch.guidance.sds import SDSConfig, SDSGuidance
    from youreditableavatar_tpu_torch.guidance.stub import (
        StubDiffusionPrior, StubPromptEncoder)
    from youreditableavatar_tpu_torch.models.geometry import (
        GeometryBudgets, TetGeometry)
    from youreditableavatar_tpu_torch.models.sdf import SDFField, SDFFieldConfig
    from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig
    from youreditableavatar_tpu_torch.stages.spatial import (
        HumanEditConfig, HumanEditTrainer)

    field = SDFField(SDFFieldConfig(
        grid=hashgrid.HashGridConfig(**SMALL_GRID), n_neurons=32,
        sdf_bias="sphere", sdf_bias_radius=0.4))
    params = field.init_params(0, device=device)
    geometry = TetGeometry(field, 10, GeometryBudgets(**SMALL_BUDGETS),
                           device=device)
    with torch.no_grad():
        mt = geometry.isosurface(params)
        centres = mt.verts[mt.faces.long()].mean(1)
        edit = (centres[:, 2] > 0.1) & mt.faces_valid
    part = geometry.partition_init(params, edit, frozen_mt=mt)
    guidance = SDSGuidance(StubDiffusionPrior(device=device),
                           SDSConfig(guidance_scale=7.5))
    prompts = PromptProcessor("a red jacket", "low quality",
                              StubPromptEncoder(device=device),
                              cache_dir=str(tmp_path / "prompts"),
                              model_name="stub")
    ecfg = HumanEditConfig(camera=RandomCameraConfig(**CAM),
                           recon_points=2048, start_sdf_loss_step=2,
                           log_every=1, **cfg)
    return HumanEditTrainer(field, geometry, part, params, guidance, prompts,
                            prompts, ecfg, MeshRasterConfig(pair_budget=1 << 14),
                            seed=SEED, device=device)


# ---- the graph key and the eager path (CPU) --------------------------------


def _changed(trainer, what):
    """The trainer's key at (False, 4) after changing one observable."""
    use_global, n_active = False, 4
    if what == "use_global":
        use_global = True
    elif what == "n_active":
        n_active = 3
    elif what == "budgets":
        trainer.geometry.budgets = dataclasses.replace(
            trainer.geometry.budgets, compact=1024)
    elif what == "pair_budget":
        trainer.mesh_cfg = dataclasses.replace(trainer.mesh_cfg,
                                               pair_budget=1 << 15)
    elif what == "cache":
        trainer.cfg = dataclasses.replace(trainer.cfg, sdf_cache_refresh=0)
    return trainer.graph_key(use_global, n_active)


@pytest.fixture(scope="module")
def cpu_trainer(tmp_path_factory):
    return _trainer(torch.device("cpu"), tmp_path_factory.mktemp("graph"))


@pytest.mark.parametrize("what", ["use_global", "n_active", "budgets",
                                  "pair_budget", "cache"])
def test_graph_key_changes_with_each_observable(cpu_trainer, what):
    trainer = cpu_trainer
    saved = trainer.geometry.budgets, trainer.mesh_cfg, trainer.cfg
    try:
        base = trainer.graph_key(False, 4)
        assert trainer.graph_key(False, 4) == base
        changed = _changed(trainer, what)
    finally:
        trainer.geometry.budgets, trainer.mesh_cfg, trainer.cfg = saved
    assert changed != base
    # Only the last entry is use_global: a chain holds both of one key.
    assert (changed[:-1] == base[:-1]) == (what == "use_global")


def test_cpu_trainer_never_captures(tmp_path):
    trainer = _trainer(torch.device("cpu"), tmp_path)
    before = dict(_kernels.GRAPHS)
    for _ in range(2):
        rec = trainer.train_step(seed=0)
    assert all(np.isfinite(v) for v in rec.values())
    assert _kernels.GRAPHS["eager"] - before["eager"] == 2 * 2
    assert _kernels.GRAPHS["captured"] == before["captured"]
    assert _kernels.GRAPHS["replayed"] == before["replayed"]
    assert trainer._graphs == {}


# ---- constants hoisted out of the per-call paths ---------------------------


def _same(a, b):
    assert a.dtype == b.dtype and a.device == b.device
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", DEVICES)
def test_hashgrid_corner_constants(name):
    dev = _device(name)
    offsets, one, sgn = hashgrid.corner_constants(dev)
    built = torch.tensor(hashgrid._OFFSETS, dtype=torch.int64, device=dev)
    _same(offsets, built)
    _same(one, built[None] == 1)
    _same(sgn, torch.tensor(hashgrid._OFFSETS, dtype=torch.float32,
                            device=dev) * 2.0 - 1.0)
    assert hashgrid.corner_constants(dev)[0] is offsets  # built once


@pytest.mark.parametrize("name", DEVICES)
@pytest.mark.parametrize("eps", [0.01, 0.003, 1.0 / 3.0])
def test_finite_difference_offsets(name, eps):
    from youreditableavatar_tpu_torch.models.sdf import fd_offsets

    dev = _device(name)
    _same(fd_offsets(eps, dev),
          torch.tensor([[eps, 0, 0], [0, eps, 0], [0, 0, eps]],
                       dtype=torch.float32, device=dev))


@pytest.mark.parametrize("name", DEVICES)
def test_marching_tets_tables_and_sentinel(name):
    dev = _device(name)
    tables = marching_tets._tables(dev)
    for got, a in zip(tables, (marching_tets.TET_EDGES,
                               marching_tets.TRIANGLE_TABLE,
                               marching_tets.NUM_TRIANGLES_TABLE)):
        _same(got, torch.as_tensor(a.astype(np.int64), device=dev))
    # `big`: the int32 maximum as a scalar operand of `torch.where`.
    g = torch.Generator().manual_seed(3)
    lo = torch.randint(0, 1000, (257,), generator=g, dtype=torch.int32).to(dev)
    valid = (torch.rand(257, generator=g) < 0.5).to(dev)
    big = torch.tensor(marching_tets._INT32_MAX, dtype=torch.int64, device=dev)
    _same(torch.where(valid, lo.to(torch.int64), marching_tets._INT32_MAX),
          torch.where(valid, lo.to(torch.int64), big))


@pytest.mark.parametrize("name", DEVICES)
def test_face_box_no_cull_constant(name):
    dev = _device(name)
    _same(raster._no_cull(dev),
          torch.tensor([-float("inf"), float("inf")] * 2, device=dev))
    # A degenerate row (no cull) reads the constant.
    box = raster.face_box_plain(torch.zeros((1, 9), device=dev))
    _same(box[0], raster._no_cull(dev))


@pytest.mark.parametrize("name", DEVICES)
@pytest.mark.parametrize("background", [0.0, 0.5, 0.1])
def test_interpolate_background_scalar(name, background):
    from youreditableavatar_tpu_torch.ops.gaussian_raster import RasterCamera

    dev = _device(name)
    verts = torch.tensor([[-0.3, -0.3, 0.0], [0.3, -0.3, 0.0],
                          [0.0, 0.3, 0.0]], device=dev)
    faces = torch.tensor([[0, 1, 2]], dtype=torch.int32, device=dev)
    vm = np.eye(4, dtype=np.float32)
    vm[2, 3] = 2.0
    cam = RasterCamera.from_fov(vm, 0.8, 0.8, 32, 32, device=dev)
    out = rasterize_mesh(verts, faces, cam)
    attrs = torch.rand((3, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    img = interpolate_attributes(out, faces, attrs, background=background)
    before = interpolate_attributes(
        out, faces, attrs, background=torch.as_tensor(background))
    assert (out.face_id < 0).any() and (out.face_id >= 0).any()
    _same(img, before)
    _same(img[out.face_id < 0][:, 0],
          torch.full_like(img[out.face_id < 0][:, 0], background))


@pytest.mark.parametrize("name", DEVICES)
@pytest.mark.parametrize("case", ["random", "zeros", "tail", "empty"])
def test_range_owner_last_producer(name, case):
    dev = _device(name)
    g = torch.Generator().manual_seed(5)
    counts = {"random": torch.randint(0, 3, (40,), generator=g),
              "zeros": torch.zeros(7, dtype=torch.int64),
              "tail": torch.tensor([0, 2, 1, 0, 0, 0]),
              "empty": torch.zeros(0, dtype=torch.int64)}[case]
    counts = counts.to(torch.int32).to(dev)
    owner, local, valid = segments.range_owner(counts, 64)
    # What the owner of a slot past the total was before: the last
    # producer with items, read through `nonzero`.
    nz = torch.nonzero(counts > 0).flatten()
    last = int(nz[-1]) if nz.numel() else 0
    total = int(counts.sum())
    assert torch.equal(valid.cpu(), torch.arange(64) < total)
    assert (owner[~valid] == last).all()
    if total:
        cum = torch.cumsum(counts.long(), 0).cpu()
        expect = torch.searchsorted(cum, torch.arange(64), right=True)
        assert torch.equal(owner[valid].long().cpu(), expect[:total])


def test_subdivision_child_mask_matches_repeat_interleave():
    g = torch.Generator().manual_seed(2)
    verts, tets = marching_tets.make_tet_grid(3)
    pos = torch.as_tensor(verts)
    sdf = torch.linalg.norm(pos, dim=-1) - 0.3
    sub = torch.as_tensor(tets[:20])
    valid = torch.rand(20, generator=g) < 0.6
    out = marching_tets.subdivide_tets(pos, sdf, sub, valid, 256)
    assert torch.equal(out[3], torch.repeat_interleave(valid, 8))


# ---- on the card -------------------------------------------------------------


def _step(trainer):
    """One train step: its record, each leaf's gradient as the optimizer
    got it, and the selection cache after the step."""
    leaves = list(trainer.params.parameters())
    step, grads = trainer.optimizer.step, []

    def taking_grads(*a, **k):
        grads.extend(x.grad.detach().clone() for x in leaves)
        return step(*a, **k)

    trainer.optimizer.step = taking_grads
    try:
        rec = trainer.train_step(seed=0)
    finally:
        trainer.optimizer.step = step
    return rec, grads, trainer._sdf_cache.clone()


def _state(trainer):
    return ([x.detach().clone() for x in trainer.params.parameters()],
            copy.deepcopy(trainer.optimizer.state_dict()),
            trainer._sdf_cache.clone(), trainer.global_step,
            None if trainer.control_sdf is None else trainer.control_sdf.clone())


def _load(trainer, state):
    params, opt, cache, step, control = state
    with torch.no_grad():
        for x, v in zip(trainer.params.parameters(), params):
            x.copy_(v)
    trainer.optimizer.load_state_dict(copy.deepcopy(opt))
    trainer._sdf_cache.copy_(cache)
    trainer.global_step, trainer.control_sdf = step, control


def _atomic_close(a, b, what):
    """K4's tolerance: within 1e-5·max|b| per level of the table (per leaf
    for the others). A one-entry leaf (the last bias) is one sum of the
    points' nearly cancelling terms, added in a run-to-run order: within
    1e-3 of itself (two eager runs differ by up to 1.3e-4)."""
    if b.numel() == 1:
        assert abs(float(a) - float(b)) <= 1e-3 * abs(float(b)), what
        return
    rows = b.reshape(b.shape[0], -1) if b.dim() == 3 else b.reshape(1, -1)
    got = a.reshape(rows.shape)
    for r, (x, y) in enumerate(zip(got, rows)):
        tol = 1e-5 * float(y.abs().max())
        err = float((x - y).abs().max())
        assert err <= tol, f"{what} row {r}: {err:.3g} > {tol:.3g}"


@pytest.mark.cuda
def test_edit_steps_replay_like_eager(tmp_path, cuda_device):
    """Each graphed step against the same step run eagerly from the same
    parameters, optimizer state, cache and draws: the terms with no atomic
    add behind them and the cache are equal, the rest within K4's
    tolerance (the hash grid's and the normals' scatters add in a
    run-to-run order, so two eager runs differ as much)."""
    graphed = _trainer(cuda_device, tmp_path / "g")
    eager = _trainer(cuda_device, tmp_path / "e")
    # The eager side: the same steps through the wrapped functions.
    eager._geometry_chain = lambda *a, **k: None
    before = dict(_kernels.GRAPHS)
    for s in range(STEPS):
        state = _state(graphed)
        g_rec, g_grads, g_cache = _step(graphed)
        if s == 0:
            assert _kernels.GRAPHS["captured"] - before["captured"] == 2 * 2
        _load(eager, state)
        e_rec, e_grads, e_cache = _step(eager)
        assert set(g_rec) == set(e_rec)
        for k in ("recon", "control", "nc", "mesh_pairs"):
            assert g_rec[k] == e_rec[k], (s, k)
        for k in ("loss", "sds"):
            assert abs(g_rec[k] - e_rec[k]) <= 1e-5 * abs(e_rec[k]), (s, k)
        assert torch.equal(g_cache, e_cache), s
        for i, (a, b) in enumerate(zip(g_grads, e_grads)):
            _atomic_close(a, b, f"step {s} leaf {i}")
    assert _kernels.GRAPHS["captured"] - before["captured"] == 2 * 2
    assert _kernels.GRAPHS["replayed"] - before["replayed"] == STEPS * 2
    assert sorted(graphed._graphs) == [False, True]


@pytest.mark.cuda
def test_pair_budget_change_captures_anew(tmp_path, cuda_device):
    trainer = _trainer(cuda_device, tmp_path)
    trainer.train_step(seed=0)
    before = dict(_kernels.GRAPHS)
    trainer.mesh_cfg = dataclasses.replace(trainer.mesh_cfg,
                                           pair_budget=1 << 15)
    trainer.train_step(seed=0)
    assert _kernels.GRAPHS["captured"] - before["captured"] == 2 * 2
    assert trainer._graph_base[3].pair_budget == 1 << 15
    trainer.train_step(seed=0)
    assert _kernels.GRAPHS["captured"] - before["captured"] == 2 * 2


@pytest.mark.cuda
def test_geometry_forward_backward_is_sync_free(tmp_path, cuda_device):
    trainer = _trainer(cuda_device, tmp_path)
    step_i, args = trainer._prepare(0)
    use_global, draws, cam_l, cam_g = args[:4]
    ctrl, sdf_cache, refresh_idx, n_active = args[9], args[13], args[14], args[15]

    def geometry():
        mt, cache, maps, normal_img = trainer._render_fn(True, n_active)(
            *trainer._render_inputs(True, cam_l, cam_g, sdf_cache, refresh_idx))
        terms = trainer._losses_fn(n_active)(mt, draws["recon_idx"], ctrl)
        (sum(terms) + normal_img.sum()).backward()

    geometry()  # builds the kernels and the per-device constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        geometry()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
