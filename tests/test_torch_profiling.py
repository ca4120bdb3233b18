"""The port's program spans (`utils/profiling.py`): off they are one shared
no-op; armed they record each step's tree in the order the work runs —
the SDS edit step, the SDXL inpaint call, the refine step — without
changing a number; under a profiler somebody else started they add no
annotation to its host-op tree."""

import numpy as np
import pytest
import torch

from youreditableavatar_tpu_torch.utils import profiling
from youreditableavatar_tpu_torch.utils.profiling import (
    recording, span, take_spans)

CPU = "cpu"
EDIT_CHILDREN = ["edit.prepare", "edit.render", "edit.guidance",
                 "edit.losses", "edit.backward", "edit.optimizer",
                 "edit.record"]


@pytest.fixture(autouse=True)
def no_spans_left():
    take_spans()
    yield
    take_spans()


def _edit_trainer(cache_dir):
    """The grid-10 sphere field's SDS edit under the tiny random SD1.5."""
    from youreditableavatar_tpu_torch.data.camera_sampler import (
        RandomCameraConfig)
    from youreditableavatar_tpu_torch.guidance.factory import (
        make_guidance_backend)
    from youreditableavatar_tpu_torch.guidance.prompts import PromptProcessor
    from youreditableavatar_tpu_torch.guidance.sds import (
        SDSConfig, SDSGuidance)
    from youreditableavatar_tpu_torch.models.geometry import (
        GeometryBudgets, TetGeometry)
    from youreditableavatar_tpu_torch.models.sdf import (
        SDFField, SDFFieldConfig)
    from youreditableavatar_tpu_torch.ops.hashgrid import HashGridConfig
    from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig
    from youreditableavatar_tpu_torch.stages.spatial import (
        HumanEditConfig, HumanEditTrainer)

    prior, clip = make_guidance_backend("sd15-random", device=CPU)
    field = SDFField(SDFFieldConfig(
        grid=HashGridConfig(n_levels=4, log2_hashmap_size=13,
                            base_resolution=4, per_level_scale=1.5),
        n_neurons=32, sdf_bias="sphere", sdf_bias_radius=0.4))
    params = field.init_params(0, device=CPU)
    geom = TetGeometry(field, 10,
                       GeometryBudgets(4096, 8192, 2048, 8192, 8192, 16384),
                       device=CPU)
    mt = geom.isosurface(params)
    edit = (mt.verts[mt.faces.long()].mean(1)[:, 2] > 0.1) & mt.faces_valid
    part = geom.partition_init(params, edit, frozen_mt=mt)
    prompts = PromptProcessor("a red jacket", "low quality", clip,
                              cache_dir=str(cache_dir))
    cfg = HumanEditConfig(recon_points=2048, log_every=1,
                          camera=RandomCameraConfig(
                              height=64, width=64,
                              camera_distance_range=(1.6, 1.8)))
    trainer = HumanEditTrainer(
        field, geom, part, params,
        SDSGuidance(prior, SDSConfig(guidance_scale=7.5)), prompts, prompts,
        cfg, MeshRasterConfig(pair_budget=1 << 14), device=CPU)
    # Every loss term on, as at the stage's later steps.
    with torch.no_grad():
        trainer.control_sdf = field.forward_sdf_chunked(params,
                                                        geom.grid_pos)
    return trainer


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def _roots(spans):
    return [i for i, s in enumerate(spans) if s.parent == -1]


def _inpaint(pipe, steps=2):
    rng = np.random.default_rng(3)
    img, normal = (rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)
                   for _ in range(2))
    mask = np.zeros((16, 16), np.float32)
    mask[:, 8:] = 1.0
    g = torch.Generator().manual_seed(5)
    return pipe.inpaint(img, mask, normal, img, "a red jacket", steps=steps,
                        generator=g)


def _pipeline():
    from youreditableavatar_tpu_torch.guidance.factory import (
        make_inpainter_backend)

    return make_inpainter_backend("sdxl-random", device=CPU)


def test_off_a_span_is_one_shared_no_op_and_records_nothing(tmp_path):
    assert span("edit.step") is span("unet")
    assert not profiling._RECORDER.recording
    _edit_trainer(tmp_path).train_step(seed=1)
    assert take_spans() == []


def test_recording_gives_each_edit_step_its_tree(tmp_path):
    trainer = _edit_trainer(tmp_path)
    with recording():
        for _ in range(2):
            trainer.train_step(seed=1)
    spans = take_spans()
    roots = _roots(spans)
    assert [spans[i].name for i in roots] == ["edit.step"] * 2
    for r in roots:
        assert _children(spans, r) == EDIT_CHILDREN
        mine = [s for s in spans if s.root == r]
        assert all(s.host_start_ns <= s.host_end_ns for s in mine)
        assert all(s.device_ms is None for s in mine)  # no CUDA here
        guidance = next(i for i, s in enumerate(spans)
                        if s.root == r and s.name == "edit.guidance")
        assert _children(spans, guidance) == ["vae_encode", "unet"]
    # The spans of one step nest inside its root's host interval.
    first = [s for s in spans if s.root == roots[0]]
    assert all(first[0].host_start_ns <= s.host_start_ns
               and s.host_end_ns <= first[0].host_end_ns for s in first)
    assert take_spans() == []


def test_an_inpaint_call_runs_controlnet_then_unet_at_each_step():
    pipe = _pipeline()
    with recording():
        _inpaint(pipe, steps=2)
    spans = take_spans()
    assert [spans[i].name for i in _roots(spans)] == ["inpaint.call"]
    assert _children(spans, 0) == ["vae_encode", "text", "controlnet",
                                   "unet", "controlnet", "unet",
                                   "vae_decode"]


def _refine_trainer():
    from chip_smoke import icosphere
    from youreditableavatar_tpu_torch.models.cameras import (
        sample_ring_cameras)
    from youreditableavatar_tpu_torch.models.tetgs import (
        build_tetgs, extract_keep_gaussians)
    from youreditableavatar_tpu_torch.models.tetgs_edit import (
        build_edit_tetgs)
    from youreditableavatar_tpu_torch.ops.gaussian_raster import (
        RasterizeConfig)
    from youreditableavatar_tpu_torch.stages.edit_texture import (
        RefineConfig, RefineTrainer)

    verts, faces = icosphere(1)
    cap = verts[faces].mean(1)[:, 2] > 0.1
    binding, params = build_tetgs(verts, faces, None, np.arange(len(faces)),
                                  sh_levels=2, device=CPU)
    keep = extract_keep_gaussians(binding, params, np.flatnonzero(~cap))
    used = np.unique(faces[cap])
    remap = np.zeros(len(verts), np.int64)
    remap[used] = np.arange(len(used))
    eb, ep = build_edit_tetgs(verts[used], remap[faces[cap]], keep,
                              device=CPU)
    cams = sample_ring_cameras(counts=(2, 0, 0), height=32, width=32)
    images = [np.full((32, 32, 3), 0.5, np.float32) for _ in cams]
    return RefineTrainer(eb, ep, cams, images,
                         RefineConfig(raster=RasterizeConfig(
                             pair_budget=1 << 13), sh_levels=2),
                         device=CPU)


def test_a_refine_step_records_its_four_parts():
    trainer = _refine_trainer()
    with recording():
        trainer.step(0)
    spans = take_spans()
    assert [s.name for s in spans if s.parent == -1] == ["refine.step"]
    assert _children(spans, 0) == ["refine.render", "refine.losses",
                                   "refine.backward", "refine.optimizer"]


def test_recording_changes_no_number(tmp_path):
    a, b = _edit_trainer(tmp_path / "a"), _edit_trainer(tmp_path / "b")
    with recording():
        recs_a = [a.train_step(seed=1) for _ in range(2)]
    recs_b = [b.train_step(seed=1) for _ in range(2)]
    assert recs_a == recs_b
    for x, y in zip(a.params.parameters(), b.params.parameters()):
        assert torch.equal(x, y)
    pipe = _pipeline()
    with recording():
        armed = _inpaint(pipe)
    assert torch.equal(armed, _inpaint(pipe))


def test_a_bare_profiler_arms_the_spans_without_annotating(tmp_path):
    """Under a profiler somebody else started, the spans are recorded and
    its host-op tree holds no user annotation of theirs."""
    trainer = _edit_trainer(tmp_path)
    with torch.profiler.profile() as prof:
        trainer.train_step(seed=1)
    names = {s.name for s in take_spans()}
    assert set(EDIT_CHILDREN) | {"edit.step", "unet", "vae_encode"} <= names
    annotated = {e.name for e in prof.events() if e.is_user_annotation}
    assert not annotated & names
    # The operator's recording annotates.
    with torch.profiler.profile() as prof, recording():
        trainer.train_step(seed=1)
    take_spans()
    annotated = {e.name for e in prof.events() if e.is_user_annotation}
    assert {"edit.step", "edit.render", "unet"} <= annotated


def test_spans_of_another_thread_have_their_own_stack():
    import threading

    with recording():
        with span("outer"):
            t = threading.Thread(target=lambda: span("other").__enter__()
                                 .__exit__(None, None, None))
            t.start()
            t.join(timeout=30)
            with span("inner"):
                pass
    assert not t.is_alive()
    spans = {s.name: s for s in take_spans()}
    assert spans["inner"].parent == list(spans).index("outer")
    assert spans["other"].parent == -1
    assert spans["other"].thread != spans["outer"].thread
