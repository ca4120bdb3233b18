"""PyTorch port: checkpoints, the run utilities and resuming the spatial
edit, against the JAX package where both write the same thing."""

import collections
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    replication_worker,
    run_world,
    single_threaded_torch,  # noqa: F401  (fixture)
    small_fields,
)

PARAMS = ("delta", "log_scales", "quats", "opacity_raw", "sh_dc", "sh_rest")
Pair = collections.namedtuple("Pair", "zeta alpha")


def _tetgs_params(seed):
    from youreditableavatar_tpu_torch.models.tetgs import params_from_numpy

    rng = np.random.default_rng(seed)
    shapes = dict(delta=(40, 1), log_scales=(40, 3), quats=(40, 4),
                  opacity_raw=(40, 1), sh_dc=(40, 1, 3), sh_rest=(40, 3, 3))
    return params_from_numpy({k: rng.normal(size=s) for k, s in shapes.items()},
                             device="cpu")


def _adam_steps(params, opt, n, seed):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        for p in params.parameters():
            p.grad = torch.tensor(rng.normal(size=p.shape).astype(np.float32))
        opt.step()


def test_save_load_state_round_trip(tmp_path):
    """Params, Adam's moments and step counts, the position-schedule count,
    step, epoch and extras come back; the next step is the same bits."""
    from youreditableavatar_tpu_torch.models.optimizer import (
        OptimizationParams, make_tetgs_optimizer)
    from youreditableavatar_tpu_torch.utils.checkpoint import (
        load_state, save_state)

    a = _tetgs_params(0)
    opt_a = make_tetgs_optimizer(a, OptimizationParams(), 2.0)
    _adam_steps(a, opt_a, 3, seed=1)
    path = tmp_path / "ckpt" / "state.pt"
    save_state(str(path), a, opt_a, step=3, epoch=1,
               extra={"control_sdf": np.arange(5, dtype=np.float32),
                      "note": torch.ones(2)})

    b = _tetgs_params(9)
    opt_b = make_tetgs_optimizer(b, OptimizationParams(), 2.0)
    state = load_state(str(path))
    assert set(state) == {"params", "opt_state", "step", "epoch", "extra"}
    assert (state["step"], state["epoch"]) == (3, 1)
    np.testing.assert_array_equal(state["extra"]["control_sdf"].numpy(),
                                  np.arange(5, dtype=np.float32))
    b.load_state_dict(state["params"])
    opt_b.load_state_dict(state["opt_state"])
    assert opt_b.count == opt_a.count == 3
    for name in PARAMS:
        pa, pb = getattr(a, name), getattr(b, name)
        assert torch.equal(pa, pb), name
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt_a.adam.state[pa][key], opt_b.adam.state[pb][key])
    _adam_steps(a, opt_a, 1, seed=2)
    _adam_steps(b, opt_b, 1, seed=2)
    for name in PARAMS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_load_module_weights(tmp_path):
    from youreditableavatar_tpu_torch.utils.checkpoint import (
        load_module_weights, save_state)

    _, field = small_fields()
    params = field.init_params(0, device="cpu")
    save_state(str(tmp_path / "s.pt"), params)
    mlp = load_module_weights(str(tmp_path / "s.pt"), "mlp")
    assert set(mlp) == set(params.mlp.state_dict())
    params.mlp.load_state_dict(mlp)
    whole = load_module_weights(str(tmp_path / "s.pt"), "")
    assert torch.equal(whole["grid"], params.grid)


def _simple_tree(xp):
    rng = np.random.default_rng(3)
    arr = lambda *s: xp(rng.normal(size=s).astype(np.float32))  # noqa: E731
    return {"b": [arr(2, 3), None, (arr(4),)], "a": arr(5),
            "pair": Pair(arr(1), arr(2, 2))}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_save_simple_npz_layout_is_shared(writer, tmp_path):
    """Either package's `save_simple` file loads in the other against a
    template; both write the same keys, leaves and structure text."""
    from youreditableavatar_tpu.utils import checkpoint as jck
    from youreditableavatar_tpu_torch.utils import checkpoint as tck

    paths = {"jax": tmp_path / "jax.npz", "port": tmp_path / "port.npz"}
    jck.save_simple(str(paths["jax"]), tree=_simple_tree(jnp.asarray), n=7)
    tck.save_simple(str(paths["port"]), tree=_simple_tree(torch.tensor), n=7)
    with np.load(paths["jax"]) as zj, np.load(paths["port"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)

    template_t = {"tree": _simple_tree(lambda x: torch.zeros(x.shape)),
                  "n": torch.zeros(())}
    template_j = {"tree": _simple_tree(lambda x: jnp.zeros(x.shape)),
                  "n": jnp.zeros(())}
    want = _simple_tree(np.asarray)
    if writer == "jax":
        got = tck.load_simple(str(paths["jax"]), template_t)
        leaf = lambda x: x.numpy()  # noqa: E731
    else:
        got = jck.load_simple(str(paths["port"]), template_j)
        leaf = np.asarray
    tree = got["tree"]
    np.testing.assert_array_equal(leaf(tree["a"]), want["a"])
    np.testing.assert_array_equal(leaf(tree["b"][0]), want["b"][0])
    assert tree["b"][1] is None
    np.testing.assert_array_equal(leaf(tree["b"][2][0]), want["b"][2][0])
    assert isinstance(tree["pair"], Pair)
    np.testing.assert_array_equal(leaf(tree["pair"].alpha), want["pair"].alpha)
    assert int(leaf(got["n"])) == 7


def _edit_trainer(tmp_path):
    """test_spatial.py's resume trainer, on the port: the small field, the
    cap z > 0.1 of its surface editable, 64² views, control SDF from
    step 1."""
    from youreditableavatar_tpu_torch.data.camera_sampler import (
        RandomCameraConfig)
    from youreditableavatar_tpu_torch.guidance.prompts import PromptProcessor
    from youreditableavatar_tpu_torch.guidance.sds import SDSConfig, SDSGuidance
    from youreditableavatar_tpu_torch.guidance.stub import (
        StubDiffusionPrior, StubPromptEncoder)
    from youreditableavatar_tpu_torch.models.geometry import (
        GeometryBudgets, TetGeometry)
    from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig
    from youreditableavatar_tpu_torch.stages.spatial import (
        HumanEditConfig, HumanEditTrainer)
    from torch_port_helpers import SMALL_BUDGETS

    _, field = small_fields()
    params = field.init_params(0, device="cpu")
    geom = TetGeometry(field, 10, GeometryBudgets(**SMALL_BUDGETS), device="cpu")
    mt = geom.isosurface(params)
    edit = (mt.verts[mt.faces.long()].mean(1)[:, 2] > 0.1) & mt.faces_valid
    part = geom.partition_init(params, edit, frozen_mt=mt)
    prompts = PromptProcessor("a red jacket", "low quality",
                              StubPromptEncoder(device="cpu"),
                              cache_dir=str(tmp_path / "prompts"),
                              model_name="stub-test")
    cfg = HumanEditConfig(
        max_steps=4, recon_points=2048, start_sdf_loss_step=1, log_every=1,
        camera=RandomCameraConfig(height=64, width=64,
                                  camera_distance_range=(1.6, 1.8),
                                  elevation_range=(-5, 10),
                                  fovy_range=(40, 45)))
    guidance = SDSGuidance(StubDiffusionPrior(device="cpu"),
                           SDSConfig(guidance_scale=7.5))
    return HumanEditTrainer(field, geom, part, params, guidance, prompts,
                            prompts, cfg, MeshRasterConfig(pair_budget=1 << 14),
                            device="cpu")


def test_resume_matches_uninterrupted(tmp_path):
    """2 steps, save, restore into a fresh trainer, 2 more: the parameters
    equal a 4-step run's (the level count, schedules, draws and control
    SDF are all re-derived from the restored step)."""
    ref = _edit_trainer(tmp_path)
    ref.train(seed=1, num_steps=4)

    a = _edit_trainer(tmp_path)
    a.train(seed=1, num_steps=2)
    assert a.control_sdf is not None  # snapshot taken at step 1
    ckpt = str(tmp_path / "resume" / "ckpt.pt")
    a.save_checkpoint(ckpt)

    b = _edit_trainer(tmp_path)
    b.restore_checkpoint(ckpt)
    assert b.global_step == 2 and b.control_sdf is not None
    assert torch.equal(b._sdf_cache, a._sdf_cache)
    b.train(seed=1, num_steps=2)
    for (name, x), y in zip(ref.params.named_parameters(), b.params.parameters()):
        np.testing.assert_allclose(y.detach().numpy(), x.detach().numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)
    assert [m["step"] for m in b.metrics] == [2, 3]
    assert [m["loss"] for m in b.metrics] == pytest.approx(
        [m["loss"] for m in ref.metrics[2:]], rel=1e-5)
    moved = float((ref.params.grid - a.params.grid).detach().abs().max())
    assert moved > 1e-6  # steps 3 and 4 changed the parameters


def test_assert_replicated_raises_on_perturbed_rank(tmp_path):
    """Two gloo ranks: equal tensors pass; after rank 1 moves one value by
    1e-6, both ranks raise the JAX package's message."""
    msgs = run_world(replication_worker, 2, tmp_path, 1)
    assert msgs == ["pytree is not replicated across devices"] * 2


def test_assert_replicated_single_process_is_a_no_op():
    from youreditableavatar_tpu_torch.utils.misc import assert_replicated

    assert_replicated({"a": torch.ones(3)})


def test_step_timer_and_metrics_logger_match_jax(tmp_path):
    """The same metrics give the same JSONL line (but for the wall-clock
    `time`). The port has no `StepTimer`: its every mark waited for the
    card."""
    from youreditableavatar_tpu.utils import profiling as jprof
    from youreditableavatar_tpu_torch.utils import profiling as tprof

    assert not hasattr(tprof, "StepTimer")
    lines = []
    for mod, scalar in ((jprof, jnp.float32(0.25)), (tprof, torch.tensor(0.25))):
        logger = mod.MetricsLogger(str(tmp_path / mod.__name__))
        logger.log(7, loss=scalar, lr=1e-3, stage="fit", done=False, n=None,
                   shape=[2, 3])
        logger.close()
        with open(logger.path) as fh:
            rec = json.loads(fh.read().strip())
        assert isinstance(rec.pop("time"), float)
        lines.append(rec)
    assert lines[1] == lines[0]


def test_trace_writes_a_chrome_trace(tmp_path):
    """The Chrome trace carries each span over its ops, and the spans'
    records go beside it."""
    from youreditableavatar_tpu_torch.utils.profiling import (
        span, take_spans, trace)

    with trace(str(tmp_path / "prof")):
        with span("outer"):
            with span("inner"):
                torch.ones(64).cumsum(0)
    chrome = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in chrome["traceEvents"]}
    assert {"outer", "inner", "aten::cumsum"} <= names
    spans = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert [(s["name"], s["parent"], s["root"]) for s in spans] == [
        ("outer", -1, 0), ("inner", 0, 0)]
    assert take_spans() == []


def test_misc_helpers():
    from youreditableavatar_tpu_torch.utils.misc import (
        cleanup, key_seq, timed, tree_bytes)

    g1, g2 = key_seq(5), key_seq(5)
    draws = [torch.rand(3, generator=next(g1)) for _ in range(3)]
    assert all(torch.equal(d, torch.rand(3, generator=next(g2))) for d in draws)
    assert not torch.equal(draws[0], draws[1])
    assert tree_bytes({"a": torch.zeros(4), "b": [torch.zeros(2, dtype=torch.int64)]}) == 32
    sink = {}
    with timed("x", sink):
        torch.ones(8).sum()
    assert sink["x"] >= 0.0
    cleanup()
