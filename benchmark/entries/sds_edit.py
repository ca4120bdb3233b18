"""The stage-1 SDS geometry-edit step: `HumanEditTrainer.train_step` of the
port in a closed loop from `start_step`, on weights, a field and draws made
from the run's seed.

Set-up builds the trainer, drives its first CHECK_STEPS steps through
`train_step` (the window's own call and feed; they warm up every shape and
build the kernels), reads their losses, the first gradient from AdamW's
state after one step and the parameters' change after the last, and hands
the same trainer to the window. Once the window has closed and the
program is freed, the plain reference (`benchmark/reference/edit_step.py`)
makes the same steps from the same inputs and the readings are compared."""

from __future__ import annotations

import gc
import math
import sys
from typing import Dict, List

import torch

from benchmark.core import controls, training, window
from benchmark.core.cell import CellRun, Context, SetupLog, seed_words, tuples
from benchmark.core.roofline import bound
from benchmark.core.trace import profile
from benchmark.core.weights import Pool

PROFILED_STEPS = 5


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The SD1.5 networks' trees and the field's tensors, drawn on the card
    by the reference's inits through one pool."""
    from benchmark.reference import clip_text, sd_unet, sd_vae

    pool = Pool(seed, device)
    out = {
        "unet": sd_unet.init_unet_params(
            pool, sd_unet.UNetConfig(**tuples(cfg["unet"]))),
        "vae": sd_vae.init_vae_params(pool, sd_vae.VAEConfig(**tuples(cfg["vae"]))),
        "clip": clip_text.init_clip_text_params(
            pool, clip_text.CLIPTextConfig(**tuples(cfg["clip"]))),
    }
    g = cfg["field"]["grid"]
    levels, feats = g["n_levels"], g["n_features_per_level"]
    # The port's inits: a U(-1e-4, 1e-4) table, Xavier-normal MLP layers.
    out["grid"] = pool.uniform((levels, 1 << g["log2_hashmap_size"], feats),
                               -1e-4, 1e-4)
    dims = ([levels * feats] + [cfg["field"]["n_neurons"]]
            * cfg["field"]["n_hidden_layers"] + [1])
    out["mlp"] = [(pool.take((a, b)) * math.sqrt(2.0 / (a + b)),
                   torch.zeros(b, device=device))
                  for a, b in zip(dims[:-1], dims[1:])]
    return out


def _field_cfg(mod_sdf, mod_hash, cfg):
    f = dict(cfg["field"])
    f["grid"] = mod_hash.HashGridConfig(**tuples(f["grid"]))
    return mod_sdf.SDFFieldConfig(**f)


def _params(mod_sdf, mod_mlp, w):
    layers = torch.nn.ModuleList(mod_mlp.MLPLayer(a.clone(), b.clone())
                                 for a, b in w["mlp"])
    return mod_sdf.SDFParams(w["grid"].clone(), layers)


def _edit_faces(mt, cap_z):
    fc = mt.verts[mt.faces.long()].mean(1)
    return (fc[:, 2] > cap_z) & mt.faces_valid


def build_program(cfg: Dict, w: Dict, seed: int, device, cache_dir: str):
    """The port's trainer at `start_step`, the control SDF taken from the
    untouched field (every loss term of the stage's config on)."""
    from youreditableavatar_tpu_torch.data.camera_sampler import (
        RandomCameraConfig)
    from youreditableavatar_tpu_torch.guidance.clip_text import CLIPTextConfig
    from youreditableavatar_tpu_torch.guidance.prompts import PromptProcessor
    from youreditableavatar_tpu_torch.guidance.sd15 import (
        CLIPPromptEncoder, SD15Prior)
    from youreditableavatar_tpu_torch.guidance.sd_unet import UNetConfig
    from youreditableavatar_tpu_torch.guidance.sd_vae import VAEConfig
    from youreditableavatar_tpu_torch.guidance.sds import SDSConfig, SDSGuidance
    from youreditableavatar_tpu_torch.models import mlp as p_mlp
    from youreditableavatar_tpu_torch.models import sdf as p_sdf
    from youreditableavatar_tpu_torch.models.geometry import (
        GeometryBudgets, TetGeometry)
    from youreditableavatar_tpu_torch.ops import hashgrid as p_hash
    from youreditableavatar_tpu_torch.ops.mesh_raster import MeshRasterConfig
    from youreditableavatar_tpu_torch.stages.spatial import (
        HumanEditConfig, HumanEditTrainer)

    prior = SD15Prior(w["unet"], w["vae"], UNetConfig(**tuples(cfg["unet"])),
                      VAEConfig(**tuples(cfg["vae"])), device=device)
    enc = CLIPPromptEncoder(w["clip"], CLIPTextConfig(**tuples(cfg["clip"])),
                            device=device)
    guidance = SDSGuidance(prior, SDSConfig(**cfg["guidance"]))
    prompts = PromptProcessor(cfg["prompt"], cfg["negative_prompt"], enc,
                              cache_dir=cache_dir,
                              model_name=f"{cfg['name']}-seed{seed}")
    field = p_sdf.SDFField(_field_cfg(p_sdf, p_hash, cfg))
    params = _params(p_sdf, p_mlp, w)
    geometry = TetGeometry(field, cfg["tet_grid"],
                           GeometryBudgets(**cfg["budgets"]), device=device)
    with torch.no_grad():
        mt = geometry.isosurface(params)
        edit = _edit_faces(mt, cfg["editable_cap_z"])
    part = geometry.partition_init(params, edit, frozen_mt=mt)
    e = cfg["edit"]
    ecfg = HumanEditConfig(
        **{k: tuples(e)[k] for k in e if k not in ("camera", "weight_decay")},
        camera=RandomCameraConfig(**tuples(e["camera"])))
    trainer = HumanEditTrainer(field, geometry, part, params, guidance,
                               prompts, prompts, ecfg,
                               MeshRasterConfig(**cfg["mesh_raster"]),
                               seed=seed, device=device)
    trainer.global_step = cfg["start_step"]
    with torch.no_grad():
        trainer.control_sdf = field.forward_sdf_chunked(params,
                                                        geometry.grid_pos)
    return trainer


def build_reference(cfg: Dict, w: Dict, seed: int, device):
    from benchmark.reference import (
        camera_sampler, clip_text, geometry, hashgrid, mesh_raster, mlp,
        prompts, sd15, sd_unet, sd_vae, sdf, sds)
    from benchmark.reference.edit_step import EditStep

    prior = sd15.SD15Prior(w["unet"], w["vae"],
                           sd_unet.UNetConfig(**tuples(cfg["unet"])),
                           sd_vae.VAEConfig(**tuples(cfg["vae"])), device=device)
    enc = sd15.CLIPPromptEncoder(
        w["clip"], clip_text.CLIPTextConfig(**tuples(cfg["clip"])),
        device=device)
    guidance = sds.SDSGuidance(prior, sds.SDSConfig(**cfg["guidance"]))
    processor = prompts.PromptProcessor(cfg["prompt"], cfg["negative_prompt"],
                                        enc)
    field = sdf.SDFField(_field_cfg(sdf, hashgrid, cfg))
    params = _params(sdf, mlp, w)
    geom = geometry.TetGeometry(field, cfg["tet_grid"],
                                geometry.GeometryBudgets(**cfg["budgets"]),
                                device=device)
    with torch.no_grad():
        mt = geom.isosurface(params)
        edit = _edit_faces(mt, cfg["editable_cap_z"])
    part = geom.partition_init(params, edit, frozen_mt=mt)
    with torch.no_grad():
        control = field.forward_sdf_chunked(params, geom.grid_pos)
    e = cfg["edit"]
    weights = {k: e[k] for k in (
        "lambda_sds", "lambda_sds_global", "lambda_sdf_recon",
        "lambda_sdf_control", "lambda_normal_consistency",
        "lambda_normal_consistency_sub")}
    return EditStep(
        field, geom, part, params, guidance, processor,
        camera_sampler.RandomCameraConfig(**tuples(e["camera"])),
        mesh_raster.MeshRasterConfig(**cfg["mesh_raster"]), weights,
        {"lr": e["lr"], "betas": e["betas"], "eps": e["eps"],
         "weight_decay": e["weight_decay"]},
        e["recon_points"], e["sub_step"], e["sdf_cache_refresh"],
        cfg["start_step"], seed, control, device)


def program_readings(cfg: Dict, trainer, seed: int) -> Dict:
    return training.readings(lambda k: trainer.train_step(seed=seed)["loss"],
                             list(trainer.params.parameters()),
                             trainer.optimizer, cfg["edit"]["betas"][0])


def reference_readings(cfg: Dict, w: Dict, seed: int, device,
                       count_flops: bool = False) -> Dict:
    """The reference's readings of the same steps; with `count_flops`, the
    FLOPs of its first step too (`FlopCounterMode`)."""
    from torch.utils.flop_counter import FlopCounterMode

    es = build_reference(cfg, w, seed, device)
    counter = FlopCounterMode(display=False) if count_flops else None
    out = training.readings(lambda k: es.step(seed)["loss"],
                            list(es.params.parameters()), es.optimizer,
                            cfg["edit"]["betas"][0], first=counter)
    out["records"] = es.records
    out["flops"] = counter.get_total_flops() if count_flops else None
    return out


def launch_quantities(cfg: Dict, ref: Dict) -> Dict[str, float]:
    """Per launch, the quantities the kernels' bounds count
    (`benchmark/kernels/*.json`), from the cell's budgets and the
    reference's own renders of its first steps: K4's rows and table, K5's
    faces, pairs, tiles and pixels."""
    b, e, g = cfg["budgets"], cfg["edit"], cfg["field"]["grid"]
    levels = g["n_levels"]
    points = [4 * b["compact"], b["subdiv_mid"], e["recon_points"]]
    recs = ref["records"]
    resolves = sum(r["resolves"] for r in recs)
    cam = e["camera"]
    tiles = (-(-cam["width"] // cfg["mesh_raster"]["tile_size"])
             * -(-cam["height"] // cfg["mesh_raster"]["tile_size"]))
    return {
        "hash_rows": sum(levels * n * 8 for n in points) / len(points),
        "hash_table_floats": levels * (1 << g["log2_hashmap_size"])
        * g["n_features_per_level"],
        "mesh_pixels": cam["width"] * cam["height"],
        "mesh_tiles": tiles,
        "mesh_pairs": sum(r["pairs"] for r in recs) / resolves,
        "mesh_faces": sum(r["faces"] * r["resolves"] for r in recs) / resolves,
    }


def least_ms(cfg: Dict, w: Dict, flops: float) -> float:
    """The step's least time on the chip: its FLOPs (counted on the
    reference) at the f32 rate, or the bytes it cannot avoid — the UNet's
    and the VAE encoder's weights read once, the field's parameters read
    and written by AdamW (parameter, gradient, two moments: 7 words)."""
    from benchmark.reference.sd_layers import tree_numel

    field = w["grid"].numel() + sum(a.numel() + b.numel() for a, b in w["mlp"])
    moved = 4 * (tree_numel(w["unet"]) + tree_numel(w["vae"]["encoder"])
                 + 7 * field)
    return bound(moved, flops)[0]


def run(ctx: Context) -> CellRun:
    cfg, dev = ctx.config, ctx.device
    seed = seed_words(ctx.seed)
    limits = ctx.workload["limits"]
    log = SetupLog(ctx)
    w = make_weights(cfg, seed, dev)
    log("weights drawn")
    trainer = build_program(cfg, w, seed, dev,
                            str(ctx.cache_dir / "text_embeddings"))
    log("trainer built")
    prog = program_readings(cfg, trainer, seed)
    log(f"{training.CHECK_STEPS} steps")
    setup_s = ctx.setup_seconds()

    losses: List[float] = []

    def step(_):
        losses.append(trainer.train_step(seed=seed)["loss"])

    window_s, durations = window.step_window(step, ctx.seconds, dev)
    steps = len(durations)
    metrics = {"step_ms": (window.step_ms(window_s, steps), "ms"),
               "setup_s": (setup_s, "s")}
    p90 = window.p90(durations)
    if p90 is not None:
        metrics["step_p90_ms"] = (p90, "ms")
    trace = None
    if ctx.trace:
        def profiled():
            for _ in range(PROFILED_STEPS):
                trainer.train_step(seed=seed)
            return PROFILED_STEPS
        trace = profile(profiled)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    del trainer, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = reference_readings(cfg, w, seed, dev, count_flops=ctx.trace)
    found = training.gaps(prog, ref)
    for k, v in found.items():
        print(f"reading {k}: {v!r}", file=sys.stderr)
    layer = {"unit_ms": metrics["step_ms"][0], "durations_ms": durations,
             "gaps": found,
             "readings": {"program": prog,
                          "reference": {k: ref[k] for k in prog}}}
    if ctx.trace:
        layer["least_ms"] = least_ms(cfg, w, ref["flops"])
        layer["launch_quantities"] = launch_quantities(cfg, ref)
    failed = sum(1 for x in losses + prog["loss"] if not math.isfinite(x))
    return CellRun(
        attempted=steps, failed=failed, metrics=metrics,
        checks=[(k, found[k], lim) for k, lim in limits.items()],
        memory_peak_bytes=peak, trace=trace, layer=layer)


class _ReferenceTrainer:
    """The plain reference with TF32 on, behind the trainer's interface."""

    def __init__(self, step):
        self.es, self.params, self.optimizer = step, step.params, step.optimizer

    def train_step(self, seed):
        with controls.tf32():
            return self.es.step(seed)


def CONTROL():
    """The reference in the program's place, computed with TF32 on: the
    nearest precision below the configuration's f32."""
    return controls.patched(
        sys.modules[__name__], "build_program",
        lambda cfg, w, seed, device, cache_dir: _ReferenceTrainer(
            build_reference(cfg, w, seed, device)))


def _state_unchanged():
    from youreditableavatar_tpu_torch.stages import spatial

    def optimizer(name, lr, betas, eps):
        return lambda ps: controls.frozen_state(torch.optim.AdamW)(
            ps, lr=lr, betas=betas, eps=eps, weight_decay=0.01)
    return controls.patched(spatial, "parse_optimizer", optimizer)


def _half_batch():
    """The step's batch is one view; its one batch of two is the UNet's
    [conditioned; unconditioned] pair: the conditioned half twice."""
    from youreditableavatar_tpu_torch.guidance.sd15 import SD15Prior

    predict = SD15Prior.predict_noise
    return controls.patched(
        SD15Prior, "predict_noise",
        lambda self, z_t, t, cond, uncond: predict(self, z_t, t, cond, cond))


def _scatter_half_rows():
    """K4's answer altered where it is produced: every second row of the
    hash grid's gradient left out of the scatter-add."""
    from youreditableavatar_tpu_torch.ops import hashgrid

    scatter = hashgrid.hash_scatter_add

    def half(idx, v0, v1, table_size):
        keep = torch.ones_like(v0)
        keep[:, 1::2] = 0
        return scatter(idx, v0 * keep, v1 * keep, table_size)
    return controls.patched(hashgrid, "hash_scatter_add", half)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "scatter_half_rows": _scatter_half_rows}
