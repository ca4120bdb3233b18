"""The stage-1 SDS geometry-edit step with SD1.5 in fp16, as the reference
deploys its guidance: `HumanEditTrainer.train_step` of the port in a closed
loop from `start_step`, its prior and prompt encoder built by the factory's
`sd15_backend` with `half_precision_weights` (what
`make_guidance_backend(..., half_precision_weights=True)` builds): the
UNet, the VAE and the CLIP text encoder in fp16; the field, the geometry,
the losses and AdamW in f32.

The weights are `sds_edit`'s draws with the UNet's, the VAE's and CLIP's
rounded to fp16, as a published fp16 checkpoint holds them. The plain reference
(`benchmark/reference/edit_step.py`) runs in f32 on those rounded weights
widened to f32, so the comparison measures the program's arithmetic and
not the rounding of its weights. Beside `sds_edit`'s readings it compares
the first step's classifier-free ε̂, the reference's on the program's own
z_t (`eps_gap`), and it counts ε̂'s non-finite entries over the check
steps (`sds_nonfinite`, the port's `sds.nonfinite` counter). After the
window the reference also records the largest |activation| of each UNet
and VAE level in f32 on the first step's inputs: fp16 holds 65,504."""

from __future__ import annotations

import gc
import json
import math
import sys
from pathlib import Path
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.core import training, window
from benchmark.core.cell import CellRun, Context, SetupLog, seed_words, tuples
from benchmark.core.roofline import F32_OPS_PER_S, HBM_BYTES_PER_S
from benchmark.core.trace import profile
from benchmark.entries import sds_edit

HALF = torch.float16
# The nearest precision below the configuration's: the control's networks.
CONTROL_DTYPE = torch.bfloat16
# NVIDIA's H100 SXM data sheet: dense fp16 on the tensor cores, 700 W.
F16_TENSOR_OPS_PER_S = 989.4e12
FP16_MAX = 65504.0
CONV_HALF = Path(__file__).resolve().parents[1] / "kernels" / "conv_half.json"


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """`sds_edit`'s draws, the UNet's, the VAE's and CLIP's rounded to fp16
    in place (they stay f32 tensors, for the reference)."""
    w = sds_edit.make_weights(cfg, seed, device)
    from benchmark.reference.sd_layers import tree_leaves

    for net in ("unet", "vae", "clip"):
        for leaf in tree_leaves(w[net]):
            leaf.copy_(leaf.to(HALF))
    return w


def build_program(cfg: Dict, w: Dict, seed: int, device, cache_dir: str):
    """`sds_edit`'s trainer on the fp16 prior and prompt encoder of the
    factory's `sd15_backend`, its prompts encoded by the fp16 encoder."""
    from youreditableavatar_tpu_torch.guidance.clip_text import CLIPTextConfig
    from youreditableavatar_tpu_torch.guidance.factory import sd15_backend
    from youreditableavatar_tpu_torch.guidance.prompts import PromptProcessor
    from youreditableavatar_tpu_torch.guidance.sd_unet import UNetConfig
    from youreditableavatar_tpu_torch.guidance.sd_vae import VAEConfig

    trainer = sds_edit.build_program(cfg, w, seed, device, cache_dir)
    prior, enc = sd15_backend(
        w["unet"], w["vae"], w["clip"], UNetConfig(**tuples(cfg["unet"])),
        VAEConfig(**tuples(cfg["vae"])), CLIPTextConfig(**tuples(cfg["clip"])),
        half_precision_weights=True, device=device)
    trainer.guidance.prior = prior
    trainer.prompts_local = trainer.prompts_global = PromptProcessor(
        cfg["prompt"], cfg["negative_prompt"], enc, cache_dir=cache_dir,
        model_name=f"{cfg['name']}-fp16-seed{seed}")
    return trainer


def build_reference(cfg: Dict, w: Dict, seed: int, device,
                    dtype=torch.float32):
    """`sds_edit`'s plain reference, its UNet and VAE computing in `dtype`
    (its text encoder takes no dtype: f32 on the fp16-rounded weights)."""
    es = sds_edit.build_reference(cfg, w, seed, device)
    if dtype != torch.float32:
        p = es.guidance.prior
        es.guidance.prior = type(p)(w["unet"], w["vae"], p.unet_cfg,
                                    p.vae_cfg, dtype=dtype, device=p.device)
    return es


class FirstCall:
    """Wraps `owner.name` for its first call alone, and keeps that call's
    arguments and result."""

    def __init__(self, owner, name: str):
        self.args = self.result = None
        inner = getattr(owner, name)

        def once(*args, **kw):
            delattr(owner, name)  # the class's method from here on
            self.args, self.result = args, inner(*args, **kw)
            return self.result

        setattr(owner, name, once)


def eps_hat(cfg: Dict, eps) -> torch.Tensor:
    cond, uncond = eps
    return uncond + cfg["guidance"]["guidance_scale"] * (cond - uncond)


def program_readings(cfg: Dict, trainer, seed: int) -> Dict:
    """`sds_edit`'s readings of the check steps, with the first step's
    noise prediction, its inputs and the rendered normal map it encoded,
    and the port's counts over the steps."""
    from youreditableavatar_tpu_torch.utils.profiling import counting

    prior = trainer.guidance.prior
    unet, vae = FirstCall(prior, "predict_noise"), FirstCall(prior,
                                                             "encode_images")
    with counting() as counted:
        out = sds_edit.program_readings(cfg, trainer, seed)
    out["counts"] = {k: int(v) for k, v in counted.items()}
    out["unet_in"] = [x.detach() for x in unet.args]
    out["eps_hat"] = eps_hat(cfg, unet.result)
    out["image"] = vae.args[0].detach()
    return out


class LevelPeaks(TorchDispatchMode):
    """The largest |output| of every floating-point operation, kept on the
    device by `level`, which the caller sets."""

    def __init__(self):
        super().__init__()
        self.level, self.peaks = None, {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.level is not None:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and t.numel()):
                    m = t.detach().abs().amax().float()
                    old = self.peaks.get(self.level)
                    self.peaks[self.level] = (m if old is None
                                              else torch.maximum(old, m))
        return out


def activation_peaks(ref_prior, prog: Dict) -> Dict[str, float]:
    """The f32 reference's largest |activation| by UNet and VAE encoder
    level (`conv_in`, `down<i>`, `mid`, `up<i>`, `out`), on the first
    step's CFG batch and normal map: the reference's stage functions, and
    the encoder's `vae_encode_moments` spelled out level by level."""
    from benchmark.reference import sd_layers, sd_unet

    z_t, t, cond, uncond = prog["unet_in"]
    zz, tt, ctx = (torch.cat([z_t, z_t]), torch.cat([t, t]),
                   torch.cat([cond, uncond]).float())
    p, ucfg = ref_prior.unet_params, ref_prior.unet_cfg
    mode = LevelPeaks()
    with torch.no_grad(), mode:
        mode.level = "unet.conv_in"
        h, temb = sd_unet.apply_unet_conv_in(p, zz, tt, ucfg)
        skips = [h]
        for lvl in range(len(p["down"])):
            mode.level = f"unet.down{lvl}"
            h, more = sd_unet.apply_unet_down_level(p, lvl, h, temb, ctx, ucfg)
            skips.extend(more)
        mode.level = "unet.mid"
        h = sd_unet.apply_unet_mid(p, h, temb, ctx, ucfg)
        for i in range(len(p["up"])):
            mode.level = f"unet.up{i}"
            k = len(p["up"][i]["resnets"])
            h = sd_unet.apply_unet_up_level(p, i, h, tuple(skips[-k:]), temb,
                                            ctx, ucfg)
            del skips[-k:]
        mode.level = "unet.out"
        sd_unet.apply_unet_out(p, h, ucfg)
        # `vae_encode_moments`, level by level.
        enc, vcfg = ref_prior.vae_params["encoder"], ref_prior.vae_cfg
        mode.level = "vae.conv_in"
        h = sd_layers.conv2d(prog["image"] * 2.0 - 1.0, enc["conv_in"])
        for i, level in enumerate(enc["down"]):
            mode.level = f"vae.down{i}"
            for res in level["resnets"]:
                h = sd_layers.resnet_block(h, None, res, vcfg.groups, eps=1e-6)
            if "down" in level:
                h = sd_layers.conv2d(h, level["down"], stride=2,
                                     padding=((0, 1), (0, 1)))
        mode.level = "vae.mid"
        mid = enc["mid"]
        h = sd_layers.resnet_block(h, None, mid["res1"], vcfg.groups, eps=1e-6)
        h = sd_layers.self_attention_2d(h, mid["attn"], vcfg.groups, eps=1e-6)
        h = sd_layers.resnet_block(h, None, mid["res2"], vcfg.groups, eps=1e-6)
        mode.level = "vae.out"
        h = torch.nn.functional.silu(
            sd_layers.group_norm(h, enc["norm_out"], vcfg.groups, eps=1e-6))
        sd_layers.conv2d(sd_layers.conv2d(h, enc["conv_out"]),
                         ref_prior.vae_params["quant"])
    return {k: float(v) for k, v in mode.peaks.items()}


class ConvTally(TorchDispatchMode):
    """Convolutions and their input gradients, by kernel footprint
    (`spatial`: R·S > 1; `pointwise`: 1×1): calls, operations and the
    bytes of their operands at 2 bytes an element (fp16)."""

    def __init__(self):
        super().__init__()
        self.tally = {kind: {"calls": 0, "flops": 0.0, "bytes": 0.0}
                      for kind in ("spatial", "pointwise")}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        aten = torch.ops.aten
        if func is aten.convolution.default:
            x, w, y = args[0], args[1], out
        elif func is aten.convolution_backward.default:
            if not args[-1][0]:  # output_mask: no input gradient asked
                return out
            y, w, x = args[0], args[2], out[0]  # dX from dY and W
        else:
            return out
        taps = w.shape[2] * w.shape[3]  # R·S of an OIHW weight
        t = self.tally["spatial" if taps > 1 else "pointwise"]
        t["calls"] += 1
        t["flops"] += 2.0 * y.numel() * w.shape[1] * taps
        t["bytes"] += 2.0 * (x.numel() + w.numel() + y.numel())
        return out


def network_work(ref_prior, prog: Dict) -> Dict[str, float]:
    """The FLOPs of the networks' part of one step (the VAE encoder forward
    and input gradient, the UNet at CFG batch 2), counted on the f32
    reference, and its convolutions' tally."""
    from torch.utils.flop_counter import FlopCounterMode

    z_t, t, cond, uncond = prog["unet_in"]
    image = prog["image"].clone().requires_grad_(True)
    noise = torch.zeros_like(z_t)
    counter, convs = FlopCounterMode(display=False), ConvTally()
    with counter, convs:
        z = ref_prior.encode_images(image, noise=noise)
        z.sum().backward()
        ref_prior.predict_noise(z_t, t, cond, uncond)
    return {"flops": float(counter.get_total_flops()), **{
        f"{kind}_{k}": v for kind, t in convs.tally.items()
        for k, v in t.items()}}


def least_ms(cfg: Dict, w: Dict, step_flops: float, net: Dict) -> float:
    """The step's least time on the chip: the networks' FLOPs at the dense
    fp16 tensor rate and the rest of the reference's at the f32 rate, or
    the bytes it cannot avoid — the UNet's and the VAE encoder's fp16
    weights read once, the field's f32 parameters read and written by AdamW
    (parameter, gradient, two moments: 7 words)."""
    from benchmark.reference.sd_layers import tree_numel

    field = w["grid"].numel() + sum(a.numel() + b.numel() for a, b in w["mlp"])
    moved = (2 * (tree_numel(w["unet"]) + tree_numel(w["vae"]["encoder"]))
             + 4 * 7 * field)
    ops_s = (net["flops"] / F16_TENSOR_OPS_PER_S
             + max(step_flops - net["flops"], 0.0) / F32_OPS_PER_S)
    return max(moved / HBM_BYTES_PER_S, ops_s) * 1e3


def run(ctx: Context) -> CellRun:
    cfg, dev = ctx.config, ctx.device
    seed = seed_words(ctx.seed)
    limits = ctx.workload["limits"]
    log = SetupLog(ctx)
    w = make_weights(cfg, seed, dev)
    log("weights drawn, the networks' rounded to fp16")
    trainer = build_program(cfg, w, seed, dev,
                            str(ctx.cache_dir / "text_embeddings"))
    log("trainer built")
    prog = program_readings(cfg, trainer, seed)
    log(f"{training.CHECK_STEPS} steps; counted {prog['counts']}")
    setup_s = ctx.setup_seconds()

    losses: List[float] = []

    def step(_):
        losses.append(trainer.train_step(seed=seed)["loss"])

    window_s, durations = window.step_window(step, ctx.seconds, dev)
    steps = len(durations)
    metrics = {"step_ms": (window.step_ms(window_s, steps), "ms"),
               "setup_s": (setup_s, "s")}
    trace = None
    if ctx.trace:
        def profiled():
            for _ in range(sds_edit.PROFILED_STEPS):
                trainer.train_step(seed=seed)
            return sds_edit.PROFILED_STEPS
        trace = profile(profiled)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    del trainer, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = sds_edit.reference_readings(cfg, w, seed, dev, count_flops=ctx.trace)
    found = training.gaps(prog, ref)
    from benchmark.reference import sd15, sd_unet, sd_vae

    ref_prior = sd15.SD15Prior(w["unet"], w["vae"],
                               sd_unet.UNetConfig(**tuples(cfg["unet"])),
                               sd_vae.VAEConfig(**tuples(cfg["vae"])),
                               device=dev)
    z_t, t, cond, uncond = prog["unet_in"]
    want = eps_hat(cfg, ref_prior.predict_noise(z_t, t, cond, uncond))
    found["eps_gap"] = float((prog["eps_hat"] - want).abs().max()
                             / want.abs().max())
    found["sds_nonfinite"] = float(prog["counts"].get("sds.nonfinite", 0))
    for k, v in found.items():
        print(f"reading {k}: {v!r}", file=sys.stderr)
    peaks = activation_peaks(ref_prior, prog)
    for k, v in peaks.items():
        print(f"reading peak {k}: {v!r}{' OVER fp16' if v > FP16_MAX else ''}",
              file=sys.stderr)
    layer = {"unit_ms": metrics["step_ms"][0], "durations_ms": durations,
             "gaps": found, "peaks": peaks, "counts": prog["counts"],
             "readings": {"program": {k: prog[k] for k in
                                      ("loss", "grad", "change1", "change")},
                          "reference": {k: ref[k] for k in
                                        ("loss", "grad", "change1", "change")}}}
    if ctx.trace:
        net = network_work(ref_prior, prog)
        layer["least_ms"] = least_ms(cfg, w, ref["flops"], net)
        quantities = sds_edit.launch_quantities(cfg, ref)
        # cuDNN runs the spatial convolutions on the implicit-GEMM kernels
        # that conv_half.json matches, and the 1×1 ones as GEMMs, which
        # it does not: the spatial ones' work over the window, by launch.
        match = json.loads(CONV_HALF.read_text())["match"]
        launched, _ = trace.kernel_time_us(match)
        if launched:
            for k in ("flops", "bytes"):
                quantities[f"conv_half_{k}"] = (
                    net[f"spatial_{k}"] * trace.iters / launched)
        net["conv_half_launches_a_step"] = launched / trace.iters
        layer["launch_quantities"] = quantities
        print(f"reading network work: {net}", file=sys.stderr)
    failed = sum(1 for x in losses + prog["loss"] if not math.isfinite(x))
    return CellRun(
        attempted=steps, failed=failed, metrics=metrics,
        checks=[(k, found[k], lim) for k, lim in limits.items()],
        memory_peak_bytes=peak, trace=trace, layer=layer)


class _ReferenceTrainer:
    """The plain reference behind the trainer's interface."""

    def __init__(self, step):
        self.es, self.params, self.optimizer = step, step.params, step.optimizer
        self.guidance = step.guidance

    def train_step(self, seed):
        return self.es.step(seed)


def CONTROL():
    """The reference in the program's place, its networks computing in
    bf16: the nearest precision below the configuration's fp16."""
    from benchmark.core import controls

    return controls.patched(
        sys.modules[__name__], "build_program",
        lambda cfg, w, seed, device, cache_dir: _ReferenceTrainer(
            build_reference(cfg, w, seed, device, CONTROL_DTYPE)))


FAULTS = sds_edit.FAULTS
