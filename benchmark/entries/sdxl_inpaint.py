"""The stage-4a guidance call: `SDXLControlNetUnionPipeline.inpaint` of the
port, whole calls back to back, each on an image, a mask and a normal map
drawn from the run's seed (a new mask each call), with both union controls
(normal + repaint) and `steps` DDIM steps under CFG.

Every draw of a call (the encode's ε, the initial noise, each step's pin
noise) comes from `draws(name, shape)`, seeded by (seed, call, name), and
is handed to both sides. Once the window has closed and the program is
freed, the plain reference (`benchmark/reference/sdxl_pipeline.py`) makes
the same calls for a sample of them, drawn from the seed, and the images
are compared."""

from __future__ import annotations

import gc
import math
import sys
import zlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.core import compare, controls, window
from benchmark.core.cell import CellRun, Context, SetupLog, seed_words, tuples
from benchmark.core.roofline import bound
from benchmark.core.trace import profile
from benchmark.core.weights import Pool

# The scale of the ControlNet's zero-initialised weights, drawn at random
# so that its residuals reach the UNet (the port's tests draw them so).
ZERO_INIT_SCALE = 0.05
# The inputs' index of the set-up call: one the window never reaches.
WARMUP_CALL = 1 << 30


def _randomize_zero_inits(p, pool: Pool):
    def rand(t):
        return pool.take(tuple(t.shape)) * ZERO_INIT_SCALE

    p["task_emb"] = rand(p["task_emb"])
    p["cond_embed"]["conv_out"] = {k: rand(v) for k, v in
                                   p["cond_embed"]["conv_out"].items()}
    p["zero_convs"] = [{k: rand(v) for k, v in zc.items()}
                       for zc in p["zero_convs"]]
    p["mid_zero"] = {k: rand(v) for k, v in p["mid_zero"].items()}


def _cn_cfg(mod_cn, mod_unet, cfg):
    c = dict(tuples(cfg["controlnet"]))
    return mod_cn.ControlNetUnionConfig(
        unet=mod_unet.UNetConfig(**tuples(cfg["unet"])), **c)


def _pipe_cfg(mod_pipe, mod_cn, mod_unet, mod_vae, cfg):
    return mod_pipe.SDXLPipelineConfig(
        unet=mod_unet.UNetConfig(**tuples(cfg["unet"])),
        vae=mod_vae.VAEConfig(**tuples(cfg["vae"])),
        controlnet=_cn_cfg(mod_cn, mod_unet, cfg), **cfg["pipeline"])


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """The SDXL UNet, VAE, ControlNet-Union (zero inits drawn), both text
    towers and bigG's text projection, drawn on the card through one
    pool by the reference's inits."""
    from benchmark.reference import (
        clip_text, sd_unet, sd_vae, sdxl_controlnet)

    pool = Pool(seed, device)
    cn = sdxl_controlnet.init_controlnet_union_params(
        pool, _cn_cfg(sdxl_controlnet, sd_unet, cfg))
    _randomize_zero_inits(cn, pool)
    g = cfg["clip_g"]["dim"]
    return {
        "unet": sd_unet.init_unet_params(
            pool, sd_unet.UNetConfig(**tuples(cfg["unet"]))),
        "vae": sd_vae.init_vae_params(pool, sd_vae.VAEConfig(**tuples(cfg["vae"]))),
        "controlnet": cn,
        "clip_l": clip_text.init_clip_text_params(
            pool, clip_text.CLIPTextConfig(**tuples(cfg["clip_l"]))),
        "clip_g": clip_text.init_clip_text_params(
            pool, clip_text.CLIPTextConfig(**tuples(cfg["clip_g"]))),
        "proj_g": pool.take((g, g)) / math.sqrt(g),
    }


def _pipeline(pipe_mod, sd15_mod, clip_mod, cn_mod, unet_mod, vae_mod, cfg, w,
              device):
    enc_l = sd15_mod.CLIPPromptEncoder(
        w["clip_l"], clip_mod.CLIPTextConfig(**tuples(cfg["clip_l"])),
        device=device)
    enc_g = sd15_mod.CLIPPromptEncoder(
        w["clip_g"], clip_mod.CLIPTextConfig(**tuples(cfg["clip_g"])),
        device=device)
    text = pipe_mod.SDXLTextEncoder(enc_l, enc_g, w["proj_g"])
    return pipe_mod.SDXLControlNetUnionPipeline(
        w["unet"], w["vae"], w["controlnet"], text,
        _pipe_cfg(pipe_mod, cn_mod, unet_mod, vae_mod, cfg), device=device)


def build_program(cfg, w, device):
    from youreditableavatar_tpu_torch.guidance import (
        clip_text, sd15, sd_unet, sd_vae, sdxl_controlnet, sdxl_pipeline)

    return _pipeline(sdxl_pipeline, sd15, clip_text, sdxl_controlnet, sd_unet,
                     sd_vae, cfg, w, device)


def build_reference(cfg, w, device):
    from benchmark.reference import (
        clip_text, sd15, sd_unet, sd_vae, sdxl_controlnet, sdxl_pipeline)

    return _pipeline(sdxl_pipeline, sd15, clip_text, sdxl_controlnet, sd_unet,
                     sd_vae, cfg, w, device)


def _key(seed: int, call: int, name: str) -> int:
    return int(np.random.SeedSequence(
        [seed, call, zlib.crc32(name.encode())]).generate_state(1)[0])


def call_inputs(traffic: Dict, seed: int, call: int, device) -> Dict:
    """Call `call`'s image (smooth colours), normal map (a sphere's, in
    [0, 1]), mask (an ellipse, 1 = repaint; new each call) and draws."""
    size = traffic["size"]
    g = torch.Generator(device=device).manual_seed(_key(seed, call, "inputs"))
    coarse = torch.rand((1, 3, traffic["image_cells"], traffic["image_cells"]),
                        generator=g, device=device)
    image = F.interpolate(coarse, size=(size, size), mode="bilinear",
                          align_corners=False)[0].permute(1, 2, 0).contiguous()
    ax = (torch.arange(size, device=device, dtype=torch.float32) + 0.5) \
        / size * 2 - 1
    y, x = torch.meshgrid(ax, ax, indexing="ij")
    r2 = x * x + y * y
    inside = r2 < 1
    nz = torch.sqrt(torch.clamp(1 - r2, min=0))
    normal = torch.where(inside[..., None],
                         torch.stack([x, -y, nz], -1) * 0.5 + 0.5,
                         torch.full((size, size, 3), 0.5, device=device))
    lo, hi = traffic["mask_radius"]
    cx, cy, rx, ry = torch.rand(4, generator=g, device=device).tolist()
    cx, cy = cx - 0.5, cy - 0.5
    rx, ry = lo + (hi - lo) * rx, lo + (hi - lo) * ry
    mask = (((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2 < 1).to(torch.float32)

    def draws(name, shape):
        dg = torch.Generator(device=device).manual_seed(_key(seed, call, name))
        return torch.randn(shape, generator=dg, device=device)

    return {"image": image, "mask": mask, "normal": normal, "draws": draws}


def inpaint(pipe, traffic: Dict, inputs: Dict):
    return pipe.inpaint(inputs["image"], inputs["mask"], inputs["normal"],
                        inputs["image"], traffic["prompt"],
                        traffic["negative_prompt"], steps=traffic["steps"],
                        draws=inputs["draws"])


def sampled_calls(seed: int, calls: int, count: int):
    """`count` of the calls made, drawn from the seed (all when fewer)."""
    rng = np.random.default_rng([seed, 1])
    return sorted(rng.choice(calls, size=min(count, calls),
                             replace=False).tolist())


def least_ms(w, flops: float, steps: int) -> float:
    """One call's least time: its FLOPs (counted on the reference) at the
    f32 rate, or its weights read once — the UNet's and ControlNet's at
    every step, the VAE's and the text towers' once."""
    from benchmark.reference.sd_layers import tree_numel

    moved = 4 * (steps * (tree_numel(w["unet"]) + tree_numel(w["controlnet"]))
                 + tree_numel(w["vae"]) + tree_numel(w["clip_l"])
                 + tree_numel(w["clip_g"]) + w["proj_g"].numel())
    return bound(moved, flops)[0]


def run(ctx: Context) -> CellRun:
    cfg, traffic, dev = ctx.config, ctx.workload, ctx.device
    seed = seed_words(ctx.seed)
    log = SetupLog(ctx)
    w = make_weights(cfg, seed, dev)
    log("weights drawn")
    pipe = build_program(cfg, w, dev)
    warm = dict(traffic, steps=traffic["warmup_steps"])
    inpaint(pipe, warm, call_inputs(traffic, seed, WARMUP_CALL, dev))
    log(f"a {traffic['warmup_steps']}-step call")
    setup_s = ctx.setup_seconds()

    outputs = []

    def call(i):
        outputs.append(inpaint(pipe, traffic, call_inputs(traffic, seed, i,
                                                          dev)))

    window_s, calls = window.call_window(call, ctx.seconds, dev)
    metrics = {"view_s": (window_s / calls, "s"), "setup_s": (setup_s, "s")}
    failed = sum(1 for o in outputs if not bool(torch.isfinite(o).all()))
    trace = None
    if ctx.trace:
        def profiled():
            inpaint(pipe, traffic, call_inputs(traffic, seed, calls, dev))
            return 1
        trace = profile(profiled)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    del pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ref = build_reference(cfg, w, dev)
    picked = sampled_calls(seed, calls, traffic["checked_calls"])
    gap = 0.0
    flops = None
    for k, i in enumerate(picked):
        inputs = call_inputs(traffic, seed, i, dev)
        if ctx.trace and k == 0:
            from torch.utils.flop_counter import FlopCounterMode

            with FlopCounterMode(display=False) as counter:
                expect = inpaint(ref, traffic, inputs)
            flops = counter.get_total_flops()
        else:
            expect = inpaint(ref, traffic, inputs)
        gap = max(gap, compare.image_gap(outputs[i], expect))
    layer = {"unit_ms": metrics["view_s"][0] * 1e3,
             "gaps": {"image_gap": gap}}
    if ctx.trace:
        layer["least_ms"] = least_ms(w, flops, traffic["steps"])
    return CellRun(
        attempted=calls, failed=failed, metrics=metrics,
        checks=[("image_gap", gap, traffic["limits"]["image_gap"])],
        memory_peak_bytes=peak, trace=trace, layer=layer)


class _TF32Calls:
    """An object whose method calls run with TF32 on."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            with controls.tf32():
                return attr(*args, **kwargs)
        return call


def CONTROL():
    """The reference in the program's place, computed with TF32 on: the
    nearest precision below the configuration's f32."""
    return controls.patched(
        sys.modules[__name__], "build_program",
        lambda cfg, w, device: _TF32Calls(build_reference(cfg, w, device)))


def _half_batch():
    """The call's batch of two is the [conditioned; unconditioned] pair:
    the conditioned half twice."""
    from youreditableavatar_tpu_torch.guidance.sdxl_pipeline import (
        SDXLControlNetUnionPipeline)

    def cfg_batch(self, cond, uncond, b):
        ctx, pooled = (torch.as_tensor(x, device=self.device) for x in cond)
        return (torch.cat([ctx, ctx]).to(self.dtype),
                torch.cat([pooled, pooled]).to(self.dtype))
    return controls.patched(SDXLControlNetUnionPipeline, "_cfg_batch",
                            cfg_batch)


def _altered_answer():
    """The image altered where it is produced: the decode × 0.999."""
    from youreditableavatar_tpu_torch.guidance.sdxl_pipeline import (
        SDXLControlNetUnionPipeline)

    decode = SDXLControlNetUnionPipeline._decode
    return controls.patched(SDXLControlNetUnionPipeline, "_decode",
                            lambda self, z: decode(self, z) * 0.999)


FAULTS = {"half_batch": _half_batch, "altered_answer": _altered_answer}
