"""SD1.5 in fp16 on the port's normal path, on the CPU at the TEST widths.

`make_guidance_backend(..., half_precision_weights=True)` holds the UNet,
the VAE and the CLIP text encoder in fp16 (the default stays f32), through
the factory's `sd15_backend`. `HumanEditTrainer` on that prior and prompt
encoder (the fp16 cell's `build_program`, which calls `sd15_backend` too,
on the factory's draws) is held against the plain reference
(`benchmark/reference/`, no port, no JAX) computing in f32 on the same
fp16-rounded weights widened to f32: the first three losses, the first
gradient of every leaf of more than one entry, and the first step's
classifier-free ε̂ on the program's own z_t. The same reference with its networks in bf16, the nearest precision
below fp16, falls outside at least one of those tolerances. An input that
overflows fp16 is counted by `sds.nonfinite` before `nan_to_num` zeroes it.
The spatial stage runs the networks in fp16 unless its config says not to.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.core import compare, training
from benchmark.entries import sds_edit, sds_edit_fp16
from benchmark.tests import tiny
from youreditableavatar_tpu_torch.guidance.factory import make_guidance_backend
from youreditableavatar_tpu_torch.guidance.sd_layers import (
    tree_leaves, tree_to)
from youreditableavatar_tpu_torch.guidance.sds import SDSConfig, SDSGuidance
from youreditableavatar_tpu_torch.utils import profiling

SEED = 5
# Tolerances, each relative to the reference's own size, with the
# readings at these widths over seeds 5–10 (program / bf16 reference).
# ε̂ = ε_u + 50·(ε_c − ε_u): the guidance scale multiplies the fp16
# rounding of the two predictions (unit roundoff 2^-11 ≈ 4.9e-4, over the
# UNet's rounded layers) against ε̂'s own size; read 2.1e-3–5.8e-3, bf16
# (2^-8) 2.0e-2–4.9e-2 (both sides on the program's own embeddings).
EPS_TOL = 1.5e-2
# The losses: the SDS term ½‖w·(ε̂ − ε)‖² takes about twice ε̂'s relative
# error where ε̂ − ε is large, the f32 geometry terms none, and the fp16
# text encoder's rounding of the embeddings enters ε_c − ε_u, which the
# guidance scale multiplies too (the bf16 reference's encoder is f32):
# read 2.4e-4–1.5e-3 (seed 5: 4.9e-4), bf16 1.8e-3–1.5e-2.
LOSS_TOL = 1e-3
# The first gradient: the fp16 VAE encoder's input gradient enters the f32
# normal map beside the recon and normal-consistency terms' f32 gradients,
# which carry most of it here; read 1.9e-7–1.4e-4, bf16 2.2e-6–1.1e-3, so
# it bounds the program without separating the two precisions.
GRAD_TOL = 1e-3


def _case(tmp_path):
    """The program's trainer on the factory's fp16 draws, and the weights
    the reference takes (those draws, widened to f32)."""
    cfg = tiny.sds_config()
    prior, enc = make_guidance_backend("sd15-random", seed=SEED, device="cpu",
                                       half_precision_weights=True)
    w = sds_edit.make_weights(cfg, SEED, "cpu")
    w.update(unet=tree_to(prior.unet_params, "cpu"),
             vae=tree_to(prior.vae_params, "cpu"),
             clip=tree_to(enc.params, "cpu"))
    trainer = sds_edit_fp16.build_program(cfg, w, SEED, "cpu", str(tmp_path))
    assert trainer.guidance.prior.dtype == torch.float16
    assert trainer.prompts_local.cond.dtype == np.float16
    return cfg, w, trainer


def _gaps(cfg, w, side, ref):
    """`side`'s readings (the program's, or a reference's in its place)
    against the f32 reference's, and its first ε̂ against the f32
    reference's on `side`'s own z_t."""
    out = training.gaps(side, ref)
    f32 = sds_edit.build_reference(cfg, w, SEED, "cpu").guidance.prior
    want = sds_edit_fp16.eps_hat(cfg, f32.predict_noise(*side["unet_in"]))
    out["eps_gap"] = float((side["eps_hat"] - want).abs().max()
                           / want.abs().max())
    return out


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    cfg, w, trainer = _case(tmp_path_factory.mktemp("text"))
    prog = sds_edit_fp16.program_readings(cfg, trainer, SEED)

    def reference(dtype):
        return sds_edit_fp16.program_readings(
            cfg, sds_edit_fp16._ReferenceTrainer(sds_edit_fp16.build_reference(
                cfg, w, SEED, "cpu", dtype)), SEED)

    ref = reference(torch.float32)
    return (prog, _gaps(cfg, w, prog, ref),
            _gaps(cfg, w, reference(torch.bfloat16), ref))


def test_the_prior_is_f32_unless_half_precision_weights():
    f32, enc = make_guidance_backend("sd15-random", device="cpu")
    half, enc_h = make_guidance_backend("sd15-random", device="cpu",
                                        half_precision_weights=True)
    assert f32.dtype == torch.float32
    assert {x.dtype for x in tree_leaves(f32.unet_params)
            + tree_leaves(f32.vae_params)} == {torch.float32}
    assert half.dtype == torch.float16
    assert {x.dtype for x in tree_leaves(half.unet_params)
            + tree_leaves(half.vae_params)} == {torch.float16}
    assert {x.dtype for x in tree_leaves(enc.params)} == {torch.float32}
    assert {x.dtype for x in tree_leaves(enc_h.params)} == {torch.float16}
    assert enc_h.encode(["a red jacket"]).dtype == torch.float16
    # The weights are the f32 draws, rounded.
    for a, b in zip(tree_leaves(f32.unet_params) + tree_leaves(enc.params),
                    tree_leaves(half.unet_params) + tree_leaves(enc_h.params)):
        assert torch.equal(a.to(torch.float16), b)


def test_the_fp16_edit_step_matches_the_f32_reference(readings):
    prog, gaps, _ = readings
    assert prog["counts"]["sds.nonfinite"] == 0
    # Every convolution of the fp16 networks took the half path: the VAE
    # encoder's forward and input gradient, the UNet's forward.
    assert prog["counts"]["sd.conv.half.forward"] > \
        prog["counts"]["sd.conv.half.input_grad"] > 0
    assert gaps["loss_gap"] <= LOSS_TOL, gaps
    assert gaps["grad_nonscalar_gap"] <= GRAD_TOL, gaps
    assert gaps["eps_gap"] <= EPS_TOL, gaps
    assert all(g > 0 for g in prog["grad"])
    assert compare.moved_leaves(prog["grad"])


def test_the_bf16_reference_fails_a_tolerance(readings):
    _, _, bf16 = readings
    assert (bf16["loss_gap"] > LOSS_TOL or bf16["eps_gap"] > EPS_TOL
            or bf16["grad_nonscalar_gap"] > GRAD_TOL), bf16


def test_an_fp16_overflow_is_counted():
    prior, _ = make_guidance_backend("sd15-random", device="cpu",
                                     half_precision_weights=True)
    guidance = SDSGuidance(prior, SDSConfig(guidance_scale=7.5))
    d = prior.latent_downscale
    gen = torch.Generator().manual_seed(2)
    images = torch.rand((1, 32, 32, 3), generator=gen)
    ctx = torch.randn((1, 16, 32), generator=gen)
    shape = (1, 32 // d, 32 // d, prior.latent_channels)
    t = torch.tensor([500])

    def loss(noise):
        with profiling.counting() as counted:
            out = guidance(images, ctx, ctx * 0.5, None, 20, 980, t=t,
                           noise=noise)
        return out, int(counted["sds.nonfinite"])

    noise = torch.randn(shape, generator=gen)
    assert loss(noise)[1] == 0
    # z_t = √ᾱ·z + √(1 − ᾱ)·ε with ε at 1e6 lies past fp16's 65,504.
    out, nonfinite = loss(noise * 1e6)
    assert nonfinite == noise.numel()
    assert bool(torch.isfinite(out["loss_sds"]))  # nan_to_num's doing
    # Outside a counting() block nothing is counted, and nothing raises.
    guidance(images, ctx, ctx * 0.5, None, 20, 980, t=t, noise=noise * 1e6)


@pytest.mark.parametrize("guidance, half", [
    ({}, True), ({"half_precision_weights": False}, False),
    ({"half_precision_weights": True}, True)])
def test_the_spatial_stage_takes_threestudios_default(guidance, half,
                                                      monkeypatch, tmp_path):
    """The spatial stage reads `system.guidance.half_precision_weights`,
    fp16 when the config leaves it unset, as threestudio's guidance does
    (the reference's configs/geometry-edit.yaml leaves it unset)."""
    from youreditableavatar_tpu_torch.cli import pipeline
    from youreditableavatar_tpu_torch.guidance import factory

    asked = []

    class Built(Exception):
        pass

    def backend(*args, **kw):
        asked.append(kw["half_precision_weights"])
        raise Built

    monkeypatch.setattr(factory, "make_guidance_backend", backend)
    verts, faces, _, _ = pipeline.synthetic_body(10, device="cpu")
    scale = dataclasses.replace(pipeline.PipelineScale.tiny(), sdf_iters=2,
                                normal_iters=1)
    with pytest.raises(Built):
        pipeline.run_spatial_stage(
            str(tmp_path), verts, faces, "a red jacket", scale,
            editing_region_info={
                "editing_mask_faces": np.ones(len(faces), np.float32)},
            guidance_backend="sd15-random",
            system_cfg={"guidance": guidance}, device="cpu")
    assert asked == [half]
