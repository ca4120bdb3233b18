"""Stable-Diffusion VAE (AutoencoderKL) as functions over a parameter tree.

Counterpart of `youreditableavatar_tpu/guidance/sd_vae.py`: a conv
encoder with (128, 256, 512, 512) levels, a self-attention mid block,
8-channel moments and 1×1 quant convs; the scaling factor (0.18215 for
SD1.5, 0.13025 for SDXL) is applied by the caller. `VAEConfig` scales
down for the tests. `convert_torch_vae` maps a diffusers `AutoencoderKL`
state dict onto the tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.sd_layers import (
    Params,
    conv2d,
    conv_from_torch,
    group_norm,
    init_conv,
    init_norm,
    init_resnet,
    init_self_attention_2d,
    linear_from_torch,
    norm_from_torch,
    params_from_numpy,
    resnet_block,
    self_attention_2d,
)
from youreditableavatar_tpu_torch.guidance.sd_unet import (
    _resnet_from_torch,
    upsample_nearest2x,
)
from youreditableavatar_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    latent_channels: int = 4
    chans: Tuple[int, ...] = (128, 256, 512, 512)
    blocks_per_level: int = 2
    groups: int = 32
    scaling_factor: float = 0.18215

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.chans) - 1)


SD_VAE = VAEConfig()
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
TEST_VAE = VAEConfig(chans=(16, 32), blocks_per_level=1, groups=8)


def init_vae_params(gen: torch.Generator, cfg: VAEConfig = TEST_VAE) -> Params:
    """Random weights at the JAX init's scales, drawn from `gen` on its
    device."""
    c0, cl = cfg.chans[0], cfg.chans[-1]
    enc: Params = {"conv_in": init_conv(gen, 3, 3, cfg.in_channels, c0),
                   "down": []}
    cin = c0
    for lvl, cout in enumerate(cfg.chans):
        level: Params = {"resnets": []}
        for _ in range(cfg.blocks_per_level):
            level["resnets"].append(init_resnet(gen, cin, cout, None))
            cin = cout
        if lvl < len(cfg.chans) - 1:
            level["down"] = init_conv(gen, 3, 3, cout, cout)
        enc["down"].append(level)
    enc["mid"] = {
        "res1": init_resnet(gen, cl, cl, None),
        "attn": init_self_attention_2d(gen, cl),
        "res2": init_resnet(gen, cl, cl, None),
    }
    enc["norm_out"] = init_norm(gen, cl)
    enc["conv_out"] = init_conv(gen, 3, 3, cl, 2 * cfg.latent_channels)

    dec: Params = {
        "conv_in": init_conv(gen, 3, 3, cfg.latent_channels, cl),
        "mid": {
            "res1": init_resnet(gen, cl, cl, None),
            "attn": init_self_attention_2d(gen, cl),
            "res2": init_resnet(gen, cl, cl, None),
        },
        "up": [],
    }
    cin = cl
    for lvl, cout in enumerate(reversed(cfg.chans)):
        level = {"resnets": []}
        for _ in range(cfg.blocks_per_level + 1):
            level["resnets"].append(init_resnet(gen, cin, cout, None))
            cin = cout
        if lvl < len(cfg.chans) - 1:
            level["up"] = init_conv(gen, 3, 3, cout, cout)
        dec["up"].append(level)
    dec["norm_out"] = init_norm(gen, cfg.chans[0])
    dec["conv_out"] = init_conv(gen, 3, 3, cfg.chans[0], cfg.in_channels)

    return {
        "encoder": enc,
        "decoder": dec,
        "quant": init_conv(gen, 1, 1, 2 * cfg.latent_channels,
                           2 * cfg.latent_channels),
        "post_quant": init_conv(gen, 1, 1, cfg.latent_channels,
                                cfg.latent_channels),
    }


def vae_params_from_numpy(tree, device=None) -> Params:
    """The JAX package's VAE tree, as numpy → tensors."""
    return params_from_numpy(tree, device)


def vae_encode_moments(params: Params, images: Tensor,
                       cfg: VAEConfig = TEST_VAE) -> Tuple[Tensor, Tensor]:
    """(B, H, W, 3) in [-1, 1] → (mean, logvar), each (B, H/8, W/8, C).

    The stride-2 downsample pads (0, 1) on each spatial axis, as diffusers'
    `Downsample2D(padding=0)` does.
    """
    enc = params["encoder"]
    h = conv2d(images, enc["conv_in"])
    for level in enc["down"]:
        for res in level["resnets"]:
            h = resnet_block(h, None, res, cfg.groups, eps=1e-6)
        if "down" in level:
            h = conv2d(h, level["down"], stride=2,
                       padding=((0, 1), (0, 1)))
    h = resnet_block(h, None, enc["mid"]["res1"], cfg.groups, eps=1e-6)
    h = self_attention_2d(h, enc["mid"]["attn"], cfg.groups, eps=1e-6)
    h = resnet_block(h, None, enc["mid"]["res2"], cfg.groups, eps=1e-6)
    h = F.silu(group_norm(h, enc["norm_out"], cfg.groups, eps=1e-6))
    h = conv2d(conv2d(h, enc["conv_out"]), params["quant"])
    mean, logvar = h.chunk(2, dim=-1)
    return mean, torch.clamp(logvar, -30.0, 20.0)


def vae_encode(params: Params, images: Tensor,
               generator: Optional[torch.Generator] = None,
               cfg: VAEConfig = TEST_VAE,
               noise: Optional[Tensor] = None) -> Tensor:
    """A posterior sample mean + std·ε (UNSCALED latents; the caller applies
    cfg.scaling_factor). ε is `noise` when given, else drawn from
    `generator`."""
    with span("vae_encode"):
        mean, logvar = vae_encode_moments(params, images, cfg)
        if noise is None:
            noise = randn_like_on(mean, generator)
        return mean + torch.exp(0.5 * logvar) * noise.to(mean.device,
                                                         mean.dtype)


def randn_like_on(x: Tensor, generator: Optional[torch.Generator]) -> Tensor:
    """N(0, 1) of x's shape, drawn on the generator's device (or x's, with
    the default generator), placed on x's device."""
    where = generator.device if generator is not None else x.device
    return torch.randn(tuple(x.shape), generator=generator, device=where,
                       dtype=torch.float32).to(x.device, x.dtype)


def vae_decode(params: Params, latents: Tensor,
               cfg: VAEConfig = TEST_VAE) -> Tensor:
    """UNSCALED (B, h, w, C) latents → (B, H, W, 3) in [-1, 1]."""
    with span("vae_decode"):
        dec = params["decoder"]
        h = conv2d(conv2d(latents, params["post_quant"]), dec["conv_in"])
        h = resnet_block(h, None, dec["mid"]["res1"], cfg.groups, eps=1e-6)
        h = self_attention_2d(h, dec["mid"]["attn"], cfg.groups, eps=1e-6)
        h = resnet_block(h, None, dec["mid"]["res2"], cfg.groups, eps=1e-6)
        for level in dec["up"]:
            for res in level["resnets"]:
                h = resnet_block(h, None, res, cfg.groups, eps=1e-6)
            if "up" in level:
                h = conv2d(upsample_nearest2x(h), level["up"])
        h = F.silu(group_norm(h, dec["norm_out"], cfg.groups, eps=1e-6))
        return conv2d(h, dec["conv_out"])


# ------------------------------------------------------- torch conversion


def _attn_from_torch(sd, pre) -> Params:
    # diffusers >= 0.18 names: group_norm / to_q/to_k/to_v/to_out.0;
    # older VAEs: norm / query / key / value / proj_attn.
    if pre + ".group_norm.weight" in sd:
        return {
            "norm": norm_from_torch(sd, pre + ".group_norm"),
            "q": linear_from_torch(sd, pre + ".to_q"),
            "k": linear_from_torch(sd, pre + ".to_k"),
            "v": linear_from_torch(sd, pre + ".to_v"),
            "out": linear_from_torch(sd, pre + ".to_out.0"),
        }
    return {
        "norm": norm_from_torch(sd, pre + ".norm"),
        "q": linear_from_torch(sd, pre + ".query"),
        "k": linear_from_torch(sd, pre + ".key"),
        "v": linear_from_torch(sd, pre + ".value"),
        "out": linear_from_torch(sd, pre + ".proj_attn"),
    }


def _levels_from_torch(sd, pre, sampler, key) -> list:
    """The encoder's down / the decoder's up levels: resnets, and the
    `{sampler}s.0.conv` resampler (stored under `key`) where present."""
    levels = []
    i = 0
    while f"{pre}.{i}.resnets.0.norm1.weight" in sd:
        level: Params = {"resnets": []}
        j = 0
        while f"{pre}.{i}.resnets.{j}.norm1.weight" in sd:
            level["resnets"].append(
                _resnet_from_torch(sd, f"{pre}.{i}.resnets.{j}"))
            j += 1
        conv = f"{pre}.{i}.{sampler}s.0.conv"
        if conv + ".weight" in sd:
            level[key] = conv_from_torch(sd, conv)
        levels.append(level)
        i += 1
    return levels


def _mid_from_torch(sd, pre) -> Params:
    return {"res1": _resnet_from_torch(sd, pre + ".resnets.0"),
            "attn": _attn_from_torch(sd, pre + ".attentions.0"),
            "res2": _resnet_from_torch(sd, pre + ".resnets.1")}


def convert_torch_vae(sd: Dict[str, Any],
                      cfg: VAEConfig = SD_VAE) -> Params:
    """diffusers `AutoencoderKL.state_dict()` → parameter tree (on the
    CPU)."""
    enc: Params = {
        "conv_in": conv_from_torch(sd, "encoder.conv_in"),
        "down": _levels_from_torch(sd, "encoder.down_blocks", "downsampler",
                                  "down"),
        "mid": _mid_from_torch(sd, "encoder.mid_block"),
        "norm_out": norm_from_torch(sd, "encoder.conv_norm_out"),
        "conv_out": conv_from_torch(sd, "encoder.conv_out"),
    }
    dec: Params = {
        "conv_in": conv_from_torch(sd, "decoder.conv_in"),
        "mid": _mid_from_torch(sd, "decoder.mid_block"),
        "up": _levels_from_torch(sd, "decoder.up_blocks", "upsampler", "up"),
        "norm_out": norm_from_torch(sd, "decoder.conv_norm_out"),
        "conv_out": conv_from_torch(sd, "decoder.conv_out"),
    }
    return {
        "encoder": enc,
        "decoder": dec,
        "quant": conv_from_torch(sd, "quant_conv"),
        "post_quant": conv_from_torch(sd, "post_quant_conv"),
    }
