"""ControlNet-Union (SDXL) as functions over a parameter tree.

Counterpart of `youreditableavatar_tpu/guidance/sdxl_controlnet.py`, the
vendored `ControlNetModel_Union` that the texture edit drives with two
control streams at once (normal + masked repaint) and with the tile
control for the refine:

  * a clone of the SDXL UNet's down + mid path (the `sd_unet` layers);
  * a conditioning encoder per control (a stride-2 conv pyramid down to
    the latent resolution);
  * an 8-way control-type embedding added to the time embedding;
  * the union "condition transformer": one mean-pooled token per active
    control (+ the latent sample's), residual attention blocks, and
    per-control channel offsets added back onto the fused sample;
  * zero-initialised 1×1 output convs → additive down / mid residuals.

The fuser attends across the BATCH, as the vendored model does: it feeds
(N, L, C) into `nn.MultiheadAttention(batch_first=False)`, which reads
dim 0 as the sequence. Under CFG the batch is [cond; uncond], so the two
halves' residuals are coupled; the JAX package keeps that and so does
this port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.clip_text import quick_gelu
from youreditableavatar_tpu_torch.guidance.sd_layers import (
    Params,
    conv2d,
    conv_from_torch,
    init_conv,
    init_linear,
    init_norm,
    init_resnet,
    init_spatial_transformer,
    layer_norm,
    linear,
    linear_from_torch,
    norm_from_torch,
    params_from_numpy,
    project_attention,
    resnet_block,
    spatial_transformer,
    t2t,
    timestep_embedding,
)
from youreditableavatar_tpu_torch.guidance.sd_unet import (
    SDXL_UNET,
    TEST_SDXL_UNET,
    UNetConfig,
    _resnet_from_torch,
    _transformer_from_torch,
    apply_unet_mid,
    unet_time_embedding,
)
from youreditableavatar_tpu_torch.utils.profiling import span

NUM_CONTROL_TYPES = 8  # openpose, depth, … normal (4), … per union-promax


@dataclasses.dataclass(frozen=True)
class ControlNetUnionConfig:
    unet: UNetConfig = SDXL_UNET
    cond_channels: int = 3
    cond_embed_chans: Tuple[int, ...] = (16, 32, 96, 256)
    num_control_types: int = NUM_CONTROL_TYPES
    control_time_dim: int = 256
    fuser_layers: int = 6
    fuser_heads: int = 8


SDXL_CONTROLNET_UNION = ControlNetUnionConfig()
TEST_CONTROLNET_UNION = ControlNetUnionConfig(
    unet=TEST_SDXL_UNET, cond_embed_chans=(8, 16), control_time_dim=8,
    fuser_layers=1, fuser_heads=4,
)


def _zero_conv(gen, cin, cout) -> Params:
    return {"w": torch.zeros((1, 1, cin, cout), device=gen.device),
            "b": torch.zeros((cout,), device=gen.device)}


def init_controlnet_union_params(
    gen: torch.Generator, cfg: ControlNetUnionConfig = TEST_CONTROLNET_UNION
) -> Params:
    """Random weights at the JAX init's scales, drawn from `gen` on its
    device; the zero convs, the conditioning encoder's conv_out and the
    task embedding are zero, as in the JAX init."""
    u = cfg.unet
    chans = [u.base * m for m in u.mults]
    p: Params = {
        "conv_in": init_conv(gen, 3, 3, u.in_channels, u.base),
        "time1": init_linear(gen, u.base, u.temb_dim),
        "time2": init_linear(gen, u.temb_dim, u.temb_dim),
        "down": [],
    }
    if u.add_embed:
        p["add1"] = init_linear(gen, u.add_in_dim, u.temb_dim)
        p["add2"] = init_linear(gen, u.temb_dim, u.temb_dim)
    p["ctrl_add1"] = init_linear(
        gen, cfg.num_control_types * cfg.control_time_dim, u.temb_dim)
    p["ctrl_add2"] = init_linear(gen, u.temb_dim, u.temb_dim)

    ce_ch = cfg.cond_embed_chans
    ce: Params = {"conv_in": init_conv(gen, 3, 3, cfg.cond_channels, ce_ch[0]),
                  "blocks": []}
    for i in range(len(ce_ch) - 1):
        ce["blocks"].append({
            "a": init_conv(gen, 3, 3, ce_ch[i], ce_ch[i]),
            "b": init_conv(gen, 3, 3, ce_ch[i], ce_ch[i + 1]),
        })
    # The reference's conv_out is a zero-init 3×3.
    ce["conv_out"] = {"w": torch.zeros((3, 3, ce_ch[-1], u.base),
                                       device=gen.device),
                      "b": torch.zeros((u.base,), device=gen.device)}
    p["cond_embed"] = ce

    p["task_emb"] = torch.zeros((cfg.num_control_types, u.base),
                                device=gen.device)
    p["fuser"] = [
        {
            "ln1": init_norm(gen, u.base),
            "attn": {n: init_linear(gen, u.base, u.base)
                     for n in ("q", "k", "v", "out")},
            "ln2": init_norm(gen, u.base),
            "fc1": init_linear(gen, u.base, 4 * u.base),
            "fc2": init_linear(gen, 4 * u.base, u.base),
        }
        for _ in range(cfg.fuser_layers)
    ]
    p["spatial_proj"] = init_linear(gen, u.base, u.base)

    zero_convs = [_zero_conv(gen, u.base, u.base)]
    cin = u.base
    for lvl, cout in enumerate(chans):
        level: Params = {"resnets": [], "attns": []}
        for _ in range(u.blocks_per_level):
            level["resnets"].append(init_resnet(gen, cin, cout, u.temb_dim))
            if lvl in u.attn_levels:
                level["attns"].append(init_spatial_transformer(
                    gen, cout, u.ctx_dim, u.tf_depth[lvl]))
            cin = cout
            zero_convs.append(_zero_conv(gen, cout, cout))
        if lvl < len(chans) - 1:
            level["down"] = init_conv(gen, 3, 3, cout, cout)
            zero_convs.append(_zero_conv(gen, cout, cout))
        p["down"].append(level)
    p["zero_convs"] = zero_convs

    mid_depth = u.tf_depth[-1] or 1
    p["mid"] = {
        "res1": init_resnet(gen, cin, cin, u.temb_dim),
        "attn": init_spatial_transformer(gen, cin, u.ctx_dim, mid_depth),
        "res2": init_resnet(gen, cin, cin, u.temb_dim),
    }
    p["mid_zero"] = _zero_conv(gen, cin, cin)
    return p


def controlnet_params_from_numpy(tree, device=None) -> Params:
    """The JAX package's ControlNet-Union tree, as numpy → tensors."""
    return params_from_numpy(tree, device)


def _cond_embed(p: Params, img: Tensor) -> Tensor:
    """Control image (B, H, W, 3) → (B, H/8, W/8, base)."""
    h = F.silu(conv2d(img, p["conv_in"]))
    for blk in p["blocks"]:
        h = F.silu(conv2d(h, blk["a"]))
        h = F.silu(conv2d(h, blk["b"], stride=2, padding=((1, 1), (1, 1))))
    return conv2d(h, p["conv_out"])


def _fuser_block(x: Tensor, p: Params, heads: int) -> Tensor:
    """Pre-LN residual attention block (CLIP-style, as the union fuser)."""
    h = layer_norm(x, p["ln1"])
    x = x + project_attention(h, h, h, p["attn"], heads)
    h = layer_norm(x, p["ln2"])
    return x + linear(quick_gelu(linear(h, p["fc1"])), p["fc2"])


def apply_controlnet_union(
    params: Params,
    z: Tensor,
    t: Tensor,
    ctx: Tensor,
    controls: Sequence[Tuple[int, Tensor]],
    cfg: ControlNetUnionConfig = TEST_CONTROLNET_UNION,
    add_cond=None,
    conditioning_scale: float = 1.0,
) -> Tuple[List[Tensor], Tensor]:
    """Control residuals for the UNet.

    Args:
      z: (B, h, w, C) noisy latents; t: (B,) timesteps; ctx: text context.
      controls: (control type index, image (B, H, W, 3)) pairs; the
        texture stage passes [(NORMAL, normal map), (REPAINT, repaint)].
    Returns (down residuals, mid residual), scaled by conditioning_scale,
    for `apply_unet(..., control_residuals=...)`.
    """
    with span("controlnet"):
        u = cfg.unet
        temb = unet_time_embedding(params, t, u, add_cond)

        # Control-type embedding: a one-hot over the active types →
        # sinusoids.
        b = z.shape[0]
        type_vec = torch.zeros((cfg.num_control_types,), device=z.device)
        for idx, _ in controls:
            type_vec[idx] = 1.0
        tid = timestep_embedding(type_vec, cfg.control_time_dim).reshape(
            1, cfg.num_control_types * cfg.control_time_dim).expand(b, -1)
        temb = temb + linear(F.silu(linear(tid, params["ctrl_add1"])),
                             params["ctrl_add2"])

        # Sample + condition fusing (the union "condition transformer").
        sample = conv2d(z, params["conv_in"])
        cond_feats, tokens = [], []
        for idx, img in controls:
            feat = _cond_embed(params["cond_embed"], img)
            cond_feats.append(feat)
            tokens.append(feat.mean(dim=(1, 2)) + params["task_emb"][idx])
        tokens.append(sample.mean(dim=(1, 2)))
        # (B, L, C) → (L, B, C): attention runs over the batch for each token
        # slot, as batch_first=False does in the vendored model.
        x = torch.stack(tokens, dim=1).transpose(0, 1)
        for blk in params["fuser"]:
            x = _fuser_block(x, blk, cfg.fuser_heads)
        x = x.transpose(0, 1)
        fused = torch.zeros_like(sample)
        for i, feat in enumerate(cond_feats):
            alpha = linear(x[:, i], params["spatial_proj"])
            fused = fused + feat + alpha[:, None, None, :]
        h = sample + fused

        # The down + mid clone, tapped by the zero convs.
        chans = [u.base * m for m in u.mults]
        taps = [h]
        for lvl, level in enumerate(params["down"]):
            for j, res in enumerate(level["resnets"]):
                h = resnet_block(h, temb, res, u.groups)
                if level["attns"]:
                    h = spatial_transformer(h, ctx, level["attns"][j],
                                            u.heads(chans[lvl]), u.groups)
                taps.append(h)
            if "down" in level:
                # diffusers' Downsample2D pads (1, 1), not "SAME".
                h = conv2d(h, level["down"], stride=2,
                           padding=((1, 1), (1, 1)))
                taps.append(h)
        h = apply_unet_mid(params, h, temb, ctx, u)

        down_res = [conv2d(tap, zc) * conditioning_scale
                    for tap, zc in zip(taps, params["zero_convs"])]
        mid_res = conv2d(h, params["mid_zero"]) * conditioning_scale
        return down_res, mid_res


# ------------------------------------------------------- torch conversion


def convert_torch_controlnet_union(sd: Dict[str, Any]) -> Params:
    """Vendored `ControlNetModel_Union.state_dict()` → parameter tree (on
    the CPU)."""
    p: Params = {
        "conv_in": conv_from_torch(sd, "conv_in"),
        "time1": linear_from_torch(sd, "time_embedding.linear_1"),
        "time2": linear_from_torch(sd, "time_embedding.linear_2"),
        "ctrl_add1": linear_from_torch(sd, "control_add_embedding.linear_1"),
        "ctrl_add2": linear_from_torch(sd, "control_add_embedding.linear_2"),
        "task_emb": t2t(sd["task_embedding"]),
        "spatial_proj": linear_from_torch(sd, "spatial_ch_projs"),
        "down": [],
    }
    if "add_embedding.linear_1.weight" in sd:
        p["add1"] = linear_from_torch(sd, "add_embedding.linear_1")
        p["add2"] = linear_from_torch(sd, "add_embedding.linear_2")

    ce: Params = {
        "conv_in": conv_from_torch(sd, "controlnet_cond_embedding.conv_in"),
        "blocks": [],
        "conv_out": conv_from_torch(sd, "controlnet_cond_embedding.conv_out"),
    }
    i = 0
    while f"controlnet_cond_embedding.blocks.{2 * i}.weight" in sd:
        ce["blocks"].append({
            "a": conv_from_torch(sd, f"controlnet_cond_embedding.blocks.{2 * i}"),
            "b": conv_from_torch(
                sd, f"controlnet_cond_embedding.blocks.{2 * i + 1}"),
        })
        i += 1
    p["cond_embed"] = ce

    # The fuser: CLIP-style residual attention blocks with a packed in_proj
    # (the official checkpoint spells them `transformer_layes`).
    fuser = []
    i = 0
    while f"transformer_layes.{i}.ln_1.weight" in sd:
        pre = f"transformer_layes.{i}"
        wqkv = t2t(sd[pre + ".attn.in_proj_weight"])
        bqkv = t2t(sd[pre + ".attn.in_proj_bias"])
        d = wqkv.shape[0] // 3
        fuser.append({
            "ln1": norm_from_torch(sd, pre + ".ln_1"),
            "attn": {
                **{n: {"w": wqkv[j * d:(j + 1) * d].t().contiguous(),
                       "b": bqkv[j * d:(j + 1) * d].clone()}
                   for j, n in enumerate(("q", "k", "v"))},
                "out": linear_from_torch(sd, pre + ".attn.out_proj"),
            },
            "ln2": norm_from_torch(sd, pre + ".ln_2"),
            "fc1": linear_from_torch(sd, pre + ".mlp.c_fc"),
            "fc2": linear_from_torch(sd, pre + ".mlp.c_proj"),
        })
        i += 1
    p["fuser"] = fuser

    i = 0
    while f"down_blocks.{i}.resnets.0.norm1.weight" in sd:
        level: Params = {"resnets": [], "attns": []}
        j = 0
        while f"down_blocks.{i}.resnets.{j}.norm1.weight" in sd:
            level["resnets"].append(
                _resnet_from_torch(sd, f"down_blocks.{i}.resnets.{j}"))
            if f"down_blocks.{i}.attentions.{j}.norm.weight" in sd:
                level["attns"].append(_transformer_from_torch(
                    sd, f"down_blocks.{i}.attentions.{j}"))
            j += 1
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            level["down"] = conv_from_torch(
                sd, f"down_blocks.{i}.downsamplers.0.conv")
        p["down"].append(level)
        i += 1

    p["zero_convs"] = []
    i = 0
    while f"controlnet_down_blocks.{i}.weight" in sd:
        p["zero_convs"].append(
            conv_from_torch(sd, f"controlnet_down_blocks.{i}"))
        i += 1
    p["mid"] = {
        "res1": _resnet_from_torch(sd, "mid_block.resnets.0"),
        "attn": _transformer_from_torch(sd, "mid_block.attentions.0"),
        "res2": _resnet_from_torch(sd, "mid_block.resnets.1"),
    }
    p["mid_zero"] = conv_from_torch(sd, "controlnet_mid_block")
    return p
