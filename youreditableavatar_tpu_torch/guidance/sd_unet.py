"""SD1.5-family conditional UNet as functions over a parameter tree.

Counterpart of `youreditableavatar_tpu/guidance/sd_unet.py`: the 4-channel
latent UNet (base width 320, mults (1, 2, 4, 4), two ResNet blocks per
level, cross-attention on the first three levels and the mid block, a
sinusoid → MLP time embedding), with SDXL's text-time addition embedding
and ControlNet residuals. `UNetConfig` scales every dimension, so the
tests run a tiny copy of the same code path.

`convert_torch_unet` maps a diffusers `UNet2DConditionModel` state dict
onto the tree; no weights ship with the repository — `load_unet_params`
reads a checkpoint file the user supplies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.sd_layers import (
    Params,
    conv2d,
    conv_from_torch,
    group_norm,
    init_conv,
    init_linear,
    init_norm,
    init_resnet,
    init_spatial_transformer,
    linear,
    linear_from_torch,
    norm_from_torch,
    params_from_numpy,
    resnet_block,
    spatial_transformer,
    t2t,
    timestep_embedding,
)
from youreditableavatar_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    base: int = 320
    mults: Tuple[int, ...] = (1, 2, 4, 4)
    blocks_per_level: int = 2
    ctx_dim: int = 768
    head_dim: int = 40  # SD1.5: 8 heads at 320 → d_head 40
    fixed_heads: "int | None" = 8  # SD1.5 legacy num-heads; SDXL: None
    groups: int = 32
    # levels with cross-attention (SD1.5: all but the deepest)
    attn_levels: Tuple[int, ...] = (0, 1, 2)
    # transformer blocks per attention (SDXL: (0, 2, 10); SD1.5: 1 each)
    tf_depth: Tuple[int, ...] = (1, 1, 1, 1)
    # SDXL "text_time" addition embedding: pooled text embeds + 6 micro-
    # conditioning time_ids, sinusoid-projected and MLP'd into the time emb.
    add_embed: bool = False
    pooled_dim: int = 1280
    num_time_ids: int = 6
    add_time_dim: int = 256

    @property
    def temb_dim(self) -> int:
        return self.base * 4

    @property
    def add_in_dim(self) -> int:
        return self.pooled_dim + self.num_time_ids * self.add_time_dim

    def heads(self, ch: int) -> int:
        # SD1.5's attention_head_dim=8 is the legacy head count (8 heads at
        # every width); SDXL uses a true per-head width of 64.
        if self.fixed_heads is not None:
            return self.fixed_heads
        return max(ch // self.head_dim, 1)


SD15_UNET = UNetConfig()
SDXL_UNET = UNetConfig(
    mults=(1, 2, 4), attn_levels=(1, 2), tf_depth=(0, 2, 10),
    ctx_dim=2048, head_dim=64, add_embed=True, fixed_heads=None,
)
# ctx_dim matches TEST_CLIP.dim so the random-init SD1.5 + CLIP pair wires
# end to end without a projection (guidance/factory.py "sd15-random").
TEST_UNET = UNetConfig(base=32, mults=(1, 2), blocks_per_level=1,
                       ctx_dim=32, head_dim=16, groups=8, attn_levels=(0,),
                       fixed_heads=None)
TEST_SDXL_UNET = UNetConfig(
    base=32, mults=(1, 2), blocks_per_level=1, ctx_dim=32, head_dim=16,
    groups=8, attn_levels=(1,), tf_depth=(0, 2), add_embed=True,
    pooled_dim=32, add_time_dim=8, fixed_heads=None,
)


def init_unet_params(gen: torch.Generator,
                     cfg: UNetConfig = TEST_UNET) -> Params:
    """Random weights at the JAX init's scales, drawn from `gen` on its
    device."""
    chans = [cfg.base * m for m in cfg.mults]
    p: Params = {
        "conv_in": init_conv(gen, 3, 3, cfg.in_channels, cfg.base),
        "time1": init_linear(gen, cfg.base, cfg.temb_dim),
        "time2": init_linear(gen, cfg.temb_dim, cfg.temb_dim),
        "down": [], "up": [],
    }
    if cfg.add_embed:
        p["add1"] = init_linear(gen, cfg.add_in_dim, cfg.temb_dim)
        p["add2"] = init_linear(gen, cfg.temb_dim, cfg.temb_dim)
    skip_ch = [cfg.base]
    cin = cfg.base
    for lvl, cout in enumerate(chans):
        level: Params = {"resnets": [], "attns": []}
        for _ in range(cfg.blocks_per_level):
            level["resnets"].append(init_resnet(gen, cin, cout, cfg.temb_dim))
            if lvl in cfg.attn_levels:
                level["attns"].append(init_spatial_transformer(
                    gen, cout, cfg.ctx_dim, cfg.tf_depth[lvl]))
            cin = cout
            skip_ch.append(cout)
        if lvl < len(chans) - 1:
            level["down"] = init_conv(gen, 3, 3, cout, cout)
            skip_ch.append(cout)
        p["down"].append(level)

    mid_depth = cfg.tf_depth[-1] or 1  # SDXL's mid shares the deepest depth
    p["mid"] = {
        "res1": init_resnet(gen, cin, cin, cfg.temb_dim),
        "attn": init_spatial_transformer(gen, cin, cfg.ctx_dim, mid_depth),
        "res2": init_resnet(gen, cin, cin, cfg.temb_dim),
    }

    for lvl in reversed(range(len(chans))):
        cout = chans[lvl]
        level = {"resnets": [], "attns": []}
        for _ in range(cfg.blocks_per_level + 1):
            level["resnets"].append(
                init_resnet(gen, cin + skip_ch.pop(), cout, cfg.temb_dim))
            if lvl in cfg.attn_levels:
                level["attns"].append(init_spatial_transformer(
                    gen, cout, cfg.ctx_dim, cfg.tf_depth[lvl]))
            cin = cout
        if lvl > 0:
            level["up"] = init_conv(gen, 3, 3, cout, cout)
        p["up"].append(level)

    p["norm_out"] = init_norm(gen, cfg.base)
    p["conv_out"] = init_conv(gen, 3, 3, cfg.base, cfg.out_channels)
    return p


def unet_params_from_numpy(tree, device=None) -> Params:
    """The JAX package's UNet (or ControlNet) tree, as numpy → tensors."""
    return params_from_numpy(tree, device)


def unet_time_embedding(params: Params, t: Tensor, cfg: UNetConfig,
                        add_cond=None) -> Tensor:
    """Time (+ SDXL text-time addition) embedding, shared with ControlNet.
    SiLU sits between linear_1 and linear_2 only; the resnets apply it
    again at use."""
    pdt = params["time1"]["w"].dtype
    temb = timestep_embedding(t, cfg.base).to(pdt)
    temb = linear(F.silu(linear(temb, params["time1"])), params["time2"])
    if cfg.add_embed:
        pooled, time_ids = add_cond
        b = pooled.shape[0]
        tid = timestep_embedding(
            time_ids.reshape(-1), cfg.add_time_dim
        ).reshape(b, cfg.num_time_ids * cfg.add_time_dim).to(pdt)
        add = torch.cat([pooled.to(pdt), tid], dim=-1)
        temb = temb + linear(F.silu(linear(add, params["add1"])),
                             params["add2"])
    return temb


def apply_unet(params: Params, z: Tensor, t: Tensor, ctx: Tensor,
               cfg: UNetConfig = TEST_UNET, add_cond=None,
               control_residuals=None) -> Tensor:
    """ε̂(z_t, t, ctx): (B, h, w, C) latents → (B, h, w, C) noise prediction.

    add_cond: (pooled text (B, Dp), time_ids (B, 6)) for SDXL configs.
    control_residuals: optional (down list, mid) additive skip residuals
    from a ControlNet (diffusers' `down_block_additional_residuals` /
    `mid_block_additional_residual`).

    Composed of the stage functions below, as in the JAX package.
    """
    with span("unet"):
        h, skips, temb = apply_unet_down(params, z, t, ctx, cfg, add_cond)
        if control_residuals is not None:
            down_res, mid_res = control_residuals
            skips = [s + r for s, r in zip(skips, down_res)]
        h = apply_unet_mid(params, h, temb, ctx, cfg)
        if control_residuals is not None and mid_res is not None:
            h = h + mid_res
        for i in range(len(params["up"])):
            k = len(params["up"][i]["resnets"])
            h = apply_unet_up_level(params, i, h, tuple(skips[-k:]), temb,
                                    ctx, cfg)
            del skips[-k:]
        return apply_unet_out(params, h, cfg)


def apply_unet_down(params, z, t, ctx, cfg, add_cond=None):
    """conv_in + the down path: (h, skip list, time embedding)."""
    h, temb = apply_unet_conv_in(params, z, t, cfg, add_cond)
    skips = [h]
    for lvl in range(len(params["down"])):
        h, lvl_skips = apply_unet_down_level(params, lvl, h, temb, ctx, cfg)
        skips.extend(lvl_skips)
    return h, skips, temb


def apply_unet_conv_in(params, z, t, cfg, add_cond=None):
    """The time embedding and conv_in."""
    temb = unet_time_embedding(params, t, cfg, add_cond)
    return conv2d(z, params["conv_in"]), temb


def apply_unet_down_level(params, lvl, h, temb, ctx, cfg):
    """One down level: (h, the skips this level emits)."""
    chans = [cfg.base * m for m in cfg.mults]
    level = params["down"][lvl]
    skips = []
    for j, res in enumerate(level["resnets"]):
        h = resnet_block(h, temb, res, cfg.groups)
        if level["attns"]:
            h = spatial_transformer(h, ctx, level["attns"][j],
                                    cfg.heads(chans[lvl]), cfg.groups)
        skips.append(h)
    if "down" in level:
        # diffusers' Downsample2D pads 1 on both sides (not "SAME").
        h = conv2d(h, level["down"], stride=2, padding=((1, 1), (1, 1)))
        skips.append(h)
    return h, skips


def apply_unet_mid(params, h, temb, ctx, cfg):
    chans = [cfg.base * m for m in cfg.mults]
    mid = params["mid"]
    h = resnet_block(h, temb, mid["res1"], cfg.groups)
    h = spatial_transformer(h, ctx, mid["attn"], cfg.heads(chans[-1]),
                            cfg.groups)
    return resnet_block(h, temb, mid["res2"], cfg.groups)


def upsample_nearest2x(h: Tensor) -> Tensor:
    """NHWC ×2 nearest upsample."""
    return F.interpolate(h.permute(0, 3, 1, 2), scale_factor=2,
                         mode="nearest").permute(0, 2, 3, 1)


def apply_unet_up_level(params, i, h, skips_i, temb, ctx, cfg):
    """One up level: consumes its skip tuple last in, first out."""
    chans = [cfg.base * m for m in cfg.mults]
    skips = list(skips_i)
    level = params["up"][i]
    lvl = len(chans) - 1 - i
    for j, res in enumerate(level["resnets"]):
        h = torch.cat([h, skips.pop()], dim=-1)
        h = resnet_block(h, temb, res, cfg.groups)
        if level["attns"]:
            h = spatial_transformer(h, ctx, level["attns"][j],
                                    cfg.heads(chans[lvl]), cfg.groups)
    if "up" in level:
        h = conv2d(upsample_nearest2x(h), level["up"])
    return h


def apply_unet_out(params, h, cfg):
    h = F.silu(group_norm(h, params["norm_out"], cfg.groups))
    return conv2d(h, params["conv_out"])


# ------------------------------------------------------- torch conversion


def _resnet_from_torch(sd, pre) -> Params:
    p = {
        "norm1": norm_from_torch(sd, pre + ".norm1"),
        "conv1": conv_from_torch(sd, pre + ".conv1"),
        "norm2": norm_from_torch(sd, pre + ".norm2"),
        "conv2": conv_from_torch(sd, pre + ".conv2"),
    }
    if pre + ".time_emb_proj.weight" in sd:
        p["time_emb_proj"] = linear_from_torch(sd, pre + ".time_emb_proj")
    if pre + ".conv_shortcut.weight" in sd:
        p["conv_shortcut"] = conv_from_torch(sd, pre + ".conv_shortcut")
    return p


def _tblock_from_torch(sd, pre) -> Params:
    def attn(a):
        return {
            "q": linear_from_torch(sd, f"{pre}.{a}.to_q"),
            "k": linear_from_torch(sd, f"{pre}.{a}.to_k"),
            "v": linear_from_torch(sd, f"{pre}.{a}.to_v"),
            "out": linear_from_torch(sd, f"{pre}.{a}.to_out.0"),
        }

    return {
        "norm1": norm_from_torch(sd, pre + ".norm1"),
        "attn1": attn("attn1"),
        "norm2": norm_from_torch(sd, pre + ".norm2"),
        "attn2": attn("attn2"),
        "norm3": norm_from_torch(sd, pre + ".norm3"),
        "ff1": linear_from_torch(sd, pre + ".ff.net.0.proj"),
        "ff2": linear_from_torch(sd, pre + ".ff.net.2"),
    }


def _transformer_from_torch(sd, pre) -> Params:
    blocks = []
    d = 0
    while f"{pre}.transformer_blocks.{d}.norm1.weight" in sd:
        blocks.append(_tblock_from_torch(sd, f"{pre}.transformer_blocks.{d}"))
        d += 1

    def proj(name):
        # SD1.5 stores proj_in/out as 1×1 Conv2d (4-D); SDXL
        # (use_linear_projection) as nn.Linear (2-D): the same 1×1 conv.
        w = t2t(sd[f"{pre}.{name}.weight"])
        if w.dim() == 2:
            return {"w": w.t().contiguous()[None, None],
                    "b": t2t(sd[f"{pre}.{name}.bias"])}
        return conv_from_torch(sd, f"{pre}.{name}")

    return {
        "norm": norm_from_torch(sd, pre + ".norm"),
        "proj_in": proj("proj_in"),
        "blocks": blocks,
        "proj_out": proj("proj_out"),
    }


def convert_torch_unet(sd: Dict[str, Any],
                       cfg: UNetConfig = SD15_UNET) -> Params:
    """diffusers `UNet2DConditionModel.state_dict()` → parameter tree (on
    the CPU)."""
    p: Params = {
        "conv_in": conv_from_torch(sd, "conv_in"),
        "time1": linear_from_torch(sd, "time_embedding.linear_1"),
        "time2": linear_from_torch(sd, "time_embedding.linear_2"),
        "down": [], "up": [],
        "norm_out": norm_from_torch(sd, "conv_norm_out"),
        "conv_out": conv_from_torch(sd, "conv_out"),
    }
    if "add_embedding.linear_1.weight" in sd:  # SDXL text-time embedding
        p["add1"] = linear_from_torch(sd, "add_embedding.linear_1")
        p["add2"] = linear_from_torch(sd, "add_embedding.linear_2")
    # Levels are probed from the keys, so a config/checkpoint mismatch
    # fails here instead of appending empty levels or dropping real ones.
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
    if len(p["down"]) != len(cfg.mults):
        raise ValueError(
            f"checkpoint has {len(p['down'])} down levels but cfg.mults "
            f"has {len(cfg.mults)} — wrong UNetConfig for this checkpoint"
        )

    p["mid"] = {
        "res1": _resnet_from_torch(sd, "mid_block.resnets.0"),
        "attn": _transformer_from_torch(sd, "mid_block.attentions.0"),
        "res2": _resnet_from_torch(sd, "mid_block.resnets.1"),
    }

    for i in range(len(p["down"])):
        level = {"resnets": [], "attns": []}
        j = 0
        while f"up_blocks.{i}.resnets.{j}.norm1.weight" in sd:
            level["resnets"].append(
                _resnet_from_torch(sd, f"up_blocks.{i}.resnets.{j}"))
            if f"up_blocks.{i}.attentions.{j}.norm.weight" in sd:
                level["attns"].append(_transformer_from_torch(
                    sd, f"up_blocks.{i}.attentions.{j}"))
            j += 1
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            level["up"] = conv_from_torch(
                sd, f"up_blocks.{i}.upsamplers.0.conv")
        p["up"].append(level)
    return p


def load_unet_params(path: str, cfg: UNetConfig = SD15_UNET) -> Params:
    """Load a torch checkpoint file (.bin/.pt/.safetensors) and convert."""
    return convert_torch_unet(_load_torch_state_dict(path), cfg)


def _load_torch_state_dict(path: str) -> Dict[str, Tensor]:
    """A checkpoint file → {key: f32 CPU tensor}."""
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(
                "safetensors not available; convert the checkpoint to "
                ".bin/.pt with torch first"
            ) from e
        return {k: v.float() for k, v in load_file(path).items()}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float() for k, v in sd.items()}
