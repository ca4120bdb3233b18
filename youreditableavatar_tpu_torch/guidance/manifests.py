"""Official checkpoint key manifests for the weight converters.

Each generator enumerates, purely from an architecture config, the exact
(key → torch shape) set the corresponding OFFICIAL checkpoint contains:

  * `unet_manifest`   — diffusers `UNet2DConditionModel.state_dict()`
                        (SD1.5 `normal-adapted-sd1.5` and SDXL variants;
                        reference load: `sds_du_guidance.py:46-119`,
                        `tetgs_inpainter/pipeline_*`)
  * `vae_manifest`    — diffusers `AutoencoderKL.state_dict()`
  * `clip_text_manifest` — transformers `CLIPTextModel.state_dict()`

Counterpart of `youreditableavatar_tpu/guidance/manifests.py`, over the
port's own configs. The tests hold every converter of the port to its
manifest exactly (no key ignored, none missing) on synthetic checkpoints,
and a mounted checkpoint's key set can be diffed against the manifest
before converting, so a layout mismatch reports as a key diff instead of
a shape error mid-conversion.

Shapes use torch conventions: Conv2d (out, in, kh, kw), Linear (out, in),
norms (C,).
"""

from __future__ import annotations

from typing import Dict, Tuple

from youreditableavatar_tpu_torch.guidance.sd_unet import UNetConfig
from youreditableavatar_tpu_torch.guidance.sd_vae import VAEConfig

Shape = Tuple[int, ...]
Manifest = Dict[str, Shape]


def _conv(m: Manifest, pre: str, cin: int, cout: int, k: int) -> None:
    m[pre + ".weight"] = (cout, cin, k, k)
    m[pre + ".bias"] = (cout,)


def _linear(m: Manifest, pre: str, din: int, dout: int,
            bias: bool = True) -> None:
    m[pre + ".weight"] = (dout, din)
    if bias:
        m[pre + ".bias"] = (dout,)


def _norm(m: Manifest, pre: str, c: int) -> None:
    m[pre + ".weight"] = (c,)
    m[pre + ".bias"] = (c,)


def _resnet(m: Manifest, pre: str, cin: int, cout: int,
            temb: int | None) -> None:
    _norm(m, pre + ".norm1", cin)
    _conv(m, pre + ".conv1", cin, cout, 3)
    _norm(m, pre + ".norm2", cout)
    _conv(m, pre + ".conv2", cout, cout, 3)
    if temb is not None:
        _linear(m, pre + ".time_emb_proj", temb, cout)
    if cin != cout:
        _conv(m, pre + ".conv_shortcut", cin, cout, 1)


def _tblock(m: Manifest, pre: str, c: int, ctx: int) -> None:
    _norm(m, pre + ".norm1", c)
    for a, kv in (("attn1", c), ("attn2", ctx)):
        _linear(m, f"{pre}.{a}.to_q", c, c, bias=False)
        _linear(m, f"{pre}.{a}.to_k", kv, c, bias=False)
        _linear(m, f"{pre}.{a}.to_v", kv, c, bias=False)
        _linear(m, f"{pre}.{a}.to_out.0", c, c)
    _norm(m, pre + ".norm2", c)
    _norm(m, pre + ".norm3", c)
    _linear(m, pre + ".ff.net.0.proj", c, 8 * c)  # GEGLU: inner 4c × 2
    _linear(m, pre + ".ff.net.2", 4 * c, c)


def _spatial_transformer(m: Manifest, pre: str, c: int, ctx: int,
                         depth: int, linear_proj: bool) -> None:
    _norm(m, pre + ".norm", c)
    if linear_proj:  # SDXL use_linear_projection=True stores nn.Linear
        _linear(m, pre + ".proj_in", c, c)
        _linear(m, pre + ".proj_out", c, c)
    else:  # SD1.5 stores 1×1 Conv2d
        _conv(m, pre + ".proj_in", c, c, 1)
        _conv(m, pre + ".proj_out", c, c, 1)
    for d in range(depth):
        _tblock(m, f"{pre}.transformer_blocks.{d}", c, ctx)


def unet_manifest(cfg: UNetConfig) -> Manifest:
    """diffusers UNet2DConditionModel state-dict keys + shapes."""
    m: Manifest = {}
    chans = [cfg.base * mult for mult in cfg.mults]
    temb = cfg.temb_dim
    linear_proj = cfg.add_embed  # SDXL-family checkpoints
    _conv(m, "conv_in", cfg.in_channels, cfg.base, 3)
    _linear(m, "time_embedding.linear_1", cfg.base, temb)
    _linear(m, "time_embedding.linear_2", temb, temb)
    if cfg.add_embed:
        _linear(m, "add_embedding.linear_1", cfg.add_in_dim, temb)
        _linear(m, "add_embedding.linear_2", temb, temb)

    skip = [cfg.base]
    cin = cfg.base
    for lvl, cout in enumerate(chans):
        pre = f"down_blocks.{lvl}"
        for j in range(cfg.blocks_per_level):
            _resnet(m, f"{pre}.resnets.{j}", cin, cout, temb)
            if lvl in cfg.attn_levels:
                _spatial_transformer(
                    m, f"{pre}.attentions.{j}", cout, cfg.ctx_dim,
                    cfg.tf_depth[lvl], linear_proj,
                )
            cin = cout
            skip.append(cout)
        if lvl < len(chans) - 1:
            _conv(m, f"{pre}.downsamplers.0.conv", cout, cout, 3)
            skip.append(cout)

    mid_depth = cfg.tf_depth[-1] or 1
    _resnet(m, "mid_block.resnets.0", cin, cin, temb)
    _spatial_transformer(m, "mid_block.attentions.0", cin, cfg.ctx_dim,
                         mid_depth, linear_proj)
    _resnet(m, "mid_block.resnets.1", cin, cin, temb)

    for i, lvl in enumerate(reversed(range(len(chans)))):
        cout = chans[lvl]
        pre = f"up_blocks.{i}"
        for j in range(cfg.blocks_per_level + 1):
            _resnet(m, f"{pre}.resnets.{j}", cin + skip.pop(), cout, temb)
            if lvl in cfg.attn_levels:
                _spatial_transformer(
                    m, f"{pre}.attentions.{j}", cout, cfg.ctx_dim,
                    cfg.tf_depth[lvl], linear_proj,
                )
            cin = cout
        if lvl > 0:
            _conv(m, f"{pre}.upsamplers.0.conv", cout, cout, 3)

    _norm(m, "conv_norm_out", cfg.base)
    _conv(m, "conv_out", cfg.base, cfg.out_channels, 3)
    return m


def vae_manifest(cfg: VAEConfig) -> Manifest:
    """diffusers AutoencoderKL state-dict keys + shapes (>=0.18 attention
    naming: group_norm / to_q/to_k/to_v/to_out.0)."""
    m: Manifest = {}

    def attn(pre: str, c: int) -> None:
        _norm(m, pre + ".group_norm", c)
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            _linear(m, f"{pre}.{n}", c, c)

    chans = list(cfg.chans)
    top = chans[-1]
    # encoder
    _conv(m, "encoder.conv_in", cfg.in_channels, chans[0], 3)
    cin = chans[0]
    for lvl, cout in enumerate(chans):
        pre = f"encoder.down_blocks.{lvl}"
        for j in range(cfg.blocks_per_level):
            _resnet(m, f"{pre}.resnets.{j}", cin, cout, None)
            cin = cout
        if lvl < len(chans) - 1:
            _conv(m, f"{pre}.downsamplers.0.conv", cout, cout, 3)
    _resnet(m, "encoder.mid_block.resnets.0", top, top, None)
    attn("encoder.mid_block.attentions.0", top)
    _resnet(m, "encoder.mid_block.resnets.1", top, top, None)
    _norm(m, "encoder.conv_norm_out", top)
    _conv(m, "encoder.conv_out", top, 2 * cfg.latent_channels, 3)
    # decoder (reversed channels; blocks_per_level+1 resnets per level)
    _conv(m, "decoder.conv_in", cfg.latent_channels, top, 3)
    _resnet(m, "decoder.mid_block.resnets.0", top, top, None)
    attn("decoder.mid_block.attentions.0", top)
    _resnet(m, "decoder.mid_block.resnets.1", top, top, None)
    cin = top
    for i, lvl in enumerate(reversed(range(len(chans)))):
        cout = chans[lvl]
        pre = f"decoder.up_blocks.{i}"
        for j in range(cfg.blocks_per_level + 1):
            _resnet(m, f"{pre}.resnets.{j}", cin, cout, None)
            cin = cout
        if lvl > 0:
            _conv(m, f"{pre}.upsamplers.0.conv", cout, cout, 3)
    _norm(m, "decoder.conv_norm_out", chans[0])
    _conv(m, "decoder.conv_out", chans[0], cfg.in_channels, 3)

    _conv(m, "quant_conv", 2 * cfg.latent_channels,
          2 * cfg.latent_channels, 1)
    _conv(m, "post_quant_conv", cfg.latent_channels,
          cfg.latent_channels, 1)
    return m


def clip_text_manifest(cfg) -> Manifest:
    """transformers CLIPTextModel state-dict keys + shapes.

    Note: transformers < 4.31 checkpoints also carry the non-parameter
    buffer `text_model.embeddings.position_ids`; converters ignore it
    (`IGNORABLE_KEYS`).
    """
    m: Manifest = {}
    d = cfg.dim
    m["text_model.embeddings.token_embedding.weight"] = (cfg.vocab_size, d)
    m["text_model.embeddings.position_embedding.weight"] = (cfg.max_len, d)
    for i in range(cfg.layers):
        pre = f"text_model.encoder.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(m, f"{pre}.self_attn.{n}", d, d)
        _norm(m, pre + ".layer_norm1", d)
        _norm(m, pre + ".layer_norm2", d)
        _linear(m, pre + ".mlp.fc1", d, cfg.mlp_dim)
        _linear(m, pre + ".mlp.fc2", cfg.mlp_dim, d)
    _norm(m, "text_model.final_layer_norm", d)
    return m


def controlnet_union_manifest(cfg) -> Manifest:
    """Vendored `ControlNetModel_Union.state_dict()` keys + shapes
    (`tetgs_inpainter/models/controlnet_union.py:154-960`; note the
    official checkpoint's `transformer_layes` spelling)."""
    u = cfg.unet
    m: Manifest = {}
    chans = [u.base * mult for mult in u.mults]
    temb = u.temb_dim
    _conv(m, "conv_in", u.in_channels, u.base, 3)
    _linear(m, "time_embedding.linear_1", u.base, temb)
    _linear(m, "time_embedding.linear_2", temb, temb)
    if u.add_embed:
        _linear(m, "add_embedding.linear_1", u.add_in_dim, temb)
        _linear(m, "add_embedding.linear_2", temb, temb)
    _linear(m, "control_add_embedding.linear_1",
            cfg.num_control_types * cfg.control_time_dim, temb)
    _linear(m, "control_add_embedding.linear_2", temb, temb)
    m["task_embedding"] = (cfg.num_control_types, u.base)
    _linear(m, "spatial_ch_projs", u.base, u.base)

    ce = cfg.cond_embed_chans
    _conv(m, "controlnet_cond_embedding.conv_in", cfg.cond_channels,
          ce[0], 3)
    for i in range(len(ce) - 1):
        _conv(m, f"controlnet_cond_embedding.blocks.{2 * i}",
              ce[i], ce[i], 3)
        _conv(m, f"controlnet_cond_embedding.blocks.{2 * i + 1}",
              ce[i], ce[i + 1], 3)
    _conv(m, "controlnet_cond_embedding.conv_out", ce[-1], u.base, 3)

    for i in range(cfg.fuser_layers):
        pre = f"transformer_layes.{i}"
        _norm(m, pre + ".ln_1", u.base)
        m[pre + ".attn.in_proj_weight"] = (3 * u.base, u.base)
        m[pre + ".attn.in_proj_bias"] = (3 * u.base,)
        _linear(m, pre + ".attn.out_proj", u.base, u.base)
        _norm(m, pre + ".ln_2", u.base)
        _linear(m, pre + ".mlp.c_fc", u.base, 4 * u.base)
        _linear(m, pre + ".mlp.c_proj", 4 * u.base, u.base)

    cin = u.base
    zc = [u.base]  # zero-conv widths track the skip outputs
    for lvl, cout in enumerate(chans):
        pre = f"down_blocks.{lvl}"
        for j in range(u.blocks_per_level):
            _resnet(m, f"{pre}.resnets.{j}", cin, cout, temb)
            if lvl in u.attn_levels:
                _spatial_transformer(
                    m, f"{pre}.attentions.{j}", cout, u.ctx_dim,
                    u.tf_depth[lvl], True,
                )
            cin = cout
            zc.append(cout)
        if lvl < len(chans) - 1:
            _conv(m, f"{pre}.downsamplers.0.conv", cout, cout, 3)
            zc.append(cout)
    for i, c in enumerate(zc):
        _conv(m, f"controlnet_down_blocks.{i}", c, c, 1)

    mid_depth = u.tf_depth[-1] or 1
    _resnet(m, "mid_block.resnets.0", cin, cin, temb)
    _spatial_transformer(m, "mid_block.attentions.0", cin, u.ctx_dim,
                         mid_depth, True)
    _resnet(m, "mid_block.resnets.1", cin, cin, temb)
    _conv(m, "controlnet_mid_block", cin, cin, 1)
    return m


def sam_manifest(cfg) -> Manifest:
    """Official `segment_anything` checkpoint keys + shapes (ViT-H/L).

    `prompt_encoder.mask_downscaling.*` (mask-prompt path, unused by the
    box-prompted localization stage) is listed in `SAM_UNCONSUMED` rather
    than here."""
    m: Manifest = {}
    d = cfg.embed_dim
    hd = d // cfg.heads
    grid = cfg.grid
    m["image_encoder.patch_embed.proj.weight"] = (d, 3, cfg.patch,
                                                  cfg.patch)
    m["image_encoder.patch_embed.proj.bias"] = (d,)
    m["image_encoder.pos_embed"] = (1, grid, grid, d)
    for i in range(cfg.depth):
        pre = f"image_encoder.blocks.{i}"
        rel = (2 * grid - 1 if i in cfg.global_idx
               else 2 * cfg.window - 1)
        _norm(m, pre + ".norm1", d)
        _linear(m, pre + ".attn.qkv", d, 3 * d)
        _linear(m, pre + ".attn.proj", d, d)
        m[pre + ".attn.rel_pos_h"] = (rel, hd)
        m[pre + ".attn.rel_pos_w"] = (rel, hd)
        _norm(m, pre + ".norm2", d)
        _linear(m, pre + ".mlp.lin1", d, 4 * d)
        _linear(m, pre + ".mlp.lin2", 4 * d, d)
    nk = cfg.neck_dim
    m["image_encoder.neck.0.weight"] = (nk, d, 1, 1)  # bias=False convs
    _norm(m, "image_encoder.neck.1", nk)
    m["image_encoder.neck.2.weight"] = (nk, nk, 3, 3)
    _norm(m, "image_encoder.neck.3", nk)

    pe = "prompt_encoder."
    m[pe + "pe_layer.positional_encoding_gaussian_matrix"] = (2, nk // 2)
    for i in range(4):
        m[pe + f"point_embeddings.{i}.weight"] = (1, nk)
    m[pe + "not_a_point_embed.weight"] = (1, nk)
    m[pe + "no_mask_embed.weight"] = (1, nk)

    md = "mask_decoder."
    nt = cfg.num_mask_tokens
    half = nk // 2  # cross-attn downsample rate 2
    m[md + "iou_token.weight"] = (1, nk)
    m[md + "mask_tokens.weight"] = (nt, nk)
    for i in range(cfg.decoder_depth):
        pre = f"{md}transformer.layers.{i}"
        for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(m, f"{pre}.self_attn.{n}", nk, nk)
        _norm(m, pre + ".norm1", nk)
        for n in ("q_proj", "k_proj", "v_proj"):
            _linear(m, f"{pre}.cross_attn_token_to_image.{n}", nk, half)
        _linear(m, pre + ".cross_attn_token_to_image.out_proj", half, nk)
        _norm(m, pre + ".norm2", nk)
        _linear(m, pre + ".mlp.lin1", nk, 8 * nk)
        _linear(m, pre + ".mlp.lin2", 8 * nk, nk)
        _norm(m, pre + ".norm3", nk)
        for n in ("q_proj", "k_proj", "v_proj"):
            _linear(m, f"{pre}.cross_attn_image_to_token.{n}", nk, half)
        _linear(m, pre + ".cross_attn_image_to_token.out_proj", half, nk)
        _norm(m, pre + ".norm4", nk)
    for n in ("q_proj", "k_proj", "v_proj"):
        _linear(m, f"{md}transformer.final_attn_token_to_image.{n}",
                nk, half)
    _linear(m, md + "transformer.final_attn_token_to_image.out_proj",
            half, nk)
    _norm(m, md + "transformer.norm_final_attn", nk)
    m[md + "output_upscaling.0.weight"] = (nk, nk // 4, 2, 2)
    m[md + "output_upscaling.0.bias"] = (nk // 4,)
    _norm(m, md + "output_upscaling.1", nk // 4)
    m[md + "output_upscaling.3.weight"] = (nk // 4, nk // 8, 2, 2)
    m[md + "output_upscaling.3.bias"] = (nk // 8,)
    for i in range(nt):
        dims = [nk, nk, nk, nk // 8]
        for j in range(3):
            _linear(m, f"{md}output_hypernetworks_mlps.{i}.layers.{j}",
                    dims[j], dims[j + 1])
    dims = [nk, nk, nk, nt]
    for j in range(3):
        _linear(m, f"{md}iou_prediction_head.layers.{j}",
                dims[j], dims[j + 1])
    return m


# Non-parameter buffers official checkpoints may carry that converters
# deliberately skip.
IGNORABLE_KEYS = frozenset({
    "text_model.embeddings.position_ids",
})

# Official-checkpoint keys the SAM converter deliberately does not consume:
# the mask-PROMPT downscaler (the pipeline prompts with boxes only,
# `stages/localization.py`).
SAM_UNCONSUMED = (
    "prompt_encoder.mask_downscaling.",
)

# Official GroundingDINO checkpoint key families the converter skips:
# torch buffers (position ids / relative-position index tables /
# attention masks), the BERT pooler (unused by grounding), and the
# per-layer aliases of the SHARED box head (`bbox_embed.{1..5}` reference
# the same tensors as `bbox_embed.0` in the official nn.ModuleList).
GDINO_UNCONSUMED = (
    "bert.pooler.",
    "bert.embeddings.position_ids",
    ".relative_position_index",
    ".attn_mask",
    "label_enc.",
)

