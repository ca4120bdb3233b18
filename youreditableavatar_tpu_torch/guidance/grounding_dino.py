"""GroundingDINO (Swin-T) as functional PyTorch: the text → box half of
LangSAM.

Counterpart of `youreditableavatar_tpu/guidance/grounding_dino.py`, with the
official structure so that `groundingdino_swint_ogc.pth` converts
(`convert_torch_gdino`):

  * the Swin-T image backbone (windowed attention, shifted windows,
    relative-position bias, patch merging) emitting the stage 1..3 maps;
  * the BERT-base text encoder;
  * the feature enhancer: per layer, multi-scale deformable self-attention
    over the flattened image pyramid, self-attention over the text, and the
    bidirectional image ↔ text attention with layer-scale gates;
  * language-guided query selection (the top-K image tokens by their
    largest text logit) and the cross-modality decoder (self-attention, text
    cross-attention, deformable image cross-attention) with iterative box
    refinement;
  * contrastive classification: logits = queries · text features.

The deformable sampling is `F.grid_sample` (bilinear, zero padding,
`align_corners=False`) over the heads of one level at once, the same
sampling as the JAX package's gathers. The parameter trees are the JAX
package's layout (NHWC, HWIO, (in, out) linears, LayerNorms as {"g", "b"}),
carried across with `gdino_params_from_numpy`. Nothing differentiates
GroundingDINO: `DinoGrounder` runs under `torch.no_grad()`.

Spans (`utils/profiling.span`): `gdino` over `gdino_ground`, one
`gdino.msda` inside it for each `ms_deform_attn` call. Counters:
`gdino.msda_calls`, `gdino.msda_tokens.l<level>` (the value tokens each
call samples on each level), and the grounder's host ↔ device bytes.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.sd_layers import (
    _randn,
    _zeros,
    attention,
    conv2d,
    layer_norm_affine,
    linear,
    params_from_numpy,
    t2t,
    tree_to,
)
from youreditableavatar_tpu_torch.utils.device import resolve_device
from youreditableavatar_tpu_torch.utils.profiling import (
    count, span, to_device, to_host)

Params = Dict[str, Any]

NEG = -1e9  # additive mask of padded text tokens and shifted windows


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GDINOConfig:
    # Swin backbone
    patch: int = 4
    swin_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    # BERT text encoder
    vocab: int = 30522
    text_dim: int = 768
    text_layers: int = 12
    text_heads: int = 12
    max_text_len: int = 256
    # Transformer
    dim: int = 256
    heads: int = 8
    ffn: int = 2048
    enc_layers: int = 6
    dec_layers: int = 6
    levels: int = 4
    points: int = 4
    num_queries: int = 900


SWIN_T_GDINO = GDINOConfig()
TEST_GDINO = GDINOConfig(
    swin_dim=8, depths=(1, 1, 1, 1), num_heads=(1, 2, 2, 2), window=4,
    vocab=64, text_dim=16, text_layers=2, text_heads=2, max_text_len=16,
    dim=16, heads=2, ffn=32, enc_layers=2, dec_layers=2, points=2,
    num_queries=20,
)


def gdino_params_from_numpy(tree, device=None) -> Params:
    """The JAX package's GroundingDINO tree (as numpy) → the same tree of
    f32 tensors on `device`."""
    return params_from_numpy(tree, device)


# ---------------------------------------------------------------------------
# Small shared pieces
# ---------------------------------------------------------------------------


def _linear(gen, din, dout, scale=None) -> Params:
    scale = scale if scale is not None else din ** -0.5
    return {"w": _randn(gen, (din, dout)) * scale, "b": _zeros(gen, (dout,))}


def _ln_init(gen, d) -> Params:
    return {"g": torch.ones((d,), device=gen.device), "b": _zeros(gen, (d,))}


def _apply_ln(x, p):
    return layer_norm_affine(x, p["g"], p["b"])


def _mha_init(gen, d) -> Params:
    return {"q": _linear(gen, d, d), "k": _linear(gen, d, d),
            "v": _linear(gen, d, d), "o": _linear(gen, d, d)}


def _attend(q, k, v, p, h, bias=None):
    """q / k / v projected, attended (`bias` additive), projected back."""
    return linear(attention(linear(q, p["q"]), linear(k, p["k"]),
                            linear(v, p["v"]), h, bias), p["o"])


def _mlp_init(gen, d, hidden, dout=None) -> Params:
    return {"fc1": _linear(gen, d, hidden),
            "fc2": _linear(gen, hidden, dout or d)}


def _gelu_exact(x):
    # torch nn.GELU's default, the exact erf GELU (Swin and BERT).
    return F.gelu(x)


def _mlp(x, p, act=_gelu_exact):
    return linear(act(linear(x, p["fc1"])), p["fc2"])


def _text_mask(token_mask: Tensor, dtype) -> Tensor:
    """(T,) bool → (1, 1, T) additive mask."""
    zero = torch.zeros((), dtype=dtype, device=token_mask.device)
    return torch.where(token_mask[None, None, :], zero, zero + NEG)


# ---------------------------------------------------------------------------
# Swin backbone
# ---------------------------------------------------------------------------


def _swin_block_init(gen, d, heads, window) -> Params:
    return {
        "norm1": _ln_init(gen, d),
        "attn": _mha_init(gen, d),
        "rel_bias": _randn(gen, ((2 * window - 1) ** 2, heads)) * 0.02,
        "norm2": _ln_init(gen, d),
        "mlp": _mlp_init(gen, d, 4 * d),
    }


@functools.lru_cache(maxsize=8)
def _rel_index(window: int) -> np.ndarray:
    """(W², W²) index into the (2W−1)² relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + window - 1
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


# The forward's small constants, uploaded to a device once: an upload
# waits for the stream, and the launches behind it cannot queue meanwhile.
@functools.lru_cache(maxsize=32)
def _rel_index_on(window: int, device: torch.device) -> Tensor:
    return torch.as_tensor(_rel_index(window), device=device)


@functools.lru_cache(maxsize=32)
def _shift_mask(h: int, wd: int, window: int, shift: int, dtype,
                device: torch.device) -> Tensor:
    """(nW, W², W²) additive mask of attention across wrapped-window
    boundaries."""
    mw = torch.as_tensor(_shift_regions(h, wd, window, shift), device=device)
    return torch.where(mw[:, None, :] != mw[:, :, None],
                       torch.tensor(NEG, dtype=dtype, device=device),
                       torch.tensor(0.0, dtype=dtype, device=device))


@functools.lru_cache(maxsize=32)
def _values_on(values: Tuple[float, ...], dtype,
               device: torch.device) -> Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def _window_partition(x, w):
    h, wd, c = x.shape
    x = x.reshape(h // w, w, wd // w, w, c).permute(0, 2, 1, 3, 4)
    return x.reshape(-1, w * w, c)


def _window_merge(wins, h, wd, w):
    c = wins.shape[-1]
    x = wins.reshape(h // w, wd // w, w, w, c).permute(0, 2, 1, 3, 4)
    return x.reshape(h, wd, c)


@functools.lru_cache(maxsize=32)
def _shift_regions(h: int, wd: int, window: int, shift: int) -> np.ndarray:
    """(nW, W²) region label of every position of each shifted window
    (standard SW-MSA), on the padded size."""
    img_mask = np.zeros((h, wd), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift),
                   slice(-shift, None)):
            img_mask[hs, ws] = cnt
            cnt += 1
    m = img_mask.reshape(h // window, window, wd // window, window)
    return m.transpose(0, 2, 1, 3).reshape(-1, window * window)


def _swin_block(x, p, heads, window, shift):
    """x: (H, W, C), H and W already padded to window multiples."""
    h, wd, c = x.shape
    res = x
    x = _apply_ln(x, p["norm1"])
    if shift:
        x = torch.roll(x, (-shift, -shift), dims=(0, 1))
    wins = _window_partition(x, window)  # (nW, W², C)
    bias = p["rel_bias"][_rel_index_on(window, x.device)]  # (W², W², heads)
    bias = bias.permute(2, 0, 1)[None]  # (1, heads, W², W²)
    if shift:
        # Mask attention across wrapped-window boundaries.
        amask = _shift_mask(h, wd, window, shift, x.dtype, x.device)
        mask = bias + amask[:, None]
    else:
        mask = bias
    wins = _attend(wins, wins, wins, p["attn"], heads, mask)
    x = _window_merge(wins, h, wd, window)
    if shift:
        x = torch.roll(x, (shift, shift), dims=(0, 1))
    x = res + x
    return x + _mlp(_apply_ln(x, p["norm2"]), p["mlp"])


def init_swin_params(gen, cfg: GDINOConfig) -> Params:
    d = cfg.swin_dim
    p: Params = {
        "patch_proj": {
            "w": _randn(gen, (cfg.patch, cfg.patch, 3, d)) * 0.05,
            "b": _zeros(gen, (d,)),
        },
        "patch_norm": _ln_init(gen, d),
        "stages": [],
        # GroundingDINO taps stages 1..3 through per-stage output norms.
        "out_norms": [_ln_init(gen, d * 2), _ln_init(gen, d * 4),
                      _ln_init(gen, d * 8)],
    }
    for si, depth in enumerate(cfg.depths):
        dim = d * (2 ** si)
        stage: Params = {
            "blocks": [_swin_block_init(gen, dim, cfg.num_heads[si],
                                        cfg.window)
                       for _ in range(depth)],
        }
        if si < len(cfg.depths) - 1:
            stage["merge_norm"] = _ln_init(gen, 4 * dim)
            stage["merge"] = {
                "w": _randn(gen, (4 * dim, 2 * dim)) * (4 * dim) ** -0.5}
        p["stages"].append(stage)
    return p


def _pad_to(x, mult):
    h, w = x.shape[:2]
    ph = (-h) % mult
    pw = (-w) % mult
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    return x


def swin_backbone(p: Params, image: Tensor, cfg: GDINOConfig) -> List[Tensor]:
    """(H, W, 3) in [0, 1] → [(H/8, W/8, 2d), (H/16, ·, 4d), (H/32, ·, 8d)]."""
    mean = _values_on((0.485, 0.456, 0.406), image.dtype, image.device)
    std = _values_on((0.229, 0.224, 0.225), image.dtype, image.device)
    x = (image - mean) / std
    x = _pad_to(x, cfg.patch)
    x = conv2d(x[None], p["patch_proj"], stride=cfg.patch,
               padding="VALID")[0]
    x = _apply_ln(x, p["patch_norm"])
    outs = []
    for si, stage in enumerate(p["stages"]):
        h0, w0 = x.shape[:2]
        x = _pad_to(x, cfg.window)
        for bi, blk in enumerate(stage["blocks"]):
            shift = 0 if bi % 2 == 0 else cfg.window // 2
            x = _swin_block(x, blk, cfg.num_heads[si], cfg.window, shift)
        x = x[:h0, :w0]
        if si > 0:
            outs.append(_apply_ln(x, p["out_norms"][si - 1]))
        if "merge" in stage:
            x = _pad_to(x, 2)
            # Torch Swin concatenates [x0, x1, x2, x3] with x1 the
            # BOTTOM-left of the 2×2 block; the downsample weights index
            # channels in that order.
            x = torch.cat([x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2],
                           x[1::2, 1::2]], dim=-1)
            x = linear(_apply_ln(x, stage["merge_norm"]), stage["merge"])
    return outs


# ---------------------------------------------------------------------------
# BERT text encoder
# ---------------------------------------------------------------------------


def init_bert_params(gen, cfg: GDINOConfig) -> Params:
    d = cfg.text_dim
    p: Params = {
        "tok_emb": _randn(gen, (cfg.vocab, d)) * 0.02,
        "pos_emb": _randn(gen, (cfg.max_text_len, d)) * 0.02,
        "type_emb": _randn(gen, (2, d)) * 0.02,
        "emb_norm": _ln_init(gen, d),
        "layers": [],
    }
    for _ in range(cfg.text_layers):
        p["layers"].append({
            "attn": _mha_init(gen, d),
            "attn_norm": _ln_init(gen, d),
            "mlp": _mlp_init(gen, d, 4 * d),
            "mlp_norm": _ln_init(gen, d),
        })
    return p


def bert_encode(p: Params, tokens: Tensor, attn_mask: Tensor,
                heads: int = 2) -> Tensor:
    """(T,) int tokens + (T,) bool mask → (T, text_dim) features."""
    t = tokens.shape[0]
    x = p["tok_emb"][tokens.long()] + p["pos_emb"][:t] + p["type_emb"][0]
    x = _apply_ln(x, p["emb_norm"])
    add = _text_mask(attn_mask, x.dtype)
    for layer in p["layers"]:
        # Post-LN residual blocks (BERT convention).
        x = _apply_ln(x + _attend(x, x, x, layer["attn"], heads, add),
                      layer["attn_norm"])
        x = _apply_ln(x + _mlp(x, layer["mlp"]), layer["mlp_norm"])
    return x


# ---------------------------------------------------------------------------
# Multi-scale deformable attention
# ---------------------------------------------------------------------------


def _bilinear_sample(feat: Tensor, xy: Tensor) -> Tensor:
    """grid_sample(align_corners=False, zeros) on one level.

    feat: (H, W, C); xy: (..., 2) in [0, 1] normalized level coords →
    (..., C).
    """
    lead = xy.shape[:-1]
    grid = (2.0 * xy - 1.0).reshape(1, 1, -1, 2)
    out = F.grid_sample(feat.permute(2, 0, 1)[None], grid, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[0, :, 0].transpose(0, 1).reshape(*lead, feat.shape[-1])


def _msda_init(gen, d, heads, levels, points) -> Params:
    # Random init for the weight-free runs (the official init starts the
    # sampling offsets on a ring).
    return {
        "sampling": _linear(gen, d, heads * levels * points * 2, 0.01),
        "attn_w": _linear(gen, d, heads * levels * points, 0.01),
        "value": _linear(gen, d, d),
        "output": _linear(gen, d, d),
    }


def _bilinear_sample_heads(feat: Tensor, xy: Tensor) -> Tensor:
    """Per-head grid_sample on one level, every head in one call.

    feat: (H, W, h, dh); xy: (Q, h, P, 2) in [0, 1] level coords →
    (Q, h, P, dh).
    """
    value = feat.permute(2, 3, 0, 1)  # (h, dh, H, W)
    grid = (2.0 * xy - 1.0).permute(1, 0, 2, 3)  # (h, Q, P, 2)
    out = F.grid_sample(value, grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)  # (h, dh, Q, P)
    return out.permute(2, 0, 3, 1)


def ms_deform_attn(
    query: Tensor,  # (Q, D)
    ref_xy: Tensor,  # (Q, 2) normalized reference points
    value_flat: Tensor,  # (S, D) flattened pyramid
    shapes: Sequence[Tuple[int, int]],  # [(H_l, W_l)]
    p: Params,
    h: int,
    pt: int,
    ref_wh: Tensor = None,  # (Q, 2): present for 4-dim (box) references
) -> Tensor:
    """Official MSDeformAttn sampling rules: 2-dim references offset by
    off / (W_l, H_l); 4-dim (box) references by off / n_points · wh / 2."""
    count("gdino.msda_calls")
    for li, (hl, wl) in enumerate(shapes):
        count(f"gdino.msda_tokens.l{li}", hl * wl)
    with span("gdino.msda"):
        return _ms_deform_attn(query, ref_xy, value_flat, shapes, p, h, pt,
                               ref_wh)


def _ms_deform_attn(query, ref_xy, value_flat, shapes, p, h, pt, ref_wh):
    lv = len(shapes)
    q, d = query.shape
    dh = d // h
    off = linear(query, p["sampling"]).reshape(q, h, lv, pt, 2)
    aw = linear(query, p["attn_w"]).reshape(q, h, lv * pt)
    aw = torch.softmax(aw, dim=-1).reshape(q, h, lv, pt)
    val = linear(value_flat, p["value"]).reshape(-1, h, dh)

    out = torch.zeros((q, h, dh), dtype=query.dtype, device=query.device)
    start = 0
    for li, (hl, wl) in enumerate(shapes):
        n = hl * wl
        lvl = val[start:start + n].reshape(hl, wl, h, dh)
        start += n
        if ref_wh is None:
            wh = _values_on((float(wl), float(hl)), query.dtype,
                            query.device)
            xy = ref_xy[:, None, None, :] + off[:, :, li] / wh
        else:
            xy = (ref_xy[:, None, None, :]
                  + off[:, :, li] / pt * ref_wh[:, None, None, :] * 0.5)
        s = _bilinear_sample_heads(lvl, xy)  # (Q, h, pt, dh)
        out = out + torch.sum(s * aw[:, :, li, :, None], dim=2)
    return linear(out.reshape(q, d), p["output"])


# ---------------------------------------------------------------------------
# Feature enhancer (encoder) + decoder
# ---------------------------------------------------------------------------


def _bi_attn_init(gen, d, text_d, heads) -> Params:
    edim = d  # attention embed dim
    return {
        "ln_v": _ln_init(gen, d),
        "ln_t": _ln_init(gen, text_d),
        "v_proj": _linear(gen, d, edim),
        "t_proj": _linear(gen, text_d, edim),
        "values_v": _linear(gen, d, edim),
        "values_t": _linear(gen, text_d, edim),
        "out_v": _linear(gen, edim, d),
        "out_t": _linear(gen, edim, text_d),
        "gamma_v": torch.full((d,), 1e-4, device=gen.device),
        "gamma_t": torch.full((text_d,), 1e-4, device=gen.device),
    }


def _bi_attention(img, txt, txt_mask, p, h):
    """GroundingDINO BiMultiHeadAttention: one image–text similarity
    softmaxed both ways, layer-scale-gated residuals."""
    vi = _apply_ln(img, p["ln_v"])
    ti = _apply_ln(txt, p["ln_t"])
    qv = linear(vi, p["v_proj"])
    qt = linear(ti, p["t_proj"])
    vv = linear(vi, p["values_v"])
    vt = linear(ti, p["values_t"])

    def split(x):
        return x.reshape(x.shape[0], h, -1).transpose(0, 1)

    qvh, qth, vvh, vth = split(qv), split(qt), split(vv), split(vt)
    sim = torch.matmul(qvh, qth.transpose(-1, -2)) / np.sqrt(qvh.shape[-1])
    sim = sim + _text_mask(txt_mask, sim.dtype)  # (h, I, T)
    a_v2t = torch.softmax(sim, dim=-1)  # image attends text
    a_t2v = torch.softmax(sim.transpose(-1, -2), dim=-1)
    dv = torch.matmul(a_v2t, vth).transpose(0, 1).reshape(img.shape[0], -1)
    dt = torch.matmul(a_t2v, vvh).transpose(0, 1).reshape(txt.shape[0], -1)
    img = img + p["gamma_v"] * linear(dv, p["out_v"])
    txt = txt + p["gamma_t"] * linear(dt, p["out_t"])
    return img, txt


def _enc_layer_init(gen, cfg) -> Params:
    d = cfg.dim
    return {
        "msda": _msda_init(gen, d, cfg.heads, cfg.levels, cfg.points),
        "msda_norm": _ln_init(gen, d),
        "ffn": _mlp_init(gen, d, cfg.ffn),
        "ffn_norm": _ln_init(gen, d),
        "txt_attn": _mha_init(gen, d),
        "txt_norm": _ln_init(gen, d),
        "txt_ffn": _mlp_init(gen, d, cfg.ffn),
        "txt_ffn_norm": _ln_init(gen, d),
        "bi": _bi_attn_init(gen, d, d, cfg.heads),
    }


def _dec_layer_init(gen, cfg) -> Params:
    d = cfg.dim
    return {
        "self_attn": _mha_init(gen, d),
        "self_norm": _ln_init(gen, d),
        "ca_text": _mha_init(gen, d),
        "ca_text_norm": _ln_init(gen, d),
        "msda": _msda_init(gen, d, cfg.heads, cfg.levels, cfg.points),
        "msda_norm": _ln_init(gen, d),
        "ffn": _mlp_init(gen, d, cfg.ffn),
        "ffn_norm": _ln_init(gen, d),
    }


def _box_mlp_init(gen, d) -> Params:
    return {"l1": _linear(gen, d, d), "l2": _linear(gen, d, d),
            "l3": _linear(gen, d, 4)}


def _box_mlp(x, p):
    x = F.relu(linear(x, p["l1"]))
    x = F.relu(linear(x, p["l2"]))
    return linear(x, p["l3"])


def _logit(x):
    return torch.log(x / (1.0 - x))


def _sine_interleaved(v: Tensor, half: int, temp: float) -> Tensor:
    """Deformable-DETR sine embedding of one coordinate: (…,) → (…, half)
    with INTERLEAVED sin/cos pairs (sin(v/t₀), cos(v/t₀), sin(v/t₁), …)."""
    ar = torch.arange(half, dtype=v.dtype, device=v.device)
    dim_t = temp ** (2.0 * (ar // 2) / half)
    ang = v[..., None] * (2.0 * np.pi) / dim_t
    return torch.where(ar % 2 == 0, torch.sin(ang), torch.cos(ang))


def _sine_embed_boxes(boxes: Tensor, d: int) -> Tensor:
    """(Q, 4) cxcywh → (Q, 2d) query position embedding (official
    `gen_sineembed_for_position`): per coordinate in (y, x, w, h) order,
    temperature 10000."""
    half = d // 2
    return torch.cat([
        _sine_interleaved(boxes[:, 1], half, 1e4),  # y
        _sine_interleaved(boxes[:, 0], half, 1e4),  # x
        _sine_interleaved(boxes[:, 2], half, 1e4),  # w
        _sine_interleaved(boxes[:, 3], half, 1e4),  # h
    ], dim=-1)


def _sine_embed_2d(ref_xy: Tensor, d: int) -> Tensor:
    """(S, 2) normalized cell centres → (S, d) encoder spatial position
    (official PositionEmbeddingSineHW, temperature 20): [y-half | x-half]."""
    half = d // 2
    return torch.cat([
        _sine_interleaved(ref_xy[:, 1], half, 20.0),  # y first
        _sine_interleaved(ref_xy[:, 0], half, 20.0),
    ], dim=-1)


def init_gdino_params(gen: torch.Generator,
                      cfg: GDINOConfig = TEST_GDINO) -> Params:
    """Random weights drawn from `gen` on its device."""
    d = cfg.dim
    swin_dims = [cfg.swin_dim * 2, cfg.swin_dim * 4, cfg.swin_dim * 8]
    return {
        "swin": init_swin_params(gen, cfg),
        "bert": init_bert_params(gen, cfg),
        # 1×1 input projections to the shared dim (+ one extra stride-2
        # level from the last stage), GroupNorm folded to LN over channels.
        "in_proj": [{"lin": _linear(gen, sd, d), "norm": _ln_init(gen, d)}
                    for sd in swin_dims],
        "extra_proj": {
            "w": _randn(gen, (3, 3, swin_dims[-1], d)) * 0.02,
            "b": _zeros(gen, (d,)),
            "norm": _ln_init(gen, d),
        },
        "level_emb": _randn(gen, (cfg.levels, d)) * 0.02,
        "feat_map": _linear(gen, cfg.text_dim, d),  # text → shared proj
        "enc": [_enc_layer_init(gen, cfg) for _ in range(cfg.enc_layers)],
        "enc_out": {"lin": _linear(gen, d, d), "norm": _ln_init(gen, d)},
        "enc_box": _box_mlp_init(gen, d),
        "tgt_emb": _randn(gen, (cfg.num_queries, d)) * 0.02,
        "ref_head": _mlp_init(gen, 2 * d, d, d),  # pos → query pos MLP
        "dec": [_dec_layer_init(gen, cfg) for _ in range(cfg.dec_layers)],
        "dec_norm": _ln_init(gen, d),
        "bbox_head": _box_mlp_init(gen, d),
    }


def _top_queries(score: Tensor, k: int) -> Tensor:
    """Indices of the `k` largest scores, largest first; among equal scores
    the lower index first (`jax.lax.top_k`'s order)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def gdino_ground(
    params: Params,
    image: Tensor,
    tokens: Tensor,
    token_mask: Tensor,
    cfg: GDINOConfig = TEST_GDINO,
) -> Dict[str, Tensor]:
    """Image + tokenized phrase → (num_queries, 4) cxcywh boxes in [0, 1],
    per-query largest text logit (sigmoid score), the logits over the
    text tokens, and the selected encoder tokens (`top`, best first)."""
    with span("gdino"):
        return _ground(params, image, tokens, token_mask, cfg)


def _ground(params, image, tokens, token_mask, cfg):
    feats = swin_backbone(params["swin"], image, cfg)
    dt, dev = image.dtype, image.device
    levels = [_apply_ln(linear(f, proj["lin"]), proj["norm"])
              for f, proj in zip(feats, params["in_proj"])]
    # Torch pads 1 on BOTH sides for the k=3 s=2 extra level.
    ex = conv2d(feats[-1][None], params["extra_proj"], stride=2,
                padding=((1, 1), (1, 1)))[0]
    levels.append(_apply_ln(ex, params["extra_proj"]["norm"]))
    levels = levels[: cfg.levels]

    shapes = tuple((f.shape[0], f.shape[1]) for f in levels)
    src = torch.cat([f.reshape(-1, cfg.dim) for f in levels], dim=0)
    # Per-token reference points (each cell's centre on its own level) and
    # level index.
    refs = torch.cat([
        torch.stack(torch.meshgrid(
            (torch.arange(w, dtype=dt, device=dev) + 0.5) / w,
            (torch.arange(h, dtype=dt, device=dev) + 0.5) / h,
            indexing="xy"), dim=-1).reshape(-1, 2)
        for (h, w) in shapes
    ])
    lvl_idx = torch.cat([torch.full((h * w,), i, dtype=torch.long, device=dev)
                         for i, (h, w) in enumerate(shapes)])
    # Positional stream = sine spatial + level embedding, added ONLY to the
    # deformable-attention query.
    pos_src = _sine_embed_2d(refs, cfg.dim) + params["level_emb"][lvl_idx]

    txt = bert_encode(params["bert"], tokens, token_mask, cfg.text_heads)
    txt = linear(txt, params["feat_map"])  # (T, dim)
    add = _text_mask(token_mask, txt.dtype)

    for layer in params["enc"]:
        src, txt = _bi_attention(src, txt, token_mask, layer["bi"],
                                 cfg.heads)
        txt = _apply_ln(
            txt + _attend(txt, txt, txt, layer["txt_attn"], cfg.heads,
                          add),
            layer["txt_norm"])
        txt = _apply_ln(txt + _mlp(txt, layer["txt_ffn"], F.relu),
                        layer["txt_ffn_norm"])
        src = _apply_ln(
            src + ms_deform_attn(src + pos_src, refs, src, shapes,
                                 layer["msda"], cfg.heads, cfg.points),
            layer["msda_norm"])
        # Deformable-DETR transformer FFNs are relu (BERT / Swin gelu).
        src = _apply_ln(src + _mlp(src, layer["ffn"], F.relu),
                        layer["ffn_norm"])

    # Language-guided query selection: top-K tokens by largest text logit.
    enc_mem = _apply_ln(linear(src, params["enc_out"]["lin"]),
                        params["enc_out"]["norm"])
    logits = torch.matmul(enc_mem, txt.T)  # (S, T)
    logits = torch.where(token_mask[None, :], logits,
                         torch.full_like(logits, NEG))
    score = logits.max(dim=-1).values
    k = min(cfg.num_queries, score.shape[0])
    top = _top_queries(score, k)
    # Official proposal baseline: logit([cx, cy, 0.05·2^lvl, 0.05·2^lvl]).
    prop_wh = 0.05 * (2.0 ** lvl_idx[top].to(dt))
    proposals = torch.cat([refs[top], prop_wh[:, None], prop_wh[:, None]],
                          dim=-1)
    ref_boxes = torch.sigmoid(
        _box_mlp(enc_mem[top], params["enc_box"])
        + _logit(torch.clamp(proposals, 1e-4, 1 - 1e-4)))  # (K, 4) cxcywh
    q = params["tgt_emb"][:k]

    for layer in params["dec"]:
        ref_in = ref_boxes
        pos = _mlp(_sine_embed_boxes(ref_in, cfg.dim), params["ref_head"],
                   F.relu)
        qp = q + pos
        q = _apply_ln(q + _attend(qp, qp, q, layer["self_attn"], cfg.heads),
                      layer["self_norm"])
        q = _apply_ln(
            q + _attend(q + pos, txt, txt, layer["ca_text"], cfg.heads,
                        add),
            layer["ca_text_norm"])
        q = _apply_ln(
            q + ms_deform_attn(q + pos, ref_in[:, :2], src, shapes,
                               layer["msda"], cfg.heads, cfg.points,
                               ref_wh=ref_in[:, 2:]),
            layer["msda_norm"])
        q = _apply_ln(q + _mlp(q, layer["ffn"], F.relu), layer["ffn_norm"])
        # Iterative box refinement: a delta in logit space, from the
        # UN-normed layer output.
        delta = _box_mlp(q, params["bbox_head"])
        ref_boxes = torch.sigmoid(
            delta + _logit(torch.clamp(ref_in, 1e-4, 1 - 1e-4)))

    # The returned boxes and logits come from the LayerNorm-ed decoder
    # state against the reference INTO the last layer.
    q = _apply_ln(q, params["dec_norm"])
    out_boxes = torch.sigmoid(
        _box_mlp(q, params["bbox_head"])
        + _logit(torch.clamp(ref_in, 1e-4, 1 - 1e-4)))
    out_logits = torch.matmul(q, txt.T)
    out_logits = torch.where(token_mask[None, :], out_logits,
                             torch.full_like(out_logits, NEG))
    return {
        "boxes": out_boxes,  # (K, 4) cxcywh in [0, 1]
        "scores": torch.sigmoid(out_logits.max(dim=-1).values),  # (K,)
        "logits": out_logits,
        "top": top,
    }


# ---------------------------------------------------------------------------
# Grounder seam + converter
# ---------------------------------------------------------------------------


class HashTokenizer:
    """Weight-free stand-in tokenizer: stable token ids from word hashes.

    Real deployments pass a BERT WordPiece tokenizer
    (`guidance.wordpiece.WordPieceTokenizer`) via
    `DinoGrounder(tokenizer=...)`.
    """

    def __init__(self, vocab: int, max_len: int):
        self.vocab = vocab
        self.max_len = max_len

    def __call__(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        words = text.lower().replace(".", " .").split()[: self.max_len - 2]
        ids = [101 % self.vocab]
        for w in words:
            hx = int(hashlib.sha256(w.encode()).hexdigest(), 16)
            ids.append(2 + hx % (self.vocab - 3))
        ids.append(102 % self.vocab)
        tok = np.zeros((self.max_len,), np.int32)
        tok[: len(ids)] = ids
        mask = np.zeros((self.max_len,), bool)
        mask[: len(ids)] = True
        return tok, mask


class DinoGrounder:
    """`Grounder` seam backed by GroundingDINO (text → best box, xyxy px).

    `taps`, when a list, receives one dict per call: `gdino_ground`'s
    outputs as computed (`boxes`, `scores`, `logits`, `top`) and the box
    returned (`box`) — the seam through which a caller reads what a call
    did."""

    def __init__(self, params: Params, cfg: GDINOConfig = TEST_GDINO,
                 tokenizer=None, box_threshold: float = 0.0,
                 image_size: int = 256, device=None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.tokenizer = tokenizer or HashTokenizer(cfg.vocab,
                                                    cfg.max_text_len)
        self.box_threshold = box_threshold
        self.image_size = image_size
        self.taps = None

    @classmethod
    def random_init(cls, gen: torch.Generator, cfg: GDINOConfig = TEST_GDINO,
                    **kw) -> "DinoGrounder":
        """Random weights drawn from `gen` on its device."""
        return cls(init_gdino_params(gen, cfg), cfg, **kw)

    def _tokenize(self, prompt: str):
        """(tokens, mask)-tuple tokenizers (HashTokenizer,
        WordPieceTokenizer) and `BatchEncoding`-like ones (a mapping with
        "input_ids"), padded to max_text_len."""
        out = self.tokenizer(prompt)
        if isinstance(out, tuple):
            return out
        ids = np.asarray(out["input_ids"], np.int32).reshape(-1)
        ml = self.cfg.max_text_len
        tok = np.zeros((ml,), np.int32)
        mask = np.zeros((ml,), bool)
        n = min(len(ids), ml)
        tok[:n] = ids[:n]
        mask[:n] = True
        return tok, mask

    def ground(self, image, prompt: str) -> np.ndarray:
        """(H, W, 3) image in [0, 1], an array or a tensor → xyxy pixel
        box."""
        from youreditableavatar_tpu_torch.stages.edit_texture import (
            _resize_bilinear)

        h, w = image.shape[:2]
        s = self.image_size
        dev = self.device
        tok, mask = self._tokenize(prompt)
        with torch.no_grad():
            img = _resize_bilinear(to_device(image, dev, torch.float32), s, s)
            out = gdino_ground(self.params, img,
                               to_device(np.asarray(tok), dev),
                               to_device(np.asarray(mask), dev), self.cfg)
        scores = to_host(out["scores"])
        best = int(scores.argmax())
        if scores[best] < self.box_threshold:
            box = np.asarray([0.0, 0.0, float(w), float(h)], np.float32)
        else:
            cx, cy, bw, bh = to_host(out["boxes"][best])
            box = np.asarray(
                [(cx - bw / 2) * w, (cy - bh / 2) * h,
                 (cx + bw / 2) * w, (cy + bh / 2) * h],
                np.float32,
            )
            box = np.clip(box, 0.0, [w, h, w, h]).astype(np.float32)
        if self.taps is not None:
            self.taps.append({**out, "box": box})
        return box


def convert_torch_gdino(sd: Dict[str, Any],
                        cfg: GDINOConfig = SWIN_T_GDINO) -> Params:
    """Map the official `groundingdino_swint_ogc.pth` state dict to the
    parameter tree (f32 CPU tensors); `model.` prefixes are stripped.

    Covers the Swin backbone, the embedded BERT, the input projections, the
    feature enhancer's and decoder's attention and deformable modules, the
    bi-attention, the query embeddings and the box heads."""
    sd = {k[6:] if k.startswith("model.") else k: v for k, v in sd.items()}

    def g(name):
        return t2t(sd[name])

    def lin(prefix):
        return {"w": g(prefix + ".weight").t().contiguous(),
                "b": g(prefix + ".bias")}

    def ln(prefix):
        return {"g": g(prefix + ".weight"), "b": g(prefix + ".bias")}

    def mha(prefix):
        return {**_split_qkv(g(prefix + ".in_proj_weight"),
                             g(prefix + ".in_proj_bias")),
                "o": lin(prefix + ".out_proj")}

    def msda(prefix):
        return {
            "sampling": lin(prefix + ".sampling_offsets"),
            "attn_w": lin(prefix + ".attention_weights"),
            "value": lin(prefix + ".value_proj"),
            "output": lin(prefix + ".output_proj"),
        }

    p: Params = {"swin": {"stages": [], "out_norms": []}, "bert": {},
                 "in_proj": [], "enc": [], "dec": []}
    bb = "backbone.0."
    p["swin"]["patch_proj"] = {
        "w": g(bb + "patch_embed.proj.weight").permute(2, 3, 1, 0)
        .contiguous(),
        "b": g(bb + "patch_embed.proj.bias"),
    }
    p["swin"]["patch_norm"] = ln(bb + "patch_embed.norm")
    for si, depth in enumerate(cfg.depths):
        sp = f"{bb}layers.{si}."
        stage: Params = {"blocks": []}
        for bi in range(depth):
            bp = f"{sp}blocks.{bi}."
            stage["blocks"].append({
                "norm1": ln(bp + "norm1"),
                "attn": {**_split_qkv(g(bp + "attn.qkv.weight"),
                                      g(bp + "attn.qkv.bias")),
                         "o": lin(bp + "attn.proj")},
                "rel_bias": g(bp + "attn.relative_position_bias_table"),
                "norm2": ln(bp + "norm2"),
                "mlp": {"fc1": lin(bp + "mlp.fc1"),
                        "fc2": lin(bp + "mlp.fc2")},
            })
        if si < len(cfg.depths) - 1:
            stage["merge_norm"] = ln(sp + "downsample.norm")
            stage["merge"] = {
                "w": g(sp + "downsample.reduction.weight").t().contiguous()}
        p["swin"]["stages"].append(stage)
    for i in (1, 2, 3):
        p["swin"]["out_norms"].append(ln(bb + f"norm{i}"))

    bp = "bert.bert." if "bert.bert.embeddings.word_embeddings.weight" in sd \
        else "bert."
    p["bert"]["tok_emb"] = g(bp + "embeddings.word_embeddings.weight")
    p["bert"]["pos_emb"] = g(bp + "embeddings.position_embeddings.weight")
    p["bert"]["type_emb"] = g(bp + "embeddings.token_type_embeddings.weight")
    p["bert"]["emb_norm"] = ln(bp + "embeddings.LayerNorm")
    p["bert"]["layers"] = []
    for li in range(cfg.text_layers):
        lp = f"{bp}encoder.layer.{li}."
        p["bert"]["layers"].append({
            "attn": {
                "q": lin(lp + "attention.self.query"),
                "k": lin(lp + "attention.self.key"),
                "v": lin(lp + "attention.self.value"),
                "o": lin(lp + "attention.output.dense"),
            },
            "attn_norm": ln(lp + "attention.output.LayerNorm"),
            "mlp": {"fc1": lin(lp + "intermediate.dense"),
                    "fc2": lin(lp + "output.dense")},
            "mlp_norm": ln(lp + "output.LayerNorm"),
        })

    for i in range(3):
        p["in_proj"].append({
            "lin": {"w": g(f"input_proj.{i}.0.weight")[:, :, 0, 0].t()
                    .contiguous(),
                    "b": g(f"input_proj.{i}.0.bias")},
            "norm": ln(f"input_proj.{i}.1"),
        })
    p["extra_proj"] = {
        "w": g("input_proj.3.0.weight").permute(2, 3, 1, 0).contiguous(),
        "b": g("input_proj.3.0.bias"),
        "norm": ln("input_proj.3.1"),
    }
    p["level_emb"] = g("transformer.level_embed")
    p["feat_map"] = lin("feat_map")
    for li in range(cfg.enc_layers):
        ep = f"transformer.encoder.layers.{li}."
        tp = f"transformer.encoder.text_layers.{li}."
        fp = f"transformer.encoder.fusion_layers.{li}."
        p["enc"].append({
            "msda": msda(ep + "self_attn"),
            "msda_norm": ln(ep + "norm1"),
            "ffn": {"fc1": lin(ep + "linear1"), "fc2": lin(ep + "linear2")},
            "ffn_norm": ln(ep + "norm2"),
            "txt_attn": mha(tp + "self_attn"),
            "txt_norm": ln(tp + "norm1"),
            "txt_ffn": {"fc1": lin(tp + "linear1"),
                        "fc2": lin(tp + "linear2")},
            "txt_ffn_norm": ln(tp + "norm2"),
            "bi": {
                "ln_v": ln(fp + "layer_norm_v"),
                "ln_t": ln(fp + "layer_norm_l"),
                "v_proj": lin(fp + "attn.v_proj"),
                "t_proj": lin(fp + "attn.l_proj"),
                "values_v": lin(fp + "attn.values_v_proj"),
                "values_t": lin(fp + "attn.values_l_proj"),
                "out_v": lin(fp + "attn.out_v_proj"),
                "out_t": lin(fp + "attn.out_l_proj"),
                "gamma_v": g(fp + "gamma_v"),
                "gamma_t": g(fp + "gamma_l"),
            },
        })
    p["enc_out"] = {"lin": lin("transformer.enc_output"),
                    "norm": ln("transformer.enc_output_norm")}
    p["enc_box"] = _box_from(sd, "transformer.enc_out_bbox_embed")
    p["tgt_emb"] = g("transformer.tgt_embed.weight")
    p["ref_head"] = {
        "fc1": lin("transformer.decoder.ref_point_head.layers.0"),
        "fc2": lin("transformer.decoder.ref_point_head.layers.1"),
    }
    for li in range(cfg.dec_layers):
        dp = f"transformer.decoder.layers.{li}."
        p["dec"].append({
            "self_attn": mha(dp + "self_attn"),
            "self_norm": ln(dp + "norm2"),
            "ca_text": mha(dp + "ca_text"),
            "ca_text_norm": ln(dp + "catext_norm"),
            "msda": msda(dp + "cross_attn"),
            "msda_norm": ln(dp + "norm1"),
            "ffn": {"fc1": lin(dp + "linear1"), "fc2": lin(dp + "linear2")},
            "ffn_norm": ln(dp + "norm3"),
        })
    p["dec_norm"] = ln("transformer.decoder.norm")
    p["bbox_head"] = _box_from(sd, "bbox_embed.0")
    return p


def _split_qkv(w: Tensor, b: Tensor) -> Params:
    """A packed (3D, D) in-projection and its bias → q / k / v linears."""
    wq, wk, wv = torch.chunk(w, 3, dim=0)
    bq, bk, bv = torch.chunk(b, 3, dim=0)
    return {
        "q": {"w": wq.t().contiguous(), "b": bq.contiguous()},
        "k": {"w": wk.t().contiguous(), "b": bk.contiguous()},
        "v": {"w": wv.t().contiguous(), "b": bv.contiguous()},
    }


def _box_from(sd, prefix) -> Params:
    def lin(name):
        return {"w": t2t(sd[name + ".weight"]).t().contiguous(),
                "b": t2t(sd[name + ".bias"])}

    return {"l1": lin(prefix + ".layers.0"), "l2": lin(prefix + ".layers.1"),
            "l3": lin(prefix + ".layers.2")}
