# Frozen copy of youreditableavatar_tpu_torch/guidance/grounding_dino.py (the random init, the forward pass, the hash tokenizer and the grounder's box only).
"""GroundingDINO (Swin-T OGC) as plain PyTorch: the text → box half of
LangSAM — the Swin-T backbone, the BERT-base text tower, the feature
enhancer (deformable self-attention, text self-attention, bidirectional
image ↔ text attention), language-guided query selection, the
cross-modality decoder with iterative box refinement and contrastive
logits. The deformable sampling is `F.grid_sample` (bilinear, zero
padding, `align_corners=False`), one call per level over every head.

Where this departs from IDEA-Research/GroundingDINO
(`GroundingDINO_SwinT_OGC.py`, `groundingdino/models/GroundingDINO`), as
the port does:
  * the input projections' GroupNorm(32, 256) is a LayerNorm over the
    channels;
  * Swin pads each stage to a window multiple once (the padded tokens,
    LayerNorm-ed to its bias, run through the stage's blocks) where the
    published block pads its normed input with zeros in every block;
  * the text tower attends over the whole phrase under a padding mask (no
    sub-sentence masks or per-phrase position ids), with the hash
    tokenizer below in place of BERT's WordPiece vocabulary;
  * padded text tokens are masked with −1e9, not −inf;
  * the image is resized to a square `image_size` (800² for the square
    probes: the published short side of 800);
  * the grounder keeps the one best-scoring box, where LangSAM keeps every
    box over the threshold.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from benchmark.reference.sam import resize_bilinear
from benchmark.reference.sd_layers import _randn, _zeros, conv2d

Params = Dict[str, Any]

NEG = -1e9


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



def _apply_ln(x, p, eps=1e-5):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * p["g"] + p["b"]


def _apply_linear(x, p):
    return torch.matmul(x, p["w"]) + p["b"]


def _mha(q_in, k_in, v_in, p, h, mask=None):
    """Dense multi-head attention over (..., L, D); `mask` (..., Q, K)
    additive."""
    q = _apply_linear(q_in, p["q"])
    k = _apply_linear(k_in, p["k"])
    v = _apply_linear(v_in, p["v"])

    def split(x):
        return x.reshape(*x.shape[:-1], h, -1).transpose(-3, -2)

    qh, kh, vh = split(q), split(k), split(v)
    att = torch.matmul(qh, kh.transpose(-1, -2)) / np.sqrt(qh.shape[-1])
    if mask is not None:
        att = att + mask
    att = torch.softmax(att, dim=-1)
    out = torch.matmul(att, vh).transpose(-3, -2)
    out = out.reshape(*out.shape[:-2], -1)
    return _apply_linear(out, p["o"])


def _gelu_exact(x):
    # torch nn.GELU's default, the exact erf GELU (Swin and BERT).
    return F.gelu(x)


def _mlp(x, p, act=_gelu_exact):
    return _apply_linear(act(_apply_linear(x, p["fc1"])), p["fc2"])


def _text_mask(token_mask: Tensor, dtype) -> Tensor:
    """(T,) bool → (1, 1, T) additive mask."""
    zero = torch.zeros((), dtype=dtype, device=token_mask.device)
    return torch.where(token_mask[None, None, :], zero, zero + NEG)


@functools.lru_cache(maxsize=8)
def _rel_index(window: int) -> np.ndarray:
    """(W², W²) index into the (2W−1)² relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + window - 1
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


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
    idx = torch.as_tensor(_rel_index(window), device=x.device)
    bias = p["rel_bias"][idx]  # (W², W², heads)
    bias = bias.permute(2, 0, 1)[None]  # (1, heads, W², W²)
    if shift:
        # Mask attention across wrapped-window boundaries.
        mw = torch.as_tensor(_shift_regions(h, wd, window, shift),
                             device=x.device)
        amask = torch.where(mw[:, None, :] != mw[:, :, None],
                            torch.tensor(NEG, dtype=x.dtype, device=x.device),
                            torch.tensor(0.0, dtype=x.dtype, device=x.device))
        mask = bias + amask[:, None]
    else:
        mask = bias
    wins = _mha(wins, wins, wins, p["attn"], heads, mask=mask)
    x = _window_merge(wins, h, wd, window)
    if shift:
        x = torch.roll(x, (shift, shift), dims=(0, 1))
    x = res + x
    return x + _mlp(_apply_ln(x, p["norm2"]), p["mlp"])


def _pad_to(x, mult):
    h, w = x.shape[:2]
    ph = (-h) % mult
    pw = (-w) % mult
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    return x


def swin_backbone(p: Params, image: Tensor, cfg: GDINOConfig) -> List[Tensor]:
    """(H, W, 3) in [0, 1] → [(H/8, W/8, 2d), (H/16, ·, 4d), (H/32, ·, 8d)]."""
    mean = torch.tensor([0.485, 0.456, 0.406], dtype=image.dtype,
                        device=image.device)
    std = torch.tensor([0.229, 0.224, 0.225], dtype=image.dtype,
                       device=image.device)
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
            x = torch.matmul(_apply_ln(x, stage["merge_norm"]),
                             stage["merge"]["w"])
    return outs


def bert_encode(p: Params, tokens: Tensor, attn_mask: Tensor,
                heads: int = 2) -> Tensor:
    """(T,) int tokens + (T,) bool mask → (T, text_dim) features."""
    t = tokens.shape[0]
    x = p["tok_emb"][tokens.long()] + p["pos_emb"][:t] + p["type_emb"][0]
    x = _apply_ln(x, p["emb_norm"])
    add = _text_mask(attn_mask, x.dtype)
    for layer in p["layers"]:
        # Post-LN residual blocks (BERT convention).
        x = _apply_ln(x + _mha(x, x, x, layer["attn"], heads, mask=add),
                      layer["attn_norm"])
        x = _apply_ln(x + _mlp(x, layer["mlp"]), layer["mlp_norm"])
    return x


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


def ms_deform_attn(query, ref_xy, value_flat, shapes, p, h, pt,
                   ref_wh=None):
    """Official MSDeformAttn sampling rules (the `grid_sample` form of
    `multi_scale_deformable_attn_pytorch`)."""
    lv = len(shapes)
    q, d = query.shape
    dh = d // h
    off = _apply_linear(query, p["sampling"]).reshape(q, h, lv, pt, 2)
    aw = _apply_linear(query, p["attn_w"]).reshape(q, h, lv * pt)
    aw = torch.softmax(aw, dim=-1).reshape(q, h, lv, pt)
    val = _apply_linear(value_flat, p["value"]).reshape(-1, h, dh)

    out = torch.zeros((q, h, dh), dtype=query.dtype, device=query.device)
    start = 0
    for li, (hl, wl) in enumerate(shapes):
        n = hl * wl
        lvl = val[start:start + n].reshape(hl, wl, h, dh)
        start += n
        if ref_wh is None:
            wh = torch.tensor([wl, hl], dtype=query.dtype,
                              device=query.device)
            xy = ref_xy[:, None, None, :] + off[:, :, li] / wh
        else:
            xy = (ref_xy[:, None, None, :]
                  + off[:, :, li] / pt * ref_wh[:, None, None, :] * 0.5)
        s = _bilinear_sample_heads(lvl, xy)  # (Q, h, pt, dh)
        out = out + torch.sum(s * aw[:, :, li, :, None], dim=2)
    return _apply_linear(out.reshape(q, d), p["output"])


def _bi_attention(img, txt, txt_mask, p, h):
    """GroundingDINO BiMultiHeadAttention: one image–text similarity
    softmaxed both ways, layer-scale-gated residuals."""
    vi = _apply_ln(img, p["ln_v"])
    ti = _apply_ln(txt, p["ln_t"])
    qv = _apply_linear(vi, p["v_proj"])
    qt = _apply_linear(ti, p["t_proj"])
    vv = _apply_linear(vi, p["values_v"])
    vt = _apply_linear(ti, p["values_t"])

    def split(x):
        return x.reshape(x.shape[0], h, -1).transpose(0, 1)

    qvh, qth, vvh, vth = split(qv), split(qt), split(vv), split(vt)
    sim = torch.matmul(qvh, qth.transpose(-1, -2)) / np.sqrt(qvh.shape[-1])
    sim = sim + _text_mask(txt_mask, sim.dtype)  # (h, I, T)
    a_v2t = torch.softmax(sim, dim=-1)  # image attends text
    a_t2v = torch.softmax(sim.transpose(-1, -2), dim=-1)
    dv = torch.matmul(a_v2t, vth).transpose(0, 1).reshape(img.shape[0], -1)
    dt = torch.matmul(a_t2v, vvh).transpose(0, 1).reshape(txt.shape[0], -1)
    img = img + p["gamma_v"] * _apply_linear(dv, p["out_v"])
    txt = txt + p["gamma_t"] * _apply_linear(dt, p["out_t"])
    return img, txt


def _box_mlp(x, p):
    x = F.relu(_apply_linear(x, p["l1"]))
    x = F.relu(_apply_linear(x, p["l2"]))
    return _apply_linear(x, p["l3"])


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


def init_gdino_params(gen, cfg: GDINOConfig) -> Params:
    """Random weights in the parameter tree's layout, drawn from `gen` (a
    `torch.Generator` or a `benchmark.core.weights.Pool`). The fusion's
    layer scales (`gamma_v`, `gamma_t`) start at the published 1e-4."""
    d, dev = cfg.dim, gen.device

    def lin(din, dout, scale=None):
        scale = scale if scale is not None else din ** -0.5
        return {"w": _randn(gen, (din, dout)) * scale,
                "b": _zeros(gen, (dout,))}

    def ln(c):
        return {"g": torch.ones((c,), device=dev), "b": _zeros(gen, (c,))}

    def mha(c):
        return {"q": lin(c, c), "k": lin(c, c), "v": lin(c, c),
                "o": lin(c, c)}

    def mlp(c, hidden, dout=None):
        return {"fc1": lin(c, hidden), "fc2": lin(hidden, dout or c)}

    def msda():
        h, lv, pt = cfg.heads, cfg.levels, cfg.points
        return {"sampling": lin(d, h * lv * pt * 2, 0.01),
                "attn_w": lin(d, h * lv * pt, 0.01),
                "value": lin(d, d), "output": lin(d, d)}

    def box_mlp():
        return {"l1": lin(d, d), "l2": lin(d, d), "l3": lin(d, 4)}

    sd = cfg.swin_dim
    swin: Params = {
        "patch_proj": {"w": _randn(gen, (cfg.patch, cfg.patch, 3, sd)) * 0.05,
                       "b": _zeros(gen, (sd,))},
        "patch_norm": ln(sd),
        "stages": [],
        "out_norms": [ln(sd * 2), ln(sd * 4), ln(sd * 8)],
    }
    for si, depth in enumerate(cfg.depths):
        dim = sd * (2 ** si)
        stage: Params = {"blocks": [{
            "norm1": ln(dim), "attn": mha(dim),
            "rel_bias": _randn(gen, ((2 * cfg.window - 1) ** 2,
                                     cfg.num_heads[si])) * 0.02,
            "norm2": ln(dim), "mlp": mlp(dim, 4 * dim),
        } for _ in range(depth)]}
        if si < len(cfg.depths) - 1:
            stage["merge_norm"] = ln(4 * dim)
            stage["merge"] = {
                "w": _randn(gen, (4 * dim, 2 * dim)) * (4 * dim) ** -0.5}
        swin["stages"].append(stage)

    td = cfg.text_dim
    bert: Params = {
        "tok_emb": _randn(gen, (cfg.vocab, td)) * 0.02,
        "pos_emb": _randn(gen, (cfg.max_text_len, td)) * 0.02,
        "type_emb": _randn(gen, (2, td)) * 0.02,
        "emb_norm": ln(td),
        "layers": [{"attn": mha(td), "attn_norm": ln(td),
                    "mlp": mlp(td, 4 * td), "mlp_norm": ln(td)}
                   for _ in range(cfg.text_layers)],
    }

    def enc_layer():
        return {
            "msda": msda(), "msda_norm": ln(d),
            "ffn": mlp(d, cfg.ffn), "ffn_norm": ln(d),
            "txt_attn": mha(d), "txt_norm": ln(d),
            "txt_ffn": mlp(d, cfg.ffn), "txt_ffn_norm": ln(d),
            "bi": {"ln_v": ln(d), "ln_t": ln(d),
                   "v_proj": lin(d, d), "t_proj": lin(d, d),
                   "values_v": lin(d, d), "values_t": lin(d, d),
                   "out_v": lin(d, d), "out_t": lin(d, d),
                   "gamma_v": torch.full((d,), 1e-4, device=dev),
                   "gamma_t": torch.full((d,), 1e-4, device=dev)},
        }

    def dec_layer():
        return {"self_attn": mha(d), "self_norm": ln(d),
                "ca_text": mha(d), "ca_text_norm": ln(d),
                "msda": msda(), "msda_norm": ln(d),
                "ffn": mlp(d, cfg.ffn), "ffn_norm": ln(d)}

    swin_dims = [sd * 2, sd * 4, sd * 8]
    return {
        "swin": swin,
        "bert": bert,
        "in_proj": [{"lin": lin(c, d), "norm": ln(d)} for c in swin_dims],
        "extra_proj": {"w": _randn(gen, (3, 3, swin_dims[-1], d)) * 0.02,
                       "b": _zeros(gen, (d,)), "norm": ln(d)},
        "level_emb": _randn(gen, (cfg.levels, d)) * 0.02,
        "feat_map": lin(td, d),
        "enc": [enc_layer() for _ in range(cfg.enc_layers)],
        "enc_out": {"lin": lin(d, d), "norm": ln(d)},
        "enc_box": box_mlp(),
        "tgt_emb": _randn(gen, (cfg.num_queries, d)) * 0.02,
        "ref_head": mlp(2 * d, d, d),
        "dec": [dec_layer() for _ in range(cfg.dec_layers)],
        "dec_norm": ln(d),
        "bbox_head": box_mlp(),
    }


def _top_queries(score: Tensor, k: int) -> Tensor:
    """Indices of the `k` largest scores, largest first; among equal scores
    the lower index first (`jax.lax.top_k`'s order)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def gdino_ground(params: Params, image: Tensor, tokens: Tensor,
                 token_mask: Tensor, cfg: GDINOConfig,
                 picks: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """Image + tokenized phrase → cxcywh boxes in [0, 1], sigmoid scores,
    logits over the text tokens and the selected encoder tokens (`top`);
    `picks` given, those tokens are taken in place of the top-k."""
    feats = swin_backbone(params["swin"], image, cfg)
    dt, dev = image.dtype, image.device
    levels = [_apply_ln(_apply_linear(f, proj["lin"]), proj["norm"])
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
    txt = _apply_linear(txt, params["feat_map"])  # (T, dim)
    add = _text_mask(token_mask, txt.dtype)

    for layer in params["enc"]:
        src, txt = _bi_attention(src, txt, token_mask, layer["bi"],
                                 cfg.heads)
        txt = _apply_ln(
            txt + _mha(txt, txt, txt, layer["txt_attn"], cfg.heads,
                       mask=add),
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
    enc_mem = _apply_ln(_apply_linear(src, params["enc_out"]["lin"]),
                        params["enc_out"]["norm"])
    logits = torch.matmul(enc_mem, txt.T)  # (S, T)
    logits = torch.where(token_mask[None, :], logits,
                         torch.full_like(logits, NEG))
    score = logits.max(dim=-1).values
    k = min(cfg.num_queries, score.shape[0])
    top = _top_queries(score, k) if picks is None else picks
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
        q = _apply_ln(q + _mha(qp, qp, q, layer["self_attn"], cfg.heads),
                      layer["self_norm"])
        q = _apply_ln(
            q + _mha(q + pos, txt, txt, layer["ca_text"], cfg.heads,
                     mask=add),
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


def ground(params: Params, cfg: GDINOConfig, image: np.ndarray, prompt: str,
           image_size: int, box_threshold: float, device,
           picks: Optional[Tensor] = None):
    """(gdino_ground's outputs, the xyxy pixel box kept) for a host (H, W,
    3) image in [0, 1], as the grounder computes them."""
    h, w = image.shape[:2]
    tok, mask = HashTokenizer(cfg.vocab, cfg.max_text_len)(prompt)
    with torch.no_grad():
        img = resize_bilinear(torch.tensor(np.asarray(image, np.float32),
                                           device=device),
                              image_size, image_size)
        out = gdino_ground(params, img, torch.tensor(tok, device=device),
                           torch.tensor(mask, device=device), cfg, picks)
    return out, kept_boxes(out, h, w, box_threshold)[0]


def kept_boxes(out: Dict[str, Tensor], h: int, w: int, box_threshold: float,
               tie: float = 0.0) -> List[np.ndarray]:
    """The xyxy pixel boxes the grounder may keep from `gdino_ground`'s
    outputs: each query's whose score is within `tie` of the best, best
    first, where the best is within `tie` of the threshold or over it;
    the whole frame where the best is within `tie` of the threshold or
    under it. With no `tie`, the one box the grounder keeps."""
    scores = out["scores"].cpu().numpy()
    boxes = out["boxes"].cpu().numpy()
    top = float(scores.max())
    kept = []
    if top + tie >= box_threshold:
        for q in np.argsort(-scores, kind="stable"):
            if scores[q] < top - tie:
                break
            cx, cy, bw, bh = boxes[q]
            box = np.asarray([(cx - bw / 2) * w, (cy - bh / 2) * h,
                              (cx + bw / 2) * w, (cy + bh / 2) * h],
                             np.float32)
            kept.append(np.clip(box, 0.0, [w, h, w, h]).astype(np.float32))
    if top - tie < box_threshold:
        kept.append(np.asarray([0.0, 0.0, float(w), float(h)], np.float32))
    return kept
