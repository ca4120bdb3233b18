# Frozen copy of youreditableavatar_tpu_torch/guidance/sam.py (the random init, the forward pass and the segmenter's mask logits only).
"""Segment Anything (SAM) as plain PyTorch: the box-prompted mask logits of
one image, as LangSAM asks for them.

  * the ViT-det image encoder: 16×16 patch embed, absolute position
    embedding, windowed attention with a decomposed relative-position bias,
    global attention at the configured blocks, the 256-channel neck;
  * the prompt encoder: random-Fourier positional encoding and the box
    corner embeddings;
  * the mask decoder: the two-way transformer, the 2× transposed-convolution
    upscaling, the per-token hypernetwork MLPs and the IoU head.

Parameter trees in the port's layout (NHWC activations, HWIO kernels, (in,
out) linears, the transposed convolutions' kernels spatially flipped).

Where this departs from facebookresearch/segment-anything (`build_sam_vit_h`
and `SamPredictor`), as the port does:
  * the image is a float array in [0, 1], resized on its longest side by
    `F.interpolate(bilinear, antialias=True)` (`apply_image_torch`'s rule;
    `apply_image` resizes a uint8 image with PIL);
  * the low-resolution mask logits are cropped to the resized image and
    resized once to the input size (the published post-processing
    upsamples to 1024², crops, then resizes);
  * only box prompts: no point or mask prompt path, no `get_rel_pos`
    interpolation (the tables already have the sizes used);
  * attention logits are (q·kᵀ)/√d rather than (q/√d)·kᵀ (equal up to
    rounding).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from benchmark.reference.sd_layers import (
    Params, _randn, _zeros, conv2d, init_linear, init_norm, linear,
    stats_dtype)
from benchmark.reference.sd_layers import layer_norm as _layer_norm_eps


def resize_bilinear(img: Tensor, height: int, width: int) -> Tensor:
    """(H, W) or (H, W, C) bilinear resize with half-pixel centres,
    antialiased when it shrinks (the port's
    `stages/edit_texture._resize_bilinear`)."""
    squeeze = img.dim() == 2
    x = img[..., None] if squeeze else img
    x = F.interpolate(x.permute(2, 0, 1)[None], size=(height, width),
                      mode="bilinear", align_corners=False, antialias=True)
    x = x[0].permute(1, 2, 0)
    return x[..., 0] if squeeze else x


def layer_norm(x: Tensor, p: Params) -> Tensor:
    return _layer_norm_eps(x, p, eps=1e-6)


def layer_norm_dec(x: Tensor, p: Params) -> Tensor:
    return _layer_norm_eps(x, p, eps=1e-5)


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch: int = 16
    embed_dim: int = 1280
    depth: int = 32
    heads: int = 16
    window: int = 14
    global_idx: Tuple[int, ...] = (7, 15, 23, 31)
    neck_dim: int = 256
    decoder_heads: int = 8
    decoder_depth: int = 2
    num_mask_tokens: int = 4

    @property
    def grid(self) -> int:
        return self.img_size // self.patch


def init_sam_params(gen, cfg: SAMConfig) -> Params:
    """Random weights in the parameter tree's layout, drawn from `gen` (a
    `torch.Generator` or a `benchmark.core.weights.Pool`)."""
    d, g = cfg.embed_dim, cfg.grid
    hd = d // cfg.heads
    enc: Params = {
        "patch": {"w": _randn(gen, (cfg.patch, cfg.patch, 3, d)) * 0.02,
                  "b": _zeros(gen, (d,))},
        "pos": _randn(gen, (1, g, g, d)) * 0.02,
        "blocks": [],
        "neck1": {"w": _randn(gen, (1, 1, d, cfg.neck_dim)) * 0.02},
        "neck_ln1": init_norm(gen, cfg.neck_dim),
        "neck2": {"w": _randn(gen, (3, 3, cfg.neck_dim, cfg.neck_dim))
                  * 0.02},
        "neck_ln2": init_norm(gen, cfg.neck_dim),
    }
    for i in range(cfg.depth):
        size = g if i in cfg.global_idx else cfg.window
        enc["blocks"].append({
            "ln1": init_norm(gen, d),
            "qkv": init_linear(gen, d, 3 * d),
            "proj": init_linear(gen, d, d),
            "rel_h": _randn(gen, (2 * size - 1, hd)) * 0.02,
            "rel_w": _randn(gen, (2 * size - 1, hd)) * 0.02,
            "ln2": init_norm(gen, d),
            "fc1": init_linear(gen, d, 4 * d),
            "fc2": init_linear(gen, 4 * d, d),
        })

    dd = cfg.neck_dim

    def attn(internal):
        return {"q": init_linear(gen, dd, internal),
                "k": init_linear(gen, dd, internal),
                "v": init_linear(gen, dd, internal),
                "out": init_linear(gen, internal, dd)}

    def mlp3(dout):
        return [init_linear(gen, dd, dd), init_linear(gen, dd, dd),
                init_linear(gen, dd, dout)]

    dec: Params = {
        "iou_token": _randn(gen, (1, dd)) * 0.02,
        "mask_tokens": _randn(gen, (cfg.num_mask_tokens, dd)) * 0.02,
        "layers": [],
        "final_attn": attn(dd // 2),
        "norm_final": init_norm(gen, dd),
        "up1": {"w": _randn(gen, (2, 2, dd, dd // 4)) * 0.02,
                "b": _zeros(gen, (dd // 4,))},
        "up_ln": init_norm(gen, dd // 4),
        "up2": {"w": _randn(gen, (2, 2, dd // 4, dd // 8)) * 0.02,
                "b": _zeros(gen, (dd // 8,))},
        "hyper": [mlp3(dd // 8) for _ in range(cfg.num_mask_tokens)],
        "iou_head": mlp3(cfg.num_mask_tokens),
    }
    for _ in range(cfg.decoder_depth):
        dec["layers"].append({
            "self_attn": attn(dd),
            "ln1": init_norm(gen, dd),
            "cross_t2i": attn(dd // 2),
            "ln2": init_norm(gen, dd),
            "fc1": init_linear(gen, dd, 8 * dd),
            "fc2": init_linear(gen, 8 * dd, dd),
            "ln3": init_norm(gen, dd),
            "cross_i2t": attn(dd // 2),
            "ln4": init_norm(gen, dd),
        })

    prm: Params = {
        "pe_gaussian": _randn(gen, (2, dd // 2)),
        "point_emb": _randn(gen, (4, dd)) * 0.02,
        "not_a_point": _randn(gen, (1, dd)) * 0.02,
        "no_mask": _randn(gen, (1, dd)) * 0.02,
    }
    return {"encoder": enc, "decoder": dec, "prompt": prm}


def _mlp3(x: Tensor, p) -> Tensor:
    x = F.relu(linear(x, p[0]))
    x = F.relu(linear(x, p[1]))
    return linear(x, p[2])


def _attn(q, k, v, p, heads):
    qq, kk, vv = linear(q, p["q"]), linear(k, p["k"]), linear(v, p["v"])
    b, n, c = qq.shape
    hd = c // heads
    qq = qq.reshape(b, n, heads, hd).transpose(1, 2)
    kk = kk.reshape(b, -1, heads, hd).transpose(1, 2)
    vv = vv.reshape(b, -1, heads, hd).transpose(1, 2)
    logits = torch.matmul(qq, kk.transpose(-1, -2)).to(
        stats_dtype(q.dtype)) / math.sqrt(hd)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(w, vv)
    return linear(o.transpose(1, 2).reshape(b, n, c), p["out"])


def _rel_pos_bias(size: int, rel: Tensor) -> Tensor:
    coords = torch.arange(size, device=rel.device)
    idx = coords[:, None] - coords[None, :] + (size - 1)
    return rel[idx]


def _window_attention(x: Tensor, p: Params, heads: int) -> Tensor:
    """Attention over (B*, size, size, D) windows with the decomposed
    relative-position bias (`Attention.forward` + `add_decomposed_rel_pos`)."""
    b, h, w, d = x.shape
    hd = d // heads
    qkv = linear(x.reshape(b, h * w, d), p["qkv"])
    qkv = qkv.reshape(b, h * w, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = torch.matmul(q, k.transpose(-1, -2)).to(
        stats_dtype(x.dtype)) / math.sqrt(hd)
    rh = _rel_pos_bias(h, p["rel_h"])
    rw = _rel_pos_bias(w, p["rel_w"])
    qr = q.reshape(b, heads, h, w, hd)
    bias_h = torch.einsum("bnhwd,hkd->bnhwk", qr, rh)
    bias_w = torch.einsum("bnhwd,wkd->bnhwk", qr, rw)
    attn = attn.reshape(b, heads, h, w, h, w)
    attn = attn + bias_h[..., :, None] + bias_w[..., None, :]
    attn = attn.reshape(b, heads, h * w, h * w)
    wgt = torch.softmax(attn, dim=-1).to(x.dtype)
    o = torch.matmul(wgt, v)
    o = o.transpose(1, 2).reshape(b, h * w, d)
    return linear(o, p["proj"]).reshape(b, h, w, d)


def _vit_block(x: Tensor, blk: Params, cfg: SAMConfig,
               windowed: bool) -> Tensor:
    shortcut = x
    h = layer_norm(x, blk["ln1"])
    if not windowed:
        h = _window_attention(h, blk, cfg.heads)
    else:
        g, c = x.shape[1], x.shape[-1]
        wsz = cfg.window
        pad = (wsz - g % wsz) % wsz
        hp = F.pad(h, (0, 0, 0, pad, 0, pad))
        gp = g + pad
        nb = gp // wsz
        hw = hp.reshape(-1, nb, wsz, nb, wsz, c)
        hw = hw.permute(0, 1, 3, 2, 4, 5).reshape(-1, wsz, wsz, c)
        hw = _window_attention(hw, blk, cfg.heads)
        hw = hw.reshape(-1, nb, nb, wsz, wsz, c)
        hw = hw.permute(0, 1, 3, 2, 4, 5).reshape(-1, gp, gp, c)
        h = hw[:, :g, :g]
    x = shortcut + h
    h = layer_norm(x, blk["ln2"])
    return x + linear(F.gelu(linear(h, blk["fc1"])), blk["fc2"])


def sam_encode_image(params: Params, image: Tensor, cfg: SAMConfig) -> Tensor:
    """(B, S, S, 3) normalized image → (B, g, g, neck_dim) embedding."""
    enc = params["encoder"]
    x = conv2d(image, enc["patch"], stride=cfg.patch, padding="VALID")
    x = x + enc["pos"]
    for i, blk in enumerate(enc["blocks"]):
        x = _vit_block(x, blk, cfg, windowed=i not in cfg.global_idx)
    x = conv2d(x, enc["neck1"])
    x = layer_norm(x, enc["neck_ln1"])
    x = conv2d(x, enc["neck2"])
    return layer_norm(x, enc["neck_ln2"])


def _pe_encode(coords: Tensor, gaussian: Tensor) -> Tensor:
    c = torch.matmul(2.0 * coords - 1.0, gaussian) * (2.0 * np.pi)
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def sam_dense_pe(params: Params, g: int) -> Tensor:
    gauss = params["prompt"]["pe_gaussian"]
    xs = (torch.arange(g, dtype=gauss.dtype, device=gauss.device) + 0.5) / g
    grid = torch.stack(torch.meshgrid(xs, xs, indexing="xy"), dim=-1)
    return _pe_encode(grid, gauss)


def sam_encode_box(params: Params, box: Tensor, img_size: int) -> Tensor:
    """(B, 4) xyxy pixel box → (B, 2, D) corner prompt tokens."""
    p = params["prompt"]
    corners = (box.reshape(-1, 2, 2) + 0.5) / img_size
    pe = _pe_encode(corners, p["pe_gaussian"])
    return pe + torch.stack([p["point_emb"][2], p["point_emb"][3]])[None]


def _conv_transpose2x2(x: Tensor, p: Params) -> Tensor:
    w = p["w"].flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2)
    return y.permute(0, 2, 3, 1) + p["b"]


def sam_decode_masks(params: Params, image_embed: Tensor,
                     prompt_tokens: Tensor,
                     cfg: SAMConfig) -> Tuple[Tensor, Tensor]:
    """(B, g, g, D) + (B, P, D) prompts → (B, num_masks, 4g, 4g), iou."""
    dec = params["decoder"]
    b, g, _, d = image_embed.shape
    out_tok = torch.cat([dec["iou_token"], dec["mask_tokens"]], 0)
    tokens = torch.cat([out_tok[None].expand(b, -1, -1), prompt_tokens],
                       dim=1)
    src = image_embed.reshape(b, g * g, d) + params["prompt"]["no_mask"]
    pos = sam_dense_pe(params, g).reshape(1, g * g, d)
    q = tokens
    heads = cfg.decoder_heads
    for i, lp in enumerate(dec["layers"]):
        if i == 0:
            q = layer_norm_dec(_attn(q, q, q, lp["self_attn"], heads),
                               lp["ln1"])
        else:
            qq = q + tokens
            q = layer_norm_dec(q + _attn(qq, qq, q, lp["self_attn"], heads),
                               lp["ln1"])
        q = layer_norm_dec(
            q + _attn(q + tokens, src + pos, src, lp["cross_t2i"], heads),
            lp["ln2"])
        q = layer_norm_dec(
            q + linear(F.relu(linear(q, lp["fc1"])), lp["fc2"]), lp["ln3"])
        src = layer_norm_dec(
            src + _attn(src + pos, q + tokens, q, lp["cross_i2t"], heads),
            lp["ln4"])
    q = layer_norm_dec(
        q + _attn(q + tokens, src + pos, src, dec["final_attn"], heads),
        dec["norm_final"])
    iou_out = q[:, 0]
    mask_toks = q[:, 1:1 + cfg.num_mask_tokens]
    img = src.reshape(b, g, g, d)
    img = _conv_transpose2x2(img, dec["up1"])
    img = F.gelu(layer_norm(img, dec["up_ln"]))
    img = F.gelu(_conv_transpose2x2(img, dec["up2"]))
    hyper = torch.stack(
        [_mlp3(mask_toks[:, i], dec["hyper"][i])
         for i in range(cfg.num_mask_tokens)], dim=1)
    masks = torch.einsum("bmc,bhwc->bmhw", hyper, img)
    iou = _mlp3(iou_out, dec["iou_head"])
    return masks, iou


MEAN = np.array([123.675, 116.28, 103.53], np.float32) / 255.0
STD = np.array([58.395, 57.12, 57.375], np.float32) / 255.0


def mask_logits(params: Params, cfg: SAMConfig, image: np.ndarray,
                box: np.ndarray, device) -> Tuple[Tensor, Tensor]:
    """A host (H, W, 3) image in [0, 1] and an xyxy pixel box → (the
    decoder's low-resolution logits of every mask token, (num_masks, 4g,
    4g); mask token 0's logits at (H, W)), as the segmenter computes them
    with one box and `multimask_output=False`."""
    h, w = image.shape[:2]
    s = cfg.img_size
    scl = s / max(h, w)
    rh, rw = max(round(h * scl), 1), max(round(w * scl), 1)
    with torch.no_grad():
        x = resize_bilinear(torch.tensor(image, device=device), rh, rw)
        x = (x - torch.tensor(MEAN, device=device)) / torch.tensor(
            STD, device=device)
        x = F.pad(x, (0, 0, 0, s - rw, 0, s - rh))
        emb = sam_encode_image(params, x[None], cfg)
        box_s = torch.tensor(box, device=device) * scl
        toks = sam_encode_box(params, box_s[None], s)
        masks, _ = sam_decode_masks(params, emb, toks, cfg)
        gm = masks.shape[-1]
        crop = masks[0, 0][: max(round(rh / s * gm), 1),
                           : max(round(rw / s * gm), 1)]
        return masks[0], resize_bilinear(crop, h, w)
