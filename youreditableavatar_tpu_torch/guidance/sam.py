"""Segment Anything (SAM) as functional PyTorch.

Counterpart of `youreditableavatar_tpu/guidance/sam.py`: the segmentation
half of LangSAM (GroundingDINO grounds the text prompt to a box, SAM turns
the box into a mask), with the official architecture so that
`sam_vit_*.pth` checkpoints convert:

  * the ViT-det image encoder: 16×16 patch embed, absolute position
    embedding, windowed attention with a decomposed relative-position bias,
    global attention at the configured blocks, the 256-channel neck;
  * the prompt encoder: random-Fourier positional encoding and the box
    corner embeddings;
  * the mask decoder: the two-way transformer (token ↔ image cross
    attention), the 2× transposed-convolution upscaling, the per-token
    hypernetwork MLPs and the IoU head.

The parameter trees are the JAX package's layout (NHWC activations, HWIO
convolution kernels, (in, out) linear weights, the transposed convolutions'
kernels spatially flipped for `lax.conv_transpose`), so a JAX tree carries
across with `sam_params_from_numpy`. Attention logits and softmaxes are
computed in f32 at least (`sd_layers.stats_dtype`; an f64 tree stays f64).
The weights never require a gradient and the segmenter runs under
`torch.no_grad()`: nothing differentiates SAM.

Text grounding sits behind the `Grounder` seam (the weight-free foreground
band here; `grounding_dino.DinoGrounder` for real grounding).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.sd_layers import (
    Params,
    _randn,
    _zeros,
    conv2d,
    init_linear,
    init_norm,
    layer_norm as _layer_norm_eps,
    linear,
    linear_from_torch,
    norm_from_torch,
    params_from_numpy,
    stats_dtype,
    t2t,
    tree_to,
)
from youreditableavatar_tpu_torch.utils.device import resolve_device


def layer_norm(x: Tensor, p: Params) -> Tensor:
    """Encoder-side LayerNorm (the ViT blocks, the neck and the decoder's
    upscaling): eps 1e-6, as `build_sam` constructs them."""
    return _layer_norm_eps(x, p, eps=1e-6)


def layer_norm_dec(x: Tensor, p: Params) -> Tensor:
    """Decoder-transformer LayerNorm: plain `nn.LayerNorm`, eps 1e-5."""
    return _layer_norm_eps(x, p, eps=1e-5)


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch: int = 16
    embed_dim: int = 1280  # ViT-H
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


SAM_VIT_H = SAMConfig()
SAM_VIT_L = SAMConfig(embed_dim=1024, depth=24, heads=16,
                      global_idx=(5, 11, 17, 23))
SAM_VIT_B = SAMConfig(embed_dim=768, depth=12, heads=12,
                      global_idx=(2, 5, 8, 11))
TEST_SAM = SAMConfig(img_size=64, embed_dim=32, depth=2, heads=4, window=2,
                     global_idx=(1,), neck_dim=16, decoder_heads=4)


# ------------------------------------------------------------ image encoder


def init_sam_params(gen: torch.Generator, cfg: SAMConfig = TEST_SAM) -> Params:
    """Random weights drawn from `gen` on its device."""
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
    dec: Params = {
        "iou_token": _randn(gen, (1, dd)) * 0.02,
        "mask_tokens": _randn(gen, (cfg.num_mask_tokens, dd)) * 0.02,
        "layers": [],
        "final_attn": _init_attn(gen, dd, dd // 2),
        "norm_final": init_norm(gen, dd),
        "up1": {"w": _randn(gen, (2, 2, dd, dd // 4)) * 0.02,
                "b": _zeros(gen, (dd // 4,))},
        "up_ln": init_norm(gen, dd // 4),
        "up2": {"w": _randn(gen, (2, 2, dd // 4, dd // 8)) * 0.02,
                "b": _zeros(gen, (dd // 8,))},
        "hyper": [_init_mlp3(gen, dd, dd, dd // 8)
                  for _ in range(cfg.num_mask_tokens)],
        "iou_head": _init_mlp3(gen, dd, dd, cfg.num_mask_tokens),
    }
    for _ in range(cfg.decoder_depth):
        dec["layers"].append({
            "self_attn": _init_attn(gen, dd, dd),
            "ln1": init_norm(gen, dd),
            "cross_t2i": _init_attn(gen, dd, dd // 2),
            "ln2": init_norm(gen, dd),
            "fc1": init_linear(gen, dd, 8 * dd),
            "fc2": init_linear(gen, 8 * dd, dd),
            "ln3": init_norm(gen, dd),
            "cross_i2t": _init_attn(gen, dd, dd // 2),
            "ln4": init_norm(gen, dd),
        })

    prm: Params = {
        "pe_gaussian": _randn(gen, (2, dd // 2)),
        "point_emb": _randn(gen, (4, dd)) * 0.02,
        "not_a_point": _randn(gen, (1, dd)) * 0.02,
        "no_mask": _randn(gen, (1, dd)) * 0.02,
    }
    return {"encoder": enc, "decoder": dec, "prompt": prm}


def sam_params_from_numpy(tree, device=None) -> Params:
    """The JAX package's SAM tree (as numpy) → the same tree of f32
    tensors on `device`."""
    return params_from_numpy(tree, device)


def _init_attn(gen, dim, internal) -> Params:
    return {
        "q": init_linear(gen, dim, internal),
        "k": init_linear(gen, dim, internal),
        "v": init_linear(gen, dim, internal),
        "out": init_linear(gen, internal, dim),
    }


def _init_mlp3(gen, din, dhid, dout) -> list:
    return [init_linear(gen, din, dhid), init_linear(gen, dhid, dhid),
            init_linear(gen, dhid, dout)]


def _mlp3(x: Tensor, p) -> Tensor:
    x = F.relu(linear(x, p[0]))
    x = F.relu(linear(x, p[1]))
    return linear(x, p[2])


def _attn(q, k, v, p, heads):
    """SAM decoder attention with separate q/k/v projections."""
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
    """Decomposed relative-position table lookup: (size, size, head_dim)."""
    coords = torch.arange(size, device=rel.device)
    idx = coords[:, None] - coords[None, :] + (size - 1)
    return rel[idx]


def _window_attention(x: Tensor, p: Params, heads: int) -> Tensor:
    """Attention over (B*, size, size, D) windows with the decomposed
    relative-position bias (segment-anything `Attention.forward` +
    `add_decomposed_rel_pos`)."""
    b, h, w, d = x.shape
    hd = d // heads
    qkv = linear(x.reshape(b, h * w, d), p["qkv"])
    qkv = qkv.reshape(b, h * w, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (b, heads, hw, hd)
    attn = torch.matmul(q, k.transpose(-1, -2)).to(
        stats_dtype(x.dtype)) / math.sqrt(hd)
    rh = _rel_pos_bias(h, p["rel_h"])  # (h, h, hd)
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


def sam_encode_image(params: Params, image: Tensor,
                     cfg: SAMConfig = TEST_SAM) -> Tensor:
    """(B, S, S, 3) normalized image → (B, g, g, neck_dim) embedding."""
    enc = params["encoder"]
    x = conv2d(image, enc["patch"], stride=cfg.patch, padding="VALID")
    x = x + enc["pos"]
    g = x.shape[1]
    c = x.shape[-1]
    for i, blk in enumerate(enc["blocks"]):
        shortcut = x
        h = layer_norm(x, blk["ln1"])
        if i in cfg.global_idx:
            h = _window_attention(h, blk, cfg.heads)
        else:
            # Zero-pad the normed activations to a window multiple, attend
            # per window, crop.
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
        x = x + linear(F.gelu(linear(h, blk["fc1"])), blk["fc2"])
    x = conv2d(x, enc["neck1"])
    x = layer_norm(x, enc["neck_ln1"])
    x = conv2d(x, enc["neck2"])
    return layer_norm(x, enc["neck_ln2"])


# ------------------------------------------------------------ prompts


def _pe_encode(coords: Tensor, gaussian: Tensor) -> Tensor:
    """Random-Fourier positional encoding of [0, 1] coords (SAM
    `PositionEmbeddingRandom`)."""
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
    # The official _embed_boxes shifts to pixel centres before normalizing.
    corners = (box.reshape(-1, 2, 2) + 0.5) / img_size
    pe = _pe_encode(corners, p["pe_gaussian"])
    return pe + torch.stack([p["point_emb"][2], p["point_emb"][3]])[None]


# ------------------------------------------------------------ decoder


def _conv_transpose2x2(x: Tensor, p: Params) -> Tensor:
    """The decoder's stride-2 2×2 transposed convolution on NHWC `x`. The
    JAX layout holds an HWIO kernel for `lax.conv_transpose` (a correlation
    over the dilated input), the spatial flip of torch's (in, out, kh, kw)
    weight."""
    w = p["w"].flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, stride=2)
    return y.permute(0, 2, 3, 1) + p["b"]


def sam_decode_masks(
    params: Params,
    image_embed: Tensor,
    prompt_tokens: Tensor,
    cfg: SAMConfig = TEST_SAM,
) -> Tuple[Tensor, Tensor]:
    """(B, g, g, D) + (B, P, D) prompts → (B, num_masks, 4g, 4g), iou."""
    dec = params["decoder"]
    b, g, _, d = image_embed.shape
    out_tok = torch.cat([dec["iou_token"], dec["mask_tokens"]], 0)
    tokens = torch.cat([out_tok[None].expand(b, -1, -1), prompt_tokens],
                       dim=1)
    # src = image embedding + the dense prompt, the learned no_mask
    # embedding when no mask prompt is given.
    src = image_embed.reshape(b, g * g, d) + params["prompt"]["no_mask"]
    pos = sam_dense_pe(params, g).reshape(1, g * g, d)
    q = tokens
    heads = cfg.decoder_heads
    for i, lp in enumerate(dec["layers"]):
        if i == 0:
            # skip_first_layer_pe: the first self-attention REPLACES the
            # queries (no PE add, no residual) before norm1.
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
    img = F.gelu(_conv_transpose2x2(img, dec["up2"]))  # (b, 4g, 4g, d/8)

    hyper = torch.stack(
        [_mlp3(mask_toks[:, i], dec["hyper"][i])
         for i in range(cfg.num_mask_tokens)], dim=1)  # (b, M, d/8)
    masks = torch.einsum("bmc,bhwc->bmhw", hyper, img)
    iou = _mlp3(iou_out, dec["iou_head"])
    return masks, iou


# ------------------------------------------------------------ segmenter


class Grounder:
    """Text → pixel box seam (GroundingDINO's role). The heuristic boxes
    the foreground band named by the prompt keywords."""

    def ground(self, image: np.ndarray, prompt: str) -> np.ndarray:
        img = np.asarray(image)
        fg = ~(img > 0.95).all(-1)
        rows = np.where(fg.any(1))[0]
        cols = np.where(fg.any(0))[0]
        if len(rows) == 0:
            return np.array([0, 0, img.shape[1], img.shape[0]], np.float32)
        top, bot = rows[0], rows[-1]
        third = max((bot - top) // 3, 1)
        pl = prompt.lower()
        if any(k in pl for k in ("hat", "head", "hair", "face")):
            top, bot = top, top + third
        elif any(k in pl for k in ("pant", "trouser", "skirt", "shoe",
                                   "leg", "lower")):
            top, bot = bot - third, bot
        else:  # garment / upper-body default
            top, bot = top + third, bot - third
        return np.array([cols[0], top, cols[-1], bot], np.float32)


class SAMSegmenter:
    """`Segmenter` backed by SAM; text grounding through a `Grounder`.

    With converted `sam_vit_*.pth` weights this is LangSAM's box-prompted
    mask; with random weights it still runs the whole architecture, and the
    mask falls back to the grounded box ∩ foreground when the decoder is
    untrained (`trust_decoder=False`).
    """

    MEAN = np.array([123.675, 116.28, 103.53], np.float32) / 255.0
    STD = np.array([58.395, 57.12, 57.375], np.float32) / 255.0

    def __init__(self, params, cfg: SAMConfig = TEST_SAM,
                 grounder: Optional[Grounder] = None,
                 trust_decoder: bool = True,
                 multimask: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.grounder = grounder or Grounder()
        self.trust_decoder = trust_decoder
        # LangSAM uses multimask_output=False (mask token 0).
        self.multimask = multimask

    @classmethod
    def random_init(cls, gen: torch.Generator, cfg: SAMConfig = TEST_SAM,
                    **kw) -> "SAMSegmenter":
        """Random weights drawn from `gen` on its device."""
        kw.setdefault("trust_decoder", False)
        return cls(init_sam_params(gen, cfg), cfg, **kw)

    @classmethod
    def from_torch_file(cls, path: str, cfg: SAMConfig = SAM_VIT_H,
                        **kw) -> "SAMSegmenter":
        from youreditableavatar_tpu_torch.guidance.sd_unet import (
            _load_torch_state_dict)

        return cls(convert_torch_sam(_load_torch_state_dict(path)), cfg,
                   **kw)

    def _mask_logits(self, img: np.ndarray, box: np.ndarray) -> Tensor:
        """(H, W, 3) float image + xyxy pixel box → (H, W) mask logits."""
        from youreditableavatar_tpu_torch.stages.edit_texture import (
            _resize_bilinear)

        h, w = img.shape[:2]
        s = self.cfg.img_size
        dev = self.device
        # Official preprocessing: resize the LONGEST side to img_size,
        # normalize, then zero-pad bottom / right to square.
        scl = s / max(h, w)
        rh, rw = max(round(h * scl), 1), max(round(w * scl), 1)
        with torch.no_grad():
            x = _resize_bilinear(torch.tensor(img, device=dev), rh, rw)
            x = (x - torch.tensor(self.MEAN, device=dev)) / torch.tensor(
                self.STD, device=dev)
            x = F.pad(x, (0, 0, 0, s - rw, 0, s - rh))
            emb = sam_encode_image(self.params, x[None], self.cfg)
            box_s = torch.tensor(box, device=dev) * scl
            toks = sam_encode_box(self.params, box_s[None], s)
            masks, iou = sam_decode_masks(self.params, emb, toks, self.cfg)
            # LangSAM predicts with multimask_output=False (mask token 0);
            # multimask=True takes the best of tokens 1..3 by predicted IoU.
            best = 1 + int(torch.argmax(iou[0, 1:4])) if self.multimask \
                else 0
            gm = masks.shape[-1]
            crop = masks[0, best][: max(round(rh / s * gm), 1),
                                  : max(round(rw / s * gm), 1)]
            return _resize_bilinear(crop, h, w)

    def segment(self, image, prompt: str) -> np.ndarray:
        if torch.is_tensor(image):
            image = image.detach().cpu().numpy()
        img = np.asarray(image, np.float32)
        h, w = img.shape[:2]
        box = self.grounder.ground(img, prompt)
        mask = (self._mask_logits(img, box) > 0.0).cpu().numpy()
        if not self.trust_decoder:
            # An untrained decoder: restrict to the grounded box.
            keep = np.zeros((h, w), bool)
            x0, y0, x1, y1 = box.astype(int)
            keep[y0:y1 + 1, x0:x1 + 1] = True
            fg = ~(img > 0.95).all(-1)
            mask = keep & fg
        return mask


# ------------------------------------------------------- torch conversion


def _conv_oihw(v) -> Tensor:
    return t2t(v).permute(2, 3, 1, 0).contiguous()


def _conv_transpose_flipped(v) -> Tensor:
    """torch ConvTranspose2d (in, out, kh, kw) → the JAX layout's HWIO
    kernel with a spatial flip."""
    return t2t(v).permute(2, 3, 0, 1).flip(0, 1).contiguous()


def convert_torch_sam(sd: Dict[str, Any]) -> Params:
    """Official `segment_anything` state dict → the parameter tree (f32
    CPU tensors)."""
    ie = "image_encoder."
    enc: Params = {
        "patch": {"w": _conv_oihw(sd[ie + "patch_embed.proj.weight"]),
                  "b": t2t(sd[ie + "patch_embed.proj.bias"])},
        "pos": t2t(sd[ie + "pos_embed"]),
        "blocks": [],
        "neck1": {"w": _conv_oihw(sd[ie + "neck.0.weight"])},
        "neck_ln1": norm_from_torch(sd, ie + "neck.1"),
        "neck2": {"w": _conv_oihw(sd[ie + "neck.2.weight"])},
        "neck_ln2": norm_from_torch(sd, ie + "neck.3"),
    }
    i = 0
    while f"{ie}blocks.{i}.norm1.weight" in sd:
        pre = f"{ie}blocks.{i}"
        enc["blocks"].append({
            "ln1": norm_from_torch(sd, pre + ".norm1"),
            "qkv": linear_from_torch(sd, pre + ".attn.qkv"),
            "proj": linear_from_torch(sd, pre + ".attn.proj"),
            "rel_h": t2t(sd[pre + ".attn.rel_pos_h"]),
            "rel_w": t2t(sd[pre + ".attn.rel_pos_w"]),
            "ln2": norm_from_torch(sd, pre + ".norm2"),
            "fc1": linear_from_torch(sd, pre + ".mlp.lin1"),
            "fc2": linear_from_torch(sd, pre + ".mlp.lin2"),
        })
        i += 1

    def attn_from(pre) -> Params:
        return {
            "q": linear_from_torch(sd, pre + ".q_proj"),
            "k": linear_from_torch(sd, pre + ".k_proj"),
            "v": linear_from_torch(sd, pre + ".v_proj"),
            "out": linear_from_torch(sd, pre + ".out_proj"),
        }

    md = "mask_decoder."
    dec: Params = {
        "iou_token": t2t(sd[md + "iou_token.weight"]),
        "mask_tokens": t2t(sd[md + "mask_tokens.weight"]),
        "layers": [],
        "final_attn": attn_from(md + "transformer.final_attn_token_to_image"),
        "norm_final": norm_from_torch(sd, md + "transformer.norm_final_attn"),
        "up1": {"w": _conv_transpose_flipped(
                    sd[md + "output_upscaling.0.weight"]),
                "b": t2t(sd[md + "output_upscaling.0.bias"])},
        "up_ln": norm_from_torch(sd, md + "output_upscaling.1"),
        "up2": {"w": _conv_transpose_flipped(
                    sd[md + "output_upscaling.3.weight"]),
                "b": t2t(sd[md + "output_upscaling.3.bias"])},
        "hyper": [],
        "iou_head": [],
    }
    i = 0
    while f"{md}transformer.layers.{i}.self_attn.q_proj.weight" in sd:
        pre = f"{md}transformer.layers.{i}"
        dec["layers"].append({
            "self_attn": attn_from(pre + ".self_attn"),
            "ln1": norm_from_torch(sd, pre + ".norm1"),
            "cross_t2i": attn_from(pre + ".cross_attn_token_to_image"),
            "ln2": norm_from_torch(sd, pre + ".norm2"),
            "fc1": linear_from_torch(sd, pre + ".mlp.lin1"),
            "fc2": linear_from_torch(sd, pre + ".mlp.lin2"),
            "ln3": norm_from_torch(sd, pre + ".norm3"),
            "cross_i2t": attn_from(pre + ".cross_attn_image_to_token"),
            "ln4": norm_from_torch(sd, pre + ".norm4"),
        })
        i += 1
    for i in range(4):
        dec["hyper"].append([
            linear_from_torch(
                sd, f"{md}output_hypernetworks_mlps.{i}.layers.{j}")
            for j in range(3)
        ])
    dec["iou_head"] = [
        linear_from_torch(sd, f"{md}iou_prediction_head.layers.{j}")
        for j in range(3)
    ]

    pe = "prompt_encoder."
    prm: Params = {
        "pe_gaussian": t2t(
            sd[pe + "pe_layer.positional_encoding_gaussian_matrix"]),
        "point_emb": torch.cat([
            t2t(sd[pe + f"point_embeddings.{i}.weight"]) for i in range(4)
        ], dim=0),
        "not_a_point": t2t(sd[pe + "not_a_point_embed.weight"]),
        "no_mask": t2t(sd[pe + "no_mask_embed.weight"]),
    }
    return {"encoder": enc, "decoder": dec, "prompt": prm}
