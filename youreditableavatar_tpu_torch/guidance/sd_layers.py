"""Shared functional layers of the Stable-Diffusion model family.

Counterpart of `youreditableavatar_tpu/guidance/sd_layers.py`: GroupNorm →
SiLU → conv residual blocks, sinusoidal time embeddings, the
cross-attention transformer block, and their random inits and torch
state-dict converters, as pure functions over parameter trees (nested
dicts and lists of tensors) in the JAX package's layout: NHWC activations,
HWIO conv kernels and (in, out) linear weights. So a JAX parameter tree
carries across with `params_from_numpy`.

The JAX version spells the convolution as shifted matmuls because the
TPU's conv lowering is slow; here a CUDA tensor runs the hand-written f32
implicit GEMM K7 (`ops/conv_cuda.py`, FFMA only, in one fixed summation
order) on the same layouts, and a CPU tensor `F.conv2d`. Attention is two
matmuls with the logits and the softmax in f32. Keep TF32 off on the card
(`torch.backends.cuda.matmul.allow_tf32 = False`, as `chip_smoke.py`
sets) so the networks compute in f32 as the JAX package's do.

The inits draw from a `torch.Generator` where the JAX ones take a key, on
the generator's device (a CUDA generator draws a full-width network on
the card).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from youreditableavatar_tpu_torch.ops import conv_cuda

Params = Dict[str, Any]


# ---------------------------------------------------------------- primitives


def linear(x: Tensor, p: Params) -> Tensor:
    y = torch.matmul(x, p["w"])
    return y + p["b"] if "b" in p else y


def conv2d(x: Tensor, p: Params, stride: int = 1, padding="SAME") -> Tensor:
    """2-D convolution of NHWC `x` with the HWIO kernel `p["w"]` (+ `p["b"]`).

    `padding` is "SAME", "VALID" or ((top, bottom), (left, right)). CUDA
    tensors run the hand-written implicit GEMM K7 (`ops/conv_cuda.py`),
    forward and input gradient; CPU tensors run `conv2d_plain`.
    """
    w = p["w"]  # (kh, kw, cin, cout) HWIO
    kh, kw, _, _ = w.shape
    s = stride
    _, h, wd, _ = x.shape
    if padding == "SAME":
        pt_h = max((-(-h // s) - 1) * s + kh - h, 0)
        pt_w = max((-(-wd // s) - 1) * s + kw - wd, 0)
        pads = ((pt_h // 2, pt_h - pt_h // 2),
                (pt_w // 2, pt_w - pt_w // 2))
    elif padding == "VALID":
        pads = ((0, 0), (0, 0))
    else:
        pads = tuple((int(q[0]), int(q[1])) for q in padding)
    if x.is_cuda:  # K7, f32 only: it raises on other types
        return conv_cuda.conv2d(x, w, p.get("b"), s, pads)
    return conv2d_plain(x, w, p.get("b"), s, pads)


def conv2d_plain(x: Tensor, w: Tensor, b: Optional[Tensor], stride: int,
                 pads) -> Tensor:
    """`F.conv2d` of NHWC `x` with the HWIO `w` (+ `b`) and explicit
    ((top, bottom), (left, right)) pads: K7's plain version, on any
    device and dtype."""
    xn = x.permute(0, 3, 1, 2)
    if pads[0][0] == pads[0][1] and pads[1][0] == pads[1][1]:
        conv_pad = (pads[0][0], pads[1][0])  # symmetric: no padded copy
    else:
        xn = F.pad(xn, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        conv_pad = 0
    y = F.conv2d(xn, w.permute(3, 2, 0, 1), stride=stride,
                 padding=conv_pad).permute(0, 2, 3, 1)
    return y + b if b is not None else y


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of normalization statistics and attention logits: f32 for
    narrower inputs (bf16 networks), the input's own when wider (an f64
    reference run)."""
    return torch.promote_types(dtype, torch.float32)


def group_norm(x: Tensor, p: Params, groups: int = 32,
               eps: float = 1e-5) -> Tensor:
    """GroupNorm over NHWC (statistics in f32 at least)."""
    orig = x.dtype
    x = x.to(stats_dtype(orig))
    c = x.shape[-1]
    g = min(groups, c)
    xg = x.reshape(x.shape[:-1] + (g, c // g))
    dims = (1, 2, 4) if x.dim() == 4 else (-1,)
    mean = xg.mean(dim=dims, keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=dims, keepdim=True)
    x = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (x * p["scale"] + p["bias"]).to(orig)


def layer_norm(x: Tensor, p: Params, eps: float = 1e-5) -> Tensor:
    orig = x.dtype
    x = x.to(stats_dtype(orig))
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * p["scale"] + p["bias"]).to(orig)


def timestep_embedding(t: Tensor, dim: int, max_period: float = 10000.0,
                       flip: bool = True) -> Tensor:
    """Sinusoidal timestep features: [cos, sin] with `flip` (SD's
    flip_sin_to_cos), else [sin, cos]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip else [sin, cos], dim=-1)


def attention(q: Tensor, k: Tensor, v: Tensor, heads: int) -> Tensor:
    """Multi-head attention; logits and softmax in f32 (at least).

    q: (B, Lq, D); k/v: (B, Lk, D) → (B, Lq, D).
    """
    b, lq, d = q.shape
    dh = d // heads
    qh = q.reshape(b, lq, heads, dh).transpose(1, 2)
    kh = k.reshape(b, -1, heads, dh).transpose(1, 2)
    vh = v.reshape(b, -1, heads, dh).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2)).to(
        stats_dtype(q.dtype)) / math.sqrt(dh)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(w, vh)
    return out.transpose(1, 2).reshape(b, lq, d)


# ------------------------------------------------------------------- blocks


def resnet_block(x: Tensor, temb: Optional[Tensor], p: Params,
                 groups: int = 32, eps: float = 1e-5) -> Tensor:
    """GN→SiLU→conv3×3 →(+time proj)→ GN→SiLU→conv3×3, residual (diffusers
    `ResnetBlock2D`)."""
    h = conv2d(F.silu(group_norm(x, p["norm1"], groups, eps)), p["conv1"])
    if temb is not None and "time_emb_proj" in p:
        h = h + linear(F.silu(temb), p["time_emb_proj"])[:, None, None, :]
    h = conv2d(F.silu(group_norm(h, p["norm2"], groups, eps)), p["conv2"])
    skip = conv2d(x, p["conv_shortcut"]) if "conv_shortcut" in p else x
    return skip + h


def transformer_block(x: Tensor, ctx: Tensor, p: Params, heads: int) -> Tensor:
    """LN→self-attn → LN→cross-attn → LN→GEGLU-FF, all residual (diffusers
    `BasicTransformerBlock`)."""
    h = layer_norm(x, p["norm1"])
    a1 = p["attn1"]
    h = attention(linear(h, a1["q"]), linear(h, a1["k"]),
                  linear(h, a1["v"]), heads)
    x = x + linear(h, a1["out"])

    h = layer_norm(x, p["norm2"])
    a2 = p["attn2"]
    h = attention(linear(h, a2["q"]), linear(ctx, a2["k"]),
                  linear(ctx, a2["v"]), heads)
    x = x + linear(h, a2["out"])

    h = layer_norm(x, p["norm3"])
    ha, hb = linear(h, p["ff1"]).chunk(2, dim=-1)
    h = ha * F.gelu(hb)  # exact erf GELU, as jax.nn.gelu(approximate=False)
    return x + linear(h, p["ff2"])


def spatial_transformer(x: Tensor, ctx: Tensor, p: Params, heads: int,
                        groups: int = 32) -> Tensor:
    """GN (eps 1e-6, as diffusers' Transformer2DModel) → 1×1 proj_in →
    transformer block(s) over the flattened pixels → 1×1 proj_out,
    residual."""
    b, h_, w_, c = x.shape
    y = group_norm(x, p["norm"], groups, eps=1e-6)
    y = conv2d(y, p["proj_in"]).reshape(b, h_ * w_, c)
    for blk in p["blocks"]:
        y = transformer_block(y, ctx, blk, heads)
    return x + conv2d(y.reshape(b, h_, w_, c), p["proj_out"])


def self_attention_2d(x: Tensor, p: Params, groups: int = 32,
                      eps: float = 1e-5) -> Tensor:
    """GN → single-head QKV self-attention over the pixels (the VAE's mid
    block)."""
    b, h_, w_, c = x.shape
    y = group_norm(x, p["norm"], groups, eps).reshape(b, h_ * w_, c)
    out = attention(linear(y, p["q"]), linear(y, p["k"]),
                    linear(y, p["v"]), heads=1)
    return x + linear(out, p["out"]).reshape(b, h_, w_, c)


# ------------------------------------------------------------------ inits


def _randn(gen: torch.Generator, shape) -> Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device)


def _zeros(gen: torch.Generator, shape) -> Tensor:
    return torch.zeros(tuple(shape), device=gen.device)


def init_linear(gen: torch.Generator, din, dout, bias=True,
                scale=None) -> Params:
    w = _randn(gen, (din, dout)) * (
        scale if scale is not None else 1.0 / math.sqrt(din))
    p = {"w": w}
    if bias:
        p["b"] = _zeros(gen, (dout,))
    return p


def init_conv(gen: torch.Generator, kh, kw, cin, cout, bias=True) -> Params:
    p = {"w": _randn(gen, (kh, kw, cin, cout)) / math.sqrt(kh * kw * cin)}
    if bias:
        p["b"] = _zeros(gen, (cout,))
    return p


def init_norm(gen: torch.Generator, c) -> Params:
    return {"scale": torch.ones((c,), device=gen.device),
            "bias": _zeros(gen, (c,))}


def init_resnet(gen: torch.Generator, cin, cout,
                temb_dim: Optional[int]) -> Params:
    p = {
        "norm1": init_norm(gen, cin),
        "conv1": init_conv(gen, 3, 3, cin, cout),
        "norm2": init_norm(gen, cout),
        "conv2": init_conv(gen, 3, 3, cout, cout),
    }
    if temb_dim is not None:
        p["time_emb_proj"] = init_linear(gen, temb_dim, cout)
    if cin != cout:
        p["conv_shortcut"] = init_conv(gen, 1, 1, cin, cout)
    return p


def init_transformer_block(gen: torch.Generator, c, ctx_dim) -> Params:
    def attn(kv_dim):
        return {"q": init_linear(gen, c, c, bias=False),
                "k": init_linear(gen, kv_dim, c, bias=False),
                "v": init_linear(gen, kv_dim, c, bias=False),
                "out": init_linear(gen, c, c)}

    return {
        "norm1": init_norm(gen, c),
        "attn1": attn(c),
        "norm2": init_norm(gen, c),
        "attn2": attn(ctx_dim),
        "norm3": init_norm(gen, c),
        "ff1": init_linear(gen, c, 8 * c),
        "ff2": init_linear(gen, 4 * c, c),
    }


def init_spatial_transformer(gen: torch.Generator, c, ctx_dim,
                             depth: int = 1) -> Params:
    return {
        "norm": init_norm(gen, c),
        "proj_in": init_conv(gen, 1, 1, c, c),
        "blocks": [init_transformer_block(gen, c, ctx_dim)
                   for _ in range(depth)],
        "proj_out": init_conv(gen, 1, 1, c, c),
    }


def init_self_attention_2d(gen: torch.Generator, c) -> Params:
    return {
        "norm": init_norm(gen, c),
        "q": init_linear(gen, c, c),
        "k": init_linear(gen, c, c),
        "v": init_linear(gen, c, c),
        "out": init_linear(gen, c, c),
    }


# -------------------------------------------------------- parameter trees


def params_from_numpy(tree, device=None):
    """A parameter tree of arrays (the JAX package's, as numpy) → the same
    tree of f32 tensors on `device` (default: the CPU)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device)


def tree_to(tree, device=None, dtype=torch.float32):
    """Every tensor of a parameter tree on `device` in `dtype`, with no
    gradient."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device, dtype) for v in tree]
    return tree.detach().to(device=device, dtype=dtype)


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_numel(tree) -> int:
    """The number of parameters in a tree."""
    return sum(x.numel() for x in tree_leaves(tree))


# ------------------------------------------------------- torch conversion


def t2t(v) -> Tensor:
    """A state-dict value (numpy array or tensor) → an f32 CPU tensor."""
    if torch.is_tensor(v):
        return v.detach().to("cpu", torch.float32).clone()
    return torch.tensor(np.asarray(v, np.float32))


def conv_from_torch(sd, prefix) -> Params:
    """torch Conv2d OIHW → HWIO."""
    p = {"w": t2t(sd[prefix + ".weight"]).permute(2, 3, 1, 0).contiguous()}
    if prefix + ".bias" in sd:
        p["b"] = t2t(sd[prefix + ".bias"])
    return p


def linear_from_torch(sd, prefix) -> Params:
    p = {"w": t2t(sd[prefix + ".weight"]).t().contiguous()}
    if prefix + ".bias" in sd:
        p["b"] = t2t(sd[prefix + ".bias"])
    return p


def norm_from_torch(sd, prefix) -> Params:
    return {"scale": t2t(sd[prefix + ".weight"]),
            "bias": t2t(sd[prefix + ".bias"])}
