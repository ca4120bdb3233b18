"""CLIP text encoder (SD1.5's ViT-L/14 text tower; SDXL's two towers) as
functions over a parameter tree.

Counterpart of `youreditableavatar_tpu/guidance/clip_text.py`: pre-LN
transformer layers (12 × d=768 × 12 heads for CLIP-L), a quick-GELU MLP
(plain GELU for the bigG tower), a causal mask and the final LayerNorm;
the last hidden state is SD1.5's conditioning, the penultimate one
SDXL's.

`CLIPTokenizerWrapper` uses the `transformers` BPE tokenizer when its
vocabulary files are on disk (they do not ship with the repository), and
otherwise the JAX package's deterministic hash stand-in, id for id.
`convert_torch_clip_text` maps a `transformers.CLIPTextModel` state dict
onto the tree.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.sd_layers import (
    Params,
    _randn,
    init_linear,
    init_norm,
    layer_norm,
    linear,
    linear_from_torch,
    norm_from_torch,
    params_from_numpy,
    project_attention,
    t2t,
)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    max_len: int = 77
    dim: int = 768
    layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    eos_token_id: int = 49407
    # SD1.5 / SDXL text_encoder use quick_gelu; the CLIP-bigG tower
    # (SDXL text_encoder_2) uses gelu.
    act: str = "quick_gelu"


SD15_CLIP = CLIPTextConfig()
TEST_CLIP = CLIPTextConfig(vocab_size=100, max_len=16, dim=32, layers=2,
                           heads=4, mlp_dim=64, eos_token_id=99)


def init_clip_text_params(gen: torch.Generator,
                          cfg: CLIPTextConfig = TEST_CLIP) -> Params:
    """Random weights at the JAX init's scales, drawn from `gen` on its
    device."""
    p: Params = {
        "tok_emb": _randn(gen, (cfg.vocab_size, cfg.dim)) * 0.02,
        "pos_emb": _randn(gen, (cfg.max_len, cfg.dim)) * 0.01,
        "layers": [],
        "final_norm": init_norm(gen, cfg.dim),
    }
    for _ in range(cfg.layers):
        p["layers"].append({
            "ln1": init_norm(gen, cfg.dim),
            "attn": {n: init_linear(gen, cfg.dim, cfg.dim)
                     for n in ("q", "k", "v", "out")},
            "ln2": init_norm(gen, cfg.dim),
            "fc1": init_linear(gen, cfg.dim, cfg.mlp_dim),
            "fc2": init_linear(gen, cfg.mlp_dim, cfg.dim),
        })
    return p


def clip_params_from_numpy(tree, device=None) -> Params:
    """The JAX package's CLIP tree, as numpy → tensors."""
    return params_from_numpy(tree, device)


@functools.lru_cache(maxsize=8)
def _causal_bias(n: int, device: torch.device) -> Tensor:
    """(n, n) additive causal mask, -1e9 above the diagonal, made once per
    length and device."""
    return torch.full((n, n), -1e9, device=device).triu(1)


def quick_gelu(x: Tensor) -> Tensor:
    return x * torch.sigmoid(1.702 * x)


def apply_clip_text(params: Params, tokens: Tensor,
                    cfg: CLIPTextConfig = TEST_CLIP,
                    penultimate: bool = False) -> Tensor:
    """(B, L) integer token ids → (B, L, D) hidden states.

    `penultimate=True` returns hidden_states[-2] (before the last layer and
    without final_layer_norm), what SDXL conditions both towers on.
    """
    # jax.nn.gelu's default is the tanh approximation.
    act = quick_gelu if cfg.act == "quick_gelu" else (
        lambda y: F.gelu(y, approximate="tanh"))
    tokens = tokens.long()
    n = tokens.shape[1]
    x = params["tok_emb"][tokens] + params["pos_emb"][None, :n]
    layers = params["layers"][:-1] if penultimate else params["layers"]
    causal = _causal_bias(n, x.device)
    for lp in layers:
        h = layer_norm(x, lp["ln1"])
        x = x + project_attention(h, h, h, lp["attn"], cfg.heads, causal)
        x = x + linear(act(linear(layer_norm(x, lp["ln2"]), lp["fc1"])),
                       lp["fc2"])
    if penultimate:
        return x
    return layer_norm(x, params["final_norm"])


def convert_torch_clip_text(sd: Dict[str, Any]) -> Params:
    """`transformers.CLIPTextModel.state_dict()` → parameter tree (on the
    CPU)."""
    pre = "text_model."
    p: Params = {
        "tok_emb": t2t(sd[pre + "embeddings.token_embedding.weight"]),
        "pos_emb": t2t(sd[pre + "embeddings.position_embedding.weight"]),
        "layers": [],
        "final_norm": norm_from_torch(sd, pre + "final_layer_norm"),
    }
    i = 0
    while f"{pre}encoder.layers.{i}.layer_norm1.weight" in sd:
        lp = f"{pre}encoder.layers.{i}"
        p["layers"].append({
            "ln1": norm_from_torch(sd, lp + ".layer_norm1"),
            "attn": {
                "q": linear_from_torch(sd, lp + ".self_attn.q_proj"),
                "k": linear_from_torch(sd, lp + ".self_attn.k_proj"),
                "v": linear_from_torch(sd, lp + ".self_attn.v_proj"),
                "out": linear_from_torch(sd, lp + ".self_attn.out_proj"),
            },
            "ln2": norm_from_torch(sd, lp + ".layer_norm2"),
            "fc1": linear_from_torch(sd, lp + ".mlp.fc1"),
            "fc2": linear_from_torch(sd, lp + ".mlp.fc2"),
        })
        i += 1
    return p


class CLIPTokenizerWrapper:
    """The real CLIP BPE when its vocabulary files exist, else a
    deterministic hash stand-in (stable ids per word, the same padding)."""

    def __init__(self, cfg: CLIPTextConfig = SD15_CLIP,
                 tokenizer_dir: str | None = None):
        self.cfg = cfg
        self._tok = None
        if tokenizer_dir is not None:
            from transformers import CLIPTokenizer

            self._tok = CLIPTokenizer.from_pretrained(tokenizer_dir)

    def __call__(self, prompts: List[str]) -> np.ndarray:
        cfg = self.cfg
        if self._tok is not None:
            out = self._tok(
                prompts, padding="max_length", max_length=cfg.max_len,
                truncation=True, return_tensors="np",
            )
            return out["input_ids"].astype(np.int32)
        ids = np.full((len(prompts), cfg.max_len), cfg.eos_token_id, np.int32)
        for b, prompt in enumerate(prompts):
            ids[b, 0] = cfg.eos_token_id - 1  # BOS stand-in
            for j, word in enumerate(prompt.lower().split()[: cfg.max_len - 2]):
                digest = hashlib.sha256(word.encode()).digest()
                ids[b, 1 + j] = int.from_bytes(digest[:4], "little") % (
                    cfg.vocab_size - 2)
        return ids
