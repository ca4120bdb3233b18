# Frozen copy of youreditableavatar_tpu_torch/guidance/sd15.py (the plain PyTorch path only).
"""SD1.5 diffusion prior: UNet + VAE + CLIP behind the guidance protocols.

Counterpart of `youreditableavatar_tpu/guidance/sd15.py`, the real-model
counterpart of `StubDiffusionPrior`. It implements `DiffusionPrior`, which
the SDS and du edits consume:

  * `encode_images` — VAE posterior sample × 0.18215 (differentiable);
  * `predict_noise` — one UNet call over the batch [cond; uncond];
  * `decode_latents` — VAE decode to [0, 1].

The weights never require a gradient, and `predict_noise` runs under
`torch.no_grad()`: SDS detaches its target, so no gradient flows through
the denoiser (the JAX gradient ignores it too), and autograd must not
keep a full-width UNet's activations. Where the JAX code draws from a key
(the posterior sample, the edit's noise) these draw from a
`torch.Generator`, or take the draw itself (`noise=`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from benchmark.reference.clip_text import (
    CLIPTextConfig,
    CLIPTokenizerWrapper,
    SD15_CLIP,
    apply_clip_text,
)
from benchmark.reference.sd_layers import tree_to
from benchmark.reference.sd_unet import (
    SD15_UNET,
    UNetConfig,
    apply_unet,
)
from benchmark.reference.sd_vae import (
    SD_VAE,
    VAEConfig,
    vae_decode,
    vae_encode,
)
from benchmark.reference.device import resolve_device


def ddpm_alphas_cumprod(num_steps: int = 1000, beta_start: float = 0.00085,
                        beta_end: float = 0.012, device=None) -> Tensor:
    """SD's scaled-linear ᾱ schedule (DDPMScheduler 'scaled_linear')."""
    betas = np.linspace(beta_start**0.5, beta_end**0.5, num_steps,
                        dtype=np.float64) ** 2
    return torch.as_tensor(np.cumprod(1.0 - betas).astype(np.float32),
                           device=device)


def ddim_step(z: Tensor, eps: Tensor, a_t, a_prev) -> Tensor:
    """One deterministic DDIM (η = 0) step from ᾱ_t to ᾱ_prev."""
    z0 = (z - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * z0 + torch.sqrt(1.0 - a_prev) * eps


class SD15Prior:
    """SD1.5 implementing `DiffusionPrior` (+ decode and the multi-step
    edit)."""

    def __init__(self, unet_params, vae_params,
                 unet_cfg: UNetConfig = SD15_UNET, vae_cfg: VAEConfig = SD_VAE,
                 num_train_timesteps: int = 1000, dtype=torch.float32,
                 device=None):
        self.device = resolve_device(device)
        self.unet_cfg = unet_cfg
        self.vae_cfg = vae_cfg
        self.dtype = dtype
        self.unet_params = tree_to(unet_params, self.device, dtype)
        self.vae_params = tree_to(vae_params, self.device, dtype)
        self.latent_channels = vae_cfg.latent_channels
        self.latent_downscale = vae_cfg.downscale
        self.num_train_timesteps = num_train_timesteps
        self.alphas_cumprod = ddpm_alphas_cumprod(num_train_timesteps,
                                                  device=self.device)

    # ------------------------------------------------------------ constructors



    # ----------------------------------------------------------- protocol

    def encode_images(self, images: Tensor,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[Tensor] = None) -> Tensor:
        """(B, H, W, 3) in [0, 1] → scaled latents (differentiable); the
        posterior sample's ε is `noise` when given."""
        x = (images * 2.0 - 1.0).to(self.dtype)
        z = vae_encode(self.vae_params, x, generator, self.vae_cfg, noise)
        return (z * self.vae_cfg.scaling_factor).to(torch.float32)

    def predict_noise(self, z_t: Tensor, t: Tensor, cond: Tensor,
                      uncond: Tensor) -> Tuple[Tensor, Tensor]:
        with torch.no_grad():
            zz = torch.cat([z_t, z_t]).to(self.dtype)
            tt = torch.cat([t, t])
            ctx = torch.cat([cond, uncond]).to(self.dtype)
            eps = apply_unet(self.unet_params, zz, tt, ctx,
                             self.unet_cfg).to(torch.float32)
        b = z_t.shape[0]
        return eps[:b], eps[b:]

    # --------------------------------------------------------------- extra

    def decode_latents(self, latents: Tensor) -> Tensor:
        z = (latents / self.vae_cfg.scaling_factor).to(self.dtype)
        img = vae_decode(self.vae_params, z, self.vae_cfg)
        return torch.clamp(img.to(torch.float32) * 0.5 + 0.5, 0.0, 1.0)



class CLIPPromptEncoder:
    """`PromptEncoder` backed by the CLIP text tower."""

    def __init__(self, params, cfg: CLIPTextConfig = SD15_CLIP,
                 tokenizer_dir: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.tokenizer = CLIPTokenizerWrapper(cfg, tokenizer_dir)



    def _tokens(self, prompts: List[str]) -> Tensor:
        return torch.as_tensor(self.tokenizer(prompts), dtype=torch.int64,
                               device=self.device)

    def encode(self, prompts: List[str]) -> Tensor:
        with torch.no_grad():
            return apply_clip_text(self.params, self._tokens(prompts),
                                   self.cfg)

    def encode_penultimate(self, prompts: List[str]):
        """(hidden_states[-2] context, tokens): SDXL's conditioning layer."""
        tokens = self._tokens(prompts)
        with torch.no_grad():
            return apply_clip_text(self.params, tokens, self.cfg,
                                   penultimate=True), tokens

    def encode_pooled(self, prompts: List[str]) -> Tensor:
        """The final layer's embedding at the first EOS token."""
        tokens = self._tokens(prompts)
        with torch.no_grad():
            h = apply_clip_text(self.params, tokens, self.cfg)
        eos = torch.argmax((tokens == self.cfg.eos_token_id).to(torch.int32),
                           dim=1)
        return h[torch.arange(h.shape[0], device=h.device), eos]
