"""SD1.5 diffusion prior: UNet + VAE + CLIP behind the guidance protocols.

Counterpart of `youreditableavatar_tpu/guidance/sd15.py`, the real-model
counterpart of `StubDiffusionPrior`. It implements `DiffusionPrior`, which
the SDS and du edits consume:

  * `encode_images` — VAE posterior sample × 0.18215 (differentiable);
  * `predict_noise` — one UNet call over the batch [cond; uncond];
  * `decode_latents` — VAE decode to [0, 1];
  * `edit_latents` — the multi-step "du" denoise from a noised latent
    (DDIM steps, CFG at each).

The weights never require a gradient, and `predict_noise` runs under
`torch.no_grad()`: SDS detaches its target, so no gradient flows through
the denoiser (the JAX gradient ignores it too), and autograd must not
keep a full-width UNet's activations. Where the JAX code draws from a key
(the posterior sample, the edit's noise) these draw from a
`torch.Generator`, or take the draw itself (`noise=`).

Weights: `SD15Prior.from_torch_files` converts diffusers-format torch
checkpoints; `SD15Prior.random_init` builds random weights at any config
(the TEST configs by default, `SD15_UNET` / `SD_VAE` for full width).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.clip_text import (
    CLIPTextConfig,
    CLIPTokenizerWrapper,
    SD15_CLIP,
    TEST_CLIP,
    apply_clip_text,
    convert_torch_clip_text,
    init_clip_text_params,
)
from youreditableavatar_tpu_torch.guidance.sd_layers import tree_to
from youreditableavatar_tpu_torch.guidance.sd_unet import (
    SD15_UNET,
    TEST_UNET,
    UNetConfig,
    _load_torch_state_dict,
    apply_unet,
    convert_torch_unet,
    init_unet_params,
)
from youreditableavatar_tpu_torch.guidance.sd_vae import (
    SD_VAE,
    TEST_VAE,
    VAEConfig,
    convert_torch_vae,
    init_vae_params,
    randn_like_on,
    vae_decode,
    vae_encode,
)
from youreditableavatar_tpu_torch.utils.device import resolve_device


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

    @classmethod
    def random_init(cls, gen: torch.Generator,
                    unet_cfg: UNetConfig = TEST_UNET,
                    vae_cfg: VAEConfig = TEST_VAE, **kw) -> "SD15Prior":
        """Random weights drawn from `gen` on its device (a CUDA generator
        draws a full-width prior on the card)."""
        return cls(init_unet_params(gen, unet_cfg),
                   init_vae_params(gen, vae_cfg), unet_cfg, vae_cfg, **kw)

    @classmethod
    def from_torch_files(cls, unet_path: str, vae_path: str,
                         unet_cfg: UNetConfig = SD15_UNET,
                         vae_cfg: VAEConfig = SD_VAE, **kw) -> "SD15Prior":
        unet_sd = _load_torch_state_dict(unet_path)
        vae_sd = _load_torch_state_dict(vae_path)
        return cls(convert_torch_unet(unet_sd, unet_cfg),
                   convert_torch_vae(vae_sd, vae_cfg), unet_cfg, vae_cfg,
                   **kw)

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

    def edit_latents(self, latents: Tensor, t: int, cond: Tensor,
                     uncond: Tensor,
                     generator: Optional[torch.Generator] = None,
                     guidance_scale: float = 7.5, steps_divisor: int = 25,
                     noise: Optional[Tensor] = None) -> Tensor:
        """Multi-step DDIM denoise from noise level t (the du edit).

        Noise the input to level t (with `noise` when given), then run
        t//divisor + 1 CFG steps down to 0 on evenly spaced timesteps.
        """
        t = int(t)
        nsteps = t // steps_divisor + 1
        ts = np.linspace(t, 0, nsteps + 1).round().astype(np.int32)
        if noise is None:
            noise = randn_like_on(latents, generator)
        noise = noise.to(latents.device, torch.float32)
        acp = self.alphas_cumprod
        one = torch.ones((), device=latents.device)
        z = torch.sqrt(acp[t]) * latents + torch.sqrt(1.0 - acp[t]) * noise
        for i in range(nsteps):
            ti = int(ts[i])
            tb = torch.full((z.shape[0],), ti, dtype=torch.int64,
                            device=z.device)
            e_c, e_u = self.predict_noise(z, tb, cond, uncond)
            eps = e_u + guidance_scale * (e_c - e_u)
            a_prev = acp[int(ts[i + 1])] if ts[i + 1] > 0 else one
            z = ddim_step(z, eps, acp[ti], a_prev)
        return z


class CLIPPromptEncoder:
    """`PromptEncoder` backed by the CLIP text tower."""

    def __init__(self, params, cfg: CLIPTextConfig = SD15_CLIP,
                 tokenizer_dir: Optional[str] = None, dtype=torch.float32,
                 device=None):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device, dtype)
        self.cfg = cfg
        self.tokenizer = CLIPTokenizerWrapper(cfg, tokenizer_dir)

    @classmethod
    def random_init(cls, gen: torch.Generator,
                    cfg: CLIPTextConfig = TEST_CLIP, **kw):
        return cls(init_clip_text_params(gen, cfg), cfg, **kw)

    @classmethod
    def from_torch_file(cls, path: str, cfg: CLIPTextConfig = SD15_CLIP,
                        allow_hash_tokenizer: bool = False, **kw):
        if kw.get("tokenizer_dir") is None and not allow_hash_tokenizer:
            # Real weights with the hash stand-in would encode meaningless
            # ids without an error: demand the vocabulary files (or an
            # explicit opt-in for smoke runs).
            raise FileNotFoundError(
                "real CLIP weights need tokenizer files: pass "
                "tokenizer_dir=<dir with vocab.json/merges.txt>, or "
                "allow_hash_tokenizer=True to knowingly run with hash ids"
            )
        sd = _load_torch_state_dict(path)
        return cls(convert_torch_clip_text(sd), cfg, **kw)

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
