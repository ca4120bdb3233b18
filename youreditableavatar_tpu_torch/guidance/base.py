"""Backend protocols for diffusion priors and text encoders.

Counterpart of `youreditableavatar_tpu/guidance/base.py`. Where the JAX
protocols take a PRNG key, these take a `torch.Generator` (or None).
"""

from __future__ import annotations

from typing import Optional, Protocol, Tuple

import torch
from torch import Tensor


class DiffusionPrior(Protocol):
    """A latent-diffusion denoiser (SD1.5-shaped for the SDS stage)."""

    latent_channels: int
    latent_downscale: int  # image→latent spatial factor (8 for SD VAEs)
    num_train_timesteps: int
    alphas_cumprod: Tensor  # (T,) ᾱ schedule

    def encode_images(self, images: Tensor,
                      generator: Optional[torch.Generator],
                      noise: Optional[Tensor] = None) -> Tensor:
        """(B, H, W, 3) in [0,1] → (B, h, w, C) latents (differentiable);
        a sampling encoder draws from `generator`, or takes `noise`."""
        ...

    def predict_noise(
        self, z_t: Tensor, t: Tensor, cond: Tensor, uncond: Tensor
    ) -> Tuple[Tensor, Tensor]:
        """ε̂ under text cond and uncond; both (B, h, w, C)."""
        ...


class PromptEncoder(Protocol):
    def encode(self, prompts: list[str]) -> Tensor:
        """List of strings → (B, L, D) embeddings."""
        ...


class Inpainter(Protocol):
    """Image-space inpainting prior (SDXL+ControlNet-Union role)."""

    def inpaint(
        self,
        image,
        mask,
        control_normal,
        control_repaint,
        prompt: str,
        negative_prompt: str,
        generator: Optional[torch.Generator],
        strength: float = 1.0,
        steps: int = 30,
    ):
        """(H, W, 3) image + (H, W) mask → inpainted (H, W, 3)."""
        ...

    def img2img(
        self, image, control, prompt: str,
        generator: Optional[torch.Generator], strength: float = 0.4,
        steps: int = 30,
    ):
        ...
