"""Stub guidance backends for pipeline smoke runs.

Counterpart of `youreditableavatar_tpu/guidance/stub.py`: deterministic,
weight-free stand-ins so the stages that consume a `DiffusionPrior`, an
`Inpainter` or a `PromptEncoder` run end to end. `StubDiffusionPrior` is a
tiny fixed-weight conv "denoiser" over 4-channel average-pooled latents
(its weights drawn from a seeded `torch.Generator`;
`stub_prior_from_numpy` carries the JAX prior's across);
`StubPromptEncoder` hashes text into a deterministic embedding;
`StubInpainter` blends the masked region toward the control image.
"""

from __future__ import annotations

import hashlib
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.sd_layers import conv2d
from youreditableavatar_tpu_torch.utils.device import resolve_device


class StubDiffusionPrior:
    latent_channels = 4
    latent_downscale = 8
    num_train_timesteps = 1000

    def __init__(self, seed: int = 0, emb_dim: int = 64, device=None):
        self.device = resolve_device(device)
        betas = np.linspace(0.00085**0.5, 0.012**0.5, 1000) ** 2  # SD schedule
        self.alphas_cumprod = torch.as_tensor(
            np.cumprod(1.0 - betas).astype(np.float32), device=self.device)
        g = torch.Generator().manual_seed(seed)
        self._w1 = (torch.randn((3, 3, 4 + 1, 16), generator=g) * 0.1).to(
            self.device)
        self._w2 = (torch.randn((3, 3, 16, 4), generator=g) * 0.1).to(self.device)
        self._cond_proj = (torch.randn((64, 4), generator=g) * 0.1).to(
            self.device)
        self.emb_dim = emb_dim

    def encode_images(self, images: Tensor,
                      generator: Optional[torch.Generator] = None) -> Tensor:
        """(B, H, W, 3) → (B, H/8, W/8, 4): avg-pool + channel lift."""
        b, h, w, _ = images.shape
        d = self.latent_downscale
        x = images[:, : h // d * d, : w // d * d]
        x = x.reshape(b, h // d, d, w // d, d, 3).mean((2, 4))
        lum = torch.mean(x, dim=-1, keepdim=True)
        return torch.cat([x, lum], dim=-1) * 2.0 - 1.0

    def _unet(self, z_t: Tensor, t: Tensor, emb: Tensor) -> Tensor:
        tt = (t.to(torch.float32) / self.num_train_timesteps)[
            :, None, None, None
        ]
        x = torch.cat([z_t, tt.expand(z_t.shape[:-1] + (1,))], dim=-1)
        x = conv2d(x, {"w": self._w1})
        x = F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
        x = conv2d(x, {"w": self._w2})
        cond_bias = torch.mean(emb, dim=1) @ self._cond_proj  # (B, 4)
        return x + cond_bias[:, None, None, :]

    def predict_noise(
        self, z_t: Tensor, t: Tensor, cond: Tensor, uncond: Tensor
    ) -> Tuple[Tensor, Tensor]:
        return self._unet(z_t, t, cond), self._unet(z_t, t, uncond)

    def decode_latents(self, latents: Tensor) -> Tensor:
        """Inverse of the stub encode: first 3 channels, ×8 bilinear upsample."""
        from youreditableavatar_tpu_torch.stages.edit_texture import (
            _resize_bilinear)

        b, h, w, _ = latents.shape
        d = self.latent_downscale
        x = (latents[..., :3] + 1.0) * 0.5
        up = torch.stack([_resize_bilinear(x[i], h * d, w * d)
                          for i in range(b)])
        return torch.clamp(up, 0.0, 1.0)

    def edit_latents(self, latents, t, cond, uncond, generator=None,
                     guidance_scale=7.5, steps_divisor=25):
        """Deterministic single-step pull toward the cond embedding."""
        tb = torch.full((latents.shape[0],), int(t), dtype=torch.int64,
                        device=latents.device)
        eps_c, eps_u = self.predict_noise(latents, tb, cond, uncond)
        return latents - 0.1 * (eps_u + guidance_scale * (eps_c - eps_u))


def stub_prior_from_numpy(d: Mapping[str, np.ndarray], seed: int = 0,
                          emb_dim: int = 64, device=None) -> StubDiffusionPrior:
    """A `StubDiffusionPrior` whose `_w1`, `_w2` and `_cond_proj` are the
    given arrays (a JAX prior's weights as numpy)."""
    prior = StubDiffusionPrior(seed, emb_dim, device=device)
    for name in ("_w1", "_w2", "_cond_proj"):
        setattr(prior, name, torch.as_tensor(
            np.array(d[name], np.float32), device=prior.device))
    return prior


class StubPromptEncoder:
    def __init__(self, length: int = 8, dim: int = 64, device=None):
        self.length = length
        self.dim = dim
        self.device = resolve_device(device)

    def encode(self, prompts: list[str]) -> Tensor:
        out = []
        for p in prompts:
            h = hashlib.sha256(p.encode()).digest()
            seed = int.from_bytes(h[:4], "little")
            rng = np.random.default_rng(seed)
            out.append(rng.normal(size=(self.length, self.dim)))
        return torch.as_tensor(np.stack(out).astype(np.float32),
                               device=self.device)


class StubInpainter:
    """Deterministic mask-blend standing in for SDXL ControlNet inpainting."""

    def inpaint(
        self, image, mask, control_normal, control_repaint, prompt: str,
        negative_prompt: str = "",
        generator: Optional[torch.Generator] = None, strength: float = 1.0,
        steps: int = 30,
    ):
        image = torch.as_tensor(image)
        m = torch.as_tensor(mask, device=image.device)[..., None]
        base = torch.as_tensor(control_repaint, device=image.device)
        tint = (
            torch.as_tensor(control_normal, device=image.device) * 0.5
            + 0.5 * self._prompt_color(prompt, image.device)
        )
        filled = 0.5 * base + 0.5 * tint
        return image * (1 - m) + filled * m

    def img2img(self, image, control, prompt: str,
                generator: Optional[torch.Generator] = None,
                strength: float = 0.4, steps: int = 30):
        image = torch.as_tensor(image)
        return image * (1 - 0.1 * strength) + 0.1 * strength * \
            self._prompt_color(prompt, image.device)

    @staticmethod
    def _prompt_color(prompt: str, device) -> Tensor:
        h = hashlib.sha256(prompt.encode()).digest()
        return torch.tensor([h[0], h[1], h[2]], dtype=torch.float32,
                            device=device) / 255.0
