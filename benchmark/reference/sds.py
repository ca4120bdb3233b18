# Frozen copy of youreditableavatar_tpu_torch/guidance/sds.py (the plain PyTorch path only).
"""Score Distillation Sampling (SDS) against a latent-diffusion prior.

Counterpart of `youreditableavatar_tpu/guidance/sds.py`:
  * timesteps sampled in an annealed [min, max] percentage range driven by
    `C()` schedules;
  * classifier-free-guidance noise mix ε̂ = ε_u + s·(ε_c − ε_u);
  * gradient w(t)·(ε̂ − ε) with w(t) = 1 − ᾱ_t, reparameterized as
    0.5·‖z − sg(z − grad)‖²/B so autograd delivers exactly that gradient;
  * NaN-guard + optional gradient clipping.

The du edit mode and Perp-Neg are left out. The draws are taken as given
(`t=`, `noise=`, `enc_noise=`), as the trainer's seam hands them in.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from benchmark.reference.schedule import C, ScheduleSpec


@dataclasses.dataclass(frozen=True)
class SDSConfig:
    guidance_scale: float = 50.0
    min_step_percent: ScheduleSpec = 0.02
    max_step_percent: ScheduleSpec = 0.98
    grad_clip: Optional[float] = None
    weighting_strategy: str = "sds"  # w(t) = 1 − ᾱ_t


def draw_timestep_noise(
    latent_shape, min_t: int, max_t: int,
    generator: Optional[torch.Generator], device,
) -> Tuple[Tensor, Tensor]:
    """t ~ U{min_t..max_t} per batch element and ε ~ N(0, 1) of the latent
    shape, drawn on the CPU from `generator`, placed on `device`."""
    t = torch.randint(min_t, max_t + 1, (latent_shape[0],),
                      generator=generator)
    noise = torch.randn(tuple(latent_shape), generator=generator)
    return t.to(device), noise.to(device)


class SDSGuidance:
    def __init__(self, prior, cfg: SDSConfig = SDSConfig()):
        self.prior = prior
        self.cfg = cfg

    def timestep_range(self, epoch: int, global_step: int) -> Tuple[int, int]:
        t_total = self.prior.num_train_timesteps
        mn = C(self.cfg.min_step_percent, epoch, global_step)
        mx = C(self.cfg.max_step_percent, epoch, global_step)
        return int(t_total * mn), int(t_total * mx)

    def _noised(self, images, generator, min_t, max_t, t, noise,
                enc_noise=None):
        latents = self.prior.encode_images(images, generator, enc_noise)
        if t is None or noise is None:
            t, noise = draw_timestep_noise(latents.shape, min_t, max_t,
                                           generator, latents.device)
        t = t.to(latents.device)
        noise = noise.to(device=latents.device, dtype=latents.dtype)
        acp = self.prior.alphas_cumprod[t][:, None, None, None]
        z_t = torch.sqrt(acp) * latents + torch.sqrt(1.0 - acp) * noise
        return latents, t, noise, acp, z_t.detach()

    def _loss(self, latents, eps_hat, noise, acp, t) -> Dict[str, Tensor]:
        w = 1.0 - acp  # sds weighting
        grad = torch.nan_to_num(w * (eps_hat - noise))
        if self.cfg.grad_clip is not None:
            grad = torch.clamp(grad, -self.cfg.grad_clip, self.cfg.grad_clip)
        target = (latents - grad).detach()
        b = latents.shape[0]
        loss = 0.5 * torch.sum((latents - target) ** 2) / b
        return {"loss_sds": loss, "grad_norm": torch.linalg.norm(grad), "t": t}

    def __call__(
        self,
        images: Tensor,
        cond_emb: Tensor,
        uncond_emb: Tensor,
        generator: Optional[torch.Generator],
        min_t: int,
        max_t: int,
        t: Optional[Tensor] = None,
        noise: Optional[Tensor] = None,
        enc_noise: Optional[Tensor] = None,
    ) -> Dict[str, Tensor]:
        """SDS loss on rendered images.

        Args:
          images: (B, H, W, 3) rendered (normal) images in [0, 1].
          cond/uncond_emb: (B, L, D) prompt embeddings.
          generator: draws t and the noise when they are not given.
          min_t/max_t: timestep bounds (ints; from `timestep_range`).
          t, noise: optional (B,) timesteps and latent-shaped noise.
          enc_noise: optional latent-shaped ε of the encoder's sample.
        Returns dict(loss_sds, grad_norm, t).
        """
        latents, t, noise, acp, z_t = self._noised(
            images, generator, min_t, max_t, t, noise, enc_noise)
        eps_cond, eps_uncond = self.prior.predict_noise(
            z_t, t, cond_emb, uncond_emb)
        eps_hat = eps_uncond + self.cfg.guidance_scale * (eps_cond - eps_uncond)
        return self._loss(latents, eps_hat, noise, acp, t)

