"""Score Distillation Sampling (SDS) against a latent-diffusion prior.

Counterpart of `youreditableavatar_tpu/guidance/sds.py`:
  * timesteps sampled in an annealed [min, max] percentage range driven by
    `C()` schedules;
  * classifier-free-guidance noise mix ε̂ = ε_u + s·(ε_c − ε_u);
  * gradient w(t)·(ε̂ − ε) with w(t) = 1 − ᾱ_t, reparameterized as
    0.5·‖z − sg(z − grad)‖²/B so autograd delivers exactly that gradient;
  * NaN-guard + optional gradient clipping.

Where the JAX code draws the timestep and the noise from a PRNG key, these
take a `torch.Generator` — or the draws themselves (`t=`, `noise=`), which
is how the trainer's single seam of randomness hands them in.

The multi-step "du" edit mode (`SDSDUConfig`, `SDSDUGuidance`) is not
ported yet: it comes with the next slice and raises `NotImplementedError`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.base import DiffusionPrior
from youreditableavatar_tpu_torch.utils.schedule import C, ScheduleSpec


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
    def __init__(self, prior: DiffusionPrior, cfg: SDSConfig = SDSConfig()):
        self.prior = prior
        self.cfg = cfg

    def timestep_range(self, epoch: int, global_step: int) -> Tuple[int, int]:
        t_total = self.prior.num_train_timesteps
        mn = C(self.cfg.min_step_percent, epoch, global_step)
        mx = C(self.cfg.max_step_percent, epoch, global_step)
        return int(t_total * mn), int(t_total * mx)

    def _noised(self, images, generator, min_t, max_t, t, noise):
        latents = self.prior.encode_images(images, generator)
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
    ) -> Dict[str, Tensor]:
        """SDS loss on rendered images.

        Args:
          images: (B, H, W, 3) rendered (normal) images in [0, 1].
          cond/uncond_emb: (B, L, D) prompt embeddings.
          generator: draws t and the noise when they are not given.
          min_t/max_t: timestep bounds (ints; from `timestep_range`).
          t, noise: optional (B,) timesteps and latent-shaped noise.
        Returns dict(loss_sds, grad_norm, t).
        """
        latents, t, noise, acp, z_t = self._noised(
            images, generator, min_t, max_t, t, noise)
        eps_cond, eps_uncond = self.prior.predict_noise(
            z_t, t, cond_emb, uncond_emb)
        eps_hat = eps_uncond + self.cfg.guidance_scale * (eps_cond - eps_uncond)
        return self._loss(latents, eps_hat, noise, acp, t)


def perpendicular_component(x: Tensor, ref: Tensor) -> Tensor:
    """Component of x perpendicular to ref (per batch element)."""
    dims = tuple(range(1, x.dim()))
    dot = torch.sum(x * ref, dim=dims, keepdim=True)
    nrm = torch.sum(ref * ref, dim=dims, keepdim=True) + 1e-12
    return x - ref * (dot / nrm)


class PerpNegSDSGuidance(SDSGuidance):
    """SDS with Perp-Neg negative-view composition: each negative
    direction's classifier-free delta contributes only its component
    perpendicular to the positive delta, scaled by the azimuth-dependent
    weights of `PromptProcessor.get_text_embeddings_perp_neg`."""

    def __call__(
        self,
        images: Tensor,
        pos_emb: Tensor,
        uncond_emb: Tensor,
        generator: Optional[torch.Generator],
        min_t: int,
        max_t: int,
        neg_emb: Optional[Tensor] = None,
        neg_weights: Optional[Tensor] = None,
        t: Optional[Tensor] = None,
        noise: Optional[Tensor] = None,
    ) -> Dict[str, Tensor]:
        if neg_emb is None:
            return super().__call__(images, pos_emb, uncond_emb, generator,
                                    min_t, max_t, t=t, noise=noise)
        latents, t, noise, acp, z_t = self._noised(
            images, generator, min_t, max_t, t, noise)
        eps_pos, eps_unc = self.prior.predict_noise(z_t, t, pos_emb, uncond_emb)
        e_pos = eps_pos - eps_unc
        accum = e_pos
        for i in range(neg_emb.shape[1]):
            eps_neg, _ = self.prior.predict_noise(z_t, t, neg_emb[:, i],
                                                  uncond_emb)
            e_i = eps_neg - eps_unc
            accum = accum + neg_weights[:, i, None, None, None] * \
                perpendicular_component(e_i, e_pos)
        eps_hat = eps_unc + self.cfg.guidance_scale * accum
        return self._loss(latents, eps_hat, noise, acp, t)


_DU_LATER = ("the multi-step 'du' edit mode (SDSDUGuidance) is not ported "
             "yet; it comes with the next slice of the port")


@dataclasses.dataclass(frozen=True)
class SDSDUConfig(SDSConfig):
    """Multi-step "du" edit-mode settings."""

    per_editing_step: int = 10
    du_guidance_scale: float = 7.5
    steps_divisor: int = 25  # t//divisor + 1 denoise steps


class SDSDUGuidance(SDSGuidance):
    """The reference's multi-step "du" edit mode — not ported yet."""

    def __init__(self, prior, cfg: SDSDUConfig = SDSDUConfig(),
                 perceptual_fn=None):
        raise NotImplementedError(_DU_LATER)
