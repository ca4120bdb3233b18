"""Score Distillation Sampling (SDS) against a latent-diffusion prior.

Counterpart of `youreditableavatar_tpu/guidance/sds.py`:
  * timesteps sampled in an annealed [min, max] percentage range driven by
    `C()` schedules;
  * classifier-free-guidance noise mix ε̂ = ε_u + s·(ε_c − ε_u);
  * gradient w(t)·(ε̂ − ε) with w(t) = 1 − ᾱ_t, reparameterized as
    0.5·‖z − sg(z − grad)‖²/B so autograd delivers exactly that gradient;
  * NaN-guard + optional gradient clipping; the non-finite entries of ε̂
    that the guard zeroes are counted first (`sds.nonfinite`, inside
    `profiling.counting()`, on the device), so an overflow of a
    half-precision UNet shows instead of vanishing.

  * the multi-step "du" edit mode (`SDSDUGuidance`): a per-view cache of
    multi-step-denoised edits of the render, refreshed every
    `per_editing_step` steps, and the latent-MSE + L1 + perceptual pulls
    toward it.

Where the JAX code draws the timestep and the noise from a PRNG key, these
take a `torch.Generator` — or the draws themselves (`t=`, `noise=`, and for
a prior whose encode samples, `enc_noise=`; the du edit's `edit_noise=`),
which is how the trainer's single seam of randomness hands them in.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.base import DiffusionPrior
from youreditableavatar_tpu_torch.utils.profiling import count, is_counting
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
        if is_counting():
            count("sds.nonfinite", torch.sum(~torch.isfinite(eps_hat)))
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
        enc_noise: Optional[Tensor] = None,
    ) -> Dict[str, Tensor]:
        if neg_emb is None:
            return super().__call__(images, pos_emb, uncond_emb, generator,
                                    min_t, max_t, t=t, noise=noise,
                                    enc_noise=enc_noise)
        latents, t, noise, acp, z_t = self._noised(
            images, generator, min_t, max_t, t, noise, enc_noise)
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


@dataclasses.dataclass(frozen=True)
class SDSDUConfig(SDSConfig):
    """Multi-step "du" edit-mode settings."""

    per_editing_step: int = 10
    du_guidance_scale: float = 7.5
    steps_divisor: int = 25  # t//divisor + 1 denoise steps


class SDSDUGuidance(SDSGuidance):
    """SDS guidance with the reference's multi-step "du" edit mode.

    Every `per_editing_step` steps a cached per-view "edited image" is
    refreshed by multi-step denoising of the render's noised latents under
    CFG; between refreshes the render is pulled toward the cache with
    latent-MSE + L1 + perceptual losses.

    The cache is host-side state (a dict keyed by view index). The
    multi-step edit runs under `torch.no_grad()` on detached inputs, so
    only the three comparison losses are differentiated. The perceptual
    term is any `perceptual_fn(pred, target)`, e.g. `ops.lpips.LPIPS`.
    """

    def __init__(self, prior, cfg: SDSDUConfig = SDSDUConfig(),
                 perceptual_fn=None):
        super().__init__(prior, cfg)
        self.edited_images: Dict[int, Tensor] = {}
        self.perceptual_fn = perceptual_fn

    def maybe_refresh(
        self,
        images: Tensor,
        cond_emb: Tensor,
        uncond_emb: Tensor,
        generator: Optional[torch.Generator],
        min_t: int,
        max_t: int,
        view_index: int,
        global_step: int,
        t: Optional[int] = None,
        enc_noise: Optional[Tensor] = None,
        edit_noise: Optional[Tensor] = None,
    ) -> Tensor:
        """Refresh the per-view edited-image cache if due; return the cached
        edit for `view_index`.

        `images` must be the CURRENT render (it is detached here). The
        timestep `t` ~ U{min_t..max_t}, the encoder's sample and the edit's
        noise are drawn from `generator` unless given (`t`, `enc_noise`,
        `edit_noise`).
        """
        cfg: SDSDUConfig = self.cfg  # type: ignore[assignment]
        refresh = (view_index not in self.edited_images
                   or global_step % cfg.per_editing_step == 0)
        if refresh:
            if t is None:
                t = int(torch.randint(min_t, max_t + 1, (),
                                      generator=generator))
            with torch.no_grad():
                latents = self.prior.encode_images(images.detach(), generator,
                                                   enc_noise)
                edit_latents = self.prior.edit_latents(
                    latents, int(t), cond_emb, uncond_emb, generator,
                    cfg.du_guidance_scale, cfg.steps_divisor,
                    noise=edit_noise)
                edit = self.prior.decode_latents(edit_latents)
                if edit.shape != images.shape:
                    from youreditableavatar_tpu_torch.stages.edit_texture \
                        import _resize_bilinear

                    h, w = images.shape[1:3]
                    edit = torch.stack([_resize_bilinear(e, h, w)
                                        for e in edit])
            self.edited_images[view_index] = edit.detach()
        return self.edited_images[view_index]

    def du_loss_terms(self, images: Tensor, gt: Tensor,
                      generator: Optional[torch.Generator] = None,
                      enc_noise: Optional[Tensor] = None,
                      ) -> Dict[str, Tensor]:
        """Differentiable du comparison losses against a cached edit `gt`:
        latent MSE + image L1 (+ perceptual, with a `perceptual_fn`). Both
        encodes take the same sample ε (`enc_noise`, when given), as the
        JAX code's one key does."""
        if enc_noise is None and generator is not None:
            enc_noise = _sample_noise(self.prior, images, generator)
        latents = self.prior.encode_images(images, generator, enc_noise)
        with torch.no_grad():
            gt_latents = self.prior.encode_images(gt.detach(), generator,
                                                  enc_noise)
        b = images.shape[0]
        out = {"loss_f": torch.sum((latents - gt_latents) ** 2) / b,
               "loss_l1": torch.sum(torch.abs(images - gt)) / b}
        if self.perceptual_fn is not None:
            out["loss_p"] = torch.sum(self.perceptual_fn(images, gt)) / b
        return out

    def du_losses(
        self,
        images: Tensor,
        cond_emb: Tensor,
        uncond_emb: Tensor,
        generator: Optional[torch.Generator],
        min_t: int,
        max_t: int,
        view_index: int,
        global_step: int,
        t: Optional[int] = None,
        enc_noise: Optional[Tensor] = None,
        edit_noise: Optional[Tensor] = None,
    ) -> Dict[str, Tensor]:
        """Multi-step edit losses for one view batch (B=1); the refresh and
        the comparison share one encoder sample, as in the JAX code."""
        if enc_noise is None and generator is not None:
            enc_noise = _sample_noise(self.prior, images, generator)
        gt = self.maybe_refresh(images, cond_emb, uncond_emb, generator,
                                min_t, max_t, view_index, global_step, t=t,
                                enc_noise=enc_noise, edit_noise=edit_noise)
        return self.du_loss_terms(images, gt, generator, enc_noise)


def _sample_noise(prior, images: Tensor,
                  generator: torch.Generator) -> Tensor:
    """One N(0, 1) draw of the prior's latent shape for `images`."""
    d = prior.latent_downscale
    b, h, w, _ = images.shape
    return torch.randn((b, h // d, w // d, prior.latent_channels),
                       generator=generator,
                       device=generator.device).to(images.device)
