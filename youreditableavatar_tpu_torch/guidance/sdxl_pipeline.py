"""SDXL + ControlNet-Union inpaint and img2img pipelines.

Counterpart of `youreditableavatar_tpu/guidance/sdxl_pipeline.py`, the two
vendored diffusers pipelines the texture edit drives:

  * `inpaint` — latent inpainting with two union control streams at once
    (normal + masked repaint), each step's latents pinned to the noised
    original outside the mask, CFG;
  * `img2img` — strength-truncated img2img with the tile control, used by
    `sdxl_tile_refine`, with its 2×2 crop path at twice the size.

Scheduling is DDIM (η = 0) over a strength-truncated ladder. Each
denoising step runs ControlNet + UNet once over the batch [cond; uncond]
under `torch.no_grad()`. Implements the `Inpainter` protocol
(`guidance/base.py`), so `InpaintTrainer` and the refine consume it as
they consume the stub.

Randomness: the posterior sample of the encode, the initial noise and
each pinned step's noise are drawn from the `generator`, or taken from
`draws(name, shape)` when it is given — names "encode", "noise" and
"pin/<i>" (the i-th step's), prefixed "crop<q>/" in `sdxl_tile_refine`'s
crops — so a test can hand in the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from youreditableavatar_tpu_torch.guidance.sd15 import (
    ddim_step,
    ddpm_alphas_cumprod,
)
from youreditableavatar_tpu_torch.guidance.sd_layers import tree_to
from youreditableavatar_tpu_torch.guidance.sd_unet import (
    SDXL_UNET,
    TEST_SDXL_UNET,
    UNetConfig,
    _load_torch_state_dict,
    apply_unet,
    convert_torch_unet,
    init_unet_params,
)
from youreditableavatar_tpu_torch.guidance.sd_vae import (
    SDXL_VAE,
    TEST_VAE,
    VAEConfig,
    convert_torch_vae,
    init_vae_params,
    vae_decode,
    vae_encode,
)
from youreditableavatar_tpu_torch.guidance.sdxl_controlnet import (
    SDXL_CONTROLNET_UNION,
    TEST_CONTROLNET_UNION,
    ControlNetUnionConfig,
    apply_controlnet_union,
    convert_torch_controlnet_union,
    init_controlnet_union_params,
)
from youreditableavatar_tpu_torch.utils.device import resolve_device
from youreditableavatar_tpu_torch.utils.profiling import span

# union-promax control-type slots (controlnet_union README ordering)
CTRL_OPENPOSE, CTRL_DEPTH, CTRL_HED, CTRL_CANNY = 0, 1, 2, 3
CTRL_NORMAL, CTRL_SEGMENT, CTRL_TILE, CTRL_REPAINT = 4, 5, 6, 7

Draws = Callable[[str, Tuple[int, ...]], Tensor]


@dataclasses.dataclass(frozen=True)
class SDXLPipelineConfig:
    unet: UNetConfig = SDXL_UNET
    vae: VAEConfig = SDXL_VAE
    controlnet: ControlNetUnionConfig = SDXL_CONTROLNET_UNION
    num_train_timesteps: int = 1000
    guidance_scale: float = 7.5
    controlnet_scale: float = 1.0


TEST_SDXL_PIPELINE = SDXLPipelineConfig(
    unet=TEST_SDXL_UNET, vae=TEST_VAE, controlnet=TEST_CONTROLNET_UNION,
)


def _prefixed(draws: Optional[Draws], prefix: str) -> Optional[Draws]:
    if draws is None:
        return None
    return lambda name, shape: draws(prefix + name, shape)


class SDXLControlNetUnionPipeline:
    """Inpaint + img2img with union controls (implements `Inpainter`)."""

    def __init__(self, unet_params, vae_params, controlnet_params,
                 text_encoder, cfg: SDXLPipelineConfig = TEST_SDXL_PIPELINE,
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        self.unet_params = tree_to(unet_params, self.device, dtype)
        self.vae_params = tree_to(vae_params, self.device, dtype)
        self.controlnet_params = tree_to(controlnet_params, self.device, dtype)
        self.text_encoder = text_encoder
        self.cfg = cfg
        self.dtype = dtype
        self.alphas_cumprod = ddpm_alphas_cumprod(cfg.num_train_timesteps,
                                                  device=self.device)

    # ------------------------------------------------------------ constructors

    @classmethod
    def random_init(cls, gen: torch.Generator, text_encoder=None,
                    cfg: SDXLPipelineConfig = TEST_SDXL_PIPELINE, **kw):
        """Random weights drawn from `gen` on its device; without a text
        encoder, a random CLIP (TEST_CLIP) behind random projections."""
        from youreditableavatar_tpu_torch.guidance.sd15 import (
            CLIPPromptEncoder)

        unet = init_unet_params(gen, cfg.unet)
        vae = init_vae_params(gen, cfg.vae)
        controlnet = init_controlnet_union_params(gen, cfg.controlnet)
        if text_encoder is None:
            text_encoder = _ProjectedTextEncoder(
                CLIPPromptEncoder.random_init(gen, device=kw.get("device")),
                cfg.unet, gen)
        return cls(unet, vae, controlnet, text_encoder, cfg, **kw)

    @classmethod
    def from_torch_files(cls, unet_path: str, vae_path: str,
                         controlnet_path: str, text_encoder,
                         cfg: SDXLPipelineConfig = None, **kw):
        cfg = cfg or SDXLPipelineConfig()
        return cls(
            convert_torch_unet(_load_torch_state_dict(unet_path), cfg.unet),
            convert_torch_vae(_load_torch_state_dict(vae_path), cfg.vae),
            convert_torch_controlnet_union(
                _load_torch_state_dict(controlnet_path)),
            text_encoder, cfg, **kw,
        )

    # ------------------------------------------------------------ internals

    def _encode_prompt(self, prompt: str, negative: str):
        with span("text"):
            cond = self.text_encoder.encode_with_pooled([prompt])
            uncond = self.text_encoder.encode_with_pooled([negative])
            return cond, uncond

    def _timesteps(self, steps: int, strength: float) -> np.ndarray:
        t_total = self.cfg.num_train_timesteps
        init_t = min(int(t_total * strength), t_total - 1)
        n = max(int(round(steps * strength)), 1)
        return np.linspace(init_t, 0, n + 1).round().astype(np.int32)

    def _draw(self, draws: Optional[Draws], name: str, shape,
              generator: Optional[torch.Generator]) -> Tensor:
        if draws is not None:
            x = draws(name, tuple(shape))
        else:
            where = generator.device if generator is not None else self.device
            x = torch.randn(tuple(shape), generator=generator, device=where)
        return torch.as_tensor(x).to(self.device, torch.float32)

    def _cfg_batch(self, cond, uncond, b: int):
        (ctx_c, pool_c), (ctx_u, pool_u) = cond, uncond

        def bc(x):
            x = torch.as_tensor(x, device=self.device)
            return x.expand((b,) + tuple(x.shape[1:]))

        return (torch.cat([bc(ctx_c), bc(ctx_u)]).to(self.dtype),
                torch.cat([bc(pool_c), bc(pool_u)]).to(self.dtype))

    def _denoise(self, z: Tensor, ti: int, ctx2: Tensor, pooled2: Tensor,
                 controls) -> Tensor:
        """CFG noise prediction: [cond; uncond] through ControlNet + UNet
        as one batch."""
        b = z.shape[0]
        dsc = self.cfg.vae.downscale
        dt = self.dtype
        z2 = torch.cat([z, z]).to(dt)
        tb = torch.full((2 * b,), ti, dtype=torch.int64, device=z.device)
        hh, ww = z.shape[1] * dsc, z.shape[2] * dsc
        px = torch.tensor([hh, ww, 0, 0, hh, ww], dtype=torch.float32,
                          device=z.device)
        add_cond = (pooled2, px[None].expand(2 * b, 6).to(dt))
        residuals = None
        if controls:
            residuals = apply_controlnet_union(
                self.controlnet_params, z2, tb, ctx2,
                [(t, torch.cat([im, im]).to(dt)) for t, im in controls],
                self.cfg.controlnet, add_cond, self.cfg.controlnet_scale)
        eps2 = apply_unet(self.unet_params, z2, tb, ctx2, self.cfg.unet,
                          add_cond, residuals).to(torch.float32)
        return eps2[b:] + self.cfg.guidance_scale * (eps2[:b] - eps2[b:])

    def _step(self, z, ti: int, tp: int, ctx2, pooled2, controls) -> Tensor:
        """One CFG + DDIM step from ts[i] = ti to ts[i + 1] = tp."""
        eps = self._denoise(z, ti, ctx2, pooled2, controls)
        acp = self.alphas_cumprod
        a_prev = acp[tp] if tp > 0 else torch.ones((), device=z.device)
        return ddim_step(z, eps, acp[ti], a_prev)

    def _image(self, x) -> Tensor:
        return torch.as_tensor(x).to(self.device, torch.float32)

    def _encode_image(self, image: Tensor, generator, draws) -> Tensor:
        x = (image[None] * 2.0 - 1.0).to(self.dtype)
        cfg = self.cfg.vae
        h, w = image.shape[0] // cfg.downscale, image.shape[1] // cfg.downscale
        eps = self._draw(draws, "encode", (1, h, w, cfg.latent_channels),
                         generator)
        z = vae_encode(self.vae_params, x, None, cfg, noise=eps)
        return (z * cfg.scaling_factor).to(torch.float32)

    def _decode(self, latents: Tensor) -> Tensor:
        z = (latents / self.cfg.vae.scaling_factor).to(self.dtype)
        img = vae_decode(self.vae_params, z, self.cfg.vae)
        return torch.clamp(img.to(torch.float32) * 0.5 + 0.5, 0, 1)[0]

    # ------------------------------------------------------------ protocol

    def inpaint(self, image, mask, control_normal, control_repaint,
                prompt: str, negative_prompt: str = "",
                generator: Optional[torch.Generator] = None,
                strength: float = 1.0, steps: int = 30,
                draws: Optional[Draws] = None) -> Tensor:
        """Mask-blended latent inpainting with both union controls.

        image/control_*: (H, W, 3) in [0, 1]; mask: (H, W), 1 = repaint.
        Returns the (H, W, 3) result on the pipeline's device.
        """
        with span("inpaint.call"), torch.no_grad():
            image = self._image(image)
            z_orig = self._encode_image(image, generator, draws)
            # Nearest with half-pixel centres (pixel 8i + 4 at a factor of
            # 8), as jax.image.resize's "nearest"; mode="nearest" would
            # take pixel 8i.
            m = F.interpolate(self._image(mask)[None, None],
                              size=tuple(z_orig.shape[1:3]),
                              mode="nearest-exact")[0, 0][None, :, :, None]
            cond, uncond = self._encode_prompt(prompt, negative_prompt)
            controls = [(CTRL_NORMAL, self._image(control_normal)[None]),
                        (CTRL_REPAINT, self._image(control_repaint)[None])]
            ts = self._timesteps(steps, strength)
            noise = self._draw(draws, "noise", z_orig.shape, generator)
            acp = self.alphas_cumprod
            t0 = int(ts[0])
            if strength >= 1.0:
                # At full strength the reference starts from pure noise.
                z = noise
            else:
                z = torch.sqrt(acp[t0]) * z_orig \
                    + torch.sqrt(1.0 - acp[t0]) * noise
            ctx2, pooled2 = self._cfg_batch(cond, uncond, z.shape[0])
            for i in range(len(ts) - 1):
                ti, tp = int(ts[i]), int(ts[i + 1])
                z = self._step(z, ti, tp, ctx2, pooled2, controls)
                # Outside the mask: the original, noised to the next level.
                if tp > 0:
                    zn = torch.sqrt(acp[tp]) * z_orig + torch.sqrt(
                        1.0 - acp[tp]) * self._draw(draws, f"pin/{i}",
                                                    z_orig.shape, generator)
                else:
                    zn = z_orig
                z = m * z + (1.0 - m) * zn
            return self._decode(z)

    def img2img(self, image, control, prompt: str,
                generator: Optional[torch.Generator] = None,
                strength: float = 0.4, steps: int = 30,
                control_type: int = CTRL_TILE, negative_prompt: str = "",
                draws: Optional[Draws] = None) -> Tensor:
        """Strength-truncated img2img with one union control (tile)."""
        with torch.no_grad():
            image = self._image(image)
            z_orig = self._encode_image(image, generator, draws)
            cond, uncond = self._encode_prompt(prompt, negative_prompt)
            controls = []
            if control is not None:
                controls = [(control_type, self._image(control)[None])]
            ts = self._timesteps(steps, strength)
            noise = self._draw(draws, "noise", z_orig.shape, generator)
            acp = self.alphas_cumprod
            t0 = int(ts[0])
            z = torch.sqrt(acp[t0]) * z_orig + torch.sqrt(1.0 - acp[t0]) * noise
            ctx2, pooled2 = self._cfg_batch(cond, uncond, z.shape[0])
            for i in range(len(ts) - 1):
                z = self._step(z, int(ts[i]), int(ts[i + 1]), ctx2, pooled2,
                               controls)
            return self._decode(z)


class _ProjectedTextEncoder:
    """A CLIP encoder behind random projections to the SDXL (ctx, pooled)
    interface, for random-weight runs (real SDXL uses two towers:
    `SDXLTextEncoder`). The projections are drawn from `gen`, or given."""

    def __init__(self, clip_encoder, unet_cfg: UNetConfig,
                 gen: Optional[torch.Generator] = None,
                 ctx_proj: Optional[Tensor] = None,
                 pool_proj: Optional[Tensor] = None):
        self.clip = clip_encoder
        d = clip_encoder.cfg.dim
        dev = clip_encoder.device

        def draw(shape):
            where = gen.device if gen is not None else dev
            return torch.randn(shape, generator=gen, device=where) / np.sqrt(d)

        self.ctx_proj = torch.as_tensor(
            ctx_proj if ctx_proj is not None else draw((d, unet_cfg.ctx_dim)),
            dtype=torch.float32).to(dev)
        self.pool_proj = torch.as_tensor(
            pool_proj if pool_proj is not None
            else draw((d, unet_cfg.pooled_dim)), dtype=torch.float32).to(dev)

    def encode_with_pooled(self, prompts):
        h = self.clip.encode(prompts)
        return h @ self.ctx_proj, h.mean(dim=1) @ self.pool_proj


class SDXLTextEncoder:
    """Dual-tower SDXL text encoding: the CLIP-L and CLIP-bigG penultimate
    contexts concatenated to the UNet's 2048-wide context, and bigG's final
    layer at the first EOS, text-projected, as the pooled embedding."""

    def __init__(self, enc_l, enc_g, proj_g):
        self.enc_l = enc_l  # hidden 768
        self.enc_g = enc_g  # hidden 1280
        self.proj_g = torch.as_tensor(proj_g, dtype=torch.float32).to(
            enc_g.device)  # (1280, 1280) text projection for the pooled

    def encode_with_pooled(self, prompts):
        h_l, _ = self.enc_l.encode_penultimate(prompts)
        h_g, _ = self.enc_g.encode_penultimate(prompts)
        ctx = torch.cat([h_l.to(h_g.device), h_g], dim=-1)
        pooled = self.enc_g.encode_pooled(prompts) @ self.proj_g
        return ctx, pooled


def sdxl_tile_refine(
    pipe: SDXLControlNetUnionPipeline,
    image,
    prompt: str,
    generator: Optional[torch.Generator] = None,
    strength: float = 0.4,
    steps: int = 30,
    upscale_to_2048: bool = False,
    draws: Optional[Draws] = None,
) -> Tensor:
    """Per-view tile-controlled img2img refinement.

    With `upscale_to_2048`: a 2× bilinear upscale, each of the 2×2 crops
    refined on its own (crop q's draws prefixed "crop<q>/"), and the
    crops reassembled — the UNet stays at its native size while the output
    doubles.
    """
    from youreditableavatar_tpu_torch.stages.edit_texture import (
        _resize_bilinear)

    image = torch.as_tensor(image).to(pipe.device, torch.float32)
    if not upscale_to_2048:
        return pipe.img2img(image, image, prompt, generator, strength, steps,
                            draws=draws)
    h, w, _ = image.shape
    big = _resize_bilinear(image, h * 2, w * 2)
    out = []
    for qi, (ys, xs) in enumerate(((0, 0), (0, w), (h, 0), (h, w))):
        crop = big[ys:ys + h, xs:xs + w]
        out.append(pipe.img2img(crop, crop, prompt, generator, strength,
                                steps, draws=_prefixed(draws, f"crop{qi}/")))
    return torch.cat([torch.cat(out[:2], dim=1), torch.cat(out[2:], dim=1)],
                     dim=0)
