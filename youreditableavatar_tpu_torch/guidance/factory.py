"""Guidance backend factory: name → (DiffusionPrior, PromptEncoder),
name → Inpainter and name → Segmenter.

Counterpart of `youreditableavatar_tpu/guidance/factory.py`: the real
SD1.5, SDXL, SAM and GroundingDINO backends load weights the user supplies
(none ship with the repository); without weights the stubs and heuristics,
or tiny random-weight networks that run the whole real code path, keep
every stage runnable.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from youreditableavatar_tpu_torch.guidance.clip_text import CLIPTextConfig
from youreditableavatar_tpu_torch.utils.device import resolve_device

_CKPT_NAMES = (
    "diffusion_pytorch_model.safetensors",
    "diffusion_pytorch_model.bin",
    "model.safetensors",
    "pytorch_model.bin",
)


def _find_ckpt(weights_dir: str, sub: str) -> str:
    d = os.path.join(weights_dir, sub)
    for fname in _CKPT_NAMES:
        p = os.path.join(d, fname)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no checkpoint file under {d}")


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


def sd15_backend(unet_params, vae_params, clip_params, unet_cfg, vae_cfg,
                 clip_cfg: CLIPTextConfig, half_precision_weights=False,
                 device=None, tokenizer_dir: Optional[str] = None
                 ) -> Tuple[object, object]:
    """SD1.5's (prior, prompt encoder) on parameter trees.

    `half_precision_weights` (threestudio's name) holds the UNet, the VAE
    and the CLIP text encoder in fp16 and runs them in fp16; else f32.
    """
    from youreditableavatar_tpu_torch.guidance.sd15 import (
        CLIPPromptEncoder,
        SD15Prior,
    )

    dtype = torch.float16 if half_precision_weights else torch.float32
    return (SD15Prior(unet_params, vae_params, unet_cfg, vae_cfg, dtype=dtype,
                      device=device),
            CLIPPromptEncoder(clip_params, clip_cfg, tokenizer_dir,
                              dtype=dtype, device=device))


def make_guidance_backend(
    name: str = "stub",
    weights_dir: Optional[str] = None,
    seed: int = 0,
    device=None,
    half_precision_weights: bool = False,
) -> Tuple[object, object]:
    """Build (prior, prompt_encoder) for the spatial stage.

    name:
      "stub"         — deterministic conv stub + hash prompt encoder.
      "sd15"         — SD1.5; `weights_dir` holds a diffusers layout
                       (unet/, vae/, text_encoder/, tokenizer/) with .bin
                       or .safetensors checkpoints.
      "sd15-random"  — tiny random-weight SD1.5 (the whole real code path,
                       no weights).

    `half_precision_weights` runs the SD1.5 networks in fp16
    (`sd15_backend`). The default is f32. The stub has no networks to
    narrow.
    """
    if name == "stub":
        from youreditableavatar_tpu_torch.guidance.stub import (
            StubDiffusionPrior,
            StubPromptEncoder,
        )

        return (StubDiffusionPrior(seed, device=device),
                StubPromptEncoder(device=device))

    if name == "sd15-random":
        from youreditableavatar_tpu_torch.guidance.clip_text import (
            TEST_CLIP, init_clip_text_params)
        from youreditableavatar_tpu_torch.guidance.sd_unet import (
            TEST_UNET, init_unet_params)
        from youreditableavatar_tpu_torch.guidance.sd_vae import (
            TEST_VAE, init_vae_params)

        gen = _generator(seed, device)
        return sd15_backend(
            init_unet_params(gen, TEST_UNET), init_vae_params(gen, TEST_VAE),
            init_clip_text_params(gen, TEST_CLIP), TEST_UNET, TEST_VAE,
            TEST_CLIP, half_precision_weights, device)

    if name == "sd15":
        from youreditableavatar_tpu_torch.guidance.clip_text import (
            SD15_CLIP, convert_torch_clip_text)
        from youreditableavatar_tpu_torch.guidance.sd_unet import (
            SD15_UNET, _load_torch_state_dict, convert_torch_unet)
        from youreditableavatar_tpu_torch.guidance.sd_vae import (
            SD_VAE, convert_torch_vae)

        if not weights_dir or not os.path.isdir(weights_dir):
            raise FileNotFoundError(
                f"sd15 backend needs --sd-weights pointing at a diffusers "
                f"layout directory (got {weights_dir!r}); use 'stub' or "
                f"'sd15-random' to run without weights"
            )
        tok_dir = os.path.join(weights_dir, "tokenizer")
        if not os.path.isdir(tok_dir):
            # Real weights with the hash stand-in would encode meaningless
            # ids without an error.
            raise FileNotFoundError(f"real CLIP weights need tokenizer "
                                    f"files (vocab.json, merges.txt) in "
                                    f"{tok_dir}")

        def load(sub):
            return _load_torch_state_dict(_find_ckpt(weights_dir, sub))

        return sd15_backend(
            convert_torch_unet(load("unet"), SD15_UNET),
            convert_torch_vae(load("vae"), SD_VAE),
            convert_torch_clip_text(load("text_encoder")), SD15_UNET, SD_VAE,
            SD15_CLIP, half_precision_weights, device, tok_dir)

    raise ValueError(f"unknown guidance backend {name!r}")


# The CLIP-bigG text tower (SDXL's text_encoder_2: hidden 1280, 32 layers,
# gelu, unlike the quick_gelu CLIP-L tower).
BIGG_CLIP = CLIPTextConfig(dim=1280, layers=32, heads=20, mlp_dim=5120,
                           act="gelu")


def make_inpainter_backend(
    name: str = "stub",
    weights_dir: Optional[str] = None,
    seed: int = 0,
    device=None,
):
    """Build an `Inpainter` for the texture stages.

    name:
      "stub"         — deterministic mask-blend stub.
      "sdxl"         — SDXL + ControlNet-Union; `weights_dir` holds a
                       diffusers layout (unet/, vae/, controlnet/,
                       text_encoder/, text_encoder_2/, tokenizer*/).
      "sdxl-random"  — tiny random-weight SDXL pipeline (the whole real
                       code path: union controls, mask pinning, the DDIM
                       loop).
    """
    if name == "stub":
        from youreditableavatar_tpu_torch.guidance.stub import StubInpainter

        return StubInpainter()

    if name == "sdxl-random":
        from youreditableavatar_tpu_torch.guidance.sdxl_pipeline import (
            SDXLControlNetUnionPipeline,
        )

        return SDXLControlNetUnionPipeline.random_init(
            _generator(seed, device), device=device)

    if name == "sdxl":
        from youreditableavatar_tpu_torch.guidance.sd15 import (
            CLIPPromptEncoder)
        from youreditableavatar_tpu_torch.guidance.sd_unet import (
            _load_torch_state_dict)
        from youreditableavatar_tpu_torch.guidance.sdxl_pipeline import (
            SDXLControlNetUnionPipeline,
            SDXLPipelineConfig,
            SDXLTextEncoder,
        )

        if not weights_dir or not os.path.isdir(weights_dir):
            raise FileNotFoundError(
                f"sdxl backend needs a diffusers layout dir "
                f"(got {weights_dir!r}); use 'stub' or 'sdxl-random' to run "
                f"without weights"
            )
        tok = os.path.join(weights_dir, "tokenizer")
        tok2 = os.path.join(weights_dir, "tokenizer_2")
        enc_l = CLIPPromptEncoder.from_torch_file(
            _find_ckpt(weights_dir, "text_encoder"),
            tokenizer_dir=tok if os.path.isdir(tok) else None, device=device)
        enc_g = CLIPPromptEncoder.from_torch_file(
            _find_ckpt(weights_dir, "text_encoder_2"), cfg=BIGG_CLIP,
            tokenizer_dir=tok2 if os.path.isdir(tok2) else None,
            device=device)
        sd2 = _load_torch_state_dict(_find_ckpt(weights_dir, "text_encoder_2"))
        proj_g = (sd2["text_projection.weight"].float().t()
                  if "text_projection.weight" in sd2 else torch.eye(1280))
        return SDXLControlNetUnionPipeline.from_torch_files(
            _find_ckpt(weights_dir, "unet"), _find_ckpt(weights_dir, "vae"),
            _find_ckpt(weights_dir, "controlnet"),
            SDXLTextEncoder(enc_l, enc_g, proj_g), SDXLPipelineConfig(),
            device=device,
        )

    raise ValueError(f"unknown inpainter backend {name!r}")


def make_segmenter_backend(
    name: str = "heuristic",
    weights_path: Optional[str] = None,
    seed: int = 0,
    dino_weights: Optional[str] = None,
    dino_vocab: Optional[str] = None,
    device=None,
):
    """Build a `Segmenter` for region localization (LangSAM's role).

    name:
      "heuristic"      — foreground-band heuristic (weight-free).
      "sam"            — SAM; `weights_path` = an official sam_vit_*.pth
                         (the vit_b / vit_l config picked by the file name,
                         else ViT-H); with `dino_weights`
                         (groundingdino_swint_ogc.pth) the box comes from
                         GroundingDINO: the full LangSAM.
      "sam-random"     — tiny random-weight SAM (the whole architecture;
                         the mask falls back to the grounded box).
      "langsam-random" — random-weight SAM + GroundingDINO chained: the
                         whole LangSAM path, weight-free.
      "langsam-vit-h-random" — LangSAM as "sam" with `dino_weights` runs
                         it (SAM ViT-H, GroundingDINO Swin-T at 800², box
                         threshold 0.35, the decoder's mask), on random
                         weights drawn from `seed` on `device`.
    """
    if name == "heuristic":
        from youreditableavatar_tpu_torch.stages.localization import (
            HeuristicSegmenter)

        return HeuristicSegmenter()

    if name == "sam-random":
        from youreditableavatar_tpu_torch.guidance.sam import SAMSegmenter

        return SAMSegmenter.random_init(_generator(seed, device),
                                        device=device)

    if name == "langsam-random":
        from youreditableavatar_tpu_torch.guidance.grounding_dino import (
            DinoGrounder)
        from youreditableavatar_tpu_torch.guidance.sam import SAMSegmenter

        return SAMSegmenter.random_init(
            _generator(seed, device),
            grounder=DinoGrounder.random_init(_generator(seed + 1, device),
                                              device=device),
            device=device,
        )

    if name == "langsam-vit-h-random":
        from youreditableavatar_tpu_torch.guidance.grounding_dino import (
            SWIN_T_GDINO, init_gdino_params)
        from youreditableavatar_tpu_torch.guidance.sam import (
            SAM_VIT_H, SAMSegmenter, init_sam_params)

        gen = _generator(seed, device)
        sam_params = init_sam_params(gen, SAM_VIT_H)
        grounder = _dino_grounder(init_gdino_params(gen, SWIN_T_GDINO),
                                  SWIN_T_GDINO, None, device)
        return SAMSegmenter(sam_params, SAM_VIT_H, grounder=grounder,
                            trust_decoder=True, multimask=False,
                            device=device)

    if name == "sam":
        from youreditableavatar_tpu_torch.guidance.sam import (
            SAM_VIT_B,
            SAM_VIT_H,
            SAM_VIT_L,
            SAMSegmenter,
        )

        if not weights_path or not os.path.exists(weights_path):
            raise FileNotFoundError(
                f"sam backend needs --sam-weights (got {weights_path!r}); "
                f"use 'heuristic' or 'sam-random' to run without weights"
            )
        base = os.path.basename(weights_path)
        cfg = SAM_VIT_H
        if "vit_b" in base:
            cfg = SAM_VIT_B
        elif "vit_l" in base:
            cfg = SAM_VIT_L
        grounder = None
        if dino_weights:
            from youreditableavatar_tpu_torch.guidance.grounding_dino import (
                SWIN_T_GDINO,
                convert_torch_gdino,
            )

            sd = torch.load(dino_weights, map_location="cpu",
                            weights_only=True)
            sd = sd.get("model", sd)
            # Real checkpoints need the real BERT WordPiece tokenizer:
            # --dino-vocab, or a vocab.txt next to the weights (the official
            # layout). Without one, the hash stand-in (its ids do NOT match
            # BERT's training), with a warning.
            tokenizer = None
            vocab = dino_vocab or os.path.join(
                os.path.dirname(dino_weights) or ".", "vocab.txt")
            if os.path.exists(vocab):
                from youreditableavatar_tpu_torch.guidance.wordpiece import (
                    WordPieceTokenizer)

                tokenizer = WordPieceTokenizer(
                    vocab, max_len=SWIN_T_GDINO.max_text_len)
            else:
                import warnings

                warnings.warn(
                    f"no BERT vocab.txt found for GroundingDINO (looked at "
                    f"{vocab!r}); falling back to the hash tokenizer — "
                    f"grounding quality will be poor with real weights"
                )
            grounder = _dino_grounder(convert_torch_gdino(sd, SWIN_T_GDINO),
                                      SWIN_T_GDINO, tokenizer, device)
        return SAMSegmenter.from_torch_file(weights_path, cfg,
                                            grounder=grounder, device=device)

    raise ValueError(f"unknown segmenter backend {name!r}")


def _dino_grounder(params, cfg, tokenizer, device):
    """GroundingDINO as LangSAM grounds: the image resized to 800², the
    best box kept at a score of 0.35 or more."""
    from youreditableavatar_tpu_torch.guidance.grounding_dino import (
        DinoGrounder)

    return DinoGrounder(params, cfg, tokenizer=tokenizer, box_threshold=0.35,
                        image_size=800, device=device)
