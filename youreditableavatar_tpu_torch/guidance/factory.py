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


def make_guidance_backend(
    name: str = "stub",
    weights_dir: Optional[str] = None,
    seed: int = 0,
    device=None,
) -> Tuple[object, object]:
    """Build (prior, prompt_encoder) for the spatial stage.

    name:
      "stub"         — deterministic conv stub + hash prompt encoder.
      "sd15"         — SD1.5; `weights_dir` holds a diffusers layout
                       (unet/, vae/, text_encoder/, tokenizer/) with .bin
                       or .safetensors checkpoints.
      "sd15-random"  — tiny random-weight SD1.5 (the whole real code path,
                       no weights).
    """
    if name == "stub":
        from youreditableavatar_tpu_torch.guidance.stub import (
            StubDiffusionPrior,
            StubPromptEncoder,
        )

        return (StubDiffusionPrior(seed, device=device),
                StubPromptEncoder(device=device))

    if name == "sd15-random":
        from youreditableavatar_tpu_torch.guidance.sd15 import (
            CLIPPromptEncoder,
            SD15Prior,
        )

        gen = _generator(seed, device)
        return (SD15Prior.random_init(gen, device=device),
                CLIPPromptEncoder.random_init(gen, device=device))

    if name == "sd15":
        from youreditableavatar_tpu_torch.guidance.sd15 import (
            CLIPPromptEncoder,
            SD15Prior,
        )

        if not weights_dir or not os.path.isdir(weights_dir):
            raise FileNotFoundError(
                f"sd15 backend needs --sd-weights pointing at a diffusers "
                f"layout directory (got {weights_dir!r}); use 'stub' or "
                f"'sd15-random' to run without weights"
            )
        prior = SD15Prior.from_torch_files(
            _find_ckpt(weights_dir, "unet"), _find_ckpt(weights_dir, "vae"),
            device=device)
        tok_dir = os.path.join(weights_dir, "tokenizer")
        enc = CLIPPromptEncoder.from_torch_file(
            _find_ckpt(weights_dir, "text_encoder"),
            tokenizer_dir=tok_dir if os.path.isdir(tok_dir) else None,
            device=device)
        return prior, enc

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
                DinoGrounder,
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
            grounder = DinoGrounder(
                convert_torch_gdino(sd, SWIN_T_GDINO), SWIN_T_GDINO,
                tokenizer=tokenizer, box_threshold=0.35, image_size=800,
                device=device,
            )
        return SAMSegmenter.from_torch_file(weights_path, cfg,
                                            grounder=grounder, device=device)

    raise ValueError(f"unknown segmenter backend {name!r}")
