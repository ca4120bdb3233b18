# Frozen copy of youreditableavatar_tpu_torch/guidance/prompts.py (the plain PyTorch path only).
"""View-dependent prompts: the direction set and `PromptProcessor`'s
per-view selection of the conditioned and unconditioned embeddings, with
the embeddings held in memory (the port caches them on disk)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DirectionConfig:
    name: str
    prompt: Callable[[str], str]
    condition: Callable[[np.ndarray, np.ndarray], np.ndarray]


def _front(e, a):
    return (a > -60) & (a < 60)


def _side(e, a):
    return ((a >= 60) & (a <= 120)) | ((a <= -60) & (a >= -120))


def _back(e, a):
    return (a > 120) | (a < -120)


def _overhead(e, a):
    return e > 60


# Direction set mirrors `base.py:228-253` (overhead wins over azimuth).
DIRECTIONS: List[DirectionConfig] = [
    DirectionConfig("front", lambda s: f"{s}, front view", _front),
    DirectionConfig("side", lambda s: f"{s}, side view", _side),
    DirectionConfig("back", lambda s: f"{s}, back view", _back),
    DirectionConfig("overhead", lambda s: f"{s}, overhead view", _overhead),
]

class PromptProcessor:
    def __init__(self, prompt: str, negative_prompt: str, encoder):
        self.prompt = prompt
        self.negative_prompt = negative_prompt
        prompts = [prompt] + [d.prompt(prompt) for d in DIRECTIONS]
        self.cond = np.stack([self._embed(encoder, p) for p in prompts])
        self.uncond = np.stack([self._embed(encoder, negative_prompt)
                                for _ in prompts])

    @staticmethod
    def _embed(encoder, text: str) -> np.ndarray:
        return encoder.encode([text])[0].detach().cpu().numpy()

    def direction_index(
        self, elevation_deg: np.ndarray, azimuth_deg: np.ndarray
    ) -> np.ndarray:
        """(B,) index into the direction set (0 = no direction match)."""
        e = np.asarray(elevation_deg)
        a = np.asarray(azimuth_deg)
        idx = np.zeros(e.shape, np.int32)
        for i, d in enumerate(DIRECTIONS):
            idx = np.where(d.condition(e, a), i + 1, idx)
        return idx

    def get_text_embeddings(
        self, elevation_deg: np.ndarray, azimuth_deg: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(B, L, D) cond + uncond embeddings for a view batch."""
        idx = self.direction_index(elevation_deg, azimuth_deg)
        return self.cond[idx], self.uncond[idx]
