"""Stub guidance backends for pipeline smoke runs.

Counterpart of `StubPromptEncoder` and `StubInpainter` in
`youreditableavatar_tpu/guidance/stub.py`: deterministic, weight-free
stand-ins so the stages that consume an `Inpainter` or a `PromptEncoder`
run end to end. `StubPromptEncoder` hashes text into a deterministic
embedding; `StubInpainter` blends the masked region toward the control
image. Both work on the device of the tensors they are given.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from youreditableavatar_tpu_torch.utils.device import resolve_device


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
