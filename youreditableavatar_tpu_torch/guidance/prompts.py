"""View-dependent prompt processing with disk-cached embeddings.

Counterpart of `youreditableavatar_tpu/guidance/prompts.py` (numpy, the
same code; embeddings from the encoder — a tensor on any device — are
stored as numpy), after `tetgs_spatial/models/prompt_processors/base.py:26-636`
and `stable_diffusion_prompt_processor.py:15-103`:

  * direction-conditioned prompts — azimuth/elevation buckets map to
    "front/side/back/overhead view" suffixes, with the human-part template
    variants (full body / head / upper / lower, `base.py:228-413`);
  * embeddings computed once per (model, prompt) and cached on disk keyed by
    md5 (`base.py:460-509`); the encoder is called inline;
  * `PromptUtils.get_text_embeddings(elevation, azimuth, ...)` selects the
    per-view conditioned embedding and the matching negative/uncond one.

The BERT-based prompt debiasing (`base.py:563-621`) is implemented in
`get_debiased_prompts` (probe-injectable; `bert_view_probe` builds the
masked-LM probe from a local HF checkpoint) and is off by default, as in the
reference (`base.py:207`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from youreditableavatar_tpu_torch.guidance.base import PromptEncoder


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

# Human-part prompt templates (`base.py:255-413` sampling variants).
PART_TEMPLATES: Dict[str, Callable[[str], str]] = {
    "full": lambda s: f"full body photo of {s}",
    "head": lambda s: f"head photo of {s}",
    "upper": lambda s: f"upper body photo of {s}",
    "lower": lambda s: f"lower body photo of {s}",
}


def get_debiased_prompts(
    prompt: str,
    probe: Callable[[str], np.ndarray],
    n_views: int = 4,
    mask_ids: Optional[Sequence[int]] = None,
    threshold: float = 0.95,
) -> List[str]:
    """Per-view prompt debiasing (`base.py:563-621` `get_debiased_prompt`).

    For every maskable word, compare the view-direction distribution of the
    full prompt against the prompt with that word removed: a word whose
    removal leaves a view's probability essentially unchanged
    (PMI = full / lerp(part, full, ½) < threshold) carries view bias for
    that view and is dropped from that view's prompt.

    `probe(text) -> (n_views,) probabilities` abstracts the reference's
    BERT masked-LM scoring of "This image is depicting a [MASK] view of
    {text}" — build it with `bert_view_probe` (local weights) or inject a
    custom scorer for tests/offline runs.
    """
    words = prompt.split(" ")
    keep = [list(words) for _ in range(n_views)]
    full = np.asarray(probe(prompt), np.float64)
    ids = list(range(len(words))) if mask_ids is None else list(mask_ids)
    for idx in ids:
        part = " ".join(words[:idx] + words[idx + 1:])
        part_probe = np.asarray(probe(part), np.float64)
        pmi = full / (0.5 * (part_probe + full))
        for v in range(n_views):
            if pmi[v] < threshold:
                keep[v][idx] = ""
    return [" ".join(w for w in p if w) for p in keep]


def bert_view_probe(
    model_name_or_path: str,
    view_names: Sequence[str] = ("front", "side", "back", "overhead"),
) -> Callable[[str], np.ndarray]:
    """Masked-LM view probe from a local HF BERT checkpoint (torch CPU).

    Mirrors the reference's `modulate` (`base.py:574-592`): softmax the
    [MASK] logits of "This image is depicting a [MASK] view of {prompt}",
    restrict to the view-word token ids, renormalize.
    """
    import torch
    from transformers import AutoTokenizer, BertForMaskedLM

    tok = AutoTokenizer.from_pretrained(model_name_or_path)
    model = BertForMaskedLM.from_pretrained(model_name_or_path)
    model.eval()
    view_ids = tok(" ".join(view_names), return_tensors="pt").input_ids[0]
    view_ids = view_ids[1:1 + len(view_names)]

    def probe(prompt: str) -> np.ndarray:
        text = f"This image is depicting a [MASK] view of {prompt}"
        tokens = tok(text, return_tensors="pt")
        mask_idx = (tokens.input_ids[0] == tok.mask_token_id).nonzero()[0]
        with torch.no_grad():
            logits = model(**tokens).logits
        p = torch.softmax(logits[0, mask_idx], dim=-1)[0, view_ids]
        return (p / p.sum()).numpy()

    return probe


class PromptProcessor:
    def __init__(
        self,
        prompt: str,
        negative_prompt: str,
        encoder: PromptEncoder,
        cache_dir: str = ".cache/text_embeddings",
        model_name: str = "stub",
        part: str = "full",
        use_part_templates: bool = False,
        debias_probe: Optional[Callable[[str], np.ndarray]] = None,
    ):
        self.prompt = (
            PART_TEMPLATES[part](prompt) if use_part_templates else prompt
        )
        self.negative_prompt = negative_prompt
        self.encoder = encoder
        self.cache_dir = cache_dir
        self.model_name = model_name
        os.makedirs(cache_dir, exist_ok=True)

        if debias_probe is not None:
            # Debiased per-view base prompts feed the direction templates
            # (`base.py:429-438`).
            bases = get_debiased_prompts(
                self.prompt, debias_probe, n_views=len(DIRECTIONS)
            )
        else:
            bases = [self.prompt] * len(DIRECTIONS)
        prompts = [self.prompt] + [
            d.prompt(base) for d, base in zip(DIRECTIONS, bases)
        ]
        negatives = [negative_prompt] * len(prompts)
        self.cond = np.stack([self._embed(p) for p in prompts])
        self.uncond = np.stack([self._embed(p) for p in negatives])

    def _cache_path(self, text: str) -> str:
        key = hashlib.md5(f"{self.model_name}::{text}".encode()).hexdigest()
        return os.path.join(self.cache_dir, f"{key}.npy")

    def _embed(self, text: str) -> np.ndarray:
        path = self._cache_path(text)
        if os.path.exists(path):
            return np.load(path)
        emb = self.encoder.encode([text])[0]
        if hasattr(emb, "detach"):  # a tensor, possibly on the card
            emb = emb.detach().cpu().numpy()
        emb = np.asarray(emb)
        np.save(path, emb)
        return emb

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

    # Perp-Neg decay coefficients a·e^(−b·r) + c (`base.py:196-204`).
    PERP_NEG_F_SB = (1.0, 0.5, -0.606)
    PERP_NEG_F_FSB = (1.0, 0.5, +0.967)
    PERP_NEG_F_FS = (4.0, 0.5, -2.426)
    PERP_NEG_F_SF = (4.0, 0.5, -2.426)

    def get_text_embeddings_perp_neg(
        self, elevation_deg: np.ndarray, azimuth_deg: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Perp-Neg view interpolation (`base.py:81-166`).

        Returns (pos (B, L, D), uncond (B, L, D), neg (B, 2, L, D),
        neg_weights (B, 2)): the positive embedding interpolates
        front/side/back by azimuth; the two negative directions carry
        shifted-exponential-decay guidance weights for the perpendicular
        gradient composition of the Perp-Neg paper.
        """

        def decay(f, r):
            a, b, c = f
            return a * np.exp(-b * r) + c

        # direction embeddings: cond rows are [base, front, side, back,
        # overhead] (constructor order).
        front, side, back, over = (
            self.cond[1], self.cond[2], self.cond[3], self.cond[4]
        )
        e = np.asarray(elevation_deg, np.float64).reshape(-1)
        a = (np.asarray(azimuth_deg, np.float64).reshape(-1) + 180.0) \
            % 360.0 - 180.0
        b = e.shape[0]
        pos = np.empty((b,) + front.shape, front.dtype)
        neg = np.empty((b, 2) + front.shape, front.dtype)
        wts = np.zeros((b, 2), np.float32)
        unc = np.empty_like(pos)
        idx = self.direction_index(e, a)
        for i in range(b):
            unc[i] = self.uncond[idx[i]]
            if idx[i] == 4:  # overhead: no interpolation, dummy negatives
                pos[i] = over
                neg[i, 0] = self.uncond[idx[i]]
                neg[i, 1] = self.uncond[idx[i]]
                continue
            az = abs(a[i])
            if az < 90:  # front↔side
                r = 1.0 - az / 90.0
                pos[i] = r * front + (1 - r) * side
                neg[i, 0], neg[i, 1] = front, side
                wts[i, 0] = -decay(self.PERP_NEG_F_FS, r)
                wts[i, 1] = -decay(self.PERP_NEG_F_SF, 1 - r)
            else:  # side↔back
                r = 2.0 - az / 90.0
                pos[i] = r * side + (1 - r) * back
                neg[i, 0], neg[i, 1] = side, front
                wts[i, 0] = -decay(self.PERP_NEG_F_SB, r)
                wts[i, 1] = -decay(self.PERP_NEG_F_FSB, r)
        return pos, unc, neg, wts
