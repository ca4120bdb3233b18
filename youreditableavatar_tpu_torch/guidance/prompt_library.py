"""Prompt-library tooling (reference `load/make_prompt_library.py` role).

Counterpart of `youreditableavatar_tpu/guidance/prompt_library.py` (plain
Python, the same code).

The reference converts the DreamFusion gallery's video filenames into a
415-prompt json library keyed by collection name. This module provides the
same machinery — filename→prompt normalization, library build/save/load,
and deterministic sampling — with a small built-in starter collection; feed
`build_library` any gallery listing to regenerate the full set.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List, Sequence

STARTER_PROMPTS = [
    "a DSLR photo of a bald eagle",
    "a DSLR photo of a blue motorcycle",
    "a ceramic lion",
    "a beautiful rainbow fish",
    "a capybara wearing a top hat, low poly",
    "a chimpanzee holding a peeled banana",
    "a delicious hamburger",
    "a cute steampunk elephant",
    "a full body photo of a man wearing a leather jacket",
    "a full body photo of a woman in a red dress",
]


def filename_to_prompt(name: str) -> str:
    """"a_bald_eagle.mp4" → "a bald eagle" (`make_prompt_library.py`)."""
    base = os.path.basename(name)
    for ext in (".mp4", ".gif", ".png", ".jpg"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    return base.replace("_", " ")


def build_library(
    collections: Dict[str, Sequence[str]] | None = None,
) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {"dreamfusion": list(STARTER_PROMPTS)}
    for name, files in (collections or {}).items():
        out[name] = [filename_to_prompt(f) for f in files]
    return out


def save_library(path: str,
                 library: Dict[str, List[str]] | None = None) -> str:
    lib = library if library is not None else build_library()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(lib, f, indent=1)
    return path


def load_library(path: str) -> Dict[str, List[str]]:
    with open(path) as f:
        return json.load(f)


def sample_prompts(library: Dict[str, List[str]], collection: str,
                   n: int, seed: int = 0) -> List[str]:
    rng = random.Random(seed)
    pool = library[collection]
    return rng.sample(pool, min(n, len(pool)))
