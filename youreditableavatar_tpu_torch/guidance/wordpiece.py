"""BERT WordPiece tokenizer: pure Python, offline, no network.

Counterpart of `youreditableavatar_tpu/guidance/wordpiece.py`, kept as the
port's own copy (the port imports nothing of the JAX package). GroundingDINO's
text side tokenizes prompts with the BERT uncased WordPiece tokenizer: BERT
basic tokenization (clean + lowercase + accent strip + punctuation split +
CJK isolation), then greedy longest-match-first WordPiece, against a
user-supplied `vocab.txt` (the file that ships next to every official
BERT / GroundingDINO checkpoint). The ids and masks equal the JAX package's
bit for bit (`tests/test_torch_wordpiece.py`).

Usage with the official checkpoint directory::

    tok = WordPieceTokenizer("/path/to/bert-base-uncased/vocab.txt")
    grounder = DinoGrounder(params, SWIN_T_GDINO, tokenizer=tok)
"""

from __future__ import annotations

import unicodedata
from pathlib import Path
from typing import Iterable, List, Tuple, Union

import numpy as np

__all__ = ["WordPieceTokenizer", "load_vocab"]

# BERT special-token defaults (bert-base-uncased row numbers).
PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def load_vocab(src: Union[str, Path, Iterable[str]]) -> dict:
    """vocab.txt (one token per line, row = id) -> {token: id}."""
    if isinstance(src, (str, Path)):
        lines = Path(src).read_text(encoding="utf-8").splitlines()
    else:
        lines = list(src)
    return {tok.rstrip("\n"): i for i, tok in enumerate(lines)}


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges count as punctuation (BERT convention:
    # includes chars like ``$`` and ``@`` that Unicode classes as symbols).
    if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
            or 123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def _basic_tokenize(text: str, lower: bool = True) -> List[str]:
    """BERT BasicTokenizer: clean, CJK-isolate, lowercase+strip accents,
    split on whitespace and punctuation."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        elif _is_whitespace(ch):
            out.append(" ")
        else:
            out.append(ch)
    tokens = []
    for word in "".join(out).split():
        if lower:
            word = word.lower()
            word = "".join(
                c for c in unicodedata.normalize("NFD", word)
                if unicodedata.category(c) != "Mn"
            )
        # split punctuation into standalone tokens
        cur: List[str] = []
        for ch in word:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a local ``vocab.txt``.

    Returns the same ``(tokens, mask)`` tuple as ``HashTokenizer`` so it
    plugs directly into ``DinoGrounder(tokenizer=...)``; output ids match
    ``transformers.BertTokenizer(vocab_file)(text)["input_ids"]``.
    """

    def __init__(self, vocab: Union[str, Path, Iterable[str], dict],
                 max_len: int = 256, lower: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab if isinstance(vocab, dict) else load_vocab(vocab)
        if UNK not in self.vocab or CLS not in self.vocab \
                or SEP not in self.vocab:
            raise ValueError(
                "vocab must define [UNK], [CLS] and [SEP] (BERT vocab.txt)"
            )
        self.max_len = max_len
        self.lower = lower
        self.max_chars = max_chars_per_word

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [UNK]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]  # whole word becomes [UNK], not partial pieces
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        pieces = []
        for word in _basic_tokenize(text, self.lower):
            pieces.extend(self._wordpiece(word))
        return pieces

    def __call__(self, text: str) -> Tuple[np.ndarray, np.ndarray]:
        pieces = self.tokenize(text)[: self.max_len - 2]
        ids = (
            [self.vocab[CLS]]
            + [self.vocab.get(p, self.vocab[UNK]) for p in pieces]
            + [self.vocab[SEP]]
        )
        tok = np.zeros((self.max_len,), np.int32)
        tok[: len(ids)] = ids
        mask = np.zeros((self.max_len,), bool)
        mask[: len(ids)] = True
        return tok, mask
