"""PyTorch port vs the JAX package: `guidance/wordpiece.py`, the BERT
WordPiece tokenizer GroundingDINO's text side reads a `vocab.txt` with.

The port keeps its own copy of the module; every prompt's pieces, ids and
mask are held equal to the JAX package's, on an in-memory vocabulary (as
`tests/test_gdino.py::TestWordPiece` builds it) and on the same vocabulary
read from a file.
"""

import sys

import numpy as np
import pytest

from youreditableavatar_tpu.guidance import wordpiece as jw
from youreditableavatar_tpu_torch.guidance import wordpiece as tw

VOCAB = [
    "[PAD]", "[unused0]", "[CLS]", "[SEP]", "[MASK]", "[UNK]",
    ".", ",", "!", "-", "'", "$", "@",
    "a", "the", "man", "woman", "with", "red", "hair", "hat",
    "wear", "green", "jacket", "shirt", "blue", "short", "and",
    "##s", "##ing", "##ed", "##er", "##iz", "##ation",
    "person", "beard", "glasses", "long", "do", "uber", "naive",
    "帽", "子", "红",
]

PROMPTS = {
    "ascii": "a man with red hairs.",
    "sentence": "The woman wearing a green jacket and blue shorts!",
    "punctuation": "hat.hat,hat-hat'hat$hat@hat",
    "accents": "über-naïve Hats",
    "cjk": "红帽子 and a hat",
    "unknown": "wearers doing normalization zzz",
    "controls": "a\that\n\x00with�beard​",
    "long_word": "a " + "x" * 120 + " hat",
    "empty": "",
}


@pytest.fixture(scope="module")
def pair():
    return (jw.WordPieceTokenizer(VOCAB, max_len=32),
            tw.WordPieceTokenizer(VOCAB, max_len=32))


@pytest.mark.parametrize("name", list(PROMPTS))
def test_tokens_match_jax(pair, name):
    ours_j, ours_t = pair
    text = PROMPTS[name]
    assert ours_t.tokenize(text) == ours_j.tokenize(text)
    tj, mj = ours_j(text)
    tt, mt = ours_t(text)
    assert tt.dtype == tj.dtype and mt.dtype == mj.dtype
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(mt, mj)


def test_truncation_at_max_len(pair):
    text = "hat " * 100
    (tj, mj), (tt, mt) = pair[0](text), pair[1](text)
    np.testing.assert_array_equal(tt, tj)
    np.testing.assert_array_equal(mt, mj)
    assert int(mt.sum()) == 32 and tt[31] == VOCAB.index("[SEP]")


def test_vocab_file_and_iterable_agree(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(VOCAB), encoding="utf-8")
    assert tw.load_vocab(str(path)) == jw.load_vocab(str(path))
    assert tw.load_vocab(path) == tw.load_vocab(iter(VOCAB))
    tok = tw.WordPieceTokenizer(str(path), max_len=16)
    np.testing.assert_array_equal(
        tok("a red hat")[0],
        jw.WordPieceTokenizer(str(path), max_len=16)("a red hat")[0])


def test_character_classes_match_jax():
    """Every character class on the code points of the Basic Multilingual
    Plane and the CJK extension blocks, and the basic tokenizer on a run of
    them."""
    cps = list(range(0, 0x3000)) + list(range(0x3400, 0x3500)) \
        + list(range(0x4E00, 0x4F00)) + list(range(0xF900, 0xFB00)) \
        + [0xFFFD, 0x20000, 0x2A700, 0x2B740, 0x2B820, 0x2F800, 0x2FA20]
    for cp in cps:
        ch = chr(cp)
        assert tw._is_whitespace(ch) == jw._is_whitespace(ch), cp
        assert tw._is_control(ch) == jw._is_control(ch), cp
        assert tw._is_punctuation(ch) == jw._is_punctuation(ch), cp
        assert tw._is_cjk(cp) == jw._is_cjk(cp), cp
    text = "".join(chr(c) for c in range(32, 0x3000, 7))
    for lower in (True, False):
        assert tw._basic_tokenize(text, lower) == jw._basic_tokenize(text,
                                                                      lower)


def test_vocab_without_specials_raises():
    with pytest.raises(ValueError):
        tw.WordPieceTokenizer(["a", "hat"])


def test_no_torch_or_jax_needed():
    """The port's tokenizer is plain Python and numpy."""
    mod = sys.modules[tw.__name__]
    assert not hasattr(mod, "torch") and not hasattr(mod, "jax")
