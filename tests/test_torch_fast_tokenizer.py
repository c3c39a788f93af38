"""The port's C++ tokenizer (``llama2_tpu_torch/tokenizer/fast/``) against
the JAX package's ``FastTokenizer`` and the Python tokenizer.

Ids and decoded bytes equal on the golden vectors of
``tests/test_fast_tokenizer.py`` and on seeded random text (a corpus's
slices and random Unicode); the library is built under ``build/tokenizer/``
at the repository root, named by the source's hash, never under
``llama2_tpu/``; a failed build raises.
"""

import os
import random

import pytest

from conftest import TOKENIZER_BIN
from llama2_tpu.tokenizer.fast import FastTokenizer as JaxFastTokenizer
from llama2_tpu_torch.tokenizer import fast
from llama2_tpu_torch.tokenizer.tokenizer import Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = (
    "Once upon a time, there was a little girl named Lily. "
    "She loved to play outside in the sunshine with 1234 friends; "
    "Zebras & émus aren't common—though café humour helps.\n\t"
)


@pytest.fixture(scope="module")
def toks():
    return fast.load_tokenizer(TOKENIZER_BIN, 32000), Tokenizer.from_file(TOKENIZER_BIN, 32000)


@pytest.fixture(scope="module")
def jax_fast():
    return JaxFastTokenizer(TOKENIZER_BIN, 32000)


def test_load_tokenizer_is_the_cpp_one(toks):
    ftok, _ = toks
    assert isinstance(ftok, fast.FastTokenizer)
    assert ftok.max_token_len == 27 and ftok.vocab_size == 32000
    assert ftok.lookup("æ") == 233 and ftok.lookup("no such piece") is None
    assert ftok.tokens[100] == b"a"


def test_library_lives_under_build_tokenizer():
    path = fast.lib_path()
    assert os.path.dirname(path) == os.path.join(REPO, "build", "tokenizer")
    assert os.path.exists(path) and not path.startswith(os.path.join(REPO, "llama2_tpu") + os.sep)
    with open(os.path.join(REPO, "llama2_tpu", "tokenizer", "fast", "tokenizer.cpp"), "rb") as a, \
            open(os.path.join(REPO, "llama2_tpu_torch", "tokenizer", "fast", "tokenizer.cpp"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("text,want", [
    ("A man dying of thirst is suddenly a mineral water critic?",
     [68, 767, 27116, 310, 266, 765, 338, 11584, 263, 1375, 13537, 4094, 11164, 66]),
    ("中", [30275]),
    ("", []),
])
def test_golden_vectors(toks, jax_fast, text, want):
    ftok, ptok = toks
    assert ftok.encode(text) == want == ptok.encode(text) == jax_fast.encode(text)
    assert ftok.decode(want) == ptok.decode(want) == jax_fast.decode(want)


def test_unknown_codepoint_raises(toks):
    ftok, ptok = toks
    for tok in (ftok, ptok):
        with pytest.raises(ValueError):
            tok.encode("😀")


@pytest.mark.parametrize("seed", [0, 1])
def test_corpus_slices_match(toks, jax_fast, seed):
    ftok, ptok = toks
    rng = random.Random(seed)
    for _ in range(40):
        n = rng.randint(0, len(CORPUS))
        start = rng.randint(0, len(CORPUS) - n)
        text = CORPUS[start : start + n]
        ids = ftok.encode(text)
        assert ids == ptok.encode(text) == jax_fast.encode(text), repr(text)
        for prev in (1, 5):
            assert ftok.decode(ids, first_prev=prev) == ptok.decode(ids, first_prev=prev)


def test_random_unicode_matches(toks, jax_fast):
    """Seeded random codepoints the vocabulary holds (single-codepoint
    tokens), with spaces: ids and bytes equal across the three."""
    ftok, ptok = toks
    singles = sorted({t.decode("utf-8") for t in ptok.tokens if len(t.decode("utf-8", "ignore")) == 1
                      and t.decode("utf-8", "ignore").encode("utf-8") == t})
    rng = random.Random(42)
    for _ in range(30):
        text = "".join(rng.choice(singles) if rng.random() < 0.8 else " " for _ in range(rng.randint(1, 80)))
        ids = ftok.encode(text)
        assert ids == ptok.encode(text) == jax_fast.encode(text), repr(text)
        assert ftok.decode(ids) == ptok.decode(ids) == jax_fast.decode(ids)


def test_decode_token_framing(toks):
    """BOS strips a leading space; ``<0xXX>`` tokens of printable bytes
    decode to the byte, others stay literal."""
    ftok, ptok = toks
    for prev in (1, 2, 300):
        for t in (0, 3, 13, 35, 259, 29871, 31999):
            assert ftok.decode_token(prev, t) == ptok.decode_token(prev, t)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A build that fails raises; nothing falls back to the Python tokenizer."""
    monkeypatch.setattr(fast, "_lib", None)
    monkeypatch.setattr(fast, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(fast, "CXX_FLAGS", ("-O2", "-std=c++17", "-shared", "-fPIC", "--no-such-flag"))
    with pytest.raises(fast.TokenizerBuildError):
        fast.load_tokenizer(TOKENIZER_BIN, 32000)
    assert os.listdir(tmp_path) == []
