"""The seeded corpus generator."""

import re

import numpy as np

import corpus

SPEC = {"bytes": 300_000, "files": 3, "lexicon": 500}


def _read(paths):
    return [p.read_bytes() for p in paths]


def test_a_seed_repeats_and_seeds_differ(tmp_path):
    a = _read(corpus.generate(tmp_path / "a", 2**31 + 7, SPEC))
    b = _read(corpus.generate(tmp_path / "b", 2**31 + 7, SPEC))
    c = _read(corpus.generate(tmp_path / "c", 2**31 + 8, SPEC))
    assert a == b
    assert all(x != y for x, y in zip(a, c))


def test_shape(tmp_path):
    files = corpus.generate(tmp_path, 3, SPEC)
    assert len(files) == 3
    for data in _read(files):
        assert len(data) >= SPEC["bytes"] // 3
        assert data.isascii() and b"<|endoftext|>" in data
        text = data.decode()
        assert text[-1] in " \n"
        sentences = [s for s in text.replace("<|endoftext|>", "").replace("\n", " ").split(" ") if s]
        assert sentences[0][0].isupper()
    lex = corpus.make_lexicon(500, 3)
    assert len(set(lex)) == 500 and all(w.isalpha() and w.islower() for w in lex)


def test_word_letters_shape_the_word_tokens(tmp_path):
    """A lexicon ranked by ``word_letters``: the corpus's word tokens have
    about the shares asked for, and the words stay distinct."""
    shares = [0.04, 0.13, 0.30, 0.24, 0.10, 0.10, 0.05, 0.02, 0.02]
    lex = corpus.make_lexicon(5000, 9, shares)
    assert len(set(lex)) == 5000
    [path] = corpus.generate(tmp_path, 9, {"bytes": 2_000_000, "files": 1, "lexicon": 5000,
                                          "word_letters": shares})
    words = [w for w in re.findall(rb"[A-Za-z]+", path.read_bytes()) if w != b"endoftext"]
    got = np.bincount([len(w) for w in words], minlength=len(shares) + 2)[1:] / len(words)
    # the head's ranks hold whole lengths: 1 and 2 letters together
    assert abs(got[0] + got[1] - shares[0] - shares[1]) < 0.03
    assert all(abs(g - s) < 0.03 for g, s in zip(got[2:], shares[2:]))
    assert abs(np.dot(np.arange(1, len(got) + 1), got)
               - np.dot(np.arange(1, len(shares) + 1), shares)) < 0.15
