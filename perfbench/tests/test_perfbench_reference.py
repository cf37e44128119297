"""The plain reference: pre-tokenisation and training."""

import json
import random
from collections import Counter

import pytest
from conftest import ROOT

import corpus
from reference import pretok
from reference import train as ref_train

FIXTURES = ROOT / "tests" / "fixtures_gpt2"
EOT = "<|endoftext|>"


def test_pattern_matches_the_regex_package():
    regex = pytest.importorskip("regex")
    g = regex.compile(r"""<\|endoftext\|>|'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
    golden = json.loads((FIXTURES / "golden_encode" / "gpt2_golden.json").read_text(encoding="utf-8"))
    texts = golden["snippets"]["texts"] + [
        (FIXTURES / "tinystories_sample_5M.txt").read_text(encoding="utf-8")[:300_000]]
    mine = pretok.training_regex((EOT,))
    for text in texts:
        assert mine.findall(text) == g.findall(text), repr(text[:80])


def _random_counts(rnd):
    wc = Counter()
    alpha = rnd.choice([b"ab", b"abc", b"aab<|>", b"xy z", bytes(range(97, 107))])
    for _ in range(rnd.randrange(5, 80)):
        w = bytes(rnd.choice(alpha) for _ in range(rnd.randrange(1, 14)))
        wc[w] += rnd.randrange(1, 6)
    if rnd.random() < 0.5:
        wc[EOT.encode()] += rnd.randrange(1, 9)
    return wc


@pytest.mark.parametrize("seed", range(12))
def test_incremental_training_matches_the_recount(seed):
    rnd = random.Random(seed)
    for _ in range(4):
        wc = _random_counts(rnd)
        vocab_size = rnd.randrange(258, 360)
        mf = rnd.choice([1, 2, 3])
        assert ref_train.train_bpe(wc, [EOT], vocab_size, mf) == \
            ref_train.train_bpe_recount(wc, [EOT], vocab_size, mf)


def test_training_on_a_generated_corpus_matches_the_recount(tmp_path):
    files = corpus.generate(tmp_path, 11, {"bytes": 60_000, "files": 1, "lexicon": 300})
    wc = pretok.count_words(files, [EOT], 16_384)
    stats = {}
    got = ref_train.train_bpe(wc, [EOT], 420, 1, stats=stats)
    assert got == ref_train.train_bpe_recount(wc, [EOT], 420, 1)
    assert stats["k2_bytes"] > 0 and stats["words"] == len(wc)


def test_reference_counts_equal_the_ports_ingest(tmp_path):
    """The reference's span-by-span counts against the port's native
    scanner, with spans cut inside pre-tokens."""
    from yabpe_tpu_torch.pretok.ingest import count_pretokens

    files = corpus.generate(tmp_path, 5, {"bytes": 200_000, "files": 2, "lexicon": 400})
    want = count_pretokens(files, [EOT], chunk_size_bytes=10_000, max_workers=2)
    assert pretok.count_words(files, [EOT], 10_000) == want


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_controls_differ_from_the_reference(tmp_path, seed):
    """The control at test size: ties broken the other way change the
    merges."""
    files = corpus.generate(tmp_path, seed, {"bytes": 400_000, "files": 1, "lexicon": 2000})
    wc = pretok.count_words(files, [EOT], 1 << 20)
    vocab, merges = ref_train.train_bpe(wc, [EOT], 1000, 1)
    c_vocab, c_merges = ref_train.train_bpe(wc, [EOT], 1000, 1, tie="least")
    assert merges != c_merges
