"""The port's whole-file encoding (tok/parallel_encode.py) against the JAX
package's: the same cut points, the same ids, the same errors. Every
comparison is exact."""

from __future__ import annotations

import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import regex

from yabpe_tpu import BBPETokenizer as JaxTokenizer
from yabpe_tpu.tok import parallel_encode as jax_parallel
from yabpe_tpu_torch import BBPETokenizer, BBPETrainer, BBPETrainerConfig, native
from yabpe_tpu_torch.tok import parallel_encode

from .common import DATA

SPECIALS = ["<|endoftext|>"]
DATA_FILES = ["empty", "large", "multiline", "sample", "simple", "unicode"]
#: Characters that ``str.isspace`` and the White_Space property disagree
#: on (U+001C-001F), non-ASCII White_Space, and a zero-width space (not
#: White_Space), to put near the cuts.
EXOTIC = ["\x1c", "\x1d", "\x1e", "\x1f", "\x85", "\xa0", "\u3000", "\u2003", "\u200b"]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The JAX tokenizer tests' model: vocab 400 on sample.txt and
    unicode.txt, one special, trained by the native loop."""
    trainer = BBPETrainer(BBPETrainerConfig(
        vocab_size=400, min_frequency=1, max_workers=1, special_tokens=SPECIALS,
        use_native_loop=True,
    ))
    trainer.train([DATA / "sample.txt", DATA / "unicode.txt"])
    out = tmp_path_factory.mktemp("parallel") / "model"
    trainer.save(out)
    return out


@pytest.fixture(scope="module")
def toks(model):
    return BBPETokenizer.from_file(model, compute_device="cpu"), JaxTokenizer.from_file(model)


def test_whitespace_is_the_regex_module_s_unicode_s():
    ws = regex.compile(r"\s")
    want = {
        c for c in range(0x110000)
        if not 0xD800 <= c < 0xE000 and ws.fullmatch(chr(c)) is not None
    }
    assert parallel_encode.WHITESPACE == want
    assert len(want) == 25
    assert not {0x1C, 0x1D, 0x1E, 0x1F} & want  # str.isspace takes these


def _random_text(seed: int, n: int = 3000) -> str:
    rng = random.Random(seed)
    ws_pool = [" ", "\n", "\t", "\r\n", "\n\n", "  ", "　", " \n ", "\v\f", *EXOTIC]
    word_pool = ["alpha", "βήτα", "東京", "mid-word", "don't", "123", "!!", "<|endoftext|>",
                 "🚀", "x" * 40, "-" * 25, "<|endof", "text|>"]
    return "".join(rng.choice(word_pool) + rng.choice(ws_pool) for _ in range(n))


def _cut_case(name: str) -> str:
    if name in DATA_FILES:
        return (DATA / f"{name}.txt").read_text(encoding="utf-8") * 8
    if name == "ws_runs":
        return ("para. one two three\n\npara two follows   here\n\n \t" * 300
                + "line with trailing spaces   \r\n\r\nnext\t\t\n" * 200)
    if name == "exotic":
        rng = random.Random(3)
        return "".join(f"word{i}{rng.choice(EXOTIC)}{rng.choice(EXOTIC)}x " for i in range(2000))
    if name == "specials":
        # specials everywhere, some straddling the 1 KiB targets
        return "".join(f"doc {i}<|endoftext|>" + " " * (i % 7) for i in range(1500))
    if name == "no_whitespace":
        return "z" * 10000 + "東" * 3000
    return _random_text(int(name.removeprefix("random")))


@pytest.mark.parametrize(
    "case",
    [*DATA_FILES, "ws_runs", "exotic", "specials", "no_whitespace", "random0", "random1"],
)
def test_safe_cut_points_match_jax(case, tmp_path):
    p = tmp_path / "t.txt"
    p.write_text(_cut_case(case), encoding="utf-8")
    data = p.read_bytes()
    for target in (257, 1024, 4096):
        for specials in ([], SPECIALS):
            got = parallel_encode.safe_cut_points(p, target, specials)
            assert got == jax_parallel.safe_cut_points(p, target, specials), (target, specials)
            if data:
                assert got[0][0] == 0 and got[-1][1] == len(data)
                assert all(b == c for (_, b), (c, _) in zip(got, got[1:]))
    if case == "no_whitespace":
        assert parallel_encode.safe_cut_points(p, 1024, []) == [(0, len(data))]


def test_cuts_near_exotic_whitespace(tmp_path):
    """A cut goes before White_Space and never before U+001C-001F."""
    p = tmp_path / "t.txt"
    p.write_text(_cut_case("exotic"), encoding="utf-8")
    data = p.read_bytes()
    spans = parallel_encode.safe_cut_points(p, 512, [])
    assert len(spans) > 10
    for _, cut in spans[:-1]:
        ch = data[cut:].decode("utf-8")[0]
        assert ord(ch) in parallel_encode.WHITESPACE, hex(ord(ch))


@pytest.mark.parametrize("seed", range(3))
def test_encode_file_matches_jax_and_encode(toks, tmp_path, seed):
    port, jax_tok = toks
    rng = random.Random(seed)
    text = _random_text(seed) + (DATA / "sample.txt").read_text(encoding="utf-8")
    p = tmp_path / f"r{seed}.txt"
    p.write_text(text, encoding="utf-8")
    expected = np.asarray(port.encode(text), dtype=np.int32)
    assert np.array_equal(expected, np.asarray(jax_tok.encode(text), dtype=np.int32))
    for chunk, workers in ((512, 1), (rng.choice([1024, 2048]), 3), (1 << 20, 2)):
        got = port.encode_file(p, max_workers=workers, chunk_bytes=chunk)
        assert got.dtype == np.int32
        assert np.array_equal(got, expected), (chunk, workers)
        assert np.array_equal(got, jax_tok.encode_file(p, max_workers=workers, chunk_bytes=chunk))


@pytest.mark.parametrize("name", DATA_FILES)
def test_encode_file_data_files(toks, name):
    port, jax_tok = toks
    path = DATA / f"{name}.txt"
    got = port.encode_file(path, max_workers=2, chunk_bytes=1024)
    assert got.tolist() == port.encode(path.read_text(encoding="utf-8"))
    assert np.array_equal(got, jax_tok.encode_file(path, max_workers=2, chunk_bytes=1024))


def test_encode_file_exact_across_whitespace_runs(toks, tmp_path):
    """A cut never splits or ends a whitespace run: ``\\s+(?!\\S)`` splits a
    run at the end of a buffer differently from mid-text."""
    port, _ = toks
    corpora = [
        "para. one two three\n\npara two follows here\n\n" * 400,
        "line with trailing spaces   \r\n\r\nnext line\t\t\n" * 300,
        "word  next 東京　　end\n\n" * 250,
        "alpha beta gamma delta " * 800,
        "doc one<|endoftext|>\n\n doc two <|endoftext|>  \n" * 200,
    ]
    for i, text in enumerate(corpora):
        p = tmp_path / f"ws{i}.txt"
        p.write_text(text, encoding="utf-8")
        expected = np.asarray(port.encode(text), dtype=np.int32)
        for chunk in (1024, 4096):
            assert np.array_equal(port.encode_file(p, max_workers=3, chunk_bytes=chunk), expected), (i, chunk)


def test_encode_file_invalid_utf8_raises_as_jax(toks, tmp_path):
    """The positioned ValueError, word for word, and the tokenizer stays
    usable (the native handles are released on the error path)."""
    port, jax_tok = toks
    p = tmp_path / "bad.txt"
    p.write_bytes(b"valid text here " * 300 + b"\xff\xfe" + b" tail" * 10)
    with pytest.raises(ValueError, match="invalid UTF-8") as got:
        port.encode_file(p, max_workers=2, chunk_bytes=1024)
    with pytest.raises(ValueError) as want:
        jax_tok.encode_file(p, max_workers=2, chunk_bytes=1024)
    assert str(got.value) == str(want.value)
    assert "position 4800" in str(got.value)
    assert port.decode(port.encode("still works")) == "still works"


def test_encode_file_missing_file(toks, tmp_path):
    with pytest.raises(FileNotFoundError):
        toks[0].encode_file(tmp_path / "missing.txt")


def test_encode_file_encoder_pool_reused(model, tmp_path):
    """Repeated calls reuse the tokenizer's encoder pool (warm word caches)
    and stay exact, also after clear_cache() and under concurrent calls,
    which must not share native handles."""
    port = BBPETokenizer.from_file(model, compute_device="cpu")
    p = tmp_path / "corpus.txt"
    p.write_text((DATA / "sample.txt").read_text(encoding="utf-8") * 20, encoding="utf-8")
    first = port.encode_file(p, max_workers=2, chunk_bytes=4096)
    pool = port._file_encoder_pool
    assert len(pool) >= 1
    again = port.encode_file(p, max_workers=2, chunk_bytes=4096)
    assert port._file_encoder_pool is pool
    assert len(pool) <= 2  # one encoder per worker thread, not per call
    assert np.array_equal(first, again)
    assert sum(e.cache_info()[2] for e in pool._encoders) > 0
    port.clear_cache()
    assert sum(e.cache_info()[2] for e in pool._encoders) == 0
    assert np.array_equal(first, port.encode_file(p, max_workers=2, chunk_bytes=4096))
    with ThreadPoolExecutor(max_workers=4) as ex:
        futures = [ex.submit(port.encode_file, p, max_workers=2, chunk_bytes=4096) for _ in range(4)]
        for f in futures:
            assert np.array_equal(first, f.result(timeout=120))
    assert len(pool) <= 8


def test_encoder_pool_rejects_foreign_tables():
    pool = parallel_encode.EncoderPool()
    a = ({(1, 2): (0, 300)}, [0])
    b = ({(3, 4): (0, 301)}, [1])
    pool.release(pool.claim(*a))
    pool.release(pool.claim(*a))  # the same tables: fine
    with pytest.raises(ValueError, match="different symbol tables"):
        pool.claim(*b)


def test_encode_file_without_the_native_library(toks, tmp_path, monkeypatch):
    """Without the native library the spans go through the regex path in
    this process (one worker): the same ids."""
    port, _ = toks
    text = _random_text(5, 600)
    p = tmp_path / "t.txt"
    p.write_text(text, encoding="utf-8")
    expected = port.encode_file(p, chunk_bytes=1024)
    monkeypatch.setattr(native, "available", lambda: False)
    tok = BBPETokenizer(port._vocab, port._merges, SPECIALS, compute_device="cpu")
    assert np.array_equal(tok.encode_file(p, max_workers=1, chunk_bytes=1024), expected)
    # device=True without the native library takes the same host path
    assert np.array_equal(tok.encode_file(p, max_workers=1, chunk_bytes=1024, device=True), expected)
    assert tok._device_encoder == {}


def test_encode_file_process_pool_without_the_native_library(toks, tmp_path, monkeypatch):
    """Without the native library, two workers and at least four spans take
    the pool of spawned processes: the same ids."""
    port, _ = toks
    text = _random_text(6, 1500)
    p = tmp_path / "t.txt"
    p.write_text(text, encoding="utf-8")
    expected = port.encode_file(p, chunk_bytes=1024)
    monkeypatch.setattr(native, "available", lambda: False)
    assert len(parallel_encode.safe_cut_points(p, 4096, SPECIALS)) >= 4
    got = parallel_encode.encode_file_parallel(
        p, port._vocab, port._merges, SPECIALS, max_workers=2, chunk_bytes=4096
    )
    assert np.array_equal(got, expected)
