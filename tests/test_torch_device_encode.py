"""The port's device encoder (tok/device_encode.py) and the encoder's apply
(kernels/merge_apply.py::apply_rowwise_merge) against the JAX package's,
on the CPU.

The JAX scan runs as the JAX package runs it on the CPU, jitted. Inputs
come from numpy seeds; every comparison is exact.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yabpe_tpu import BBPETokenizer as JaxTokenizer
from yabpe_tpu import native as jax_native
from yabpe_tpu.kernels import merge_apply as jax_apply
from yabpe_tpu.tok import device_encode as jax_device
from yabpe_tpu_torch import BBPETokenizer, BBPETrainer, BBPETrainerConfig, native
from yabpe_tpu_torch.core.wordtable import PAD
from yabpe_tpu_torch.kernels import merge_apply
from yabpe_tpu_torch.tok import device_encode

from .common import DATA, LOCAL_FIXTURES

SPECIALS = ["<|endoftext|>"]
DATA_FILES = ["empty", "large", "multiline", "sample", "simple", "unicode"]
SNIPPETS = json.loads(
    (LOCAL_FIXTURES / "golden_encode" / "gpt2_golden.json").read_text(encoding="utf-8")
)["snippets"]["texts"]

#: A table with a duplicated pair ((a, a): its last rank counts), runs of
#: one symbol, and a key that ``b`` followed by PAD would hit without the
#: validity mask: the last new symbol is "bab" (id n - 1), and (a, bab) is
#: live, so ``b * n + PAD == a * n + (n - 1)``.
SYNTHETIC_MERGES = [
    (b"a", b"a"), (b"aa", b"aa"), (b"a", b"b"), (b"ab", b"ab"), (b"a", b"a"),
    (b"b", b"b"), (b"aaaa", b"a"), (b"b", b"ab"), (b"a", b"bab"),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model(tinystories_5m):
    """(vocab, merges) at vocab 1000 from the 5 MB TinyStories fixture, by
    the native loop (the device routes give the same merges)."""
    trainer = BBPETrainer(BBPETrainerConfig(
        vocab_size=1000, min_frequency=1, max_workers=1, chunk_size_bytes=1 << 30,
        special_tokens=SPECIALS, use_native_loop=True,
    ))
    trained = trainer.train([tinystories_5m])
    return trained.vocab, trained.merges


def test_native_word_ids_match_jax():
    """The word-id scans of the port's native binding against the JAX
    package's, over one counter fed several texts."""
    texts = [(DATA / f"{n}.txt").read_bytes() for n in DATA_FILES]
    texts.append("a<|endoftext|>b <|endoftext|><|endoftext|> c".encode())
    specials = ("<|endoftext|>",)
    for method in ("add_word_ids", "add_word_ids_specials"):
        port, jax_counter = native.NativeCounter(specials), jax_native.NativeCounter(specials)
        for data in texts:
            got, want = getattr(port, method)(data), getattr(jax_counter, method)(data)
            assert got.dtype == np.int32 and np.array_equal(got, want), method
        assert port.export_words() == jax_counter.export_words()
        assert len(port.export_words()) > 100
        port.close()
        jax_counter.close()


def _synthetic_model():
    vocab = {bytes([b]): b for b in range(256)}
    for left, right in SYNTHETIC_MERGES:
        vocab.setdefault(left + right, len(vocab))
    return vocab, SYNTHETIC_MERGES


def _tables(vocab, merges):
    port = device_encode.DeviceEncoder(vocab, merges, device="cpu")
    jax_enc = jax_device.DeviceEncoder(vocab, merges)
    return port, jax_enc


def _random_tile(rng, rows: int, width: int, words: list[bytes], alphabet: bytes) -> np.ndarray:
    """``rows`` rows: pre-tokens of ``words``, random strings over
    ``alphabet`` (runs included) and empty rows, -1 padded."""
    tile = np.full((rows, width), PAD, dtype=np.int32)
    for r in range(rows):
        kind = rng.integers(0, 8)
        if kind == 0:
            continue
        if kind < 4 and words:
            word = words[rng.integers(0, len(words))][:width]
        else:
            n = int(rng.integers(1, width + 1))
            letters = np.frombuffer(alphabet, dtype=np.uint8)
            word = bytes(letters[rng.integers(0, len(letters), n)])
            if kind == 7:  # one long run of one symbol
                word = word[:1] * n
        tile[r, : len(word)] = np.frombuffer(word, dtype=np.uint8)
    return tile


def _scan_both(port, jax_enc, tile):
    want = np.asarray(jax.jit(jax_device._scan_encode_impl)(
        jnp.asarray(tile), jax_enc._sorted_keys, jax_enc._sorted_ranks,
        jax_enc._sorted_new_syms, jax_enc._n_syms_dev,
    ))
    tables = (port._sorted_keys, port._sorted_ranks, port._sorted_new_syms, port._n_syms)
    stats: dict = {}
    got = device_encode.scan_encode(torch.from_numpy(tile), *tables, stats=stats)
    return got.numpy(), want, tables, stats


@pytest.mark.parametrize("rows,width", [(64, 32), (256, 64)])
@pytest.mark.parametrize("table", ["trained", "synthetic"])
def test_scan_matches_jax(model, tinystories_5m, table, rows, width):
    rng = np.random.default_rng(rows + width)
    if table == "trained":
        vocab, merges = model
        with open(tinystories_5m, encoding="utf-8") as f:
            text = f.read(200_000)
        words = sorted({w.encode("utf-8") for w in text.split(" ") if w})
        alphabet = b"etaoin shrdlu.,\n"
    else:
        vocab, merges = _synthetic_model()
        words = [b"ab", b"b", b"aaaa", b"aaaaa", b"abab", b"babab", b"aab"]
        alphabet = b"ab"
    port, jax_enc = _tables(vocab, merges)
    tile = _random_tile(rng, rows, width, words, alphabet)
    got, want, tables, stats = _scan_both(port, jax_enc, tile)
    assert np.array_equal(got, want)
    assert not np.array_equal(got, tile)  # the scan merged something
    assert stats["iterations"] <= width - 1
    # the same rows whatever the bound and the tests for work
    for kw in ({"check_every": 1}, {"max_iters": width - 1, "check_every": width}):
        again = device_encode.scan_encode(torch.from_numpy(tile), *tables, **kw)
        assert np.array_equal(again.numpy(), want), kw
    # the tile is not changed, and rows without work stay as they are
    assert np.array_equal(device_encode.scan_encode(torch.from_numpy(got), *tables).numpy(), got)


def test_scan_keeps_the_last_rank_and_never_merges_across_pad():
    vocab, merges = _synthetic_model()
    port, jax_enc = _tables(vocab, merges)
    assert port._n_syms - 1 == vocab[b"bab"]  # symbol ids are the vocab ids here
    rows = [b"b", b"ab", b"aaaa", b"aaaaaaa", b"aaaaaaaaa", b"bab", b"abab"]
    tile = np.full((len(rows), 32), PAD, dtype=np.int32)
    for r, word in enumerate(rows):
        tile[r, : len(word)] = np.frombuffer(word, dtype=np.uint8)
    got, want, _, _ = _scan_both(port, jax_enc, tile)
    assert np.array_equal(got, want)
    tok = BBPETokenizer(vocab, merges, [], compute_device="cpu")
    for r, word in enumerate(rows):
        assert [int(s) for s in got[r] if s >= 0] == tok.encode(word.decode()), word
    # (a, a)'s last rank (4) is above (ab, ab)'s (3): "aabab" merges "ab"
    # first, then "abab"; with the first rank "aa" would win
    assert tok.encode_batch(["aabab"], device=True) == tok.encode_batch(["aabab"])
    assert tok.encode("aabab") == [vocab[b"a"], vocab[b"abab"]]


@pytest.mark.parametrize("width", [32, 128])
def test_apply_rowwise_merge_matches_jax(width):
    rng = np.random.default_rng(width)
    n = 96
    lens = rng.integers(0, width + 1, n)
    words = np.full((n, width), PAD, dtype=np.int32)
    for r, length in enumerate(lens):
        words[r, :length] = rng.integers(0, 4, length)  # small alphabet: runs
    left, right = words[:, :-1], words[:, 1:]
    match = (left >= 0) & (right >= 0) & (left == right) & (rng.random(left.shape) < 0.7)
    new_syms = rng.integers(256, 300, left.shape).astype(np.int32)
    jax_applied = jax_apply.leftmost_nonoverlapping(jnp.asarray(match))
    applied = merge_apply.leftmost_nonoverlapping(torch.from_numpy(match))
    assert np.array_equal(applied.numpy(), np.asarray(jax_applied))
    want = jax_apply.apply_rowwise_merge(jnp.asarray(words), jax_applied, jnp.asarray(new_syms))
    got = merge_apply.apply_rowwise_merge(
        torch.from_numpy(words), applied, torch.from_numpy(new_syms)
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert applied.any() and (got.numpy() >= 256).any()


def _texts(source: str) -> list[str]:
    if source == "snippets":
        return SNIPPETS
    return [(DATA / f"{source}.txt").read_text(encoding="utf-8")]


@pytest.mark.parametrize("with_specials", [True, False], ids=["specials", "no_specials"])
def test_encode_batch_matches_jax_device_encoder(model, with_specials):
    vocab, merges = model
    specials = SPECIALS if with_specials else []
    port = BBPETokenizer(vocab, merges, specials, compute_device="cpu")
    jax_tok = JaxTokenizer(vocab, merges, specials)
    for source in ["snippets", *DATA_FILES]:
        texts = _texts(source) + ["tail<|endoftext|>aaaa  \n\n", ""]
        host = [port.encode(t) for t in texts]
        assert jax_tok.encode_batch(texts, device=True) == host, source
        for shards in (None, 2, 4):
            assert port.encode_batch(texts, device=True, data_shards=shards) == host, (source, shards)
    for shards in (1, 2, 4):
        enc = port._get_device_encoder(shards)
        assert enc.stats["tiles"] > 0 and enc._sorted_keys.device.type == "cpu"
    assert port._get_device_encoder(4)._max_rows % 4 == 0


def test_encode_batch_regex_path_matches_native_path(model, monkeypatch):
    """Without the native library the device encoder pre-tokenizes with
    the regex pattern: the same ids."""
    vocab, merges = model
    texts = SNIPPETS + _texts("large") + ["a<|endoftext|>b<|endoftext|>"]
    want = BBPETokenizer(vocab, merges, SPECIALS, compute_device="cpu").encode_batch(texts)
    tok = BBPETokenizer(vocab, merges, SPECIALS, compute_device="cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    assert tok.encode_batch(texts, device=True) == want
    assert tok.encode_batch(texts, device=True, data_shards=2) == want
    assert tok._get_device_encoder(None)._word_cache  # the regex path's cache


def test_encode_file_device_exact_and_cache_persists(model, tmp_path):
    """encode_file(device=True) equals the whole text's encode, and the word
    cache persists across calls: a second file finds no new word."""
    vocab, merges = model
    tok = BBPETokenizer(vocab, merges, SPECIALS, compute_device="cpu")
    jax_tok = JaxTokenizer(vocab, merges, SPECIALS)
    base = (DATA / "sample.txt").read_text(encoding="utf-8")
    text = (base + "\n<|endoftext|>\n") * 40
    p = tmp_path / "corpus.txt"
    p.write_text(text, encoding="utf-8")
    got = tok.encode_file(p, chunk_bytes=4096, device=True)
    expected = np.asarray(tok.encode(text), dtype=np.int32)
    assert got.dtype == np.int32
    assert np.array_equal(got, expected)
    assert np.array_equal(got, jax_tok.encode_file(p, chunk_bytes=4096, device=True))

    enc = tok._get_device_encoder(None)
    cached = len(enc._word_cache_b)
    new_words, tiles = enc.stats["new_words"], enc.stats["tiles"]
    assert cached > 0 and tiles > 0
    # warm: the same file again finds no new word and runs no tile
    assert np.array_equal(tok.encode_file(p, chunk_bytes=4096, device=True), expected)
    assert (len(enc._word_cache_b), enc.stats["new_words"], enc.stats["tiles"]) == (cached, new_words, tiles)
    p2 = tmp_path / "corpus2.txt"
    p2.write_text(text[: len(text) // 2 + 7], encoding="utf-8")
    got2 = tok.encode_file(p2, chunk_bytes=4096, device=True)
    assert np.array_equal(got2, np.asarray(tok.encode(text[: len(text) // 2 + 7]), dtype=np.int32))
    assert len(enc._word_cache_b) >= cached
    assert enc.stats["readbacks"] >= 2 and enc.stats["dispatch_s"] > 0


def test_device_paths_raise_without_a_cuda_device(model, tmp_path):
    """compute_device="cuda" without a CUDA device raises; the host never
    serves the call in its place."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    vocab, merges = model
    tok = BBPETokenizer(vocab, merges, SPECIALS)
    p = tmp_path / "t.txt"
    p.write_text("hello world", encoding="utf-8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tok.encode_batch(["hello"], device=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tok.encode_file(p, device=True)
    assert tok._device_encoder == {}
    assert tok.encode_batch(["hello"]) == [tok.encode("hello")]


def _huge_tables():
    """65,536 two-byte merges: 256 + 65,536 extended symbols, past the
    65,535 of the packed pair keys."""
    merges = [(bytes([x]), bytes([y])) for x in range(256) for y in range(256)]
    vocab = {bytes([b]): b for b in range(256)}
    for i, (left, right) in enumerate(merges):
        vocab.setdefault(left + right, 256 + i)
    return vocab, merges


def test_device_encode_falls_back_for_huge_symbol_table():
    vocab, merges = _huge_tables()
    tok = BBPETokenizer(vocab=vocab, merges=merges, compute_device="cpu")
    jax_tok = JaxTokenizer(vocab=vocab, merges=merges)
    texts = ["hello world", ""]
    assert tok.encode_batch(texts, device=True) == tok.encode_batch(texts)
    assert tok.encode_batch(texts, device=True) == jax_tok.encode_batch(texts, device=True)
    # The failure is cached: later calls do not rebuild the tables to fail.
    assert tok._device_encoder[1] is None
    assert tok._get_device_encoder(None) is None
    with pytest.raises(device_encode.SymbolTableTooLarge):
        device_encode.DeviceEncoder(vocab, merges, device="cpu")


def test_device_encode_fallback_past_packed_key_range(tmp_path):
    vocab, merges = _huge_tables()
    tok = BBPETokenizer(vocab=vocab, merges=merges, special_tokens=[], compute_device="cpu")
    texts = ["hello world", "aa bb cc"]
    host = tok.encode_batch(texts)
    assert tok.encode_batch(texts, device=True) == host
    assert tok._device_encoder.get(1, "missing") is None
    # encode_file(device=True) takes the host's parallel path as well
    p = tmp_path / "t.txt"
    p.write_text(" ".join(texts), encoding="utf-8")
    assert tok.encode_file(p, device=True).tolist() == tok.encode(" ".join(texts))
