"""The port's host layer against the JAX package, and its import isolation.

Every comparison is exact: same word tables, same raw ingest arrays, same
bytes on disk.
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from yabpe_tpu import native as jax_native
from yabpe_tpu.core.vocab import Vocab as JaxVocab
from yabpe_tpu.core.wordtable import WordTable as JaxWordTable
from yabpe_tpu.io import native as jax_io
from yabpe_tpu.pretok import chunking as jax_chunking
from yabpe_tpu.pretok import ingest as jax_ingest
from yabpe_tpu_torch import native
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.io.native import load_model, save_model
from yabpe_tpu_torch.pretok import chunking, ingest

from .common import DATA, LOCAL_FIXTURES, REPO

SPECIALS = ["<|endoftext|>"]
DATA_FILES = ["empty", "large", "multiline", "sample", "simple", "unicode"]


def test_import_leaves_out_jax_and_the_jax_package():
    code = (
        "import sys, yabpe_tpu_torch, yabpe_tpu_torch.train.hbm_driver, "
        "yabpe_tpu_torch.pretok.ingest, yabpe_tpu_torch.kernels._build, "
        "yabpe_tpu_torch.kernels.fused_loop, yabpe_tpu_torch.train.fused_driver, "
        "yabpe_tpu_torch.tok, yabpe_tpu_torch.io.gpt2, "
        "yabpe_tpu_torch.dist.hbm_sharded, yabpe_tpu_torch.kernels.replay_emit, "
        "yabpe_tpu_torch.kernels.merge_apply, yabpe_tpu_torch.kernels.pair_count, "
        "yabpe_tpu_torch.kernels.select, yabpe_tpu_torch.train.state, "
        "yabpe_tpu_torch.train.incremental, yabpe_tpu_torch.train.bigvocab, "
        "yabpe_tpu_torch.train.checkpoint, yabpe_tpu_torch.tok.parallel_encode, "
        "yabpe_tpu_torch.tok.device_encode, yabpe_tpu_torch.dist.sharded, "
        "yabpe_tpu_torch.dist.ingest, yabpe_tpu_torch.dist.speculative, "
        "yabpe_tpu_torch.cli.train_bpe, yabpe_tpu_torch.utils.profiling, tempfile, pathlib\n"
        "tok = yabpe_tpu_torch.BBPETokenizer("
        "{b'a': 0, b'b': 1, b' ': 2, b'ab': 3, b' ab': 4}, "
        "[(b'a', b'b'), (b' ', b'ab')], [])\n"
        "assert tok.encode('abab ab' * 20)[:4] == [3, 3, 4, 3], tok.encode('abab ab')\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    p = pathlib.Path(d) / 'f.txt'\n"
        "    p.write_text('abab ab\\n' * 3000)\n"
        "    ids = tok.encode_file(p, max_workers=2, chunk_bytes=4096)\n"
        "    assert ids.tolist() == tok.encode(p.read_text()), ids[:8]\n"
        "bad =[m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'yabpe_tpu' or m.startswith('yabpe_tpu.') or m == 'regex']\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        capture_output=True,
        text=True,
        timeout=120,
        check=True,
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_no_jax_imports_in_the_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|yabpe_tpu)\b", re.M)
    sources = sorted((REPO / "src" / "yabpe_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    assert len(sources) > 10
    offenders = [
        f"{p.relative_to(REPO)}: {m.group(0).strip()}"
        for p in sources
        for m in pattern.finditer(p.read_text(encoding="utf-8"))
    ]
    assert offenders == []


def _same_table(a, b) -> None:
    assert np.array_equal(a.words, b.words)
    assert np.array_equal(a.freqs, b.freqs)
    assert (a.num_words, a.max_len) == (b.num_words, b.max_len)


@pytest.mark.parametrize(
    "path",
    [DATA / f"{n}.txt" for n in DATA_FILES]
    + [LOCAL_FIXTURES / "bench_5M_realistic.txt"],
    ids=DATA_FILES + ["bench_5M_realistic"],
)
def test_count_pretokens_word_table_matches_jax(path):
    kw = dict(chunk_size_bytes=1 << 20, max_workers=4, align_to_newline=True)
    got = ingest.count_pretokens([path], SPECIALS, **kw)
    want = jax_ingest.count_pretokens([path], SPECIALS, **kw)
    assert got == want
    _same_table(WordTable.from_counter(got), JaxWordTable.from_counter(want))
    g_blob, g_lens, g_counts = ingest.count_pretokens_raw([path], SPECIALS, **kw)
    w_blob, w_lens, w_counts = jax_ingest.count_pretokens_raw([path], SPECIALS, **kw)
    assert g_blob == w_blob
    assert np.array_equal(g_lens, w_lens) and np.array_equal(g_counts, w_counts)


@pytest.mark.parametrize("name", ["unicode", "multiline", "large"])
def test_regex_path_matches_jax_regex_and_native(name):
    path = DATA / f"{name}.txt"
    size = path.stat().st_size
    got = ingest.count_pretokens_regex([path], SPECIALS, chunk_size_bytes=size)
    want = jax_ingest._count_span(str(path), 0, size, tuple(SPECIALS))
    assert got == want
    assert got == ingest.count_pretokens([path], SPECIALS, max_workers=1)


@pytest.mark.parametrize("chunk,align", [(1000, False), (1000, True), (4096, True)])
def test_chunk_spans_match_jax(chunk, align):
    path = DATA / "large.txt"
    assert chunking.chunk_spans(path, chunk, align_to_newline=align) == (
        jax_chunking.chunk_spans(path, chunk, align_to_newline=align)
    )


def test_invalid_utf8_error_matches_jax(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_bytes(b"hello wor\xffld")
    with pytest.raises(ValueError) as got:
        ingest.count_pretokens([bad], [])
    with pytest.raises(ValueError) as want:
        jax_ingest.count_pretokens([bad], [])
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        ingest.count_pretokens([tmp_path / "missing.txt"], [])


def test_native_scanner_calls_match_jax():
    data = (DATA / "unicode.txt").read_bytes() + b" <|x|> tail<|x|><|y|>"
    assert native.utf8_invalid_at(data) == jax_native.utf8_invalid_at(data) == -1
    assert native.utf8_invalid_at(b"ab\xc3") == jax_native.utf8_invalid_at(b"ab\xc3")
    assert np.array_equal(
        native.pretok_offsets(data), jax_native.pretok_offsets(data)
    )
    specials = [b"<|x|>", b"<|y|>"]
    for g, w in zip(
        native.find_specials(data, specials),
        jax_native.find_specials(data, specials),
    ):
        assert np.array_equal(g, w)


def test_native_host_loop_matches_jax():
    blob, lens, counts = ingest.count_pretokens_raw([DATA / "large.txt"], SPECIALS)
    got = native.train_host_raw(blob, lens, counts, 300, 2)
    assert got == jax_native.train_host_raw(blob, lens, counts, 300, 2)
    assert len(got) > 100


def test_vocab_base_matches_jax():
    for specials in ([], SPECIALS, ["A", "[X]", "[X]", "[Y]"]):
        got, want = Vocab.base(specials), JaxVocab.base(specials)
        assert list(got.tokens()) == list(want.tokens())
        assert got.max_token_len() == want.max_token_len()


def test_save_model_byte_identical(tmp_path):
    vocab = {bytes([i]): i for i in range(256)}
    vocab.update({b"<|endoftext|>": 256, b"th": 257, b"\xe6\x9d": 258, b"a b": 259})
    merges = [(b"t", b"h"), (b"\xe6", b"\x9d"), (b"a", b" b")]
    save_model(tmp_path / "port", vocab, merges, SPECIALS)
    jax_io.save_model(tmp_path / "jax", vocab, merges, SPECIALS)
    for name in ("vocab.json", "merges.txt", "special_tokens.json"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name
        ).read_bytes(), name
    assert load_model(tmp_path / "port") == jax_io.load_model(tmp_path / "jax")
    assert load_model(tmp_path / "port")[1] == merges


def test_word_table_from_counter_matches_jax():
    counter = Counter({b"abc": 3, b"x" * 40: 2, b"": 5, b"zero": 0, b"q": 1})
    _same_table(WordTable.from_counter(counter), JaxWordTable.from_counter(counter))
    assert Path(ingest.__file__).parent.parent.name == "yabpe_tpu_torch"
