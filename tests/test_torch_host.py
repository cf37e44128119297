"""The port's host layer against the JAX package, and its import isolation.

Every comparison is exact: same word tables, same raw ingest arrays, same
bytes on disk.
"""

from __future__ import annotations

import dataclasses
import importlib
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
        "yabpe_tpu_torch.cli.train_bpe, yabpe_tpu_torch.cli.bench, bench_torch, "
        "yabpe_tpu_torch.utils.profiling, yabpe_tpu_torch.utils.hostmem, tempfile, pathlib\n"
        "from yabpe_tpu_torch.core import PAD, Vocab, WordTable\n"
        "from yabpe_tpu_torch.pretok import GPT2_SPLIT_PATTERN, count_pretokens\n"
        "from yabpe_tpu_torch.io import load_model, save_model\n"
        "from yabpe_tpu_torch.train import BBPEModel, BBPETrainer, BBPETrainerConfig\n"
        "from yabpe_tpu_torch.dist import multihost_initialize\n"
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
    sources += [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
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


@pytest.mark.parametrize("package", ["core", "pretok", "io", "train", "tok", "dist"])
def test_subpackage_exports_match_jax(package):
    """Each sub-package exports the JAX package's names (``dist`` all but
    ``state_partition_specs``, the shard_map layout that has no
    counterpart), and the patterns' source is the same."""
    port = importlib.import_module(f"yabpe_tpu_torch.{package}")
    jax = importlib.import_module(f"yabpe_tpu.{package}")
    want = set(jax.__all__) - {"state_partition_specs"}
    assert want <= set(port.__all__)
    if package != "dist":
        assert set(port.__all__) == want
    for name in port.__all__:
        assert getattr(port, name) is not None, name
        if not callable(getattr(jax, name, None)) and name in jax.__all__:
            assert getattr(port, name) == getattr(jax, name), name


def test_config_fields_match_jax():
    """BBPETrainerConfig has every field of the JAX config, with its
    default, ``ingest_processes`` and ``count_strategy`` included, plus
    ``device``."""
    from yabpe_tpu.train.config import BBPETrainerConfig as JaxConfig
    from yabpe_tpu_torch.train import BBPETrainerConfig

    port = {f.name: f for f in dataclasses.fields(BBPETrainerConfig)}
    for f in dataclasses.fields(JaxConfig):
        assert f.name in port, f.name
    assert set(port) - {f.name for f in dataclasses.fields(JaxConfig)} == {"device"}
    ours, theirs = BBPETrainerConfig(), JaxConfig()
    for name in ("ingest_processes", "count_strategy", "use_fused_kernel", "min_frequency"):
        assert getattr(ours, name) == getattr(theirs, name), name


def test_multihost_initialize_without_a_launcher_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from yabpe_tpu.dist.mesh import multihost_initialize as jax_multihost_initialize
    from yabpe_tpu_torch.dist.mesh import multihost_initialize

    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "JAX_COORDINATOR_ADDRESS",
                 "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    multihost_initialize()
    jax_multihost_initialize()
    assert not dist.is_initialized()


def test_native_train_host_matches_train_host_raw_and_jax():
    counter = ingest.count_pretokens([DATA / "large.txt"], SPECIALS)
    counter[b""] = 4  # dropped, as the JAX function drops it
    got = native.train_host(counter, 300, 2)
    blob, lens, counts = ingest.count_pretokens_raw([DATA / "large.txt"], SPECIALS)
    assert got == native.train_host_raw(blob, lens, counts, 300, 2)
    assert got == jax_native.train_host(counter, 300, 2)
    assert len(got) > 100


@pytest.mark.parametrize("use_processes", [True, False, None], ids=["processes", "threads", "auto"])
def test_regex_path_pools_match_jax(use_processes):
    """The regex path in a pool of two processes or threads (auto: threads
    for this small file, as in the JAX package) gives the JAX package's
    counter."""
    path = DATA / "large.txt"
    kw = dict(chunk_size_bytes=4096, max_workers=2, align_to_newline=True)
    got = ingest.count_pretokens_regex([path], SPECIALS, use_processes=use_processes, **kw)
    assert got == jax_ingest.count_pretokens([path], SPECIALS, **kw)


def test_trainer_ingest_processes_on_the_regex_path(monkeypatch):
    """``ingest_processes=True`` reaches the regex path of the numpy
    backend (the native library taken away): the same merges as the JAX
    trainer's."""
    from yabpe_tpu import BBPETrainer as JaxTrainer
    from yabpe_tpu import BBPETrainerConfig as JaxConfig
    from yabpe_tpu_torch.train import BBPETrainer, BBPETrainerConfig

    seen = []
    regex_count = ingest.count_pretokens_regex

    def spy(*args, **kwargs):
        seen.append(kwargs["use_processes"])
        return regex_count(*args, **kwargs)

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(ingest, "count_pretokens_regex", spy)
    kw = dict(vocab_size=300, min_frequency=1, max_workers=2, chunk_size_bytes=4096,
              special_tokens=SPECIALS, align_chunks_to_newline=True)
    model = BBPETrainer(BBPETrainerConfig(**kw, backend="numpy", ingest_processes=True)).train(
        [DATA / "large.txt"]
    )
    assert seen == [True]
    want = JaxTrainer(JaxConfig(**kw, backend="numpy", ingest_processes=True)).train(
        [DATA / "large.txt"]
    )
    assert model.merges == want.merges and model.vocab == want.vocab


WARM_SEQUENCE = (
    "import json\n"
    "from {package}.utils import hostmem\n"
    "print(json.dumps([hostmem.warm_heap(8), hostmem.warm_heap(8), hostmem.warm_heap(16)]))\n"
)


def test_warm_heap_returns_match_jax():
    """warm_heap(8), warm_heap(8), warm_heap(16) fault 8 MiB, nothing, then
    the 8 MiB more, as the JAX function does; each package in a process of
    its own, since both keep the warmed amount per process."""
    env = {k: v for k, v in os.environ.items() if k != "YABPE_NO_MALLOC_TUNE"}
    env["PYTHONPATH"] = str(REPO / "src")
    got = {}
    for package in ("yabpe_tpu_torch", "yabpe_tpu"):
        out = subprocess.run(
            [sys.executable, "-c", WARM_SEQUENCE.format(package=package)],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=120, check=True,
        )
        got[package] = out.stdout.strip().splitlines()[-1]
    assert got["yabpe_tpu_torch"] == got["yabpe_tpu"] == "[8388608, 0, 8388608]"


def test_warm_heap_off_with_no_malloc_tune(monkeypatch):
    from yabpe_tpu_torch.utils import hostmem

    monkeypatch.setenv("YABPE_NO_MALLOC_TUNE", "1")
    assert hostmem.warm_heap(64) == 0
    assert "warm_heap" in hostmem.__all__


def test_library_path_keys_on_flags_and_nvcc_version(monkeypatch):
    """The library's name changes with NVCC_FLAGS and with the compiler's
    --version text, and with nothing else held fixed it stays put."""
    from yabpe_tpu_torch.kernels import _build

    first = _build.library_path("hbm_loop", "release 12.4")
    assert first == _build.library_path("hbm_loop", "release 12.4")
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libhbm_loop-")
    assert _build.library_path("hbm_loop", "release 12.6") != first
    assert _build.library_path("fused_loop", "release 12.4") != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build.library_path("hbm_loop", "release 12.4") != first
    monkeypatch.undo()
    assert _build.library_path("hbm_loop", "release 12.4") == first


def test_build_reuses_a_library_of_the_same_key(monkeypatch, tmp_path):
    """build() keys on the version that nvcc_version() reads; a library
    already there under that key is returned without compiling, and
    another version's key is a different file."""
    from yabpe_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_version", lambda: "release 12.4")
    monkeypatch.setattr(_build, "nvcc_path", lambda: pytest.fail("nvcc was run"))
    lib = _build.library_path("replay_emit", "release 12.4")
    lib.write_bytes(b"")
    assert _build.build("replay_emit") == (lib, "")
    assert not _build.library_path("replay_emit", "release 12.6").exists()


def test_nvcc_version_is_read_once(monkeypatch):
    from yabpe_tpu_torch.kernels import _build

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout="Cuda compilation tools, release 12.4\n")

    monkeypatch.setattr(_build, "_nvcc_version", None)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    assert _build.nvcc_version() == _build.nvcc_version() == "Cuda compilation tools, release 12.4\n"
    assert calls == [["/cuda/bin/nvcc", "--version"]]
