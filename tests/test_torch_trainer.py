"""The port's trainer end to end on the CPU (device="cpu"), held against
the JAX package's trainer and its snapshot. Every comparison is exact."""

from __future__ import annotations

import pickle
from pathlib import Path

import pytest
import torch

from yabpe_tpu import BBPETrainer as JaxTrainer
from yabpe_tpu import BBPETrainerConfig as JaxConfig
from yabpe_tpu.io import gpt2 as gpt2io
from yabpe_tpu_torch import BBPEModel, BBPETrainer, BBPETrainerConfig
from yabpe_tpu_torch.io.native import load_model

from .adapters import run_train_bpe as jax_run_train_bpe
from .common import DATA, LOCAL_FIXTURES, REF_FIXTURES, REPO

SPECIALS = ["<|endoftext|>"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_train_bpe(
    input_path: str | Path,
    vocab_size: int,
    special_tokens: list[str],
    **overrides,
) -> tuple[dict[int, bytes], list[tuple[bytes, bytes]]]:
    """Port twin of tests/adapters.py::run_train_bpe, on the device route."""
    kw = dict(
        vocab_size=vocab_size,
        min_frequency=1,
        max_workers=1,
        chunk_size_bytes=1024 * 1024 * 1024,
        special_tokens=special_tokens,
        device="cpu",
    )
    config = BBPETrainerConfig(**{**kw, **overrides})
    model = BBPETrainer(config).train([Path(input_path)])
    return {v: k for k, v in model.vocab.items()}, model.merges


def test_run_train_bpe_matches_jax_on_large():
    got = run_train_bpe(DATA / "large.txt", 500, SPECIALS)
    want = jax_run_train_bpe(DATA / "large.txt", 500, SPECIALS)
    assert got == want
    assert len(got[1]) == 500 - 257


def test_special_tokens_snapshot(tinystories_5m):
    """The 5 MB corpus at vocab 1000 reproduces the JAX package's snapshot
    (tests/_snapshots/test_train_bpe_special_tokens.pkl)."""
    vocab, merges = run_train_bpe(tinystories_5m, 1000, SPECIALS)
    for word_bytes in vocab.values():
        if word_bytes != b"<|endoftext|>":
            assert b"<|" not in word_bytes
    with open(REPO / "tests" / "_snapshots" / "test_train_bpe_special_tokens.pkl", "rb") as f:
        expected = pickle.load(f)
    assert merges == expected["merges"]
    assert set(vocab.keys()) == expected["vocab_keys"]
    assert set(vocab.values()) == expected["vocab_values"]


def test_golden_reference_merges():
    corpus = REF_FIXTURES / "corpus.en"
    if not corpus.exists():
        pytest.skip(f"reference fixtures not present at {REF_FIXTURES}")
    _, merges = run_train_bpe(corpus, 500, SPECIALS)
    want = gpt2io.load_gpt2_merges(REF_FIXTURES / "train-bpe-reference-merges.txt")
    assert merges == want


@pytest.mark.parametrize(
    "route",
    [
        dict(use_native_loop=True),
        dict(backend="numpy"),
        dict(merge_chunk_size=5),
        dict(use_fused_kernel=False),
        dict(use_fused_kernel=True),
    ],
    ids=["native", "numpy", "device_small_chunks", "no_fused_kernel", "fused_kernel"],
)
def test_routes_agree(route):
    """On the 5 MB realistic fixture the device route runs K2 (past the
    small-vocabulary admission); on large.txt it runs K1, and
    ``use_fused_kernel=False`` holds K2 to it there."""
    path = LOCAL_FIXTURES / "bench_5M_realistic.txt"
    kw = dict(min_frequency=3, chunk_size_bytes=1 << 20, max_workers=4)
    if "backend" in route or "use_fused_kernel" in route:
        path = DATA / "large.txt"
    base = run_train_bpe(path, 420, SPECIALS, **kw)
    assert run_train_bpe(path, 420, SPECIALS, **kw, **route) == base


def test_forced_fused_kernel_past_its_admission_raises():
    with pytest.raises(ValueError, match="use_fused_kernel=True"):
        run_train_bpe(DATA / "large.txt", 4096, SPECIALS, use_fused_kernel=True)


def test_save_matches_jax_trainer_files(tmp_path):
    cfg = dict(vocab_size=400, min_frequency=2, special_tokens=SPECIALS)
    port = BBPETrainer(BBPETrainerConfig(**cfg, device="cpu"))
    model = port.train([DATA / "large.txt"])
    assert isinstance(model, BBPEModel)
    port.save(tmp_path / "port")
    jax = JaxTrainer(JaxConfig(**cfg))
    jax.train([DATA / "large.txt"])
    jax.save(tmp_path / "jax")
    for name in ("vocab.json", "merges.txt", "special_tokens.json"):
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "jax" / name
        ).read_bytes(), name
    # merges.txt cannot hold a token with a newline (a documented hazard of
    # the format), so only the vocab and the specials round-trip exactly.
    vocab, _, specials = load_model(tmp_path / "port")
    assert (vocab, specials) == (model.vocab, SPECIALS)
    assert set(port.last_stats) == set(jax.last_stats)
    assert port.last_stats["num_merges"] == len(model.merges)


def test_not_ported_configurations_raise(tmp_path):
    """Every layout the JAX trainer takes trains, with the JAX trainer's
    merges (data shards, vocab shards, both); an unknown backend raises."""
    for kw in (dict(data_shards=2), dict(vocab_shards=2), dict(data_shards=2, vocab_shards=2)):
        cfg = dict(vocab_size=300, min_frequency=1, special_tokens=SPECIALS, **kw)
        got = BBPETrainer(BBPETrainerConfig(device="cpu", **cfg)).train([DATA / "sample.txt"])
        want = JaxTrainer(JaxConfig(**cfg)).train([DATA / "sample.txt"])
        assert got.merges == want.merges and got.vocab == want.vocab, kw
    with pytest.raises(ValueError, match="backend"):
        BBPETrainer(BBPETrainerConfig(backend="jax")).train([DATA / "sample.txt"])


@pytest.mark.parametrize(
    "layout,route",
    [
        (dict(data_shards=2), "sharded_loop"),
        (dict(data_shards=2, vocab_shards=2), "sharded_loop"),
        (dict(data_shards=4, spec_merges_per_round=8), "sharded_loop"),
        (dict(data_shards=2, use_hbm_kernel=True), "sharded"),
        (dict(data_shards=2, vocab_shards=2, use_hbm_kernel=True), "sharded_loop"),
    ],
    ids=["data", "data_vocab", "speculative", "kernel_sharded", "kernel_vocab"],
)
def test_sharded_routes(layout, route):
    """The sharded routes, named apart, give the JAX trainer's merges (its
    sharded loop, on the same data and vocab shards)."""
    cfg = dict(vocab_size=420, min_frequency=2, special_tokens=SPECIALS, max_workers=1,
               merge_chunk_size=64)
    trainer = BBPETrainer(BBPETrainerConfig(device="cpu", **cfg, **layout))
    got = trainer.train([DATA / "large.txt"])
    assert trainer.route == route
    jax_layout = {k: v for k, v in layout.items() if k != "use_hbm_kernel"}
    want = JaxTrainer(JaxConfig(**cfg, **jax_layout)).train([DATA / "large.txt"])
    assert got.merges == want.merges and got.vocab == want.vocab


def _abc_corpus(path: Path) -> Path:
    """3,000 seeded words of 20-49 letters over {a, b, c}: the first
    merge's cells fill more than 32 log rows of a shard."""
    import numpy as np

    rng = np.random.default_rng(0)
    words = ["".join(rng.choice(list("abc"), size=int(rng.integers(20, 50)))) for _ in range(3000)]
    path.write_text("\n".join(" ".join(words[i : i + 10]) for i in range(0, 3000, 10)))
    return path


def test_restart_after_the_kernel_sharded_loop_rejects_the_run(tmp_path):
    """A cell-log plan that leaves the overflow fallback 32 rows: the
    kernel-sharded loop raises HbmShardedUnsupported at its first merge
    (the fallback's largest log), and the trainer restarts on the sharded
    loop, with the merges of the JAX trainer's sharded loop, where the JAX
    trainer restarts such a run (its kernel-sharded loop is left out here:
    in interpret mode its 74,000-row logs take 35-40 s)."""
    from yabpe_tpu_torch.core.vocab import Vocab
    from yabpe_tpu_torch.core.wordtable import WordTable
    from yabpe_tpu_torch.dist.hbm_sharded import HbmShardedUnsupported, run_hbm_sharded_merge_loop
    from yabpe_tpu_torch.kernels.replay_emit import max_log_rows
    from yabpe_tpu_torch.pretok.ingest import count_pretokens

    corpus = _abc_corpus(tmp_path / "abc.txt")
    table = WordTable.from_counter(count_pretokens([corpus], [], max_workers=1))
    nrs = -(-table.words.shape[0] // (2 * 128) // 8) * 8
    cps = max_log_rows(nrs, (table.width + 2) * 128) - 32
    with pytest.raises(HbmShardedUnsupported, match="largest cell log"):
        run_hbm_sharded_merge_loop(
            table, Vocab.base([]), vocab_cap=300, num_merges=44, min_frequency=1,
            data_shards=2, spec_batch=2, cps=cps, device="cpu",
        )
    cfg = dict(vocab_size=300, min_frequency=1, special_tokens=[], max_workers=1,
               data_shards=2, use_hbm_kernel=True, hbm_sharded_cps=cps,
               spec_merges_per_round=2)
    trainer = BBPETrainer(BBPETrainerConfig(device="cpu", **cfg))
    got = trainer.train([corpus])
    assert trainer.route == "sharded_loop"
    assert trainer.loop_stats["full_recounts"] > 0
    del cfg["use_hbm_kernel"], cfg["hbm_sharded_cps"]
    want = JaxTrainer(JaxConfig(**cfg)).train([corpus])
    assert got.merges == want.merges and len(got.merges) == 44


def test_pair_table_guard_divides_by_vocab_shards():
    """The dense-table guard counts one slab, as the JAX trainer's does:
    a limit between the slab and the whole table refuses one vocab shard
    and admits two."""
    cfg = dict(vocab_size=300, min_frequency=1, max_workers=1, special_tokens=SPECIALS,
               data_shards=2, max_pair_table_bytes=4 * 300 * 300 // 2)
    with pytest.raises(ValueError, match="dense pair table"):
        BBPETrainer(BBPETrainerConfig(device="cpu", **cfg)).train([DATA / "sample.txt"])
    with pytest.raises(ValueError, match="dense pair table"):
        JaxTrainer(JaxConfig(**cfg)).train([DATA / "sample.txt"])
    got = BBPETrainer(BBPETrainerConfig(device="cpu", vocab_shards=2, **cfg)).train([DATA / "sample.txt"])
    want = JaxTrainer(JaxConfig(vocab_shards=2, **cfg)).train([DATA / "sample.txt"])
    assert got.merges == want.merges


def test_default_device_is_cuda_and_never_falls_back():
    assert BBPETrainerConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    trainer = BBPETrainer(BBPETrainerConfig(vocab_size=300, min_frequency=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trainer.train([DATA / "sample.txt"])
    # The native host loop needs no device.
    cfg = BBPETrainerConfig(vocab_size=300, min_frequency=1, use_native_loop=True)
    assert len(BBPETrainer(cfg).train([DATA / "sample.txt"]).merges) > 0


def test_input_errors_and_empty_corpus(tmp_path):
    trainer = BBPETrainer(BBPETrainerConfig(device="cpu"))
    with pytest.raises(ValueError, match="At least one file"):
        trainer.train([])
    with pytest.raises(FileNotFoundError):
        trainer.train([tmp_path / "missing.txt"])
    with pytest.raises(ValueError, match="not been trained"):
        trainer.save(tmp_path / "out")
    model = BBPETrainer(
        BBPETrainerConfig(vocab_size=300, special_tokens=SPECIALS)
    ).train([DATA / "empty.txt"])
    assert model.merges == [] and len(model.vocab) == 257
