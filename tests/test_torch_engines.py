"""The port's fallback engines (yabpe_tpu_torch.kernels.{merge_apply,
pair_count,select}, train/state.py, train/incremental.py,
train/bigvocab.py) and the trainer's routing past the merge kernels'
limits, held against the JAX package's XLA code on the CPU.

Inputs come from numpy seeds or from tests/data/sample.txt with lines of
65-300-byte pre-tokens (scripts/wide_lines.py). Tolerance: exact; all of
this is integer arithmetic.
"""

from __future__ import annotations

import importlib.util
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yabpe_tpu import BBPETrainer as JaxTrainer
from yabpe_tpu import BBPETrainerConfig as JaxConfig
from yabpe_tpu.core.vocab import Vocab as JaxVocab
from yabpe_tpu.core.wordtable import WordTable as JaxWordTable
from yabpe_tpu.kernels import merge_apply as jax_apply
from yabpe_tpu.kernels import pair_count as jax_count
from yabpe_tpu.kernels import select as jax_select
from yabpe_tpu.pretok.ingest import count_pretokens as jax_count_pretokens
from yabpe_tpu.train import bigvocab as jax_big
from yabpe_tpu.train import incremental as jax_inc
from yabpe_tpu.train import state as jax_state
from yabpe_tpu.train.reference_loop import train_merges_oracle as jax_oracle
from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.kernels import merge_apply, pair_count, select
from yabpe_tpu_torch.train import bigvocab, incremental, state
from yabpe_tpu_torch.train.state import merges_to_bytes

from .common import DATA, REPO

WIDTHS = [8, 65, 300]


def _wide_lines(n: int, seed: int) -> list[str]:
    spec = importlib.util.spec_from_file_location(
        "wide_lines", REPO / "scripts" / "wide_lines.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.wide_lines(n, seed)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def wide_corpus(tmp_path_factory):
    """tests/data/sample.txt plus 30 lines of 65-300-byte pre-tokens; its
    counter and word table, counted by the JAX package."""
    path = tmp_path_factory.mktemp("engines") / "wide.txt"
    path.write_text(
        (DATA / "sample.txt").read_text(encoding="utf-8") + "\n"
        + "\n".join(_wide_lines(30, 1)) + "\n",
        encoding="utf-8",
    )
    counter = jax_count_pretokens([path], [], max_workers=1)
    table = JaxWordTable.from_counter(counter)
    assert table.max_len > 64
    return path, counter, table


def _port_table(jt) -> WordTable:
    return WordTable(jt.words, jt.freqs, jt.num_words, jt.max_len)


def _random_words(seed: int, width: int, n: int = 48, alphabet: int = 4):
    """[n, width] int32 rows of random length over a small alphabet (so
    runs of a == b occur), -1 padded; some rows empty."""
    rng = np.random.default_rng(seed)
    words = np.full((n, width), -1, dtype=np.int32)
    for i in range(n):
        length = int(rng.integers(0, width + 1))
        words[i, :length] = rng.integers(0, alphabet, size=length)
    return words


def _recount(words: np.ndarray, freqs: np.ndarray, v: int) -> np.ndarray:
    left, right = words[:, :-1], words[:, 1:]
    valid = (left >= 0) & (right >= 0)
    keys = (left.astype(np.int64) * v + right)[valid]
    wts = np.broadcast_to(freqs.astype(np.int64)[:, None], left.shape)[valid]
    return np.bincount(keys, weights=wts, minlength=v * v).astype(np.int64)


# ------------------------------------------------------------ the primitives


@pytest.mark.parametrize("width", WIDTHS)
def test_merge_apply_matches_jax(width):
    words = _random_words(width, width)
    match = np.random.default_rng(width + 1).random((48, width)) < 0.6
    got = merge_apply.leftmost_nonoverlapping(torch.from_numpy(match))
    want = jax_apply.leftmost_nonoverlapping(jnp.asarray(match))
    assert np.array_equal(got.numpy(), np.asarray(want))
    keep = words >= 1
    got = merge_apply.compact_rows(torch.from_numpy(words), torch.from_numpy(keep))
    want = jax_apply.compact_rows(jnp.asarray(words), jnp.asarray(keep))
    assert np.array_equal(got.numpy(), np.asarray(want))
    for a, b in [(0, 0), (1, 2), (3, 3), (2, 0)]:
        got = merge_apply.apply_pair_merge(torch.from_numpy(words), a, b, 9)
        want = jax_apply.apply_pair_merge(jnp.asarray(words), a, b, 9)
        assert np.array_equal(got.numpy(), np.asarray(want)), (a, b)
        t = torch.tensor
        got = merge_apply.apply_pair_merge(torch.from_numpy(words), t(a), t(b), t(9))
        assert np.array_equal(got.numpy(), np.asarray(want)), (a, b)


@pytest.mark.parametrize("width", WIDTHS)
def test_pair_counts_match_jax(width):
    v = 6
    words = _random_words(width + 7, width, alphabet=v)
    freqs = np.random.default_rng(width).integers(0, 50, size=48).astype(np.int32)
    left, right, valid = pair_count.adjacent_pairs(torch.from_numpy(words))
    jl, jr, jv = jax_count.adjacent_pairs(jnp.asarray(words))
    for got, want in ((left, jl), (right, jr), (valid, jv)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    want = np.asarray(jax_count.pair_counts_dense(jnp.asarray(words), jnp.asarray(freqs), v))
    assert np.array_equal(want, np.asarray(
        jax_count.pair_counts_matmul(jnp.asarray(words), jnp.asarray(freqs), v)
    ))
    for dtype in (torch.int32, torch.int64):
        got = pair_count.pair_counts_dense(
            torch.from_numpy(words), torch.from_numpy(freqs), v, dtype
        )
        assert got.dtype == dtype and np.array_equal(got.numpy(), want)
    for strategy in ("dense", "matmul"):
        got = state.count_pairs(torch.from_numpy(words), torch.from_numpy(freqs), v, strategy)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", WIDTHS)
def test_select_matches_jax(width):
    """Random tables with ties across and within rows, and an all-zero one."""
    rng = np.random.default_rng(width)
    v = 12
    lex = rng.permutation(v).astype(np.int32)
    lex[-2:] = -1  # inactive ids
    for counts in (
        rng.integers(0, 4, size=v * v).astype(np.int32),
        np.zeros(v * v, dtype=np.int32),
        _recount(_random_words(width, width, alphabet=v - 2), np.ones(48), v).astype(np.int32),
    ):
        got = select.select_best_pair(torch.from_numpy(counts), torch.from_numpy(lex), v)
        want = jax_select.select_best_pair(jnp.asarray(counts), jnp.asarray(lex), v)
        assert [int(x) for x in got] == [int(x) for x in want]


def _same_core(port: state.TrainState, jax) -> None:
    assert np.array_equal(port.words.numpy(), np.asarray(jax.words))
    assert np.array_equal(port.freqs.numpy(), np.asarray(jax.freqs))
    v = port.vocab
    for name in ("token_bytes", "token_len", "lex_rank", "merges"):
        assert np.array_equal(getattr(v, name).numpy(), np.asarray(getattr(jax, name))), name
    for name in ("next_id", "stopped", "num_done"):
        assert int(getattr(v, name)) == int(getattr(jax, name)), name


def test_merge_chunk_matches_jax(wide_corpus):
    """The reference-shaped step (full recount, full select) on the wide
    corpus at vocab 300, state equal after every 16-step chunk."""
    _, _, jt = wide_corpus
    v, num = 300, 44
    jbase, base = JaxVocab.base([]), Vocab.base([])
    js = jax_state.init_state(jt, jbase, v, num)
    ps = state.init_state(_port_table(jt), base, v, num, "cpu")
    _same_core(ps, js)
    for start in range(0, num, 16):
        kw = dict(vocab_cap=v, min_frequency=1, num_merges=num, chunk_size=16)
        js = jax_state.merge_chunk(js, jnp.asarray(start, jnp.int32), **kw)
        state.merge_chunk(ps, start, **kw)
        _same_core(ps, js)


# ---------------------------------------------------------------- the engines


def test_incremental_matches_jax_after_every_chunk(wide_corpus):
    """``merge_chunk_incremental`` against JAX's at vocab 320 in chunks of
    16: the state and the count table equal after every chunk, the table
    equal to a full recount; the merges equal the native loop's."""
    _, counter, jt = wide_corpus
    v = 320
    num = v - 256
    jbase, base = JaxVocab.base([]), Vocab.base([])
    core = jax_state.init_state(jt, jbase, v, num)
    js = jax_inc.IncState(core=core, counts=jax_inc.init_counts(core.words, core.freqs, vocab_cap=v))
    pcore = state.init_state(_port_table(jt), base, v, num, "cpu")
    ps = incremental.IncState(
        core=pcore, counts=incremental.init_counts(pcore.words, pcore.freqs, vocab_cap=v)
    )
    cap = jax_inc.pick_affected_cap(int(jt.words.shape[0]))
    assert cap == incremental.pick_affected_cap(int(jt.words.shape[0]))
    for start in range(0, num, 16):
        kw = dict(vocab_cap=v, min_frequency=1, num_merges=num, chunk_size=16, affected_cap=cap)
        js = jax_inc.merge_chunk_incremental(js, jnp.asarray(start, jnp.int32), **kw)
        incremental.merge_chunk_incremental(ps, start, **kw)
        _same_core(ps.core, js.core)
        assert np.array_equal(ps.counts.numpy(), np.asarray(js.counts))
        assert np.array_equal(
            ps.counts.numpy(), _recount(ps.core.words.numpy(), jt.freqs, v)
        )
    merges = merges_to_bytes(ps.core.vocab.merges.numpy(), base)[1]
    assert merges == jax_oracle(counter, [], v, 1)[1]


def test_bigvocab_matches_jax_after_every_chunk(wide_corpus):
    """``merge_chunk_big`` against JAX's at vocab 2300 in chunks of 256,
    as ``run_bigvocab_merge_loop`` drives them: the state, the merge record
    and the ``row_max`` bound equal after every chunk, and the count table
    equal to a full recount; the merges equal the native loop's. (The
    trainer test below holds the two drivers to each other.)"""
    _, counter, jt = wide_corpus
    v = 2300
    num = v - 256
    jbase, base = JaxVocab.base([]), Vocab.base([])
    core = jax_state.init_state(jt, jbase, v, num)
    counts = jax_state.count_pairs(core.words, core.freqs, v, "dense")
    js = jax_big.BigState(core=core, counts=counts, row_max=jnp.max(counts.reshape(v, v), axis=1))
    pcore = state.init_state(_port_table(jt), base, v, num, "cpu")
    pcounts = state.count_pairs(pcore.words, pcore.freqs, v, "dense")
    ps = bigvocab.BigState(core=pcore, counts=pcounts, row_max=pcounts.view(v, v).amax(dim=1))
    cap = incremental.pick_affected_cap(int(jt.words.shape[0]))
    for start in range(0, num, 256):
        kw = dict(vocab_cap=v, min_frequency=1, num_merges=num, chunk_size=256, affected_cap=cap)
        js = jax_big.merge_chunk_big(js, jnp.asarray(start, jnp.int32), **kw)
        bigvocab.merge_chunk_big(ps, start, **kw)
        _same_core(ps.core, js.core)
        assert np.array_equal(ps.row_max.numpy(), np.asarray(js.row_max))
        assert np.array_equal(
            ps.counts.numpy(), _recount(ps.core.words.numpy(), jt.freqs, v)
        )
        if bool(js.core.stopped):
            break
    merges = merges_to_bytes(ps.core.vocab.merges.numpy(), base)[1]
    assert merges == jax_oracle(counter, [], v, 1)[1]


def test_engines_take_an_int64_table_past_2_31():
    """A corpus whose pair mass reaches 2^31: the int32 table would wrap,
    so the engines count in int64, and their merges equal the oracle's."""
    counter = Counter({b"abcabc" * 12: 2**28, b"abd" * 30: 3, b"xyz": 2**27})
    table = WordTable.from_counter(counter)
    assert state.count_dtype(table) == torch.int64
    base = Vocab.base([])
    want = jax_oracle(counter, [], 280, 2)[1]
    for run in (incremental.run_incremental_merge_loop, bigvocab.run_bigvocab_merge_loop):
        ids = run(table, base, vocab_cap=280, num_merges=24, min_frequency=2, device="cpu")
        assert merges_to_bytes(ids, base)[1] == want, run.__name__


def test_lazy_select_matches_jax():
    """Stale bounds, ties across rows: the same pair, count and tightened
    bounds as JAX's ``lazy_select``."""
    rng = np.random.default_rng(3)
    v = 16
    for _ in range(8):
        counts = rng.integers(0, 5, size=(v, v)).astype(np.int32)
        lex = rng.permutation(v).astype(np.int32)
        bound = counts.max(axis=1) + rng.integers(0, 3, size=v).astype(np.int32)
        want = jax_big.lazy_select(jnp.asarray(counts.ravel()), jnp.asarray(bound), jnp.asarray(lex), v)
        rm = torch.from_numpy(bound.copy())
        got = bigvocab.lazy_select(torch.from_numpy(counts.ravel()), rm, torch.from_numpy(lex), v)
        assert [int(x) for x in got[:3]] == [int(x) for x in want[:3]]
        assert np.array_equal(rm.numpy(), np.asarray(want[3]))


def test_count_strategy_resolution_matches_jax(wide_corpus):
    _, _, jt = wide_corpus
    pt = _port_table(jt)
    for requested in ("dense", "matmul", "auto"):
        assert state.resolve_count_strategy(requested, pt, 320, "cuda") == (
            jax_state.resolve_count_strategy(requested, jt, 320, "gpu")
        )
    assert state.max_possible_pair_count(pt) == jax_state.max_possible_pair_count(jt)
    heavy = WordTable.from_counter(Counter({b"abc": 2**24}))
    with pytest.raises(ValueError, match="not exact"):
        state.resolve_count_strategy("matmul", heavy, 300, "cuda")
    with pytest.raises(ValueError, match="unknown count_strategy"):
        state.resolve_count_strategy("sparse", pt, 300, "cuda")


# ------------------------------------------------------------ the trainer


@pytest.mark.parametrize(
    "vocab_size,extra,route",
    [
        (320, {}, "K1"),
        (320, dict(use_fused_kernel=False), "incremental"),
        (2300, {}, "bigvocab"),
    ],
    ids=["320-K1", "320-incremental", "2300-bigvocab"],
)
def test_trainer_past_the_kernels_matches_jax_and_native(wide_corpus, vocab_size, extra, route):
    """Words past 64 symbols train on the device route (device="cpu") with
    no NotImplementedError: within K1's admission on K1 (as the JAX
    trainer routes them), else at vocab <= 2048 on the incremental engine
    and above it on the bigvocab engine, with the merges and vocab of the
    JAX trainer's engines and of the native loop."""
    path = wide_corpus[0]
    kw = dict(vocab_size=vocab_size, min_frequency=1, max_workers=1, special_tokens=[])
    trainer = BBPETrainer(BBPETrainerConfig(**kw, **extra, device="cpu"))
    model = trainer.train([path])
    assert trainer.route == route
    jax = JaxTrainer(JaxConfig(**kw, use_native_loop=False)).train([path])
    native = BBPETrainer(BBPETrainerConfig(**kw, use_native_loop=True)).train([path])
    assert model.merges == jax.merges == native.merges
    assert model.vocab == jax.vocab == native.vocab


def test_trainer_routes_and_forced_kernels(wide_corpus):
    """The JAX trainer's order: K1 for a small admitted problem, K2 with
    ``use_fused_kernel=False``, the engines with ``use_hbm_kernel=False``
    or past the kernels' limits; K1 takes words past 64 symbols, forced
    or not, and a forced K2 past its limits raises ValueError; the matmul
    strategy gives the same merges."""
    kw = dict(vocab_size=300, min_frequency=1, max_workers=1, special_tokens=[], device="cpu")
    narrow = DATA / "sample.txt"
    routes = {}
    for name, extra in [
        ("auto", {}), ("no_fused", dict(use_fused_kernel=False)),
        ("no_kernels", dict(use_fused_kernel=False, use_hbm_kernel=False)),
        ("matmul", dict(use_fused_kernel=False, use_hbm_kernel=False, count_strategy="matmul")),
    ]:
        trainer = BBPETrainer(BBPETrainerConfig(**kw, **extra))
        merges = trainer.train([narrow]).merges
        routes[name] = (merges, trainer.route)
    assert [r for _, r in routes.values()] == ["K1", "K2", "incremental", "incremental"]
    assert len({tuple(m) for m, _ in routes.values()}) == 1
    wide = wide_corpus[0]
    forced = BBPETrainer(BBPETrainerConfig(**kw, use_fused_kernel=True))
    forced_merges = forced.train([wide]).merges
    assert forced.route == "K1"
    engine = BBPETrainer(BBPETrainerConfig(**kw, use_fused_kernel=False))
    assert forced_merges == engine.train([wide]).merges
    assert engine.route == "incremental"
    with pytest.raises(ValueError, match="use_hbm_kernel=True"):
        BBPETrainer(BBPETrainerConfig(
            **kw, use_fused_kernel=False, use_hbm_kernel=True,
        )).train([wide])


@pytest.mark.parametrize("v", [300, 70_000])
def test_bigvocab_select_orders_lex_ranks_past_16_bits(v):
    """The bigvocab engine's (bound, lex rank) key at a vocabulary past
    65,536 ids, where the engine now takes what K2 does not: a row of count
    10 and lex rank 5 beats one of count 9 and the greatest lex rank. The
    table repeats each row's count across its columns (a strided view, so
    no [V, V] array is made)."""
    per_row = torch.zeros(v, dtype=torch.int32)
    lex = torch.arange(v, dtype=torch.int32).flip(0)  # row v - 1 has lex rank 0
    top, runner_up = v - 6, 0  # lex ranks 5 and v - 1
    per_row[top], per_row[runner_up] = 10, 9
    counts = per_row.as_strided((v, v), (1, 0))
    a, b, m, exact = bigvocab.lazy_select_2d(counts, per_row.clone(), lex)
    assert bool(exact) and (int(a), int(m)) == (top, 10)
    assert int(b) == int(lex.argmax())  # every column holds the count: the greatest lex rank
