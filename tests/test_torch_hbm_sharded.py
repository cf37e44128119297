"""The port's data-sharded merge loop (yabpe_tpu_torch.dist.hbm_sharded)
and the functions it selects and validates with, held against the JAX
package and the port's single-device route.

Inputs are made from seeds with numpy and go through both packages. On the
CPU the replay kernel's wrapper runs its plain twin; the JAX loop runs its
Pallas kernel in interpret mode (4 virtual devices, as tests/conftest.py
sets up). Every comparison is exact: the state is integers, and the
follow-up estimate's float32 arithmetic is compared bit for bit through
the integer view it produces.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.dist import hbm_sharded
from yabpe_tpu_torch.dist.hbm_sharded import (
    HbmShardedUnsupported,
    run_hbm_sharded_merge_loop,
)
from yabpe_tpu_torch.dist.mesh import make_data_mesh
from yabpe_tpu_torch.dist.speculative import estimate_followup_2d
from yabpe_tpu_torch.kernels import replay_emit
from yabpe_tpu_torch.pretok.ingest import count_pretokens, count_pretokens_raw
from yabpe_tpu_torch.train.bigvocab import lazy_select_2d
from yabpe_tpu_torch.train.hbm_driver import run_hbm_merge_loop
from yabpe_tpu_torch.train.state import VocabState, merges_to_bytes, vocab_update

from .common import DATA

SPECIALS = ["<|endoftext|>"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and these tensors are small."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def large_table():
    return WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS)), Vocab.base(SPECIALS)


def _single(table, base, cap, min_frequency=1):
    """The port's single-device route (K2's twin) on the CPU."""
    return run_hbm_merge_loop(
        table, base, vocab_cap=cap, num_merges=cap - len(base),
        min_frequency=min_frequency, device="cpu",
    )


def _sharded(table, base, cap, shards, min_frequency=1, **kw):
    stats: dict = {}
    got = run_hbm_sharded_merge_loop(
        table, base, vocab_cap=cap, num_merges=cap - len(base),
        min_frequency=min_frequency, data_shards=shards, device="cpu",
        stats_out=stats, **kw,
    )
    return got, stats


# ---- the selection and validation functions against the JAX package


def _random_table(rng, v):
    counts = rng.integers(0, 6, size=(v, v)).astype(np.int32)
    counts[rng.random((v, v)) < 0.6] = 0
    lex = np.full(v, -1, np.int32)
    live = v - 5
    lex[:live] = rng.permutation(live).astype(np.int32)
    counts[live:] = 0
    counts[:, live:] = 0
    stale = counts.max(axis=1) + rng.integers(0, 3, size=v) * (rng.random(v) < 0.5)
    return counts, stale.astype(np.int32), lex


@pytest.mark.parametrize("seed", range(4))
def test_lazy_select_2d_matches_jax(seed):
    """Random tables with many tied counts and stale bounds: the same
    (left, right, count) as the JAX while_loop, with the default rounds
    and with one row re-scanned per round over enough rounds."""
    import jax.numpy as jnp

    from yabpe_tpu.train.bigvocab import lazy_select_2d as jax_select

    rng = np.random.default_rng(seed)
    v = 48
    counts, stale, lex = _random_table(rng, v)
    want_a, want_b, want_m, _ = jax_select(
        jnp.asarray(counts), jnp.asarray(stale), jnp.asarray(lex), v
    )
    for kw in ({}, dict(rounds=v, width=1)):
        rm = torch.from_numpy(stale.copy())
        a, b, m, exact = lazy_select_2d(
            torch.from_numpy(counts), rm, torch.from_numpy(lex), **kw
        )
        assert bool(exact)
        assert (int(a), int(b), int(m)) == (int(want_a), int(want_b), int(want_m))
        assert (rm.numpy() >= counts.max(axis=1)).all()
        assert (rm.numpy() <= stale).all()


def test_lazy_select_2d_reports_a_select_that_is_not_exact():
    """Bounds stale on more rows than one round re-scans: the flag is
    false, and the count returned still bounds the true max from above."""
    v = 16
    counts = np.zeros((v, v), np.int32)
    counts[0, 1] = 3
    stale = np.full(v, 9, np.int32)
    lex = np.arange(v, dtype=np.int32)
    rm = torch.from_numpy(stale.copy())
    _, _, m, exact = lazy_select_2d(torch.from_numpy(counts), rm, torch.from_numpy(lex), rounds=1, width=4)
    assert not bool(exact) and int(m) >= 3
    a, b, m, exact = lazy_select_2d(torch.from_numpy(counts), rm, torch.from_numpy(lex), rounds=4, width=4)
    assert bool(exact) and (int(a), int(b), int(m)) == (0, 1, 3)


@pytest.mark.parametrize(
    "left,right,new_sym,do",
    [(3, 7, 40, True), (5, 5, 41, True), (2, 9, 12, True), (4, 6, 42, False)],
    ids=["a_b", "a_equals_b", "dedup_id", "skipped"],
)
def test_estimate_followup_2d_matches_jax_bit_for_bit(left, right, new_sym, do):
    import jax.numpy as jnp

    from yabpe_tpu.dist.speculative import estimate_followup_2d as jax_estimate

    rng = np.random.default_rng(left * 100 + right)
    v = 48
    gview = rng.integers(0, 1000, size=(v, v)).astype(np.int32)
    gview[rng.random((v, v)) < 0.3] = 0
    rmv = gview.max(axis=1).astype(np.int32)
    cnt = int(gview[left, right])
    want_g, want_rm = jax_estimate(
        jnp.asarray(gview), jnp.asarray(rmv), jnp.int32(left), jnp.int32(right),
        jnp.int32(cnt), jnp.int32(new_sym), jnp.bool_(do), v,
    )
    g = torch.from_numpy(gview.copy())
    rm = torch.from_numpy(rmv.copy())
    scalars = [torch.tensor(x, dtype=torch.int32) for x in (left, right, cnt, new_sym)]
    cells, deltas = estimate_followup_2d(g, rm, *scalars, torch.tensor(do))
    assert np.array_equal(g.numpy(), np.asarray(want_g))
    assert np.array_equal(rm.numpy(), np.asarray(want_rm))
    assert do == bool((g.numpy() != gview).any())
    g.view(-1).index_add_(0, cells, -deltas)  # the chain's undo
    assert np.array_equal(g.numpy(), gview)


def test_vocab_update_matches_jax():
    """A sequence of steps with a dedup, a chained symbol and a skipped
    step (do = False): every field equal after every step."""
    import jax.numpy as jnp

    from yabpe_tpu.core.vocab import Vocab as JaxVocab
    from yabpe_tpu.core.wordtable import WordTable as JaxWordTable
    from yabpe_tpu.train.state import init_state
    from yabpe_tpu.train.state import vocab_update as jax_vocab_update

    counter = Counter({b"abc": 5, b"ab": 3, b"bca": 2})
    v, m = 270, 8
    js = init_state(JaxWordTable.from_counter(counter), JaxVocab.base([]), v, m)
    base = list(Vocab.base([]).tokens())
    ps = VocabState.initial(base, v, js.token_bytes.shape[1], m, "cpu")
    a, b, c = ord("a"), ord("b"), ord("c")
    steps = [(a, b, True), (256, c, True), (b, c, True), (a, 258, True), (c, a, False), (a, b, True)]
    for i, (left, right, do) in enumerate(steps):
        stop = jnp.bool_(i == len(steps) - 1)
        js, want_sym = jax_vocab_update(
            js, jnp.int32(left), jnp.int32(right), jnp.bool_(do), stop, jnp.int32(i), v
        )
        got_sym = vocab_update(
            ps, torch.tensor(left), torch.tensor(right), torch.tensor(do),
            torch.tensor(i == len(steps) - 1), i,
        )
        assert int(got_sym) == int(want_sym), i
        for name in ("token_bytes", "token_len", "lex_rank", "merges", "next_id", "num_done", "stopped"):
            assert np.array_equal(getattr(ps, name).numpy(), np.asarray(getattr(js, name))), (name, i)
    # a + bc and (a, b) again dedup to 257 and 256; the skipped step wrote
    # nothing
    assert ps.merges[3].tolist() == [a, 258, 257] and ps.merges[5].tolist() == [a, b, 256]
    assert ps.merges[4].tolist() == [-1, -1, -1] and int(ps.next_id) == 256 + 3


def test_plan_and_admission_match_jax():
    from yabpe_tpu.dist import hbm_sharded as jax_sharded

    for n, w, v, s, p in [(1024, 16, 400, 4, 1), (388096, 16, 32000, 4, 1), (100, 64, 63488, 2, 1),
                          (100, 80, 300, 2, 1), (100, 16, 70000, 2, 1), (100, 16, 300, 2, 4)]:
        assert hbm_sharded.hbm_sharded_applicable(n, w, v, s, p) == jax_sharded.hbm_sharded_applicable(n, w, v, s, p)
    # cps0 as the JAX loop plans it: 2 log rows per 128 words of a shard
    assert hbm_sharded.log_plan(388096, 16, 4, 16, 64)[1] == 1520
    assert hbm_sharded.log_plan(1024, 16, 4, 8, 64)[1] == 256
    with pytest.raises(NotImplementedError, match="item 6"):
        make_data_mesh(4, "cpu", processes=2)


# ---- the loop


@pytest.mark.parametrize("shards", [2, 4])
def test_loop_matches_single_device_and_native(large_table, shards):
    from yabpe_tpu_torch import native

    table, base = large_table
    got, stats = _sharded(table, base, 500, shards, spec_batch=8)
    want = _single(table, base, 500)
    assert np.array_equal(got, want)
    assert stats["merges_done"] == 500 - len(base)
    assert stats["epochs"] < stats["merges_done"]  # speculation commits > 1 per epoch
    assert stats["fallbacks"] == 0 and stats["select_cuts"] == 0
    blob, lens, counts = count_pretokens_raw([DATA / "large.txt"], SPECIALS)
    assert merges_to_bytes(got, base)[1] == native.train_host_raw(blob, lens, counts, 500 - len(base), 1)


def test_loop_matches_jax_loop_epoch_for_epoch(large_table):
    """Shards 4, k 8, vocab 300: the same merges and the same number of
    epochs as the JAX loop with its Pallas kernel in interpret mode."""
    from yabpe_tpu.core.vocab import Vocab as JaxVocab
    from yabpe_tpu.core.wordtable import WordTable as JaxWordTable
    from yabpe_tpu.dist.hbm_sharded import run_hbm_sharded_merge_loop as jax_loop

    table, base = large_table
    jt = JaxWordTable(table.words, table.freqs, table.num_words, table.max_len)
    jstats: dict = {}
    want = jax_loop(
        jt, JaxVocab.base(SPECIALS), vocab_cap=300, num_merges=300 - len(base),
        min_frequency=1, data_shards=4, spec_batch=8, interpret=True,
        stats_out=jstats,
    )
    got, stats = _sharded(table, base, 300, 4, spec_batch=8)
    assert np.array_equal(got, np.asarray(want))
    assert stats["epochs"] == jstats["epochs"] and stats["fallbacks"] == jstats["fallbacks"] == 0


def test_overflow_fallback():
    """Most words hold the first merge's pair, so at cps 8 step 0 of the
    first epoch passes its log (2 slots per word of a shard): the epoch
    falls back to that merge alone at a larger log, and the merges stay
    the single-device loop's."""
    rng = np.random.default_rng(11)
    letters = np.frombuffer(b"cdefghij", dtype=np.uint8)
    counter = Counter()
    while len(counter) < 3000:
        tail = bytes(letters[rng.integers(0, len(letters), int(rng.integers(1, 6)))].tolist())
        counter[b"ab" + tail] += int(rng.integers(1, 4))
    table, base = WordTable.from_counter(counter), Vocab.base([])
    got, stats = _sharded(table, base, 300, 2, spec_batch=8, cps=8)
    assert stats["fallbacks"] > 0
    assert np.array_equal(got, _single(table, base, 300))


def test_min_frequency_stop_leaves_the_tail_unwritten(large_table):
    table, base = large_table
    got, _ = _sharded(table, base, 2000, 4, min_frequency=20, spec_batch=8)
    want = _single(table, base, 2000, min_frequency=20)
    assert np.array_equal(got, want)
    assert (got[-1] == -1).all() and (got[:, 0] >= 0).sum() > 50


def test_resume_from_a_truncated_record(large_table):
    table, base = large_table
    full, _ = _sharded(table, base, 400, 4, spec_batch=8)
    truncated = np.full_like(full, -1)
    truncated[:30] = full[:30]
    saved = []
    resumed, stats = _sharded(
        table, base, 400, 4, spec_batch=8, resume=(truncated, 30),
        on_chunk=lambda merges, steps: saved.append(steps),
    )
    assert np.array_equal(resumed, full)
    assert saved and saved[-1] == 400 - len(base) and min(saved) > 30


def test_rejects_oversize_vocab(large_table):
    table, base = large_table
    with pytest.raises(HbmShardedUnsupported, match="vocab_cap"):
        run_hbm_sharded_merge_loop(
            table, base, vocab_cap=70000, num_merges=100, min_frequency=1,
            data_shards=2, device="cpu",
        )


def test_loop_launches_no_kernel_on_cpu(large_table):
    table, base = large_table
    before = replay_emit.LAUNCHES["replay_emit_chunk"]
    _sharded(table, base, 280, 2)
    assert replay_emit.LAUNCHES["replay_emit_chunk"] == before


# ---- the trainer's route


def test_trainer_route_matches_single_device():
    kw = dict(vocab_size=420, min_frequency=2, special_tokens=SPECIALS, device="cpu", max_workers=1)
    single = BBPETrainer(BBPETrainerConfig(**kw)).train([DATA / "large.txt"])
    trainer = BBPETrainer(BBPETrainerConfig(**kw, data_shards=4, use_hbm_kernel=True, spec_merges_per_round=8))
    sharded = trainer.train([DATA / "large.txt"])
    assert sharded.merges == single.merges and sharded.vocab == single.vocab
    assert trainer.loop_stats["merges_done"] == len(single.merges)


def test_trainer_route_raises_where_not_ported():
    with pytest.raises(NotImplementedError, match="item 6"):
        BBPETrainer(BBPETrainerConfig(vocab_size=300, device="cpu", data_shards=2)).train([DATA / "sample.txt"])
    with pytest.raises(NotImplementedError, match="item 6"):
        BBPETrainer(BBPETrainerConfig(
            vocab_size=300, device="cpu", data_shards=2, use_hbm_kernel=True, vocab_shards=2,
        )).train([DATA / "sample.txt"])
    with pytest.raises(ValueError, match="sharded-HBM loop's limits"):
        BBPETrainer(BBPETrainerConfig(
            vocab_size=64000, device="cpu", data_shards=2, use_hbm_kernel=True,
            max_pair_table_bytes=1 << 40,
        )).train([DATA / "sample.txt"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            BBPETrainer(BBPETrainerConfig(vocab_size=300, data_shards=2, use_hbm_kernel=True)).train(
                [DATA / "sample.txt"]
            )
