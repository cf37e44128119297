"""The replay kernel's word-major order and its unwritten log slots
(yabpe_tpu_torch.kernels.replay_emit, csrc/replay_emit.cu), held against
the JAX package on the CPU.

The CUDA kernel walks the chain word by word: a thread owns one word for
the whole chain, so each step's cells reach the log word by word, not step
by step, and the slots past a step's cursor are never written. Here the
plain twin is applied to each word alone through the whole chain, which is
that order, and the result is held against the JAX kernel in interpret
mode (as tests/test_torch_replay_emit.py runs it); then the logs are
poisoned past each step's cursor with ids >= 0, and the readers (the
per-step net delta and the data-sharded loop) must not see the poison.
Every comparison is exact: all of this is integer arithmetic.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.dist import hbm_sharded
from yabpe_tpu_torch.kernels import replay_emit
from yabpe_tpu_torch.pretok.ingest import count_pretokens

from .common import DATA
from .test_torch_replay_emit import _jax_replay, _port_inputs

SPECIALS = ["<|endoftext|>"]


def _word_major(words, freqs, chain, *, cps, cps0):
    """The twin applied to each word alone through the whole chain, its
    cells appended to each step's log in word order, as the kernel's
    threads append theirs: (words', log_l, log_r, log_w, ok, cursor)."""
    k = chain.shape[0]
    rows = replay_emit.log_rows(k, cps, cps0)
    logs = [torch.full((rows * replay_emit.LANES,), -1, dtype=torch.int32) for _ in range(2)]
    logs.append(torch.zeros(rows * replay_emit.LANES, dtype=torch.int32))
    cursor = torch.zeros(k, dtype=torch.int32)
    out = torch.empty_like(words)
    for i in range(words.shape[0]):
        one = replay_emit.replay_emit_chunk_reference(
            words[i : i + 1], freqs[i : i + 1], chain, cps=cps, cps0=cps0
        )
        out[i] = one[0][0]
        for j in range(k):
            n = int(one[5][j])
            if n == 0:
                continue
            first, cap = replay_emit.step_slots(j, cps, cps0)
            at = int(cursor[j])
            kept = max(0, min(n, cap - at))
            for log, part in zip(logs, one[1:4]):
                log[first + at : first + at + kept] = part.view(-1)[first : first + kept]
            cursor[j] += n
    caps = torch.tensor([replay_emit.step_slots(j, cps, cps0)[1] for j in range(k)])
    ok = (cursor <= caps).to(torch.int32)
    return (out, *(log.view(rows, replay_emit.LANES) for log in logs), ok, cursor)


def _net(logs, j, cursor, **kw):
    return replay_emit.step_net_delta(*logs, j, cursor=cursor, **kw)


def _random_case(seed: int):
    """The random cases of tests/test_replay_emit.py: a present pair, an
    absent pair, an inactive row, a merge of the symbol made one step
    before, and the overlapping (7, 7)."""
    rng = np.random.default_rng(seed)
    width, n = 12, 300
    words_list = [
        rng.integers(0, 40, size=rng.integers(1, width + 1)).tolist() for _ in range(n)
    ]
    freqs = rng.integers(1, 9, size=n).tolist()
    first = words_list[0]
    chain = [
        (first[0], first[1], 40) if len(first) > 1 else (0, 1, 40),
        (3, 5, 41), (99, 98, 42), (-1, -1, -1), (41, 2, 43), (7, 7, 44),
    ]
    return words_list, freqs, chain, width, dict(cps=64, cps0=128), 64, False


def _case(name: str):
    """(words_list, freqs, chain, width, cps/cps0, vocab_cap, wide)."""
    if name.startswith("random_"):
        return _random_case(int(name.removeprefix("random_")))
    if name == "overflow":  # 600 words hit by step 0 at 1024 slots
        return [[1, 2, 3]] * 600, [1] * 600, [(1, 2, 50), (50, 3, 51)], 8, dict(cps=8, cps0=8), 64, False
    base = 40000  # ids past the i16 range: the JAX kernel's wide mode
    words_list = [[base, base + 1, base + 2], [base + 1, base + 2], [base + 2, base]]
    chain = [(base, base + 1, base + 3), (base + 1, base + 2, base + 4), (base + 3, base + 2, base + 5)]
    return words_list, [3, 5, 2], chain, 6, dict(cps=64, cps0=64), base + 8, True


@pytest.mark.parametrize("name", ["random_0", "random_1", "overflow", "ids_near_40000"])
def test_word_major_twin_matches_jax_kernel(name):
    """Each word alone through the whole chain gives the JAX kernel's
    words, ok flags and per-step net deltas, and the step-major twin's
    cursors: the order of the cells changes, their multiset per step does
    not."""
    words_list, freqs, chain, width, plan, vocab_cap, wide = _case(name)
    want_words, want_logs, want_ok = _jax_replay(words_list, freqs, chain, width, wide=wide, **plan)
    words, fr, ch = _port_inputs(words_list, freqs, chain, width)
    got = _word_major(words, fr, ch, **plan)
    step_major = replay_emit.replay_emit_chunk_reference(words, fr, ch, **plan)
    assert np.array_equal(got[0].numpy(), want_words)
    assert got[4].tolist() == step_major[4].tolist()
    assert torch.equal(got[5], step_major[5])
    if name == "overflow":
        # step 1's 600 cells fit its 1024 slots; the TPU kernel spends 8 rows
        # on a window visit and overflows there too
        assert want_ok.tolist() == [0, 0] and got[4].tolist() == [0, 1]
        assert got[5].tolist() == [1800, 600]
        return
    assert got[4].tolist() == want_ok.tolist()
    kw = dict(vocab_cap=vocab_cap, **plan)
    for j, ok in enumerate(want_ok.tolist()):
        if not ok:
            continue
        mine = _net(got[1:4], j, got[5], **kw)
        jax = _net(want_logs, j, None, **kw)
        assert torch.equal(mine[0], jax[0]) and torch.equal(mine[1], jax[1]), j


def _poison(out, chain_len, rng, *, cps, cps0, vocab_cap):
    """Write random ids >= 0 and weights > 0 into every slot at or past
    each step's cursor, as a kernel that leaves them unwritten may leave
    anything there; returns how many slots were poisoned."""
    _, log_l, log_r, log_w, _, cursor = out
    poisoned = 0
    for j in range(chain_len):
        first, count = replay_emit.step_slots(j, cps, cps0)
        dead = ~replay_emit.step_live(cursor, j, cps=cps, cps0=cps0)
        n = int(dead.sum())
        for log, lo, hi in ((log_l, 0, vocab_cap), (log_r, 0, vocab_cap), (log_w, 1, 50)):
            part = log.view(-1)[first : first + count]
            part[dead] = torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32))
        poisoned += n
    return poisoned


def test_step_net_delta_ignores_slots_past_the_cursor():
    """The random case's logs, poisoned past each cursor: the net deltas
    read with the cursor are the clean logs' and the JAX kernel's; read by
    the cleared-slot mark they would not be."""
    words_list, freqs, chain, width, plan, vocab_cap, _ = _case("random_0")
    _, want_logs, _ = _jax_replay(words_list, freqs, chain, width, **plan)
    words, fr, ch = _port_inputs(words_list, freqs, chain, width)
    out = replay_emit.replay_emit_chunk_reference(words, fr, ch, **plan)
    clean = [t.clone() for t in out[1:4]]
    assert _poison(out, len(chain), np.random.default_rng(0), vocab_cap=vocab_cap, **plan) > 0
    kw = dict(vocab_cap=vocab_cap, **plan)
    fooled = False
    for j in range(len(chain)):
        got = _net(out[1:4], j, out[5], **kw)
        for want in (_net(clean, j, out[5], **kw), _net(want_logs, j, None, **kw)):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), j
        blind = _net(out[1:4], j, None, **kw)
        fooled |= not torch.equal(blind[0], got[0])
    assert fooled  # the poison lands where a reader without the cursor looks


@pytest.fixture(scope="module")
def large_table():
    return WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS)), Vocab.base(SPECIALS)


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_loop_with_poisoned_logs_matches_jax_loop(large_table, shards, monkeypatch):
    """The data-sharded loop on large.txt at vocab 300 with every replay's
    logs poisoned past each step's cursor gives the JAX loop's merges (its
    Pallas kernel in interpret mode, the same shards and chain length)."""
    from yabpe_tpu.core.vocab import Vocab as JaxVocab
    from yabpe_tpu.core.wordtable import WordTable as JaxWordTable
    from yabpe_tpu.dist.hbm_sharded import run_hbm_sharded_merge_loop as jax_loop

    table, base = large_table
    rng = np.random.default_rng(shards)
    poisoned = []
    real = replay_emit.replay_emit_chunk

    def poisoning(words, freqs, chain, *, cps, cps0):
        out = real(words, freqs, chain, cps=cps, cps0=cps0)
        poisoned.append(_poison(out, chain.shape[0], rng, cps=cps, cps0=cps0, vocab_cap=300))
        return out

    monkeypatch.setattr(hbm_sharded, "replay_emit_chunk", poisoning)
    got = hbm_sharded.run_hbm_sharded_merge_loop(
        table, base, vocab_cap=300, num_merges=300 - len(base), min_frequency=1,
        data_shards=shards, spec_batch=8, device="cpu",
    )
    jt = JaxWordTable(table.words, table.freqs, table.num_words, table.max_len)
    want = jax_loop(
        jt, JaxVocab.base(SPECIALS), vocab_cap=300, num_merges=300 - len(base),
        min_frequency=1, data_shards=shards, spec_batch=8, interpret=True,
    )
    assert np.array_equal(got, np.asarray(want))
    assert len(poisoned) >= shards and min(poisoned) > 0
