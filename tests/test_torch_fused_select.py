"""The small-vocabulary kernel's lazy select and its rank search
(yabpe_tpu_torch.kernels.fused_loop, csrc/fused_loop.cu), held against the
JAX package's ``_merge_loop_kernel`` on the CPU.

The CUDA kernel selects each step's pair by verifying the rows whose
``row_max`` bound is highest (``kernels/hbm_loop.py::
cluster_select_reference`` with the kernel's 16 stripes models it), and
finds the merged bytes' duplicate and insertion rank by a binary search
over the lex ranks (``rank_search_reference``). Here the twin's exact
select is replaced by that model over bounds loosened at random, chunk by
chunk against the JAX kernel in interpret mode (as
tests/test_torch_fused_loop.py runs it), and the search is held to the
twin's walk over every live token on every step. Every comparison is
exact: all of this is integer arithmetic.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yabpe_tpu.core.vocab import Vocab as JaxVocab
from yabpe_tpu.core.wordtable import WordTable as JaxWordTable
from yabpe_tpu.kernels.fused_loop import fused_merge_chunk as jax_fused_merge_chunk
from yabpe_tpu.pretok.ingest import count_pretokens as jax_count_pretokens
from yabpe_tpu.train.incremental import init_counts as jax_init_counts
from yabpe_tpu.train.state import init_state as jax_init_state
from yabpe_tpu_torch.core import lexkey
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.kernels import fused_loop, hbm_loop
from yabpe_tpu_torch.kernels.hbm_loop import STOPPED
from yabpe_tpu_torch.train import fused_driver, hbm_driver

from .common import DATA
from .test_torch_fused_loop import _assert_same

SPECIALS = ["<|endoftext|>"]

#: large.txt as the CUDA tests run K1 on it: (vocab, min_frequency, chunk).
CASES = [(600, 1, 32), (1024, 2, 333)]


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
    counter = jax_count_pretokens([DATA / "large.txt"], SPECIALS, max_workers=1)
    return JaxWordTable.from_counter(counter)


def _states(jt, vocab_cap: int, num: int):
    """The JAX kernel's state, as its driver builds it, and the port's."""
    st = jax_init_state(jt, JaxVocab.base(SPECIALS), vocab_cap, num)
    counts = jax_init_counts(st.words, st.freqs, vocab_cap=vocab_cap)
    jax_state = [
        st.words,
        counts.reshape(vocab_cap, vocab_cap),
        st.token_bytes,
        st.token_len.reshape(1, -1),
        st.lex_rank.reshape(1, -1),
        jnp.full((max(num, 1), 4), -1, jnp.int32),
        jnp.zeros((1, 8), jnp.int32).at[0, 0].set(st.next_id),
    ]
    port = fused_driver.fused_state_from_numpy(
        jt.words, jt.freqs, list(Vocab.base(SPECIALS).tokens()), vocab_cap, "cpu",
        num_merges=num,
    )
    return jax_state, st.freqs.reshape(1, -1), port


def _loose_model_select(rng, rounds: list[int]):
    """A stand-in for ``hbm_loop.exact_select`` inside the twin's step: the
    kernel's select modelled round by round over the exact row maxima
    loosened at random (a third of the rows, by 1 to 3), as the apply's
    atomicMax leaves them stale on the card."""

    def select(counts, row_max, lex_rank):
        n = int((lex_rank >= 0).sum())
        bound = row_max.clone()
        loose = torch.from_numpy(rng.random(bound.shape[0]) < 1 / 3)
        bound[loose] += torch.from_numpy(rng.integers(1, 4, int(loose.sum())).astype(np.int32))
        a, b, count, r = hbm_loop.cluster_select_reference(
            counts, bound, lex_rank, next_id=n, min_frequency=1,
            cluster=fused_loop.SELECT_STRIPES,
        )
        rounds.append(r)
        return a, b, count

    return select


@pytest.mark.parametrize("vocab_cap,min_freq,chunk", CASES)
def test_lazy_select_twin_matches_jax_kernel(large_table, vocab_cap, min_freq, chunk, monkeypatch):
    """The twin's chunks with the select replaced by the kernel's lazy
    select over loosened bounds: the state equals the JAX kernel's
    (interpret mode) after every chunk, and row_max bounds every row."""
    num = vocab_cap - len(Vocab.base(SPECIALS))
    jax_state, jax_freqs, port = _states(large_table, vocab_cap, num)
    rounds: list[int] = []
    monkeypatch.setattr(hbm_loop, "exact_select", _loose_model_select(np.random.default_rng(vocab_cap), rounds))
    start = 0
    while start < num:
        scalars = jax_state[6].at[0, 3].set(start)
        jax_state = list(jax_fused_merge_chunk(
            *jax_state[:6], scalars, jax_freqs, vocab_cap=vocab_cap,
            num_merges=num, chunk_size=chunk, min_frequency=min_freq,
            interpret=True,
        ))
        fused_loop.fused_merge_chunk(
            port, chunk_start=start, chunk_size=chunk, num_merges=num,
            min_frequency=min_freq,
        )
        start += chunk
        _assert_same(port, jax_state, f"after the chunk ending at {start}")
        assert bool((port.row_max >= port.counts.amax(dim=1)).all()), start
        if int(port.scalars[STOPPED]):
            break
    assert int(port.scalars[hbm_loop.NUM_DONE]) > 100
    assert max(rounds) >= 2  # the loosened bounds made steps verify again


@pytest.mark.parametrize("vocab_cap,min_freq,chunk", CASES)
def test_rank_search_matches_the_walk_every_step(large_table, vocab_cap, min_freq, chunk, monkeypatch):
    """On every step of the twin's run, the binary search over rank -> id
    gives the duplicate id and the insertion rank that the twin's walk
    over every live token gives."""
    num = vocab_cap - len(Vocab.base(SPECIALS))
    _, _, port = _states(large_table, vocab_cap, num)
    exact = hbm_loop.exact_select
    seen = {"steps": 0, "dedups": 0}

    def select(counts, row_max, lex_rank):
        a, b, best = exact(counts, row_max, lex_rank)
        if best < max(min_freq, 1):
            return a, b, best
        n = int((lex_rank >= 0).sum())
        merged, _ = lexkey.concat_token_bytes(port.token_bytes, port.token_len, a, b)
        less, equal = lexkey.rows_vs_query(port.token_bytes, merged)
        live = torch.arange(lex_rank.shape[0]) < n
        walk = (int((equal & live).int().argmax()) if bool((equal & live).any()) else -1,
                int((less & live).sum()))
        assert fused_loop.rank_search_reference(port.token_bytes, lex_rank, merged, n) == walk
        seen["steps"] += 1
        seen["dedups"] += walk[0] >= 0
        return a, b, best

    monkeypatch.setattr(hbm_loop, "exact_select", select)
    hbm_driver.run_chunks(
        fused_loop.fused_merge_chunk, port, num_merges=num, min_frequency=min_freq,
        chunk_size=chunk,
    )
    assert seen["steps"] == int(port.scalars[hbm_loop.NUM_DONE]) > 100


def test_rank_search_on_a_hand_made_vocab():
    """Tokens b"a" < b"ab" < b"b" < b"ba" at ids 3, 0, 2, 1: every query's
    duplicate and insertion rank, prefixes and past-the-end included."""
    rows = [b"ab", b"ba", b"b", b"a"]
    token_bytes = torch.full((6, 4), -1, dtype=torch.int32)
    for i, t in enumerate(rows):
        token_bytes[i, : len(t)] = torch.tensor(list(t))
    lex = torch.tensor([1, 3, 2, 0, -1, -1], dtype=torch.int32)
    for query, want in ((b"a", (3, 0)), (b"aa", (-1, 1)), (b"ab", (0, 1)), (b"abc", (-1, 2)),
                        (b"b", (2, 2)), (b"bb", (-1, 4)), (b"", (-1, 0))):
        merged = torch.full((4,), -1, dtype=torch.int32)
        merged[: len(query)] = torch.tensor(list(query), dtype=torch.int32)
        assert fused_loop.rank_search_reference(token_bytes, lex, merged, 4) == want, query


def test_state_row_max_and_select_entry_on_cpu():
    """FusedState's row_max starts as K2's (the exact corner maxima), the
    twin keeps it exact, and the select entry runs the model on the CPU."""
    from collections import Counter

    from yabpe_tpu_torch.core.wordtable import WordTable

    table = WordTable.from_counter(Counter({b"abab": 3, b"abc": 2, b"bca": 4}))
    base = list(Vocab.base([]).tokens())
    port = fused_driver.fused_state_from_numpy(table.words, table.freqs, base, 270, "cpu")
    k2 = hbm_driver.state_from_numpy(table.words, table.freqs, base, 270, "cpu")
    assert torch.equal(port.row_max, k2.row_max)
    assert torch.equal(port.row_max, port.counts.amax(dim=1))
    fused_loop.fused_merge_chunk(port, chunk_start=0, chunk_size=3, num_merges=10, min_frequency=1)
    assert torch.equal(port.row_max, port.counts.amax(dim=1))
    bound = port.row_max + 2
    model_bound = bound.clone()
    n = int(port.scalars[hbm_loop.NEXT_ID])
    before = fused_loop.LAUNCHES["fused_select_step"]
    got = fused_loop.fused_select_step(port.counts, bound, port.lex_rank, next_id=n, min_frequency=1)
    want = hbm_loop.cluster_select_reference(
        port.counts, model_bound, port.lex_rank, next_id=n, min_frequency=1,
        cluster=fused_loop.SELECT_STRIPES,
    )
    assert got == want and torch.equal(bound, model_bound)
    assert got[:3] == hbm_loop.exact_select(port.counts, port.counts.amax(dim=1), port.lex_rank)
    assert fused_loop.LAUNCHES["fused_select_step"] == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_loop.fused_select_step(*(t.to("meta") for t in (port.counts, bound, port.lex_rank)),
                                     next_id=n, min_frequency=1)
