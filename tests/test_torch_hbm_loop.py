"""The port's merge-loop kernel module (yabpe_tpu_torch.kernels.hbm_loop)
and train/hbm_driver.py, held against the JAX package.

On the CPU the wrapper runs the kernel's plain twin; the JAX side runs its
Pallas kernel in interpret mode, as tests/test_hbm_loop.py does. Every
comparison is exact: all of this is integer arithmetic. The CUDA kernel
is held against the twin on a card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import pytest
import torch

from yabpe_tpu.core import lexkey as jax_lexkey
from yabpe_tpu.core.vocab import Vocab as JaxVocab
from yabpe_tpu.core.wordtable import WordTable as JaxWordTable
from yabpe_tpu.train import hbm_driver as jax_driver
from yabpe_tpu.train.reference_loop import train_merges_oracle as jax_oracle
from yabpe_tpu_torch.core import lexkey
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.kernels import hbm_loop
from yabpe_tpu_torch.train import hbm_driver
from yabpe_tpu_torch.train.state import merges_to_bytes

from .test_torch_cuda import SELECT_CASES, select_state

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
def small_corpus(tmp_path_factory):
    """The corpus of tests/test_hbm_loop.py, counted by the JAX package."""
    from yabpe_tpu.pretok.ingest import count_pretokens

    text = (
        "the quick brown fox jumps over the lazy dog. "
        "the dog barks, the fox runs away! banana bandana anagrams "
        "low lower lowest newer newest wider widest 123 4567 \n\n"
    ) * 6 + "naïve café 東京 😀 mixed UP case WORDS"
    f = tmp_path_factory.mktemp("hbm") / "small.txt"
    f.write_text(text, encoding="utf-8")
    counter = count_pretokens([f], SPECIALS, max_workers=1)
    return counter, JaxWordTable.from_counter(counter)


def _port_table(jt) -> WordTable:
    """The port's WordTable over the same numpy arrays."""
    return WordTable(jt.words, jt.freqs, jt.num_words, jt.max_len)


def _recount(words: np.ndarray, freqs: np.ndarray, v: int) -> np.ndarray:
    left, right = words[:, :-1], words[:, 1:]
    valid = (left >= 0) & (right >= 0)
    keys = (left.astype(np.int64) * v + right)[valid]
    wts = np.broadcast_to(freqs.astype(np.int64)[:, None], left.shape)[valid]
    return np.bincount(keys, weights=wts, minlength=v * v).astype(np.int64).reshape(v, v)


def _run_port(jt, specials, vocab_size, min_freq, chunk):
    """Port merges on the CPU twin, recounting the table after each chunk."""
    base = Vocab.base(specials)
    num = vocab_size - len(base)
    chunks = []

    def on_chunk(state, steps_done):
        counts = state.counts.numpy()
        want = _recount(state.words.numpy(), state.freqs.numpy(), counts.shape[0])
        assert np.array_equal(counts, want), f"table != recount at {steps_done}"
        assert (state.row_max.numpy() >= counts.max(axis=1)).all()
        chunks.append(steps_done)

    ids = hbm_driver.run_hbm_merge_loop(
        _port_table(jt), base, vocab_cap=vocab_size, num_merges=num,
        min_frequency=min_freq, chunk_size=chunk, device="cpu",
        on_state=on_chunk,
    )
    return ids, merges_to_bytes(ids, base)[1], chunks


def test_twin_matches_jax_kernel_interpret_and_oracle(small_corpus):
    """vocab 300, min_frequency 1, chunk 16: the port's merge ids equal the
    JAX kernel's (interpret mode) and the oracle's merges; the count table
    equals a full recount after every chunk."""
    counter, jt = small_corpus
    jbase = JaxVocab.base(SPECIALS)
    num = 300 - len(jbase)
    jax_ids = jax_driver.run_hbm_merge_loop(
        jt, jbase, vocab_cap=300, num_merges=num, min_frequency=1,
        chunk_size=16, interpret=True,
    )
    ids, merges, chunks = _run_port(jt, SPECIALS, 300, 1, 16)
    assert np.array_equal(ids, np.asarray(jax_ids)[:num])
    assert merges == jax_oracle(counter, SPECIALS, 300, 1)[1]
    assert chunks == list(range(16, num, 16)) + [num]


@pytest.mark.parametrize("vocab_size,min_freq", [(280, 3), (400, 1)])
def test_twin_matches_oracle(small_corpus, vocab_size, min_freq):
    counter, jt = small_corpus
    _, merges, _ = _run_port(jt, SPECIALS, vocab_size, min_freq, 32)
    assert merges == jax_oracle(counter, SPECIALS, vocab_size, min_freq)[1]


@pytest.mark.parametrize(
    "name,counter,vocab_size,min_freq",
    [
        ("lex_tiebreak", {b"ab": 5, b"cd": 5, b"zy": 5}, 258, 1),
        ("dedup", {b"abc": 10, b"ab": 6, b"bc": 5, b"zabc": 4}, 264, 1),
        ("min_frequency_stop", {b"ab": 5, b"cd": 1, b"ef": 1}, 300, 2),
        ("a_equals_b", {b"aaaa": 7, b"aaa": 3, b"aa": 2, b"baaab": 4}, 262, 1),
        ("special_bytes", {b"<|eot|>": 50, b"hi": 3}, 262, 1),
    ],
)
def test_edge_cases_match_oracle(name, counter, vocab_size, min_freq):
    specials = ["<|eot|>"] if name == "special_bytes" else []
    jt = JaxWordTable.from_counter(Counter(counter))
    _, merges, _ = _run_port(jt, specials, vocab_size, min_freq, 3)
    assert merges == jax_oracle(Counter(counter), specials, vocab_size, min_freq)[1]
    if name == "lex_tiebreak":
        assert merges[:1] == [(b"z", b"y")]
    if name == "min_frequency_stop":
        assert merges == [(b"a", b"b")]


@pytest.mark.parametrize("seed", range(6))
def test_random_tables_match_oracle(seed):
    """Random word tables over a tiny alphabet: ties, dedups, a == b runs
    and early stops all occur."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcab ", dtype=np.uint8)
    counter = Counter()
    for _ in range(int(rng.integers(5, 40))):
        n = int(rng.integers(1, 14))
        word = bytes(alphabet[rng.integers(0, len(alphabet), n)].tolist())
        counter[word] += int(rng.integers(1, 6))
    vocab_size = 256 + int(rng.integers(5, 60))
    min_freq = int(rng.integers(1, 4))
    jt = JaxWordTable.from_counter(counter)
    _, merges, _ = _run_port(jt, [], vocab_size, min_freq, 7)
    assert merges == jax_oracle(counter, [], vocab_size, min_freq)[1]


def test_state_from_numpy_matches_jax_inputs(small_corpus):
    _, jt = small_corpus
    jbase = list(JaxVocab.base(SPECIALS).tokens())
    b0, v = len(jbase), 300
    st = hbm_driver.state_from_numpy(jt.words, jt.freqs, jbase, v, "cpu")
    corner = jax_driver.initial_corner_counts(jt, b0)
    assert np.array_equal(hbm_driver.initial_corner_counts(jt.words, jt.freqs, b0), corner)
    counts = st.counts.numpy()
    assert np.array_equal(counts[:b0, :b0], corner)
    assert not counts[b0:].any() and not counts[:, b0:].any()
    assert np.array_equal(st.row_max.numpy()[:b0], corner.max(axis=1))
    assert np.array_equal(st.words.numpy(), jt.words)
    assert np.array_equal(st.freqs.numpy(), jt.freqs)
    width = st.token_bytes.shape[1]
    tb, tl = jax_lexkey.initial_token_matrix(jbase, v, width)
    assert np.array_equal(st.token_bytes.numpy(), tb)
    assert np.array_equal(st.token_len.numpy(), tl)
    assert np.array_equal(
        st.lex_rank.numpy(), jax_lexkey.initial_lex_ranks(jbase, v)
    )
    assert st.scalars.tolist()[:3] == [b0, 0, 0]


def test_torch_lexkey_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    toks = sorted({bytes(rng.integers(97, 100, rng.integers(1, 5)).tolist()) for _ in range(40)})
    v, width = 64, 8
    tb, tl = lexkey.initial_token_matrix(toks, v, width)
    lex = lexkey.initial_lex_ranks(toks, v)
    active = np.arange(v) < len(toks)
    for left, right in [(0, 1), (3, 3), (len(toks) - 1, 2)]:
        want_m, want_len = jax_lexkey.concat_token_bytes(
            jnp.asarray(tb), jnp.asarray(tl), jnp.int32(left), jnp.int32(right)
        )
        got_m, got_len = lexkey.concat_token_bytes(
            torch.from_numpy(tb), torch.from_numpy(tl), left, right
        )
        assert np.array_equal(got_m.numpy(), np.asarray(want_m))
        assert got_len == int(want_len)
        want_less, want_eq = jax_lexkey.rows_vs_query(jnp.asarray(tb), want_m)
        got_less, got_eq = lexkey.rows_vs_query(torch.from_numpy(tb), got_m)
        assert np.array_equal(got_less.numpy(), np.asarray(want_less))
        assert np.array_equal(got_eq.numpy(), np.asarray(want_eq))
        want_r, want_ins = jax_lexkey.insert_lex_rank(
            jnp.asarray(lex), jnp.asarray(active), want_less
        )
        got_r, got_ins = lexkey.insert_lex_rank(
            torch.from_numpy(lex), torch.from_numpy(active), got_less
        )
        assert np.array_equal(got_r.numpy(), np.asarray(want_r))
        assert got_ins == int(want_ins)


def _key_of(token: bytes) -> int:
    """A token's prefix key, from its bytes: the first 7 bytes big-endian,
    9 bits each (byte + 1, 0 past the end), then 1 where it is longer."""
    key = 0
    for i in range(7):
        key = (key << 9) | (token[i] + 1 if i < len(token) else 0)
    return (key << 1) | (len(token) > 7)


def _keys_read(keys: torch.Tensor) -> list[int]:
    """int64 prefix keys read as the unsigned 64-bit keys they hold."""
    return [k % 2**64 for k in keys.tolist()]


def _random_tokens(seed: int) -> list[bytes]:
    """Distinct byte strings of 0-64 bytes over 0x00, 0x01, 0x61, 0xFE and
    0xFF, each drawn with some of its prefixes and extensions, and long
    ones that share their first 7 bytes."""
    rng = np.random.default_rng(seed)
    alphabet = [0x00, 0x01, 0x61, 0xFE, 0xFF]
    out = {b""}
    for _ in range(300):
        tok = bytes(rng.choice(alphabet, int(rng.integers(0, 65))).tolist())
        cut = int(rng.integers(0, len(tok) + 1))
        out |= {tok, tok[:cut], tok[:7], tok[:8], tok + b"\x00", tok + b"\xff"}
    return sorted(out)


@pytest.mark.parametrize("seed", range(3))
def test_prefix_keys_order_as_byte_strings(seed):
    """Where two tokens' prefix keys differ, unsigned they order as the byte
    strings do (a prefix first, 0x00 and 0xFF bytes included); equal keys
    only where the strings are equal or both are longer than 7 bytes with
    the same first 7. The helper's keys equal the keys built from bytes."""
    toks = _random_tokens(seed)
    mat, _ = lexkey.initial_token_matrix(toks, len(toks), 72)
    keys = _keys_read(lexkey.prefix_keys(torch.from_numpy(mat)))
    assert keys == [_key_of(t) for t in toks]
    rng = np.random.default_rng(seed + 10)
    pairs = [(i, i + 1) for i in range(len(toks) - 1)]
    pairs += [tuple(sorted(p)) for p in rng.integers(0, len(toks), (4000, 2)).tolist()]
    ties = 0
    for i, j in pairs:
        s, t = toks[i], toks[j]
        if keys[i] != keys[j]:
            assert (keys[i] < keys[j]) == (s < t), (s, t)
        elif s != t:
            assert len(s) > 7 and len(t) > 7 and s[:7] == t[:7], (s, t)
            ties += 1
    assert ties > 0
    assert keys == sorted(keys)  # toks are sorted
    assert _keys_read(lexkey.prefix_keys(torch.full((3, 4), -1))) == [0, 0, 0]


def test_state_from_numpy_builds_prefix_keys(small_corpus):
    """token_key holds each base token's prefix key and 0 on the free ids
    and the padding rows, to a multiple of 4 rows."""
    _, jt = small_corpus
    base = list(Vocab.base(SPECIALS).tokens())
    v = 301
    st = hbm_driver.state_from_numpy(jt.words, jt.freqs, base, v, "cpu")
    assert st.token_key.dtype == torch.int64 and tuple(st.token_key.shape) == (304,)
    assert hbm_loop.key_rows(v) == 304 and hbm_loop.key_rows(300) == 300
    assert _keys_read(st.token_key) == [_key_of(t) for t in base] + [0] * (304 - len(base))
    st.check()
    bad = st.clone()
    bad.token_key = bad.token_key.int()
    with pytest.raises(ValueError, match="token_key must be contiguous int64"):
        bad.check()


@pytest.mark.parametrize("replay_until", [0, 40])
def test_twin_keeps_prefix_keys_beside_the_bytes(small_corpus, replay_until):
    """After a twin run, live or replaying a record, token_key holds the
    key of every live token's bytes (each written when its token was), and
    the merges are the uninterrupted run's."""
    _, jt = small_corpus
    base = list(Vocab.base(SPECIALS).tokens())
    v = 400
    num = v - len(base)
    full = hbm_driver.run_hbm_merge_loop(
        _port_table(jt), Vocab.base(SPECIALS), vocab_cap=v, num_merges=num,
        min_frequency=1, chunk_size=64, device="cpu",
    )
    st = hbm_driver.state_from_numpy(jt.words, jt.freqs, base, v, "cpu")
    st.merges[:replay_until] = torch.from_numpy(full[:replay_until])
    for start in range(0, num, 50):
        hbm_loop.hbm_merge_chunk_reference(
            st, chunk_start=start, chunk_size=50, num_merges=num, min_frequency=1,
            replay_until=replay_until,
        )
    n = int(st.scalars[hbm_loop.NEXT_ID])
    assert n > 300 and np.array_equal(st.merges.numpy(), full)
    toks = [bytes(r[r >= 0].tolist()) for r in st.token_bytes[:n].numpy()]
    assert _keys_read(st.token_key[:n]) == [_key_of(t) for t in toks]
    assert not bool(st.token_key[n:].any())
    assert any(len(t) > 7 for t in toks)


def test_admission_limits():
    """The driver raises past the kernels' limits, for the reason that
    ``kernel_limits`` gives the trainer's routing."""
    base = Vocab.base([])
    wide = WordTable.from_counter(Counter({b"x" * 70: 1}))
    heavy = WordTable.from_counter(Counter({b"abc": 2**30}))
    narrow = WordTable.from_counter(Counter({b"abc": 3}))
    for table, vocab_cap, what in [
        (wide, 300, "width"), (heavy, 300, "pair mass"),
        (narrow, hbm_driver.MAX_VOCAB_CAP + 1, "vocab"),
    ]:
        assert what in hbm_driver.kernel_limits(table, vocab_cap)
        with pytest.raises(hbm_driver.HbmKernelUnsupported, match=what):
            hbm_driver.run_hbm_merge_loop(
                table, base, vocab_cap=vocab_cap, num_merges=10,
                min_frequency=1, device="cpu",
            )
    assert hbm_driver.kernel_limits(narrow, 300) is None


def test_kernel_limits_admit_a_100k_vocabulary():
    """K2 takes DeepSeek LLM's 100,001 ids at the widest word it admits, and
    still refuses a wider word and a pair mass of 2^31; the K3 route keeps
    the JAX loop's 63,488."""
    from yabpe_tpu_torch.dist import hbm_sharded

    assert hbm_driver.MAX_VOCAB_CAP == hbm_loop.MAX_VOCAB_CAP == 1 << 17
    at_width = WordTable.from_counter(Counter({b"x" * 64: 1, b"abc": 3}))
    assert at_width.width == hbm_loop.MAX_WORD_WIDTH
    assert hbm_driver.kernel_limits(at_width, 100_001) is None
    assert hbm_driver.kernel_limits(at_width, 1 << 17) is None
    past = WordTable.from_counter(Counter({b"x" * 65: 1}))
    assert "width" in hbm_driver.kernel_limits(past, 100_001)
    heavy = WordTable.from_counter(Counter({b"abc": 2**30}))  # two pairs of 2^30
    assert "pair mass" in hbm_driver.kernel_limits(heavy, 100_001)
    assert not hbm_sharded.hbm_sharded_applicable(10, 8, 63_489)
    assert hbm_sharded.hbm_sharded_applicable(10, 8, 63_488)
    with pytest.raises(hbm_sharded.HbmShardedUnsupported, match="63488"):
        hbm_sharded._admit(at_width, 100_001)


@pytest.mark.parametrize("ctas", [8, 16])
def test_row_key_model_orders_as_the_tuple_order(ctas):
    """K2's row key (csrc/select_keys.cuh's pack_row_key, modelled by
    ``_pack_key``) over 131,072 rows, counts up to 2^31 - 1 with many ties,
    ids and lex ranks on both sides of 65,535: the keys order live rows
    (distinct lex ranks, as the select's rows [0, n) always hold) exactly
    as (count, lex rank, id) does; an inactive row (rank -1) ranks below
    every live row of its count, and by id within its stripe; each key
    gives back its count, its lex rank and its row (the stripe's first row
    plus the slot). The CPU suite cannot run K2's twin past 65,535 ids (a
    [V, V] table of more than 17 GB): tests/test_torch_cuda.py runs the
    kernel there."""
    v = 1 << 17
    rng = np.random.default_rng(ctas)
    tied = np.array([0, 1, 7, 65_535, 65_536, 2**31 - 2, 2**31 - 1])
    counts = np.where(rng.random(v) < 0.5, rng.choice(tied, v), rng.integers(0, 2**31, v))
    counts, lex = counts.tolist(), rng.permutation(v).tolist()
    size = hbm_loop._stripe_rows(v, ctas)
    keys = [hbm_loop._pack_key(counts[i], lex[i], i % size) for i in range(v)]
    assert max(keys) < 2**64 and min(keys) >= 0
    by_key = sorted(range(v), key=keys.__getitem__, reverse=True)
    assert by_key == sorted(range(v), key=lambda i: (counts[i], lex[i], i), reverse=True)
    for i in (0, 65_534, 65_535, 65_536, 65_537, v - 1):
        assert hbm_loop._key_count(keys[i]) == counts[i]
        assert (keys[i] >> 15) % (1 << 18) == lex[i] + 1
        assert (i // size) * size + hbm_loop._key_slot(keys[i]) == i
    for c in (0, 65_536, 2**31 - 1):
        dead = [hbm_loop._pack_key(c, -1, slot) for slot in range(size)]
        assert dead == sorted(dead) and dead[-1] < hbm_loop._pack_key(c, 0, 0)


def test_no_hidden_cpu():
    """A CUDA request never runs on the CPU: run_hbm_merge_loop raises without a
    card, and the wrapper takes the twin for CPU tensors only."""
    table = WordTable.from_counter(Counter({b"abab": 3}))
    base = Vocab.base([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            hbm_driver.run_hbm_merge_loop(
                table, base, vocab_cap=260, num_merges=4, min_frequency=1,
                device="cuda",
            )
    cpu_state = hbm_driver.state_from_numpy(
        table.words, table.freqs, list(base.tokens()), 260, "cpu"
    )
    meta_state = hbm_loop.HbmState(
        *(torch.empty_like(t, device="meta") for t in cpu_state.tensors())
    )
    before = hbm_loop.LAUNCHES["hbm_merge_chunk"]
    with pytest.raises(ValueError, match="cuda or cpu"):
        hbm_loop.hbm_merge_chunk(
            meta_state, chunk_start=0, chunk_size=4, num_merges=4,
            min_frequency=1,
        )
    hbm_loop.hbm_merge_chunk(
        cpu_state, chunk_start=0, chunk_size=4, num_merges=4, min_frequency=1
    )
    assert hbm_loop.LAUNCHES["hbm_merge_chunk"] == before  # the twin ran
    assert cpu_state.merges.tolist()[:2] == [[97, 98, 256], [256, 256, 257]]



@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize(
    "name,seed", [("random", s) for s in range(4)] + [(c, 0) for c in SELECT_CASES[1:-1]]
)
def test_cluster_select_model_matches_exact_select(name, seed, cluster):
    """The kernel's select, modelled round by round, picks the exact
    (count, lex(a), lex(b)) max of the twin's step under stale bounds, or
    stops where the twin stops; row_max stays an upper bound and each row
    it verified is tightened to its exact max."""
    counts, row_max, lex, n, min_freq = select_state(name, seed)
    before = row_max.clone()
    a, b, count, rounds = hbm_loop.cluster_select_reference(
        counts, row_max, lex, next_id=n, min_frequency=min_freq, cluster=cluster
    )
    exact = counts.amax(dim=1)
    want = hbm_loop.exact_select(counts, exact, lex)
    if want[2] < max(min_freq, 1):
        assert (a, b, count) == (-1, -1, 0)
    else:
        assert (a, b, count) == want
    assert rounds >= 1
    assert bool((row_max >= exact).all()) and bool((row_max <= before).all())
    changed = row_max != before
    assert torch.equal(row_max[changed], exact[changed])
    if name in ("ties_across_stripes", "ties_within_row", "stale_equals_winner"):
        assert count == int(counts.max())
    if name == "stale_equals_winner":  # the stale row ranks above the winner
        assert int(lex[a]) < int(lex.max()) and bool(changed.any())


def test_cluster_select_model_through_a_run(small_corpus):
    """Step by step through the small corpus's merges to the stop, with bounds
    that are raised as the table changes and lowered only by the select's
    own tightening, as the kernel keeps them: the modelled select equals
    the twin's exact select at every step."""
    _, jt = small_corpus
    base = list(Vocab.base(SPECIALS).tokens())
    v = 420
    st = hbm_driver.state_from_numpy(jt.words, jt.freqs, base, v, "cpu")
    bound = st.counts.amax(dim=1)
    rounds = []
    for step in range(150):
        n = int(st.scalars[hbm_loop.NEXT_ID])
        a, b, count, r = hbm_loop.cluster_select_reference(
            st.counts, bound, st.lex_rank, next_id=n, min_frequency=1, cluster=8
        )
        want = hbm_loop.exact_select(st.counts, st.counts.amax(dim=1), st.lex_rank)
        rounds.append(r)
        if want[2] < 1:  # no pair left: both stop
            assert (a, b, count) == (-1, -1, 0)
            break
        assert (a, b, count) == want, step
        hbm_loop.plain_merge_steps(
            st, chunk_start=step, chunk_size=1, num_merges=v - len(base), min_frequency=1
        )
        assert st.merges[step, :2].tolist() == [a, b]
        bound = torch.maximum(bound, st.counts.amax(dim=1))
    assert max(rounds) >= 2  # stale bounds made some step verify again


def test_select_step_on_cpu_runs_the_model():
    counts, row_max, lex, n, min_freq = select_state("random", 7)
    model_max = row_max.clone()
    before = hbm_loop.LAUNCHES["hbm_select_step"]
    got = hbm_loop.hbm_select_step(counts, row_max, lex, next_id=n, min_frequency=min_freq)
    want = hbm_loop.cluster_select_reference(
        counts, model_max, lex, next_id=n, min_frequency=min_freq,
        cluster=hbm_loop.CLUSTER_CTAS,
    )
    assert got == (*want, hbm_loop.CLUSTER_CTAS)
    assert torch.equal(row_max, model_max)
    assert hbm_loop.LAUNCHES["hbm_select_step"] == before


#: Columns a block in the block-verify cases: a small row spans more blocks
#: than a row the verify reads whole (WHOLE_ROW_BLOCKS, 32 columns).
SMALL_BLOCK = 4

#: The block-verify cases (block_select_state).
BLOCK_CASES = (
    "max_in_later_block", "tie_across_blocks", "bound_equals_best_holds_tie",
    "stale_high_bounds", "ragged_last_block", "all_blocks_zero",
)


def block_select_state(name: str, seed: int = 0):
    """A select state with block bounds of SMALL_BLOCK columns: (counts,
    row_max, block_max, lex_rank, next_id), int32 CPU tensors. Counts of 1
    to 8 over the live ids [0, 90) of V = 100, so the live row ends inside
    its sixth block; bounds exact but stale on a third of the blocks (row_max
    the largest block bound of its row, as K2 keeps it), with the case
    planted in one winning row w:

    - max_in_later_block: w's top count in block 16, under a stale bound
      on block 0 that equals w's bound (pass 1 reads nothing more, pass 2
      finds the max);
    - tie_across_blocks: w's top count in blocks 11 and 15, the column of
      block 15 of the greater lex rank;
    - bound_equals_best_holds_tie: w's top count in block 0 and, at a
      column of greater lex rank, in block 12, whose bound equals the count
      while block 0's is stale above it: only a `>=` reads block 12;
    - stale_high_bounds: every live block's bound above its exact max;
    - ragged_last_block: w's top count in the last, short block [88, 90);
    - all_blocks_zero: a row ranked above w with a stale positive bound and
      no count: its blocks' bounds are all 0.
    """
    rng = np.random.default_rng(seed)
    v, n, b = 100, 90, SMALL_BLOCK
    counts = np.zeros((v, v), dtype=np.int32)
    nnz = n * n // 8
    counts[rng.integers(0, n, nnz), rng.integers(0, n, nnz)] = rng.integers(1, 9, nnz)
    lex = np.full(v, -1, dtype=np.int32)
    lex[:n] = rng.permutation(n)
    top = 20
    w = int(np.flatnonzero(lex == n - 2)[0])  # a row of high lex rank
    cols = {"max_in_later_block": [16 * b + 3], "tie_across_blocks": [11 * b + 1, 15 * b + 3],
            "bound_equals_best_holds_tie": [2, 12 * b + 1], "stale_high_bounds": [20 * b + 1],
            "ragged_last_block": [n - 1], "all_blocks_zero": [b + 1]}[name]
    if len(cols) == 2:  # the later column takes the greater lex rank
        lo, hi = sorted(cols, key=lambda c: int(lex[c]))
        if hi < lo:
            lex[[lo, hi]] = lex[[hi, lo]]
    counts[w, cols] = top
    blocks = hbm_loop.exact_block_max(torch.from_numpy(counts), b).numpy().copy()
    live = -(-n // b)
    stale = rng.random((v, live)) < (1.0 if name == "stale_high_bounds" else 0.3)
    blocks[:, :live][stale] += rng.integers(1, 4, (v, live))[stale]
    blocks[n:] = 0
    if name == "max_in_later_block":
        blocks[w, 0] = top + 2
    elif name == "bound_equals_best_holds_tie":
        blocks[w, 0], blocks[w, 12] = top + 2, top
    elif name == "all_blocks_zero":
        z = int(np.flatnonzero(lex == n - 1)[0])
        counts[z] = 0
        blocks[z] = 0
    row_max = blocks.max(axis=1)
    if name == "all_blocks_zero":
        row_max[z] = top + 5  # a stale row bound over blocks of no count
    return (torch.from_numpy(counts), torch.from_numpy(row_max.astype(np.int32)),
            torch.from_numpy(blocks), torch.from_numpy(lex), n)


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("name", BLOCK_CASES)
def test_block_verify_matches_full_row_verify(name, cluster):
    """The select with block bounds picks what the select that reads whole
    rows picks, in the same rounds, and leaves the same row_max: the blocks
    it leaves unread can hold neither the max nor a tie. Every block it
    read then holds its exact max, and every other block still bounds its
    own."""
    counts, row_max, blocks, lex, n = block_select_state(name)
    full_max, before = row_max.clone(), blocks.clone()
    tally: dict[str, int] = {}
    got = hbm_loop.cluster_select_reference(
        counts, row_max, lex, next_id=n, min_frequency=1, cluster=cluster,
        block_max=blocks, block_cols=SMALL_BLOCK, tally=tally,
    )
    want = hbm_loop.cluster_select_reference(
        counts, full_max, lex, next_id=n, min_frequency=1, cluster=cluster,
    )
    assert got == want
    assert got[:3] == hbm_loop.exact_select(counts, counts.amax(dim=1), lex)
    assert torch.equal(row_max, full_max)
    exact = hbm_loop.exact_block_max(counts, SMALL_BLOCK)
    assert bool((blocks >= exact).all()) and bool((blocks <= before).all())
    changed = blocks != before
    assert torch.equal(blocks[changed], exact[changed])
    live = -(-n // SMALL_BLOCK)
    assert 0 < tally["blocks_read"] < 16 * live  # never every block of every row
    w = got[0]
    if name == "stale_high_bounds":  # every block read was stale, so changed
        assert int(changed.sum()) == tally["blocks_read"]
    if name == "max_in_later_block":  # pass 1 read and tightened block 0
        assert int(blocks[w, 0]) == int(exact[w, 0]) < 20
    if name == "bound_equals_best_holds_tie":  # block 0 tightened to the tie
        assert int(blocks[w, 0]) == 20 and got[1] == 12 * SMALL_BLOCK + 1
        # w alone: block 0, then block 12 alone (its bound equals the count
        # found)
        assert hbm_loop._verify_blocks(
            counts[w, :n], before[w].clone(), int(before[w].max()), lex[:n].long(),
            SMALL_BLOCK,
        ) == (20, 12 * SMALL_BLOCK + 1, 2)
    if name == "tie_across_blocks":
        assert got[1] == 15 * SMALL_BLOCK + 3
    if name == "ragged_last_block":
        assert got[1] == n - 1


@pytest.mark.parametrize(
    "name,seed", [("random", s) for s in range(3)] + [(c, 0) for c in SELECT_CASES[1:-1]]
)
def test_block_select_model_on_the_select_cases(name, seed):
    """The select's cases of test_torch_cuda.py with stale block bounds of
    SMALL_BLOCK columns over them: the same pair, count, rounds and row_max
    as reading whole rows."""
    counts, row_max, lex, n, min_freq = select_state(name, seed)
    rng = np.random.default_rng(seed + 100)
    blocks = hbm_loop.exact_block_max(counts, SMALL_BLOCK)
    stale = torch.from_numpy(rng.random(tuple(blocks.shape)) < 0.3)
    noise = rng.integers(1, 4, tuple(blocks.shape)).astype(np.int32)
    blocks[stale] += torch.from_numpy(noise)[stale]
    row_max = torch.maximum(row_max, blocks.amax(dim=1))  # row_max bounds its blocks
    row_max[n:] = 0
    full_max = row_max.clone()
    got = hbm_loop.cluster_select_reference(
        counts, row_max, lex, next_id=n, min_frequency=min_freq, block_max=blocks,
        block_cols=SMALL_BLOCK,
    )
    want = hbm_loop.cluster_select_reference(
        counts, full_max, lex, next_id=n, min_frequency=min_freq
    )
    assert got == want
    assert torch.equal(row_max, full_max)
    assert bool((blocks >= hbm_loop.exact_block_max(counts, SMALL_BLOCK)).all())


def test_block_select_model_through_a_run(small_corpus):
    """Step by step through the small corpus's merges, with row and block
    bounds raised as the table changes and lowered only by the select's own
    tightening, as the kernel keeps them (blocks of 16 columns over V =
    420): the modelled select equals the twin's exact select at every step,
    and reads fewer blocks than whole rows would."""
    _, jt = small_corpus
    base = list(Vocab.base(SPECIALS).tokens())
    v, b = 420, 16
    st = hbm_driver.state_from_numpy(jt.words, jt.freqs, base, v, "cpu")
    bound = st.counts.amax(dim=1)
    blocks = hbm_loop.exact_block_max(st.counts, b)
    tally: dict[str, int] = {}
    rows = 0
    for step in range(150):
        n = int(st.scalars[hbm_loop.NEXT_ID])
        before = tally.get("blocks_read", 0)
        a, b_, count, _ = hbm_loop.cluster_select_reference(
            st.counts, bound, st.lex_rank, next_id=n, min_frequency=1, cluster=8,
            block_max=blocks, block_cols=b, tally=tally,
        )
        rows += tally["blocks_read"] > before
        want = hbm_loop.exact_select(st.counts, st.counts.amax(dim=1), st.lex_rank)
        if want[2] < 1:
            assert (a, b_, count) == (-1, -1, 0)
            break
        assert (a, b_, count) == want, step
        hbm_loop.plain_merge_steps(
            st, chunk_start=step, chunk_size=1, num_merges=v - len(base), min_frequency=1
        )
        bound = torch.maximum(bound, st.counts.amax(dim=1))
        blocks = torch.maximum(blocks, hbm_loop.exact_block_max(st.counts, b))
    assert rows > 0 and tally["blocks_read"] < 150 * 8 * -(-v // b)


def test_twin_chunk_leaves_block_bounds_exact(small_corpus):
    """A twin chunk (the wrapper on CPU tensors) recomputes block_max
    exactly, as it does row_max: at V = 2,100, three blocks a row."""
    _, jt = small_corpus
    base = list(Vocab.base(SPECIALS).tokens())
    v = 2100
    st = hbm_driver.state_from_numpy(jt.words, jt.freqs, base, v, "cpu", num_merges=30)
    assert tuple(st.block_max.shape) == (v, 3) == (v, hbm_loop.block_count(v))
    st.block_max += 7  # stale everywhere
    hbm_loop.hbm_merge_chunk(st, chunk_start=0, chunk_size=30, num_merges=30, min_frequency=1)
    assert int(st.scalars[hbm_loop.NUM_DONE]) == 30
    assert torch.equal(st.block_max, hbm_loop.exact_block_max(st.counts))
    assert torch.equal(st.row_max, st.block_max.amax(dim=1))


def test_select_step_block_bounds_default_to_exact():
    """hbm_select_step without block_max uses the exact block maxima of
    counts; given stale ones, it tightens the blocks it reads, and picks the
    same pair either way."""
    counts, row_max, lex, n, min_freq = select_state("random", 3)
    stale = hbm_loop.exact_block_max(counts) + 2
    stale[n:] = 0
    row_max = torch.maximum(row_max, stale.amax(dim=1))
    row_max[n:] = 0
    plain_max = row_max.clone()
    plain = hbm_loop.hbm_select_step(counts, plain_max, lex, next_id=n, min_frequency=min_freq)
    tally: dict[str, int] = {}
    got = hbm_loop.hbm_select_step(
        counts, row_max, lex, next_id=n, min_frequency=min_freq, block_max=stale, tally=tally
    )
    assert got == plain and torch.equal(row_max, plain_max)
    assert tally["blocks_read"] >= 1
    assert bool((stale >= hbm_loop.exact_block_max(counts)).all())
    with pytest.raises(ValueError, match="block_max must be"):
        hbm_loop.hbm_select_step(
            counts, row_max, lex, next_id=n, min_frequency=min_freq, block_max=stale[:, :0]
        )


@pytest.mark.parametrize("stale_row_bound", [False, True])
def test_block_verify_takes_two_passes_past_a_pass_of_blocks(stale_row_bound):
    """A row of 25 blocks of 8 columns whose block 0 (read first) holds
    little, under ten stale bounds above it (more than a block a warp):
    pass 1 reads only the blocks that may hold the row's bound;
    where those hold less (a stale row bound over an empty block), pass 2
    reads every block whose bound reaches the best count read. The max and
    its column are the whole row's."""
    b, n = 8, 200
    row = torch.zeros(n, dtype=torch.int32)
    row[3] = 2  # block 0
    row[20 * b + 5] = 15  # the max, in block 20
    row[9 * b + 1] = 15  # a tie in block 9, of lower lex rank
    lex = torch.arange(n, dtype=torch.int64)
    bounds = hbm_loop.exact_block_max(row[None, :], b)[0].clone()
    bounds[10:20] = 10  # stale, above block 0's max
    if stale_row_bound:
        bounds[21] = 18  # the row's bound, over a block of no count
    before = bounds.clone()
    got = hbm_loop._verify_blocks(row, bounds, int(bounds.max()), lex, b)
    # block 0; pass 1: the blocks at the row's bound (9 and 20, or 21);
    # pass 2 after the stale one: every other block whose bound reaches 2
    stale = set(range(10, 20))
    want_read = {0} | ({9, 20, 21} | stale if stale_row_bound else {9, 20})
    assert got == (15, 20 * b + 5, len(want_read))
    changed = set(torch.nonzero(bounds != before)[:, 0].tolist())
    assert changed == ({21} | stale if stale_row_bound else set())
    assert bool((bounds >= hbm_loop.exact_block_max(row[None, :], b)[0]).all())


def test_rows_of_a_batch_are_verified_whole():
    """A row of at most WHOLE_ROW_BLOCKS blocks is read whole, however
    stale its block bounds: its max, its column, every block read, and its
    bounds left as they were (they stay upper bounds)."""
    b = 4
    row = torch.tensor([0, 3, 0, 1, 9, 0, 0, 9, 2] + [1] * 23, dtype=torch.int32)
    assert -(-row.shape[0] // b) == hbm_loop.WHOLE_ROW_BLOCKS
    lex = torch.arange(row.shape[0], dtype=torch.int64).flip(0)  # column 4 ranks above 7
    bounds = torch.full((8,), 50, dtype=torch.int32)
    assert hbm_loop._verify_blocks(row, bounds, 50, lex, b) == (9, 4, 8)
    assert bool((bounds == 50).all())
    assert hbm_loop._verify_blocks(torch.zeros(30, dtype=torch.int32), bounds, 50, lex[:30], b) \
        == (0, 0, 8)
