"""The port's CUDA kernels on a card, held against their plain twins.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has neither, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every comparison is exact: all of this is integer arithmetic.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.dist import hbm_sharded
from yabpe_tpu_torch.kernels import fused_loop, hbm_loop, replay_emit
from yabpe_tpu_torch.pretok.ingest import count_pretokens
from yabpe_tpu_torch.train import fused_driver, hbm_driver

DATA = Path(__file__).resolve().parent / "data"
SPECIALS = ["<|endoftext|>"]
TENSORS = ("words", "counts", "merges", "token_bytes", "token_len", "lex_rank")


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


#: Cases of the select's states (select_state); "wide" is for the card.
SELECT_CASES = (
    "random", "ties_across_stripes", "ties_within_row", "stale_equals_winner",
    "all_stale", "empty", "min_frequency", "wide",
)


def select_state(name: str, seed: int):
    """A state for one select: (counts [V, V], row_max [V], lex_rank [V],
    next_id, min_frequency), int32 CPU tensors. Counts are random over the
    live ids [0, next_id) and row_max an upper bound on each row's max,
    stale on a third of the rows, with the case planted:

    - ties_across_stripes: six rows, spread over the stripes, share the
      top count (the greatest lex rank wins);
    - ties_within_row: one row holds the top count in five columns;
    - stale_equals_winner: a row ranked above the winner has a bound equal
      to the winner's count and a lower exact max;
    - all_stale: every live row's bound is above its exact max;
    - empty: no count at all, under stale bounds (a stop);
    - min_frequency: counts of 1 under min_frequency 2 (a stop);
    - wide: V = 13,001, so a count row is read in 16-byte loads with a
      misaligned head and several loads in flight.
    """
    rng = np.random.default_rng(seed)
    v = 13001 if name == "wide" else int(rng.integers(60, 260))
    n = int(rng.integers(v // 2, v + 1))
    nnz = 200_000 if name == "wide" else n * n // 10
    counts = np.zeros((v, v), dtype=np.int32)
    counts[rng.integers(0, n, nnz), rng.integers(0, n, nnz)] = rng.integers(1, 9, nnz)
    lex = np.full(v, -1, dtype=np.int32)
    lex[:n] = rng.permutation(n)
    rows = rng.permutation(n)
    top = int(counts.max()) + 5
    min_freq = 2
    if name == "ties_across_stripes":
        for r in rows[:6]:
            counts[r, rng.integers(0, n)] = top
    elif name in ("ties_within_row", "stale_equals_winner"):
        counts[rows[0], rng.choice(n, 5 if name == "ties_within_row" else 1, replace=False)] = top
    elif name == "empty":
        counts[:] = 0
    elif name == "min_frequency":
        counts = np.minimum(counts, 1)
    exact = counts.max(axis=1)
    row_max = exact.copy()
    stale = (rng.random(v) < (1.0 if name == "all_stale" else 0.3))
    row_max[stale] += rng.integers(1, 4, v)[stale]
    if name == "stale_equals_winner":
        win, other = rows[0], rows[1]
        if lex[other] < lex[win]:
            lex[[win, other]] = lex[[other, win]]
        row_max[other] = top
    row_max[n:] = 0
    return (torch.from_numpy(counts), torch.from_numpy(row_max.astype(np.int32)),
            torch.from_numpy(lex), n, min_freq)


def _kernel_vs_twin(table: WordTable, specials, vocab_cap, min_freq, chunk, fused=False):
    """K2 (or K1 with ``fused``) against its twin, chunk by chunk, from one
    state; returns the kernel's state."""
    base = list(Vocab.base(specials).tokens())
    num = vocab_cap - len(base)
    if fused:
        build = fused_driver.fused_state_from_numpy
        twin_fn, kern_fn = fused_loop.fused_merge_chunk_reference, fused_loop.fused_merge_chunk
    else:
        build = hbm_driver.state_from_numpy
        twin_fn, kern_fn = hbm_loop.hbm_merge_chunk_reference, hbm_loop.hbm_merge_chunk
    twin = build(table.words, table.freqs, base, vocab_cap, "cuda")
    kern = twin.clone()
    for start in range(0, num, chunk):
        kw = dict(chunk_start=start, chunk_size=chunk, num_merges=num, min_frequency=min_freq)
        twin_fn(twin, **kw)
        kern_fn(kern, **kw)
        torch.cuda.synchronize()
        for name in TENSORS:
            assert torch.equal(getattr(kern, name), getattr(twin, name)), (name, start)
        assert torch.equal(kern.scalars[:3], twin.scalars[:3]), start
        assert bool((kern.row_max >= kern.counts.amax(dim=1)).all()), start
    return kern


@pytest.mark.cuda
@pytest.mark.parametrize("vocab_cap,min_freq,chunk", [(600, 1, 32), (1000, 2, 333)])
def test_kernel_matches_twin_large_txt(vocab_cap, min_freq, chunk):
    _need_cuda()
    table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
    _kernel_vs_twin(table, SPECIALS, vocab_cap, min_freq, chunk)


def _random_table(seed: int) -> WordTable:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcab ", dtype=np.uint8)
    longest = 64 if seed == 3 else 30
    counter = Counter({b"ab" * (longest // 2): 2})
    for _ in range(int(rng.integers(5, 60))):
        n = int(rng.integers(1, longest + 1))
        word = bytes(alphabet[rng.integers(0, len(alphabet), n)].tolist())
        counter[word] += int(rng.integers(1, 6))
    return WordTable.from_counter(counter)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_kernel_matches_twin_random_tables(seed):
    """Tiny alphabets: ties, dedups, a == b runs and early stops; the last
    seed has words of the widest admitted length (64)."""
    _need_cuda()
    kern = _kernel_vs_twin(_random_table(seed), [], 330, 1 + seed % 3, 7)
    assert int(kern.scalars[hbm_loop.NUM_DONE]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("vocab_cap,min_freq,chunk", [(600, 1, 32), (1024, 2, 333)])
def test_fused_kernel_matches_twin_large_txt(vocab_cap, min_freq, chunk):
    _need_cuda()
    table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
    _kernel_vs_twin(table, SPECIALS, vocab_cap, min_freq, chunk, fused=True)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
def test_fused_kernel_matches_twin_random_tables(seed):
    _need_cuda()
    kern = _kernel_vs_twin(_random_table(seed), [], 330, 1 + seed % 3, 7, fused=True)
    assert int(kern.scalars[hbm_loop.NUM_DONE]) > 0


@pytest.mark.cuda
def test_trainer_on_cuda_matches_native_loop():
    """vocab 800 on large.txt is within the small-vocabulary admission, so
    the device route runs K1 and never K2."""
    _need_cuda()
    cfg = dict(vocab_size=800, min_frequency=2, special_tokens=SPECIALS)
    fused_before = fused_loop.LAUNCHES["fused_merge_chunk"]
    hbm_before = hbm_loop.LAUNCHES["hbm_merge_chunk"]
    device = BBPETrainer(BBPETrainerConfig(**cfg, merge_chunk_size=100)).train(
        [DATA / "large.txt"]
    )
    assert fused_loop.LAUNCHES["fused_merge_chunk"] > fused_before
    assert hbm_loop.LAUNCHES["hbm_merge_chunk"] == hbm_before
    native = BBPETrainer(BBPETrainerConfig(**cfg, use_native_loop=True)).train(
        [DATA / "large.txt"]
    )
    assert device.merges == native.merges and device.vocab == native.vocab


@pytest.mark.cuda
def test_trainer_on_cuda_without_fused_kernel_runs_k2():
    _need_cuda()
    cfg = dict(vocab_size=800, min_frequency=2, special_tokens=SPECIALS, merge_chunk_size=100)
    fused_before = fused_loop.LAUNCHES["fused_merge_chunk"]
    hbm_before = hbm_loop.LAUNCHES["hbm_merge_chunk"]
    k2 = BBPETrainer(BBPETrainerConfig(**cfg, use_fused_kernel=False)).train([DATA / "large.txt"])
    assert hbm_loop.LAUNCHES["hbm_merge_chunk"] > hbm_before
    assert fused_loop.LAUNCHES["fused_merge_chunk"] == fused_before
    k1 = BBPETrainer(BBPETrainerConfig(**cfg, use_fused_kernel=True)).train([DATA / "large.txt"])
    assert k2.merges == k1.merges and k2.vocab == k1.vocab


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,seed", [("random", s) for s in range(4)] + [(c, 0) for c in SELECT_CASES[1:]]
)
def test_kernel_select_matches_model(name, seed):
    """The step kernel's select alone (one cluster launch) against
    cluster_select_reference with the kernel's cluster size: the same
    pair, count and verify rounds, and the same tightened row_max."""
    _need_cuda()
    counts, row_max, lex, n, min_freq = select_state(name, seed)
    model_max = row_max.clone()
    dev = [t.cuda() for t in (counts, row_max, lex)]
    before = hbm_loop.LAUNCHES["hbm_select_step"]
    a, b, count, rounds, ctas = hbm_loop.hbm_select_step(
        *dev, next_id=n, min_frequency=min_freq
    )
    assert hbm_loop.LAUNCHES["hbm_select_step"] == before + 1
    assert ctas in (8, 16)
    want = hbm_loop.cluster_select_reference(
        counts, model_max, lex, next_id=n, min_frequency=min_freq, cluster=ctas
    )
    assert (a, b, count, rounds) == want
    assert torch.equal(dev[1].cpu(), model_max)


def _poison_allocator(nbytes: int = 64 << 20) -> None:
    """Leave ``nbytes`` of the caching allocator's free blocks holding ids
    >= 0 (0x01010101), so that the kernel's fresh outputs start out as
    garbage that a reader could mistake for cells."""
    torch.full((nbytes // 4,), 0x01010101, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,seed", [("random", s) for s in range(4)] + [(c, 0) for c in SELECT_CASES[1:]]
)
def test_fused_select_matches_model(name, seed):
    """K1's select alone (CTA 0 of a one-CTA cluster) against
    cluster_select_reference with the kernel's 16 stripes: the same pair,
    count and verify rounds, and the same tightened row_max."""
    _need_cuda()
    counts, row_max, lex, n, min_freq = select_state(name, seed)
    model_max = row_max.clone()
    dev = [t.cuda() for t in (counts, row_max, lex)]
    before = fused_loop.LAUNCHES["fused_select_step"]
    got = fused_loop.fused_select_step(*dev, next_id=n, min_frequency=min_freq)
    assert fused_loop.LAUNCHES["fused_select_step"] == before + 1
    want = hbm_loop.cluster_select_reference(
        counts, model_max, lex, next_id=n, min_frequency=min_freq,
        cluster=fused_loop.SELECT_STRIPES,
    )
    assert got == want
    assert torch.equal(dev[1].cpu(), model_max)


@pytest.mark.cuda
def test_fused_kernel_one_cluster_launch_per_chunk():
    """A chunk is one launch of one cluster, its size cached per shape:
    enough CTAs to give each word of large.txt a thread, at most 16."""
    _need_cuda()
    table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
    base = list(Vocab.base(SPECIALS).tokens())
    state = fused_driver.fused_state_from_numpy(table.words, table.freqs, base, 600, "cuda")
    n, v, byte_width = state.words.shape[0], 600, state.token_bytes.shape[1]
    ctas = fused_loop.cluster_ctas(n, v, byte_width)
    assert 1 <= ctas <= min(16, -(-n // 512))
    assert 8 <= fused_loop.cluster_ctas(12000, v, byte_width) <= 16
    before = fused_loop.LAUNCHES["fused_merge_chunk"]
    fused_loop.fused_merge_chunk(state, chunk_start=0, chunk_size=50, num_merges=100, min_frequency=1)
    torch.cuda.synchronize()
    assert fused_loop.LAUNCHES["fused_merge_chunk"] == before + 1
    assert int(state.scalars[hbm_loop.NUM_DONE]) == 50


def _replay_vs_twin(words, freqs, chain, cps, cps0, vocab_cap):
    """K3 and its twin on one shard, the kernel's outputs allocated over
    poisoned memory: words, ok flags, cursors and every step's net delta
    (read up to the cursor) equal, one launch and one memset for the call;
    returns the kernel's ok flags."""
    before = words.clone()
    counts = [c["replay_emit_chunk"] for c in (replay_emit.CALLS, replay_emit.LAUNCHES, replay_emit.MEMSETS)]
    _poison_allocator()
    kern = replay_emit.replay_emit_chunk(words, freqs, chain, cps=cps, cps0=cps0)
    assert [c["replay_emit_chunk"] for c in (replay_emit.CALLS, replay_emit.LAUNCHES, replay_emit.MEMSETS)] == [
        x + 1 for x in counts
    ]
    twin = replay_emit.replay_emit_chunk_reference(words, freqs, chain, cps=cps, cps0=cps0)
    torch.cuda.synchronize()
    assert torch.equal(words, before)
    assert torch.equal(kern[0], twin[0])
    assert torch.equal(kern[4], twin[4]) and torch.equal(kern[5], twin[5])
    for j, ok in enumerate(kern[4].tolist()):
        if ok:
            kw = dict(cps=cps, cps0=cps0, vocab_cap=vocab_cap)
            a = replay_emit.step_net_delta(*kern[1:4], j, cursor=kern[5], **kw)
            b = replay_emit.step_net_delta(*twin[1:4], j, cursor=twin[5], **kw)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), j
    return kern[4].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("cps,cps0", [(64, 256), (8, 8)])
def test_replay_kernel_matches_twin(cps, cps0):
    """The first 16 merges of large.txt as the chain, with an inactive row
    and a pair that no word holds, over each of 4 shards."""
    _need_cuda()
    table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
    base = Vocab.base(SPECIALS)
    merges = hbm_driver.run_hbm_merge_loop(
        table, base, vocab_cap=400, num_merges=16, min_frequency=1, device="cuda"
    )
    chain = torch.tensor(merges[:16], dtype=torch.int32, device="cuda")
    chain[5, 0] = -1
    chain[9, :2] = torch.tensor([300, 301])
    words = torch.tensor(table.words, dtype=torch.int32, device="cuda")
    freqs = torch.tensor(table.freqs, dtype=torch.int32, device="cuda")
    before = replay_emit.LAUNCHES["replay_emit_chunk"]
    flags = []
    for shard in torch.arange(words.shape[0], device="cuda").chunk(4):
        flags += _replay_vs_twin(
            words[shard].contiguous(), freqs[shard].contiguous(), chain, cps, cps0, 400
        )
    assert replay_emit.LAUNCHES["replay_emit_chunk"] == before + 4
    assert flags[5] == 1  # the inactive row


@pytest.mark.cuda
def test_replay_kernel_flags_overflow_as_the_twin_does():
    """600 words hit by step 0 at 1024 slots: ok[0] == 0 on both, the
    words applied all the same."""
    _need_cuda()
    words = torch.tensor([[1, 2, 3, -1]] * 600, dtype=torch.int32, device="cuda")
    freqs = torch.ones(600, dtype=torch.int32, device="cuda")
    chain = torch.tensor([[1, 2, 50], [50, 3, 51]], dtype=torch.int32, device="cuda")
    assert _replay_vs_twin(words, freqs, chain, 8, 8, 64) == [0, 1]


@pytest.mark.cuda
def test_replay_kernel_matches_twin_random_tables():
    """Tiny alphabets, words of the widest admitted length (64), a == b
    runs; the chain merges the pairs the twin's own steps pick."""
    _need_cuda()
    for seed in range(4):
        table = _random_table(seed)
        words = torch.tensor(table.words, dtype=torch.int32, device="cuda")
        freqs = torch.tensor(table.freqs, dtype=torch.int32, device="cuda")
        merges = hbm_driver.run_hbm_merge_loop(
            table, Vocab.base([]), vocab_cap=300, num_merges=12,
            min_frequency=1, device="cuda",
        )
        chain = torch.tensor(merges[:12], dtype=torch.int32, device="cuda")
        assert _replay_vs_twin(words, freqs, chain, 16, 32, 300) == [1] * 12


@pytest.mark.cuda
@pytest.mark.parametrize("shards,cps", [(2, 64), (4, 8)])
def test_sharded_loop_on_cuda_matches_k2(shards, cps):
    """The data-sharded loop on the card gives K2's merges; at cps 8 its
    overflow paths run too."""
    _need_cuda()
    table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
    base = Vocab.base(SPECIALS)
    want = hbm_driver.run_hbm_merge_loop(
        table, base, vocab_cap=700, num_merges=700 - len(base),
        min_frequency=1, device="cuda",
    )
    before = replay_emit.LAUNCHES["replay_emit_chunk"]
    stats: dict = {}
    got = hbm_sharded.run_hbm_sharded_merge_loop(
        table, base, vocab_cap=700, num_merges=700 - len(base),
        min_frequency=1, data_shards=shards, cps=cps, device="cuda",
        stats_out=stats,
    )
    assert np.array_equal(got, want)
    assert replay_emit.LAUNCHES["replay_emit_chunk"] >= before + shards * stats["epochs"]
    assert set(stats["phase_ms"]) == set(hbm_sharded.PHASES)


@pytest.mark.cuda
def test_sharded_epoch_never_waits_on_the_host():
    """Select, replay and validate of an epoch under the sync debug mode
    set to raise: nothing in them copies to the host."""
    _need_cuda()
    from yabpe_tpu_torch.dist.mesh import make_data_mesh
    from yabpe_tpu_torch.train.state import VocabState

    table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
    base = list(Vocab.base(SPECIALS).tokens())
    v, k = 600, 8
    mesh = make_data_mesh(2, "cuda")
    tables = hbm_sharded._Tables(
        hbm_driver.initial_corner_counts(table.words, table.freqs, len(base)), v, "cuda"
    )
    vocab = VocabState.initial(base, v, hbm_driver.byte_width(table.width, base), v - len(base), "cuda")
    words = torch.tensor(table.words, dtype=torch.int32, device="cuda")
    freqs = torch.tensor(table.freqs, dtype=torch.int32, device="cuda")
    half = words.shape[0] // 2
    shards = [(words[:half].contiguous(), freqs[:half].contiguous()),
              (words[half:].contiguous(), freqs[half:].contiguous())]
    inexact = torch.zeros((), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        A, B, C, okf = hbm_sharded._select_chain(
            tables, vocab, 0, k=k, min_frequency=1, num_merges=v - len(base), inexact=inexact,
        )
        chain = torch.stack([torch.where(okf > 0, A, -1), B, C], dim=1).contiguous()
        outs = [replay_emit.replay_emit_chunk(w, f, chain, cps=64, cps0=256) for w, f in shards]
        p, cut = hbm_sharded._validate(
            mesh, outs, A, B, okf, tables, vocab, 0, k=k, cps=64, cps0=256,
            min_frequency=1, num_merges=v - len(base),
        )
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(p) >= 1 and not bool(cut) and int(inexact) == 0


def _replay_pair(table: WordTable, vocab_cap: int, record: np.ndarray, replay_until: int):
    """A kernel state and a twin state on the card, both with the first
    ``replay_until`` rows of ``record`` preloaded as the resume driver
    preloads them."""
    base = list(Vocab.base(SPECIALS).tokens())
    twin = hbm_driver.state_from_numpy(table.words, table.freqs, base, vocab_cap, "cuda")
    twin.merges[:replay_until] = torch.as_tensor(record[:replay_until], device="cuda")
    return twin.clone(), twin


@pytest.mark.cuda
@pytest.mark.parametrize("replay_until", [45, 100])
def test_kernel_replay_matches_twin(replay_until):
    """K2's replay mode against the twin's, from one state, at replay
    points that are not chunk-aligned (chunks of 32): the state equal
    after every chunk, the merges equal to the uninterrupted run's, the
    replayed steps counted apart from the live ones."""
    _need_cuda()
    table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
    v = 600
    num = v - len(Vocab.base(SPECIALS))
    full = hbm_driver.run_hbm_merge_loop(
        table, Vocab.base(SPECIALS), vocab_cap=v, num_merges=num, min_frequency=1,
        chunk_size=32, device="cpu",
    )
    kern, twin = _replay_pair(table, v, full, replay_until)
    for start in range(0, num, 32):
        kw = dict(chunk_start=start, chunk_size=32, num_merges=num, min_frequency=1,
                  replay_until=replay_until)
        hbm_loop.hbm_merge_chunk_reference(twin, **kw)
        hbm_loop.hbm_merge_chunk(kern, **kw)
        torch.cuda.synchronize()
        for name in TENSORS:
            assert torch.equal(getattr(kern, name), getattr(twin, name)), (name, start)
        assert torch.equal(kern.scalars[:3], twin.scalars[:3]), start
        assert bool((kern.row_max >= kern.counts.amax(dim=1)).all()), start
    assert np.array_equal(kern.merges[:num].cpu().numpy(), full)
    assert int(kern.stats[hbm_loop.STAT_REPLAYED]) == replay_until
    assert int(kern.scalars[hbm_loop.DIVERGED]) == 0


@pytest.mark.cuda
def test_kernel_replay_divergence_raises():
    """A record whose merged id, or whose pair, disagrees with the vocab
    sets the divergence flag where the twin sets it, and the driver
    raises."""
    _need_cuda()
    table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
    base = Vocab.base(SPECIALS)
    v, num = 600, 600 - len(base)
    full = hbm_driver.run_hbm_merge_loop(
        table, base, vocab_cap=v, num_merges=num, min_frequency=1, chunk_size=64,
        device="cpu",
    )
    bad_id, bad_pair = full.copy(), full.copy()
    bad_id[10, 2] += 1
    bad_pair[10, 0] = v - 1
    for record in (bad_id, bad_pair):
        kern, twin = _replay_pair(table, v, record, 40)
        kw = dict(chunk_start=0, chunk_size=64, num_merges=num, min_frequency=1, replay_until=40)
        hbm_loop.hbm_merge_chunk_reference(twin, **kw)
        hbm_loop.hbm_merge_chunk(kern, **kw)
        assert torch.equal(kern.scalars[:3], twin.scalars[:3])
        assert int(kern.scalars[hbm_loop.DIVERGED]) == int(twin.scalars[hbm_loop.DIVERGED]) == 11
        for name in TENSORS:
            assert torch.equal(getattr(kern, name), getattr(twin, name)), name
        with pytest.raises(AssertionError, match="divergence at replayed step 10"):
            hbm_driver.run_hbm_merge_loop(
                table, base, vocab_cap=v, num_merges=num, min_frequency=1,
                chunk_size=64, device="cuda", resume=(record, 40),
            )


@pytest.mark.cuda
def test_engines_on_cuda_past_the_kernels(tmp_path):
    """Words past 64 symbols train on the card through the incremental and
    the bigvocab engines, with no merge kernel launched, to the native
    loop's merges."""
    _need_cuda()
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "wide_lines", Path(__file__).resolve().parent.parent / "scripts" / "wide_lines.py"
    )
    wide = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wide)
    path = tmp_path / "wide.txt"
    path.write_text((DATA / "sample.txt").read_text(encoding="utf-8") + "\n"
                    + "\n".join(wide.wide_lines(60, 1)) + "\n", encoding="utf-8")
    for vocab_size, route in ((320, "incremental"), (2300, "bigvocab")):
        kw = dict(vocab_size=vocab_size, min_frequency=1, max_workers=1, special_tokens=[])
        hbm_loop.LAUNCHES["hbm_merge_chunk"] = fused_loop.LAUNCHES["fused_merge_chunk"] = 0
        trainer = BBPETrainer(BBPETrainerConfig(**kw, device="cuda"))
        model = trainer.train([path])
        assert trainer.route == route
        assert hbm_loop.LAUNCHES["hbm_merge_chunk"] == fused_loop.LAUNCHES["fused_merge_chunk"] == 0
        native = BBPETrainer(BBPETrainerConfig(**kw, use_native_loop=True)).train([path])
        assert model.merges == native.merges and model.vocab == native.vocab


def _encode_model():
    """(vocab, merges) at vocab 600 on tests/data/large.txt, by the native
    loop, and the unique pre-tokens of that file."""
    from yabpe_tpu_torch import native

    kw = dict(vocab_size=600, min_frequency=1, max_workers=1, special_tokens=SPECIALS)
    model = BBPETrainer(BBPETrainerConfig(**kw, use_native_loop=True)).train([DATA / "large.txt"])
    counter = native.NativeCounter(tuple(SPECIALS))
    counter.add_word_ids_specials((DATA / "large.txt").read_bytes())
    words = counter.export_words()
    counter.close()
    return model.vocab, model.merges, words


@pytest.mark.cuda
def test_device_encode_scan_on_cuda_matches_cpu():
    """The merge-rank scan on the card equals the same function on the CPU,
    tile by tile, with the rows split into shards or not."""
    _need_cuda()
    from yabpe_tpu_torch.tok.device_encode import DeviceEncoder

    vocab, merges, words = _encode_model()
    words = words + [b"a" * 40, b"ab" * 50]  # a run, and a width of 128
    for shards in (None, 4):
        cuda = DeviceEncoder(vocab, merges, SPECIALS, max_rows=256, data_shards=shards, device="cuda")
        cpu = DeviceEncoder(vocab, merges, SPECIALS, max_rows=256, data_shards=shards, device="cpu")
        tiles = cuda.pack_tiles(words)
        assert len(tiles) > 1
        for _, tile, row_lens in tiles:
            got = cuda.scan_tile(torch.from_numpy(tile).cuda(), row_lens)
            want = cpu.scan_tile(torch.from_numpy(tile), row_lens)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), want)
        assert cuda.stats["iterations"] == cpu.stats["iterations"]


@pytest.mark.cuda
def test_device_encode_batch_and_file_on_cuda_match_host(tmp_path):
    _need_cuda()
    from yabpe_tpu_torch import BBPETokenizer

    vocab, merges, _ = _encode_model()
    tok = BBPETokenizer(vocab, merges, SPECIALS)
    text = (DATA / "large.txt").read_text(encoding="utf-8")
    texts = [text, "unicode 東京 🚀<|endoftext|>tail aaaa", ""]
    host = tok.encode_batch(texts)
    for shards in (None, 4):
        assert tok.encode_batch(texts, device=True, data_shards=shards) == host
    enc = tok._get_device_encoder(None)
    assert enc.stats["tiles"] > 0 and enc._sorted_keys.device.type == "cuda"
    path = tmp_path / "corpus.txt"
    path.write_text((text + "\n<|endoftext|>\n") * 20, encoding="utf-8")
    want = np.asarray(tok.encode(path.read_text(encoding="utf-8")), dtype=np.int32)
    assert np.array_equal(tok.encode_file(path, chunk_bytes=8192, device=True), want)
    assert np.array_equal(tok.encode_file(path, chunk_bytes=8192), want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [(2, 2, 0), (1, 4, 0), (4, 1, 0), (4, 1, 8), (2, 1, 16)],
                         ids=["2x2", "1x4", "4x1", "4x1_spec8", "2x1_spec16"])
def test_sharded_loop_on_cuda_matches_cpu(layout):
    """The data x vocab loop and the speculative loop (dist/sharded.py,
    dist/speculative.py) on the card: the merge record and the run's
    counters equal the same loop's on the CPU."""
    _need_cuda()
    from yabpe_tpu_torch.dist.sharded import run_sharded_merge_loop

    table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
    base = Vocab.base(SPECIALS)
    d, v, s = layout
    runs = []
    for device in ("cuda", "cpu"):
        stats: dict = {}
        merges = run_sharded_merge_loop(
            table, base, vocab_cap=700, num_merges=700 - len(base), min_frequency=1,
            data_shards=d, vocab_shards=v, spec_batch=s, chunk_size=128,
            device=device, stats_out=stats,
        )
        runs.append((merges, {k: v for k, v in stats.items() if not k.endswith("_seconds")}))
    assert np.array_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    assert (runs[0][0][:, 0] >= 0).sum() == 700 - len(base)
