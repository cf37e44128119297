"""The port on a card: its CUDA kernels held against their plain twins,
and the flows that reach the card (training, checkpoint resume, the
sharded loops, two processes over gloo, the CLI, encoding and the bench
harness) held against the native loop, the golden ids or one process.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor the JAX package, so it also runs on a machine
that has neither, without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every comparison is exact: all of this is integer arithmetic.
"""

from __future__ import annotations

import json
import pickle
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
FIXTURES = Path(__file__).resolve().parent / "fixtures_gpt2"
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"
PERFBENCH = Path(__file__).resolve().parent.parent / "perfbench"
SPECIALS = ["<|endoftext|>"]
TENSORS = ("words", "counts", "merges", "token_bytes", "token_len", "lex_rank")
K2_TENSORS = TENSORS + ("token_key",)


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _load_by_path(name: str, path: Path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


def _kernel_vs_twin(table: WordTable, specials, vocab_cap, min_freq, chunk, fused=False,
                    layout=None, stage_keys=True):
    """K2 (or K1 with ``fused``, its token bytes in ``layout``) against its
    twin, chunk by chunk, from one state; returns the kernel's state. K2
    with ``stage_keys=False`` reads its prefix keys from device memory."""
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
        kern_fn(kern, **kw, **(dict(_layout=layout) if fused else dict(_stage_keys=stage_keys)))
        torch.cuda.synchronize()
        for name in TENSORS if fused else K2_TENSORS:
            assert torch.equal(getattr(kern, name), getattr(twin, name)), (name, start)
        assert torch.equal(kern.scalars[:3], twin.scalars[:3]), start
        assert bool((kern.row_max >= kern.counts.amax(dim=1)).all()), start
        if not fused:
            assert bool((kern.block_max >= hbm_loop.exact_block_max(kern.counts)).all()), start
    return kern


@pytest.mark.cuda
@pytest.mark.parametrize("vocab_cap,min_freq,chunk", [(600, 1, 32), (1000, 2, 333)])
def test_kernel_matches_twin_large_txt(vocab_cap, min_freq, chunk):
    _need_cuda()
    table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
    _kernel_vs_twin(table, SPECIALS, vocab_cap, min_freq, chunk)


@pytest.mark.cuda
def test_kernel_matches_twin_across_column_blocks():
    """K2 against its twin at V = 12,000 (twelve column blocks a row) over
    the realistic 5 MB corpus, whose 11,743 merges fill every block, so the
    last ~3,800 steps verify rows past WHOLE_ROW_BLOCKS through their block
    bounds: the state equal after every chunk and block_max a bound on
    every block; the verifies read fewer blocks than whole rows would."""
    _need_cuda()
    corpus = FIXTURES / "bench_5M_realistic.txt"
    table = WordTable.from_counter(count_pretokens([corpus], SPECIALS))
    kern = _kernel_vs_twin(table, SPECIALS, 12_000, 1, 1024)
    steps = int(kern.scalars[hbm_loop.NUM_DONE])
    assert steps == 12_000 - 257
    rows, blocks = (int(kern.stats[i]) for i in (hbm_loop.STAT_VERIFIED, hbm_loop.STAT_BLOCKS_READ))
    assert rows <= blocks < 12 * rows


@pytest.mark.cuda
def test_kernel_matches_twin_at_a_100k_wide_vocab():
    """K2 against its twin at V = 100,001 (rows of 98 blocks, each row
    misaligned to 16 bytes) over large.txt's few words, its 447 merges:
    the kernel runs first, chunk by chunk, with block_max a bound on every
    block; then the twin from the same start (the two 40 GB tables do not
    fit on the card together) must give the same words, vocab, record and
    counts after every chunk."""
    _need_cuda()
    table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
    base = list(Vocab.base(SPECIALS).tokens())
    v, chunk = 100_001, 128
    num = 447
    small = ("words", "merges", "token_bytes", "token_len", "lex_rank", "token_key")

    def snapshot(state):
        n = int(state.scalars[hbm_loop.NEXT_ID])
        live = state.counts[:n, :n].cpu()
        assert int(state.counts[n:].amax()) == int(state.counts[:n, n:].amax()) == 0
        return {**{k: getattr(state, k).cpu() for k in small},
                "live": live, "scalars": state.scalars[:3].cpu()}

    kern = hbm_driver.state_from_numpy(table.words, table.freqs, base, v, "cuda", num_merges=num)
    assert tuple(kern.block_max.shape) == (v, 98)
    want = []
    for start in range(0, num, chunk):
        hbm_loop.hbm_merge_chunk(kern, chunk_start=start, chunk_size=chunk, num_merges=num,
                                 min_frequency=1)
        torch.cuda.synchronize()
        assert bool((kern.row_max >= kern.counts.amax(dim=1)).all()), start
        assert bool((kern.block_max >= hbm_loop.exact_block_max(kern.counts)).all()), start
        want.append(snapshot(kern))
    assert int(kern.scalars[hbm_loop.NUM_DONE]) == num
    del kern
    torch.cuda.empty_cache()
    twin = hbm_driver.state_from_numpy(table.words, table.freqs, base, v, "cuda", num_merges=num)
    for i, start in enumerate(range(0, num, chunk)):
        hbm_loop.hbm_merge_chunk_reference(twin, chunk_start=start, chunk_size=chunk,
                                           num_merges=num, min_frequency=1)
        got = snapshot(twin)
        for name, t in want[i].items():
            assert torch.equal(got[name], t), (name, start)
    del twin
    torch.cuda.empty_cache()


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


def _wide_file(tmp_path: Path, lines: int, seed: int) -> Path:
    """tests/data/large.txt plus ``lines`` lines of 65-300-byte pre-tokens
    (scripts/wide_lines.py)."""
    wide = _load_by_path("wide_lines", SCRIPTS / "wide_lines.py")
    path = tmp_path / "wide.txt"
    path.write_text((DATA / "large.txt").read_text(encoding="utf-8") + "\n"
                    + "\n".join(wide.wide_lines(lines, seed)) + "\n", encoding="utf-8")
    return path


@pytest.mark.cuda
@pytest.mark.parametrize(
    "vocab_cap,layout,auto_layout",
    [(320, None, "shared"), (320, "global", "shared"), (1024, None, "global")],
)
def test_fused_kernel_matches_twin_wide_words(tmp_path, vocab_cap, layout, auto_layout):
    """Words past 64 symbols (width 304) through K1's in-place apply, in
    both token-byte layouts: at vocab 320 the u16 bytes fit the first
    CTA's shared memory and the global layout is forced; at 1024 they do
    not fit, and the kernel picks the global one."""
    _need_cuda()
    table = WordTable.from_counter(count_pretokens([_wide_file(tmp_path, 200, 2)], SPECIALS))
    assert table.words.shape[1] == 304
    byte_width = hbm_driver.byte_width(table.width, list(Vocab.base(SPECIALS).tokens()))
    assert fused_loop.token_layout(vocab_cap, byte_width) == auto_layout
    before = table.words.copy()
    kern = _kernel_vs_twin(table, SPECIALS, vocab_cap, 1, 50, fused=True, layout=layout)
    long_rows = (before >= 0).sum(axis=1) > 64
    assert (kern.words.cpu().numpy()[long_rows] != before[long_rows]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_fused_kernel_matches_twin_random_wide_tables(seed):
    """Tiny alphabets in words of 65-300 symbols: long a == b runs, ties,
    dedups, in both token-byte layouts."""
    _need_cuda()
    rng = np.random.default_rng(100 + seed)
    alphabet = np.frombuffer(b"aab b", dtype=np.uint8)
    counter = Counter({b"a" * 299: 3})
    for _ in range(int(rng.integers(5, 40))):
        n = int(rng.integers(65, 301))
        counter[bytes(alphabet[rng.integers(0, len(alphabet), n)].tolist())] += int(rng.integers(1, 6))
    table = WordTable.from_counter(counter)
    for layout in fused_loop.TOKEN_LAYOUTS:
        kern = _kernel_vs_twin(table, [], 330, 1 + seed % 2, 7, fused=True, layout=layout)
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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,seed", [("wide", s) for s in range(3)] + [(c, 1) for c in SELECT_CASES[:-1]]
)
def test_kernel_select_with_stale_block_bounds_matches_model(name, seed):
    """The step kernel's select under stale block bounds (a third of the
    blocks above their exact max, row_max at least its largest block bound)
    against cluster_select_reference with the same bounds: the same pair,
    count and rounds, the same tightened row_max and block_max, and the same
    number of blocks read. "wide" rows span 13 blocks."""
    _need_cuda()
    counts, row_max, lex, n, min_freq = select_state(name, seed)
    rng = np.random.default_rng(seed + 200)
    blocks = hbm_loop.exact_block_max(counts)
    stale = torch.from_numpy(rng.random(tuple(blocks.shape)) < 0.3)
    noise = rng.integers(1, 4, tuple(blocks.shape)).astype(np.int32)
    blocks[stale] += torch.from_numpy(noise)[stale]
    blocks[n:] = 0
    row_max = torch.maximum(row_max, blocks.amax(dim=1))
    model_max, model_blocks = row_max.clone(), blocks.clone()
    dev = [t.cuda() for t in (counts, row_max, lex, blocks)]
    tally: dict[str, int] = {}
    a, b, count, rounds, ctas = hbm_loop.hbm_select_step(
        *dev[:3], next_id=n, min_frequency=min_freq, block_max=dev[3], tally=tally
    )
    model_tally: dict[str, int] = {}
    want = hbm_loop.cluster_select_reference(
        counts, model_max, lex, next_id=n, min_frequency=min_freq, cluster=ctas,
        block_max=model_blocks, tally=model_tally,
    )
    assert (a, b, count, rounds) == want
    assert torch.equal(dev[1].cpu(), model_max)
    assert torch.equal(dev[3].cpu(), model_blocks)
    assert tally.get("blocks_read", 0) == model_tally.get("blocks_read", 0)
    assert bool((model_blocks >= hbm_loop.exact_block_max(counts)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["high_ids", "ties_across_stripes", "stale"])
def test_kernel_select_past_16_bit_ids(case):
    """K2's select at V = 70,000 (a 19.6 GB table, built on the card)
    against cluster_select_reference on the same card tensors, with the
    winning row, its column and their lex ranks past 65,535: the same pair,
    count and verify rounds, the same tightened row_max, and the exact
    select's pair.

    - high_ids: the top count in one row past 65,535, in three columns on
      both sides of it (the greatest lex rank, past 65,535, wins);
    - ties_across_stripes: the top count in ten rows over every stripe,
      on both sides of 65,535;
    - stale: rows past 65,535 ranked above the winner hold stale bounds
      above the top count, so the select verifies and tightens them."""
    _need_cuda()
    rng = np.random.default_rng(["high_ids", "ties_across_stripes", "stale"].index(case))
    v, n, nnz = 70_000, 69_990, 400_000
    counts = torch.zeros((v, v), dtype=torch.int32, device="cuda")
    cells = rng.integers(0, n, (2, nnz))
    counts[torch.from_numpy(cells[0]).cuda(), torch.from_numpy(cells[1]).cuda()] = (
        torch.from_numpy(rng.integers(1, 9, nnz).astype(np.int32)).cuda())
    lex = np.full(v, -1, dtype=np.int32)
    lex[:n] = rng.permutation(n)
    top = 20
    high = rng.choice(np.arange(65_536, n), 8, replace=False)
    win = int(high[0])
    if case == "high_ids":
        cols = [100, 65_400, 69_000]
        for r, rank in zip([win, *cols], [n - 1, n - 4, n - 3, n - 2]):
            j = int(np.flatnonzero(lex == rank)[0])  # a swap keeps a permutation
            lex[[r, j]] = lex[[j, r]]
        counts[win, cols] = top
    elif case == "ties_across_stripes":
        for r in list(high[:4]) + list(rng.choice(65_536, 6, replace=False)):
            counts[int(r), int(rng.integers(0, n))] = top
    else:
        counts[win, int(rng.integers(0, n))] = top
    exact = counts.amax(dim=1)
    row_max = exact.clone()
    stale = torch.from_numpy(rng.random(v) < 0.3).cuda()
    row_max[stale] += torch.from_numpy(rng.integers(1, 4, v).astype(np.int32)).cuda()[stale]
    if case == "stale":
        above = [int(r) for r in high[1:] if lex[r] > lex[win]]
        assert above
        row_max[above] = top + 3
    row_max[n:] = 0
    lex_t = torch.from_numpy(lex).cuda()
    model_max = row_max.clone()
    a, b, count, rounds, ctas = hbm_loop.hbm_select_step(
        counts, row_max, lex_t, next_id=n, min_frequency=1
    )
    want = hbm_loop.cluster_select_reference(
        counts, model_max, lex_t, next_id=n, min_frequency=1, cluster=ctas
    )
    assert (a, b, count, rounds) == want
    assert torch.equal(row_max, model_max)
    assert (a, b, count) == hbm_loop.exact_select(counts, exact, lex_t)
    assert count == top
    if case == "high_ids":
        assert (a, b) == (win, 69_000) and lex[a] > 65_535 and lex[b] > 65_535
    if case == "stale":
        assert bool((row_max[above] < top + 3).any())


@pytest.mark.cuda
def test_trainer_at_vocab_70000_runs_k2(tmp_path):
    """A 70,000-token vocabulary (a 19.6 GB table; ids and lex ranks past
    65,535 from merge 65,280 on) on the default route with the library's
    defaults: it takes K2, and its 69,743 merges and vocab equal the native
    loop's and the benchmark's plain reference's (perfbench/reference/)
    exactly. The corpus is perfbench/corpus.py's, 6 MiB from a fixed seed:
    one 8 MiB span, so the reference counts it in this process."""
    _need_cuda()
    perfbench = Path(__file__).resolve().parent.parent / "perfbench"
    corpus = _load_by_path("perfbench_corpus", perfbench / "corpus.py")
    ref_pretok = _load_by_path("perfbench_ref_pretok", perfbench / "reference" / "pretok.py")
    ref_train = _load_by_path("perfbench_ref_train", perfbench / "reference" / "train.py")
    files = corpus.generate(tmp_path, 12345, {"bytes": 6 << 20, "files": 1, "lexicon": 200_000})
    kw = dict(vocab_size=70_000, special_tokens=SPECIALS, min_frequency=1)
    before = hbm_loop.LAUNCHES["hbm_merge_chunk"]
    trainer = BBPETrainer(BBPETrainerConfig(**kw))
    model = trainer.train(files)
    assert trainer.route == "K2"
    assert hbm_loop.LAUNCHES["hbm_merge_chunk"] > before
    assert len(model.merges) == 70_000 - 257
    native = BBPETrainer(BBPETrainerConfig(**kw, use_native_loop=True)).train(files)
    assert model.merges == native.merges and model.vocab == native.vocab
    counts = ref_pretok.count_words(files, SPECIALS, 8 << 20)
    want_vocab, want_merges = ref_train.train_bpe(counts, SPECIALS, 70_000, 1)
    assert model.merges == want_merges and model.vocab == want_vocab


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


def _shared_prefix_table() -> WordTable:
    """Words of 8-10 bytes in two families, each sharing its first 7 bytes
    (one of them 0xFF ... 0x00), so that the long tokens their merges make
    tie on the prefix key."""
    rng = np.random.default_rng(5)
    counter = Counter()
    for head in (b"abcdefg", b"\xffbcdef\x00"):
        for x in b"hijklm":
            counter[head + bytes([x])] += int(rng.integers(1, 9))
            for y in b"nopq":
                counter[head + bytes([x, y])] += int(rng.integers(1, 9))
                counter[head + bytes([x, y, y])] += int(rng.integers(1, 5))
    return WordTable.from_counter(counter)


def _tie_rows(base: list[bytes], merges: list[list[int]]) -> int:
    """Token rows that K2's dedup compare reads over the steps of ``merges``:
    at each step, the live tokens longer than 7 bytes whose first 7 bytes
    are the merged string's, where that string is longer than 7 bytes."""
    toks, rows = list(base), 0
    for a, b, c in merges:
        merged = toks[a] + toks[b]
        if len(merged) > 7:
            rows += sum(len(t) > 7 and t[:7] == merged[:7] for t in toks)
        if c == len(toks):
            toks.append(merged)
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("stage_keys", [True, False])
def test_kernel_reads_token_rows_only_on_prefix_key_ties(stage_keys):
    """K2 against its twin over two families of long words that share 7-byte
    prefixes, its keys staged in shared memory or (the fallback of a card
    without the room) read from device memory: the state equal after every
    chunk, token_key included, and the token rows read on key ties equal
    to the count recomputed from the twin's steps."""
    _need_cuda()
    kern = _kernel_vs_twin(_shared_prefix_table(), SPECIALS, 420, 1, 16, stage_keys=stage_keys)
    steps = int(kern.scalars[hbm_loop.NUM_DONE])
    base = list(Vocab.base(SPECIALS).tokens())
    want = _tie_rows(base, kern.merges[:steps].tolist())
    assert steps > 100 and want > 100
    assert int(kern.stats[hbm_loop.STAT_TIE_ROWS]) == want


@pytest.mark.cuda
def test_step_cluster_keeps_its_ctas_and_stages_keys():
    """The prefix keys' room costs the step kernel's cluster no CTA: on the
    H100, 16 CTAs that stage their keys at V = 32,000, 100,001 and 131,072
    with the widest token rows, where the cluster had 16 before."""
    _need_cuda()
    for v in (32_000, 100_001, 131_072):
        ctas = hbm_loop.cluster_ctas(v, 64)
        if "H100" in torch.cuda.get_device_name():
            assert ctas == 16 and hbm_loop.stages_keys(v, 64), v
        else:
            assert ctas in (8, 16), v


@pytest.mark.cuda
@pytest.mark.parametrize("corpus,replay_until", [("large", 45), ("large", 100),
                                                 ("shared_prefix", 60)])
def test_kernel_replay_matches_twin(corpus, replay_until):
    """K2's replay mode against the twin's, from one state, at replay
    points that are not chunk-aligned (chunks of 32): the state equal
    after every chunk, the merges equal to the uninterrupted run's, the
    replayed steps counted apart from the live ones. The shared-prefix
    words make the replayed compare read token rows on key ties."""
    _need_cuda()
    if corpus == "large":
        table = WordTable.from_counter(count_pretokens([DATA / "large.txt"], SPECIALS))
        v = 600
    else:
        table, v = _shared_prefix_table(), 420
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
        for name in K2_TENSORS:
            assert torch.equal(getattr(kern, name), getattr(twin, name)), (name, start)
        assert torch.equal(kern.scalars[:3], twin.scalars[:3]), start
        assert bool((kern.row_max >= kern.counts.amax(dim=1)).all()), start
        assert bool((kern.block_max >= hbm_loop.exact_block_max(kern.counts)).all()), start
    assert np.array_equal(kern.merges[:num].cpu().numpy(), full)
    assert int(kern.stats[hbm_loop.STAT_REPLAYED]) == replay_until
    if corpus == "shared_prefix":  # the replayed steps add no tie rows
        steps = int(kern.scalars[hbm_loop.NUM_DONE])
        base = list(Vocab.base(SPECIALS).tokens())
        records = kern.merges[:steps].tolist()
        live = _tie_rows(base, records) - _tie_rows(base, records[:replay_until])
        assert int(kern.stats[hbm_loop.STAT_TIE_ROWS]) == live
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
        for name in K2_TENSORS:
            assert torch.equal(getattr(kern, name), getattr(twin, name)), name
        with pytest.raises(AssertionError, match="divergence at replayed step 10"):
            hbm_driver.run_hbm_merge_loop(
                table, base, vocab_cap=v, num_merges=num, min_frequency=1,
                chunk_size=64, device="cuda", resume=(record, 40),
            )


@pytest.mark.cuda
def test_engines_on_cuda_past_the_kernels(tmp_path):
    """Words past 64 symbols train on the card through K1 where it admits
    them, and through the incremental (K1 off) and the bigvocab engines
    with no merge kernel launched, to the native loop's merges."""
    _need_cuda()
    wide = _load_by_path("wide_lines", SCRIPTS / "wide_lines.py")
    path = tmp_path / "wide.txt"
    path.write_text((DATA / "sample.txt").read_text(encoding="utf-8") + "\n"
                    + "\n".join(wide.wide_lines(60, 1)) + "\n", encoding="utf-8")
    for vocab_size, extra, route in (
        (320, {}, "K1"),
        (320, dict(use_fused_kernel=False), "incremental"),
        (2300, {}, "bigvocab"),
    ):
        kw = dict(vocab_size=vocab_size, min_frequency=1, max_workers=1, special_tokens=[])
        hbm_loop.LAUNCHES["hbm_merge_chunk"] = fused_loop.LAUNCHES["fused_merge_chunk"] = 0
        trainer = BBPETrainer(BBPETrainerConfig(**kw, **extra, device="cuda"))
        model = trainer.train([path])
        assert trainer.route == route
        assert hbm_loop.LAUNCHES["hbm_merge_chunk"] == 0
        assert (fused_loop.LAUNCHES["fused_merge_chunk"] > 0) == (route == "K1")
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


def _launches() -> dict[str, int]:
    """The merge kernels' launch counts (K1, K2, K3)."""
    return {"K1": fused_loop.LAUNCHES["fused_merge_chunk"],
            "K2": hbm_loop.LAUNCHES["hbm_merge_chunk"],
            "K3": replay_emit.LAUNCHES["replay_emit_chunk"]}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "route,kernel,corpus,extra,cut",
    [
        ("K2", "K2", FIXTURES / "bench_5M_realistic.txt",
         dict(vocab_size=4096, min_frequency=2, merge_chunk_size=256), 1000),
        ("sharded", "K3", DATA / "large.txt",
         dict(vocab_size=700, min_frequency=1, merge_chunk_size=128, data_shards=4,
              use_hbm_kernel=True), 300),
        ("sharded_loop", None, DATA / "large.txt",
         dict(vocab_size=700, min_frequency=1, merge_chunk_size=128, data_shards=2,
              vocab_shards=2), 300),
    ],
    ids=["k2_replay", "k3_4_shards", "sharded_2x2"],
)
def test_checkpointed_training_resumes_on_cuda(tmp_path, route, kernel, corpus, extra, cut):
    """A training on the card with a checkpoint every chunk, its saved
    record cut to ``cut`` steps (off the chunk grid), then trained again
    from it: K2 replays the cut record in its replay mode, the 4-shard
    route over K3 and the 2 data x 2 vocab sharded loop from their resume;
    each gives the uncheckpointed run's merges and vocab and launches only
    its own merge kernel."""
    _need_cuda()
    from yabpe_tpu_torch.train import checkpoint as ckpt

    kw = dict(special_tokens=SPECIALS, **extra)
    full = BBPETrainer(BBPETrainerConfig(**kw)).train([corpus])
    cfg = BBPETrainerConfig(**kw, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every_chunks=1)
    BBPETrainer(cfg).train([corpus])
    record, done = ckpt.load_checkpoint(tmp_path / "ck", cfg)
    assert done == len(full.merges) and cut % extra["merge_chunk_size"]
    record[cut:] = -1
    ckpt.save_checkpoint(tmp_path / "ck", record, cut, cfg)
    before = _launches()
    trainer = BBPETrainer(cfg)
    resumed = trainer.train([corpus])
    launched = {k: v - before[k] for k, v in _launches().items()}
    assert trainer.route == route
    assert resumed.merges == full.merges and resumed.vocab == full.vocab
    assert {k for k, n in launched.items() if n} == ({kernel} if kernel else set())
    if route == "sharded_loop":
        assert trainer.loop_stats["steps"] == len(full.merges) - cut


@pytest.fixture(scope="module")
def owt_4mib(tmp_path_factory):
    """4 MiB in owt-32k.train's corpus shape (perfbench/corpus.py, seed
    21) and the native loop's models of it by vocabulary: at 32,000, the
    cell's, it makes all 31,743 merges at min_frequency 2."""
    _need_cuda()
    corpus = _load_by_path("corpus", PERFBENCH / "corpus.py")
    spec = json.loads((PERFBENCH / "configs" / "owt-32k.json").read_text(encoding="utf-8"))
    files = corpus.generate(tmp_path_factory.mktemp("owt"), 21, {**spec["corpus"], "bytes": 4 << 20})
    native = {
        v: BBPETrainer(BBPETrainerConfig(
            vocab_size=v, min_frequency=2, special_tokens=SPECIALS, use_native_loop=True,
        )).train(files)
        for v in (32000, 8192)
    }
    assert len(native[32000].merges) == 32000 - len(Vocab.base(SPECIALS))
    return files, native


@pytest.mark.cuda
@pytest.mark.parametrize(
    "route,kernel,extra,vocab,cut",
    [
        ("K2", "K2", {}, 32000, 10_000),
        ("sharded", "K3", dict(data_shards=4, use_hbm_kernel=True), 8192, 7_435),
        ("sharded_loop", None, dict(data_shards=2, vocab_shards=2), 8192, 7_435),
    ],
    ids=["k2_replay", "k3_4_shards", "sharded_2x2"],
)
def test_routes_resume_on_4mib_on_cuda(owt_4mib, tmp_path, route, kernel, extra, vocab, cut):
    """4 MiB of owt-32k.train's corpus shape, each route resumed from a
    checkpoint of the native loop's first ``cut`` merges: K2 through its
    replay at the cell's 32,000 (off the chunk grid), the 4-shard K3 route
    (each call one launch and one memset, every shard called every epoch)
    and the 2 data x 2 vocab sharded loop (no kernel launched, the live
    steps counted) at 8,192; each equals the native loop's merges and
    vocab. Both sharded routes replay a record step by step, so 8,192 is
    the largest vocabulary at which each case stays within ~20 s on an
    H100 (at 32,000: 70 s and 32 s)."""
    from yabpe_tpu_torch.train import checkpoint as ckpt

    files, native = owt_4mib
    want = native[vocab]
    cfg = BBPETrainerConfig(vocab_size=vocab, min_frequency=2, special_tokens=SPECIALS, **extra,
                            checkpoint_dir=str(tmp_path / "ck"), checkpoint_every_chunks=1 << 20)
    ids = want.vocab
    record = np.array([(ids[a], ids[b], ids[a + b]) for a, b in want.merges], dtype=np.int32)
    record[cut:] = -1
    ckpt.save_checkpoint(tmp_path / "ck", record, cut, cfg)
    counters = (replay_emit.CALLS, replay_emit.LAUNCHES, replay_emit.MEMSETS)
    k3_before = [c["replay_emit_chunk"] for c in counters]
    before = _launches()
    trainer = BBPETrainer(cfg)
    model = trainer.train(files)
    launched = {k: v - before[k] for k, v in _launches().items()}
    k3_calls, k3_launches, k3_memsets = (
        c["replay_emit_chunk"] - b for c, b in zip(counters, k3_before)
    )
    assert trainer.route == route
    assert model.merges == want.merges and model.vocab == want.vocab
    assert {k for k, n in launched.items() if n} == ({kernel} if kernel else set())
    assert k3_calls == k3_launches == k3_memsets
    if route == "sharded":
        assert k3_launches >= 4 * trainer.loop_stats["epochs"]
    if route == "sharded_loop":
        assert trainer.loop_stats["steps"] == len(want.merges) - cut


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ingest", "hbm", "loop"])
def test_two_processes_on_one_card_over_gloo(mode):
    """Two processes on the card over gloo (tests/torch_dist_worker.py), 4
    data shards, two a process: the global ingest of three files, the
    kernel-sharded loop (K3 on each process's shards, which must launch)
    and the sharded loop each equal one process's result."""
    _need_cuda()
    from yabpe_tpu_torch.pretok.ingest import count_pretokens_raw

    from .torch_dist_worker import CAP, digest, run_pair

    files = [str(DATA / name) for name in ("large.txt", "unicode.txt", "multiline.txt")]
    if mode == "ingest":
        # the global ingest's order: process 0's files (0 and 2), then process 1's
        want = digest(*count_pretokens_raw(
            [files[0], files[2], files[1]], SPECIALS, chunk_size_bytes=32 << 20,
            max_workers=1, align_to_newline=True,
        ))
    else:
        table = WordTable.from_counter(count_pretokens(files, SPECIALS, max_workers=1))
        base = Vocab.base(SPECIALS)
        want = digest(hbm_driver.run_hbm_merge_loop(
            table, base, vocab_cap=CAP, num_merges=CAP - len(base), min_frequency=1,
            device="cuda",
        ))
    assert run_pair(mode, files, device="cuda") == {0: want, 1: want}


@pytest.mark.cuda
def test_cli_on_cuda_writes_the_trainers_files(tmp_path):
    """The CLI with --device cuda, with and without --profile-dir: the
    saved files equal BBPETrainer.save's for the same config, and the
    traced run writes its trace and spans."""
    _need_cuda()
    from yabpe_tpu_torch.cli import train_bpe

    large = DATA / "large.txt"
    args = [str(large), "--vocab-size", "1024", "--device", "cuda"]
    assert train_bpe.main([*args, "-o", str(tmp_path / "cli")]) == 0
    assert train_bpe.main([*args, "-o", str(tmp_path / "traced"),
                           "--profile-dir", str(tmp_path / "trace")]) == 0
    trainer = BBPETrainer(BBPETrainerConfig(
        vocab_size=1024, min_frequency=2, chunk_size_bytes=20 << 20, special_tokens=SPECIALS,
        align_chunks_to_newline=True,
    ))
    trainer.train([large])
    trainer.save(tmp_path / "api")
    for out in ("cli", "traced"):
        for name in ("vocab.json", "merges.txt", "special_tokens.json"):
            assert (tmp_path / out / name).read_bytes() == (tmp_path / "api" / name).read_bytes()
    for name in ("trace.json", "spans.json"):
        assert (tmp_path / "trace" / name).stat().st_size > 0


@pytest.mark.cuda
def test_gpt2_golden_ids_on_cuda(tmp_path):
    """GPT-2's derived 50,000-merge model with compute_device="cuda":
    encode, encode_batch(device=True) and encode_file on host threads and
    through the device scan give the golden ids of the 11 snippets and the
    two special-token texts, with and without <|endoftext|>, and the scans
    ran on the card."""
    _need_cuda()
    from yabpe_tpu_torch import BBPETokenizer
    from yabpe_tpu_torch.io import gpt2

    vocab = gpt2.load_gpt2_vocab(FIXTURES / "gpt2_vocab.json")
    merges = gpt2.derive_gpt2_merges(vocab)
    golden = json.loads((FIXTURES / "golden_encode" / "gpt2_golden.json").read_text(encoding="utf-8"))
    snippets = golden["snippets"]
    cases = list(zip(snippets["texts"], snippets["with_special"], snippets["no_special"]))
    plain = BBPETokenizer(vocab, merges, [], compute_device="cuda")
    for key in ("special_trailing", "special_double"):
        entry = golden[key]
        cases.append((plain.decode(entry["no_special"]), entry["with_special"], entry["no_special"]))
    texts = [text for text, _, _ in cases]
    paths = [tmp_path / f"{i}.txt" for i in range(len(texts))]
    for path, text in zip(paths, texts):
        path.write_bytes(text.encode("utf-8"))
    for specials, pick in ((SPECIALS, 1), ([], 2)):
        want = [case[pick] for case in cases]
        tok = BBPETokenizer(vocab, merges, specials, compute_device="cuda")
        assert [tok.encode(t) for t in texts] == want
        assert tok.encode_batch(texts, device=True) == want
        for device in (False, True):
            assert [tok.encode_file(p, device=device).tolist() for p in paths] == want
        enc = tok._get_device_encoder(None)
        assert enc.stats["tiles"] > 0 and enc._sorted_keys.device.type == "cuda"


@pytest.mark.cuda
def test_bench_harness_5m_legs_on_cuda():
    """The bench harness's 5 MB legs through its own functions (one timed
    run a route): the realistic text on K2 and TinyStories on K1, each
    equal to the native loop (the harness raises otherwise), GPT-2's
    encode on the card, and bench.py's four keys in its last line."""
    _need_cuda()
    import bench_torch

    before = _launches()
    real = bench_torch.train_leg(bench_torch.REAL_5M, "train_real5m", reps=1)
    repeated = bench_torch.train_leg(bench_torch.FIVE_M, "train_5m_repeated", reps=1)
    enc = bench_torch.encode_leg()
    launched = {k: v - before[k] for k, v in _launches().items()}
    assert real["device"]["route"] == "K2" and repeated["device"]["route"] == "K1"
    assert launched["K1"] > 0 and launched["K2"] > 0
    assert enc["batch_device"]["tokens"] > 0 and enc["batch_device"]["peak_device_bytes"] > 0
    line = bench_torch.result_line(real)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == bench_torch.METRIC and line["unit"] == "bytes/s"
    assert line["value"] > 0 and line["vs_baseline"] > 0


@pytest.mark.cuda
def test_trained_model_round_trips_on_cuda(tmp_path):
    """TinyStories 5 MB at vocab 1000 (the settings of the JAX package's
    snapshot tests/_snapshots/test_train_bpe_special_tokens.pkl) on the
    card: K1 runs and K2 does not, the merges and vocab equal the snapshot
    and the native loop, the saved files equal the native loop's; then
    from_file, encode and decode give back the first 1 MiB and the golden
    snippets."""
    _need_cuda()
    from yabpe_tpu_torch import BBPETokenizer

    text_file = FIXTURES / "tinystories_sample_5M.txt"
    kw = dict(vocab_size=1000, min_frequency=1, max_workers=1, chunk_size_bytes=1 << 30,
              special_tokens=SPECIALS)
    before = _launches()
    trainer = BBPETrainer(BBPETrainerConfig(**kw))
    model = trainer.train([text_file])
    launched = {k: v - before[k] for k, v in _launches().items()}
    assert trainer.route == "K1" and launched["K1"] > 0 and launched["K2"] == 0
    snapshot = Path(__file__).resolve().parent / "_snapshots" / "test_train_bpe_special_tokens.pkl"
    with open(snapshot, "rb") as f:
        want = pickle.load(f)
    assert model.merges == want["merges"]
    assert set(model.vocab) == want["vocab_values"] and set(model.vocab.values()) == want["vocab_keys"]
    native = BBPETrainer(BBPETrainerConfig(**kw, use_native_loop=True))
    native_model = native.train([text_file])
    assert native_model.merges == model.merges and native_model.vocab == model.vocab
    trainer.save(tmp_path / "device")
    native.save(tmp_path / "native")
    for name in ("vocab.json", "merges.txt", "special_tokens.json"):
        assert (tmp_path / "device" / name).read_bytes() == (tmp_path / "native" / name).read_bytes()
    tok = BBPETokenizer.from_file(tmp_path / "device")
    with open(text_file, encoding="utf-8") as f:
        text = f.read(1 << 20)
    assert tok.decode(tok.encode(text)) == text
    golden = json.loads((FIXTURES / "golden_encode" / "gpt2_golden.json").read_text(encoding="utf-8"))
    for snippet in golden["snippets"]["texts"]:
        assert tok.decode(tok.encode(snippet)) == snippet
