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
from yabpe_tpu_torch.kernels import fused_loop, hbm_loop
from yabpe_tpu_torch.pretok.ingest import count_pretokens
from yabpe_tpu_torch.train import fused_driver, hbm_driver

DATA = Path(__file__).resolve().parent / "data"
SPECIALS = ["<|endoftext|>"]
TENSORS = ("words", "counts", "merges", "token_bytes", "token_len", "lex_rank")


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


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
        if not fused:
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
