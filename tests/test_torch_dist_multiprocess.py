"""The port across two processes over gloo on the CPU: global ingest, the
sharded loop (per step, speculative and 2D), the kernel-sharded loop (K3's
twin on the CPU) and the trainer, each equal to one process's result.

Each test starts its two processes (tests/torch_dist_worker.py) on a free
port and waits for them with a time limit; past it the processes are
killed and the test fails, so no test can hang the suite.
"""

from __future__ import annotations

import hashlib

import pytest

from yabpe_tpu.pretok.ingest import count_pretokens_raw as jax_count_pretokens_raw
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.pretok.ingest import count_pretokens
from yabpe_tpu_torch.train.hbm_driver import run_hbm_merge_loop

from .common import DATA
from .torch_dist_worker import digest as _digest
from .torch_dist_worker import run_pair as _run_pair

SPECIALS = ["<|endoftext|>"]
CAP = 400
FILES = [str(DATA / "large.txt"), str(DATA / "unicode.txt"), str(DATA / "multiline.txt")]


@pytest.fixture(scope="module")
def single_merges():
    table = WordTable.from_counter(count_pretokens(FILES[:1], SPECIALS, max_workers=1))
    base = Vocab.base(SPECIALS)
    return run_hbm_merge_loop(
        table, base, vocab_cap=CAP, num_merges=CAP - len(base), min_frequency=1,
        device="cpu",
    )


def test_global_ingest_equals_the_jax_ingest_of_every_file():
    """One file per process (and one more on process 0): the union, the
    same on both processes, equals the JAX count_pretokens_raw over all
    files, arrays and order."""
    want = _digest(*jax_count_pretokens_raw(
        [FILES[0], FILES[2], FILES[1]], SPECIALS, chunk_size_bytes=32 * 1024 * 1024,
        max_workers=1, align_to_newline=True,
    ))
    assert _run_pair("ingest", FILES) == {0: want, 1: want}


@pytest.mark.parametrize("mode", ["loop", "spec", "vocab"])
def test_sharded_loop_across_processes(single_merges, mode):
    """4 data shards, two a process: per step, speculative (k=8), and 2 x 2
    with the vocab slabs in each process."""
    want = _digest(single_merges)
    assert _run_pair(mode, FILES[:1]) == {0: want, 1: want}


def test_kernel_sharded_loop_across_processes(single_merges):
    """The kernel-sharded loop, each process replaying its two shards."""
    want = _digest(single_merges)
    assert _run_pair("hbm", FILES[:1]) == {0: want, 1: want}


def test_trainer_across_processes():
    """BBPETrainer under torch.distributed: global ingest, then the sharded
    loop in speculative epochs (the default across processes); the merges
    equal one process's training of the same files."""
    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig

    cfg = BBPETrainerConfig(
        vocab_size=CAP, min_frequency=1, max_workers=1, special_tokens=SPECIALS,
        device="cpu",
    )
    model = BBPETrainer(cfg).train(FILES)
    want = hashlib.sha256(repr(model.merges).encode()).hexdigest()
    assert _run_pair("trainer", FILES) == {0: want, 1: want}
