"""The port across two processes over gloo on the CPU: global ingest, the
sharded loop (per step, speculative and 2D), the kernel-sharded loop (K3's
twin on the CPU) and the trainer, each equal to one process's result.

Each test starts its two processes (tests/torch_dist_worker.py) on a free
port and waits for them with a time limit; past it the processes are
killed and the test fails, so no test can hang the suite.
"""

from __future__ import annotations

import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from yabpe_tpu.pretok.ingest import count_pretokens_raw as jax_count_pretokens_raw
from yabpe_tpu_torch.core.vocab import Vocab
from yabpe_tpu_torch.core.wordtable import WordTable
from yabpe_tpu_torch.pretok.ingest import count_pretokens
from yabpe_tpu_torch.train.hbm_driver import run_hbm_merge_loop

from .common import DATA, REPO

WORKER = REPO / "tests" / "torch_dist_worker.py"
TIMEOUT_S = 150
SPECIALS = ["<|endoftext|>"]
CAP = 400
FILES = [str(DATA / "large.txt"), str(DATA / "unicode.txt"), str(DATA / "multiline.txt")]


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_pair(mode: str, files: list[str]) -> dict[int, str]:
    """Both processes' RESULT digests; fails on an error or the time limit."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(rank), "2", str(port), mode, *files],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        )
        for rank in range(2)
    ]
    results, errors = {}, []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=TIMEOUT_S)
            if proc.returncode != 0:
                errors.append(err[-2000:])
            for line in out.splitlines():
                if line.startswith("RESULT"):
                    _, rank, value = line.split()
                    results[int(rank)] = value
    except subprocess.TimeoutExpired:
        pytest.fail(f"{mode}: the processes did not finish in {TIMEOUT_S} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errors, "\n".join(errors)
    return results


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a if isinstance(a, bytes) else np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


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
