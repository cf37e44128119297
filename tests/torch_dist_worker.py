"""One process of a two-process run of the port over gloo.

    python tests/torch_dist_worker.py RANK WORLD PORT MODE DEVICE [FILE ...]

Joins a ``torch.distributed`` group of WORLD processes over gloo at
tcp://127.0.0.1:PORT, runs MODE on DEVICE (``cpu`` or ``cuda``), and
prints one line ``RESULT <rank> <sha256>``: the digest of the raw word
table (``ingest``) or of the merge record (the rest). On ``cuda`` the
``hbm`` mode must launch the replay kernel. Imports the port only, never
JAX. :func:`run_pair` starts two of them.
"""

from __future__ import annotations

import hashlib
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

SPECIALS = ["<|endoftext|>"]
CAP = 400


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a if isinstance(a, bytes) else np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def merges_digest(merges) -> str:
    return digest(repr(merges).encode())


def run(mode: str, files: list[str], world: int, device: str = "cpu") -> str:
    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
    from yabpe_tpu_torch.core.vocab import Vocab
    from yabpe_tpu_torch.core.wordtable import WordTable
    from yabpe_tpu_torch.dist.hbm_sharded import run_hbm_sharded_merge_loop
    from yabpe_tpu_torch.dist.ingest import count_pretokens_global
    from yabpe_tpu_torch.dist.sharded import run_sharded_merge_loop
    from yabpe_tpu_torch.kernels import replay_emit
    from yabpe_tpu_torch.pretok.ingest import count_pretokens

    if mode == "ingest":
        return digest(*count_pretokens_global(files, SPECIALS, max_workers=1))
    if mode == "trainer":
        cfg = BBPETrainerConfig(
            vocab_size=CAP, min_frequency=1, max_workers=1, special_tokens=SPECIALS,
            device=device, data_shards=4, merge_chunk_size=64,
        )
        trainer = BBPETrainer(cfg)
        model = trainer.train(files)
        assert trainer.route == "sharded_loop", trainer.route
        assert trainer.loop_stats["spec_epochs"] > 0, trainer.loop_stats
        return merges_digest(model.merges)
    table = WordTable.from_counter(count_pretokens(files, SPECIALS, max_workers=1))
    base = Vocab.base(SPECIALS)
    kw = dict(
        vocab_cap=CAP, num_merges=CAP - len(base), min_frequency=1, data_shards=4,
        device=device, processes=world, backend="gloo",
    )
    if mode == "hbm":
        launches = replay_emit.LAUNCHES["replay_emit_chunk"]
        merges = run_hbm_sharded_merge_loop(table, base, spec_batch=8, **kw)
        if device == "cuda":
            assert replay_emit.LAUNCHES["replay_emit_chunk"] > launches, "K3 never launched"
        return digest(merges)
    layout = dict(loop=dict(), spec=dict(spec_batch=8), vocab=dict(vocab_shards=2))[mode]
    return digest(run_sharded_merge_loop(table, base, chunk_size=64, **layout, **kw))


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    mode, device, files = sys.argv[4], sys.argv[5], sys.argv[6:]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world
    )
    try:
        print(f"RESULT {rank} {run(mode, files, world, device)}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_pair(
    mode: str, files: list[str], device: str = "cpu", timeout_s: float = 150
) -> dict[int, str]:
    """Two processes of this script on a free port running ``mode`` on
    ``device``: both RESULT digests by rank. Raises AssertionError on a
    process's error, or past ``timeout_s``, after which both are killed."""
    port = _free_port()
    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo / "src"), "OMP_NUM_THREADS": "1"}
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(rank), "2", str(port), mode, device, *files],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        )
        for rank in range(2)
    ]
    results, errors = {}, []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=timeout_s)
            if proc.returncode != 0:
                errors.append(err[-2000:])
            for line in out.splitlines():
                if line.startswith("RESULT"):
                    _, rank, value = line.split()
                    results[int(rank)] = value
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{mode}: the processes did not finish in {timeout_s} s") from None
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert not errors, "\n".join(errors)
    return results


if __name__ == "__main__":
    sys.exit(main())
