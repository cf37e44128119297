"""One process of a two-process run of the port over gloo on the CPU.

    python tests/torch_dist_worker.py RANK WORLD PORT MODE [FILE ...]

Joins a ``torch.distributed`` group of WORLD processes over gloo at
tcp://127.0.0.1:PORT, runs MODE, and prints one line ``RESULT <rank>
<sha256>``: the digest of the raw word table (``ingest``) or of the merge
record (the rest). Imports the port only, never JAX.
"""

from __future__ import annotations

import hashlib
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


def run(mode: str, files: list[str], world: int) -> str:
    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
    from yabpe_tpu_torch.core.vocab import Vocab
    from yabpe_tpu_torch.core.wordtable import WordTable
    from yabpe_tpu_torch.dist.hbm_sharded import run_hbm_sharded_merge_loop
    from yabpe_tpu_torch.dist.ingest import count_pretokens_global
    from yabpe_tpu_torch.dist.sharded import run_sharded_merge_loop
    from yabpe_tpu_torch.pretok.ingest import count_pretokens

    if mode == "ingest":
        return digest(*count_pretokens_global(files, SPECIALS, max_workers=1))
    if mode == "trainer":
        cfg = BBPETrainerConfig(
            vocab_size=CAP, min_frequency=1, max_workers=1, special_tokens=SPECIALS,
            device="cpu", data_shards=4, merge_chunk_size=64,
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
        device="cpu", processes=world, backend="gloo",
    )
    if mode == "hbm":
        return digest(run_hbm_sharded_merge_loop(table, base, spec_batch=8, **kw))
    layout = dict(loop=dict(), spec=dict(spec_batch=8), vocab=dict(vocab_shards=2))[mode]
    return digest(run_sharded_merge_loop(table, base, chunk_size=64, **layout, **kw))


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    mode, files = sys.argv[4], sys.argv[5:]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world
    )
    try:
        print(f"RESULT {rank} {run(mode, files, world)}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
