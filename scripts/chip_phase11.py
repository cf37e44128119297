#!/usr/bin/env python3
"""chip_smoke.py's phase 11 (the distributed layer and the CLI) alone.

    python3 scripts/chip_phase11.py

First probes which collectives gloo takes CUDA tensors for (two spawned
processes on the card: all_gather, all_gather_into_tensor, all_reduce),
then builds what phase 11 needs (the native library, the 100 MB corpus of
scripts/gen_corpus.py, its native-loop model at vocab 32,000) and runs
chip_smoke.distributed_run: 11a-11e with their checks, each part timed.
Needs one CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import json
import socket
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src"), str(REPO / "scripts")]

import chip_smoke  # noqa: E402


def _gloo_probe(rank: int, port: int, out_dir: str) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
    t = torch.full((4,), rank, device="cuda")
    calls = {
        "all_gather": lambda: dist.all_gather([torch.empty_like(t) for _ in range(2)], t),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8, device="cuda", dtype=t.dtype), t),
        "all_reduce": lambda: dist.all_reduce(t.clone()),
    }
    result = {}
    for name, call in calls.items():
        try:
            call()
            result[name] = "ok"
        except Exception as e:  # the probe reports what gloo refuses
            result[name] = f"{type(e).__name__}: {str(e)[:200]}"
    dist.destroy_process_group()
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(result))


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("chip_phase11: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    print(card)
    with tempfile.TemporaryDirectory() as out_dir:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        procs = [mp.get_context("spawn").Process(target=_gloo_probe, args=(r, port, out_dir))
                 for r in range(2)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(120)
            if proc.is_alive():
                proc.kill()
        for r in range(2):
            f = Path(out_dir, f"rank{r}.json")
            print(f"gloo with CUDA tensors, rank {r}: {f.read_text() if f.exists() else 'no result'} [{card}]")

    from gen_corpus import generate

    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig, native

    native.load()
    with tempfile.TemporaryDirectory(prefix="yabpe_chip_phase11_") as tmp:
        corpus = Path(tmp) / "corpus_100M.txt"
        generate(str(corpus), 100.0, lexicon_size=200_000)
        model = BBPETrainer(BBPETrainerConfig(
            vocab_size=32000, min_frequency=2, max_workers=8, chunk_size_bytes=32 << 20,
            special_tokens=chip_smoke.SPECIALS, align_chunks_to_newline=True,
            use_native_loop=True,
        )).train([corpus])
        t0 = time.perf_counter()
        chip_smoke.distributed_run(corpus, model, card)
        print(f"phase 11: {time.perf_counter() - t0} s [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
