#!/usr/bin/env python3
"""Where the merge loop's time goes on the GPU, chunk by chunk and kernel
by kernel, for the PyTorch/CUDA port (src/yabpe_tpu_torch).

    python3 profile_torch.py [--size-mb 100] [--vocab 32000] [--seed 7]

Builds the corpus of chip_smoke.py's full-width phase (scripts/gen_corpus.py,
lexicon 200,000), ingests it, and runs the merge loop chunk by chunk on
the card through the kernel wrapper, printing for every chunk its time by
CUDA events. After each chunk the plain twin runs the same chunk on its
own copy of the state (untimed): the two states must stay exactly equal
over the whole run, and the twin's byte tally gives each chunk's bound
(the bytes the chunk needs at least over the H100's 3.35 TB/s). Two
chunks, the first and the last, also run under torch.profiler: their
device time per kernel, the kernels' launch counts and the device's busy
share of the chunk's wall time. Needs one CUDA device; imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SPECIALS = ["<|endoftext|>"]
#: H100 SXM device-memory rate (NVIDIA data sheet), for the bound.
HBM_BYTES_PER_S = 3.35e12


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size-mb", type=float, default=100.0)
    parser.add_argument("--vocab", type=int, default=32000)
    parser.add_argument("--lexicon", type=int, default=200_000)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--chunk", type=int, default=2048)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO / "scripts"))
    from gen_corpus import generate
    from torch.profiler import ProfilerActivity, profile

    from yabpe_tpu_torch.core.vocab import Vocab
    from yabpe_tpu_torch.core.wordtable import WordTable
    from yabpe_tpu_torch.kernels import hbm_loop
    from yabpe_tpu_torch.pretok.ingest import count_pretokens
    from yabpe_tpu_torch.train.hbm_driver import state_from_numpy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    with tempfile.TemporaryDirectory(prefix="yabpe_profile_") as tmp:
        corpus = Path(tmp) / "corpus.txt"
        generate(str(corpus), args.size_mb, lexicon_size=args.lexicon, seed=args.seed)
        table = WordTable.from_counter(count_pretokens(
            [corpus], SPECIALS, chunk_size_bytes=32 << 20, max_workers=8,
            align_to_newline=True,
        ))
    base = list(Vocab.base(SPECIALS).tokens())
    num = args.vocab - len(base)
    state = state_from_numpy(table.words, table.freqs, base, args.vocab, "cuda", num_merges=num)
    twin = state.clone()
    print(f"V={args.vocab} N={table.words.shape[0]} W={table.width} merges={num} [{card}]")
    with profile(activities=[ProfilerActivity.CUDA]):  # start the tracer once
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    starts = list(range(0, num, args.chunk))
    profiled = {starts[0], starts[-1]}
    total_ms = total_bound_ms = 0.0
    for start in starts:
        kw = dict(chunk_start=start, chunk_size=args.chunk, num_merges=num, min_frequency=2)
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if start in profiled:
            wall0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                ev0.record()
                hbm_loop.hbm_merge_chunk(state, **kw)
                ev1.record()
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - wall0) * 1e3
        else:
            ev0.record()
            hbm_loop.hbm_merge_chunk(state, **kw)
            ev1.record()
            torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1)
        tally: dict[str, int] = {}
        hbm_loop.hbm_merge_chunk_reference(twin, tally=tally, **kw)
        for name in ("words", "counts", "token_bytes", "token_len", "lex_rank", "merges"):
            if not torch.equal(getattr(state, name), getattr(twin, name)):
                raise SystemExit(f"profile_torch: kernel != twin in {name} after chunk {start}")
        if not torch.equal(state.scalars[:3], twin.scalars[:3]):
            raise SystemExit(f"profile_torch: kernel != twin in scalars after chunk {start}")
        if not bool((state.row_max >= state.counts.amax(dim=1)).all()):
            raise SystemExit(f"profile_torch: row_max below a row max after chunk {start}")
        bound_ms = tally.get("bytes", 0) / HBM_BYTES_PER_S * 1e3
        total_ms += ms
        total_bound_ms += bound_ms
        steps = min(start + args.chunk, num) - start
        print(f"chunk {start}: {ms} ms, {ms * 1e3 / steps} us/step, bound {bound_ms} ms "
              f"by bytes, {tally.get('affected_words', 0)} affected words [{card}]")
        if start in profiled:
            device_us = 0.0
            rows = []
            for e in prof.key_averages():
                dev = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                if dev and e.key.find("kernel") >= 0:
                    rows.append((dev, e.count, e.key))
                    device_us += dev
            for dev, count, key in sorted(rows, reverse=True):
                print(f"  {key[:60]}: {dev / 1e3} ms device, {count} launches, "
                      f"{dev / count} us each")
            print(f"  device busy {device_us / 1e3} ms of {wall_ms} ms wall "
                  f"({100 * device_us / 1e3 / wall_ms} %) under the profiler [{card}]")
        if int(state.scalars[hbm_loop.STOPPED]):
            break
    print(f"all chunks: {total_ms} ms for {int(state.scalars[hbm_loop.NUM_DONE])} merges, "
          f"bound {total_bound_ms} ms by bytes; kernel == twin after every chunk [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
