#!/usr/bin/env python3
"""Where the fallback engines' time goes on one GPU.

    python3 scripts/profile_engines.py [--warm 512] [--window 256]

The corpora of chip_smoke.py phase 9c: the 5 MB realistic fixture plus
2,000 lines of 65-300-byte pre-tokens (scripts/wide_lines.py, seed 0) at
vocab 4,096 (the bigvocab engine, train/bigvocab.py), and
tests/data/large.txt plus 2,000 such lines (seed 1) at vocab 1024 (the
incremental engine, train/incremental.py), min_frequency 2, one special
token. For each, the engine state is built as its driver builds it, the
first ``--warm`` steps run unprofiled, and the next ``--window`` steps
run under torch.profiler. Printed per step of the window: the wall time
(host clock, the window ending in a synchronize), the device's busy time
(the sum of CUDA kernel and memcpy/memset durations), the idle share, the
kernel launches and the host syncs (cudaStreamSynchronize calls), then
the top device kernels by time. Needs one CUDA device; the card's name
and power limit are printed first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SPECIALS = ["<|endoftext|>"]


def profile_engine(label, path, vocab_cap, big, warm, window, card):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from yabpe_tpu_torch.core.vocab import Vocab
    from yabpe_tpu_torch.core.wordtable import WordTable
    from yabpe_tpu_torch.pretok.ingest import count_pretokens
    from yabpe_tpu_torch.train import bigvocab, incremental, state

    table = WordTable.from_counter(count_pretokens([path], SPECIALS, max_workers=8))
    base = Vocab.base(SPECIALS)
    num = vocab_cap - len(base)
    core, _ = incremental.start_engine(table, base, vocab_cap, num, None, "cuda")
    counts = state.count_pairs(core.words, core.freqs, vocab_cap, "dense", state.count_dtype(table))
    if big:
        st = bigvocab.BigState(core, counts, counts.view(vocab_cap, vocab_cap).amax(dim=1))
        chunk = bigvocab.merge_chunk_big
    else:
        st = incremental.IncState(core, counts)
        chunk = incremental.merge_chunk_incremental
    kw = dict(vocab_cap=vocab_cap, min_frequency=2, num_merges=num,
              affected_cap=incremental.pick_affected_cap(int(core.words.shape[0])))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk(st, 0, chunk_size=warm, **kw)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk(st, warm, chunk_size=window, **kw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    steps = int(st.core.vocab.num_done) - warm
    events = prof.key_averages()
    # only the device's own events: a CPU op's device time repeats its kernels'
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in device)
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
    print(f"{label}: N={table.words.shape[0]} W={table.words.shape[1]} V={vocab_cap} "
          f"warm_steps={warm} warm_ms_per_step={1e3 * warm_s / warm} window_steps={steps} "
          f"wall_ms_per_step={1e3 * wall_s / steps} device_busy_ms_per_step={device_us / 1e3 / steps} "
          f"idle_share={1 - device_us / 1e6 / wall_s} launches_per_step={launches / steps} "
          f"host_syncs_per_step={syncs / steps} [{card}]")
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    for e in top:
        print(f"  {e.key[:70]}: {e.self_device_time_total / steps:.2f} us/step, "
              f"{e.count / steps:.2f} calls/step")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warm", type=int, default=512)
    ap.add_argument("--window", type=int, default=256)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_engines: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO / "scripts"))
    from wide_lines import wide_lines

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    with tempfile.TemporaryDirectory(prefix="yabpe_profile_engines_") as tmp:
        tmp = Path(tmp)
        corpora = (
            ("bigvocab_wide_5M_v4096", REPO / "tests" / "fixtures_gpt2" / "bench_5M_realistic.txt", 0, 4096, True),
            ("incremental_wide_large_v1024", REPO / "tests" / "data" / "large.txt", 1, 1024, False),
        )
        for label, source, seed, vocab_cap, big in corpora:
            path = tmp / f"{label}.txt"
            path.write_text(source.read_text(encoding="utf-8") + "\n"
                            + "\n".join(wide_lines(2000, seed)) + "\n", encoding="utf-8")
            profile_engine(label, path, vocab_cap, big, args.warm, args.window, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
