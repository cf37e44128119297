#!/usr/bin/env python3
"""Where the device encoder's time goes on one GPU.

    python3 scripts/profile_encode.py [--size-mb 100]

The cell of chip_smoke.py phase 10b: a corpus from scripts/gen_corpus.py
(lexicon 200,000, seed 7) and a 32,000-token model trained on it by the
native host loop (min_frequency 2, one special token; the device routes
give the same merges). Printed, after the card's name and power limit:

1. ``encode_file(path, device=True)`` cold (a fresh encoder) and warm
   (the same encoder again: no scan), and ``encode_file(path)`` on host
   threads, each once unprofiled and once under torch.profiler: the wall
   time (host clock),
   the device's busy time (the sum of CUDA kernel and memcpy/memset
   durations), the idle share, the kernel launches and the host syncs
   (cudaStreamSynchronize calls), then the top device kernels;
2. the largest tile of the first 4 MiB chunk scanned alone, queued behind
   a spin kernel with no test for work, unprofiled (CUDA events) and under
   the profiler: device time and launches per iteration, and the device
   time of each op kind.

Needs one CUDA device.
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


def _summary(prof):
    """(device busy s, launches, host syncs, the top device events). Only
    the device's own events (kernels, copies, memsets) count: a CPU op's
    device time repeats its kernels'."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in device)
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"))
    syncs = sum(e.count for e in events if e.key == "cudaStreamSynchronize")
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    return device_us / 1e6, launches, syncs, top


def profile_file(label, run, card) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    busy_s, launches, syncs, top = _summary(prof)
    print(f"{label}: wall_s={plain_s} profiled_wall_s={wall_s} device_busy_s={busy_s} "
          f"idle_share={1 - busy_s / wall_s} launches={launches} host_syncs={syncs} [{card}]")
    for e in top:
        print(f"  {e.key[:70]}: {e.self_device_time_total / 1e3:.3f} ms, {e.count} calls")


def profile_tile(enc, words, card) -> None:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from yabpe_tpu_torch.tok.device_encode import scan_encode

    _, tile, row_lens = max(enc.pack_tiles(words), key=lambda t: (t[1].shape[1], int(t[2].max())))
    tables = (enc._sorted_keys, enc._sorted_ranks, enc._sorted_new_syms, enc._n_syms)
    iters = int(row_lens.max()) - 1
    t = torch.from_numpy(tile).cuda()

    def run():
        return scan_encode(t, *tables, max_iters=iters, check_every=tile.shape[1])

    run()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    device_ms = e0.elapsed_time(e1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000_000)
        run()
        torch.cuda.synchronize()
    busy_s, launches, _, top = _summary(prof)
    spin = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "sleep" in e.key.lower()) / 1e6
    print(f"largest tile of the first chunk: shape={tile.shape} words={int(np.count_nonzero(row_lens))} "
          f"iterations={iters} device_ms={device_ms} device_ms_per_iteration={device_ms / iters} "
          f"profiled_busy_ms_per_iteration={1e3 * (busy_s - spin) / iters} "
          f"launches_per_iteration={(launches - 1) / iters} [{card}]")
    for e in top:
        if "sleep" not in e.key.lower():
            print(f"  {e.key[:70]}: {e.self_device_time_total / iters:.2f} us/iteration, "
                  f"{e.count / iters:.2f} calls/iteration")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size-mb", type=float, default=100.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_encode: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO / "scripts"))
    from gen_corpus import generate

    from yabpe_tpu_torch import BBPETokenizer, BBPETrainer, BBPETrainerConfig, native
    from yabpe_tpu_torch.tok.device_encode import DeviceEncoder
    from yabpe_tpu_torch.tok.parallel_encode import safe_cut_points

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    with tempfile.TemporaryDirectory(prefix="yabpe_profile_encode_") as tmp:
        corpus = Path(tmp) / "corpus.txt"
        generate(str(corpus), args.size_mb, lexicon_size=200_000)
        model = BBPETrainer(BBPETrainerConfig(
            vocab_size=32000, min_frequency=2, max_workers=8, chunk_size_bytes=32 << 20,
            special_tokens=SPECIALS, align_chunks_to_newline=True, use_native_loop=True,
        )).train([corpus])
        tok = BBPETokenizer(model.vocab, model.merges, SPECIALS)
        nbytes = corpus.stat().st_size
        print(f"corpus: {nbytes} bytes, model: {len(model.merges)} merges")

        def fresh():
            return DeviceEncoder(model.vocab, model.merges, SPECIALS, device="cuda")

        encoders = [fresh(), fresh()]
        profile_file("encode_file(device=True) cold", lambda: encoders.pop().encode_file(corpus), card)
        warm = fresh()
        warm.encode_file(corpus)
        profile_file("encode_file(device=True) warm", lambda: warm.encode_file(corpus), card)
        profile_file("encode_file host threads", lambda: tok.encode_file(corpus), card)

        start, end = safe_cut_points(corpus, 4 << 20, SPECIALS)[0]
        with open(corpus, "rb") as f:
            data = f.read(end - start)
        counter = native.NativeCounter(tuple(SPECIALS))
        counter.add_word_ids_specials(data)
        words = counter.export_words()
        counter.close()
        profile_tile(warm, words, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
