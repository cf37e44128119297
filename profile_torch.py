#!/usr/bin/env python3
"""Where the merge loop's time goes on the GPU, chunk by chunk and kernel
by kernel, for the PyTorch/CUDA port (src/yabpe_tpu_torch).

    python3 profile_torch.py [--size-mb 100] [--vocab 32000] [--seed 7]

Builds the corpus of chip_smoke.py's full-width phase (scripts/gen_corpus.py,
lexicon 200,000). Then two runs of the K2 merge loop:

1. one ``BBPETrainer(...).train(...)`` under torch.profiler, after an
   untimed warm-up training: the program's own spans (utils/profiling.py)
   give the split of ``ingest_seconds`` (scan, fold, each worker) and of
   ``merge_seconds`` (WordTable.from_raw, the state, the chunks,
   merges_to_bytes; what the route's own choice takes is the
   rest), and its K2 counters the select's verified rows and time a step;
2. over the table the trainer builds (ingested again, untimed), chunk by chunk on the card through the kernel wrapper, printing for
   every chunk its time by CUDA events, the select's verify rounds and
   verified rows per step, and the step kernel's time by phase from its
   own global-timer stamps (``HbmState.stats``; the rest of the step is
   the apply kernel and the gaps). After each chunk the
   plain twin runs the same chunk on its own copy of the state (untimed):
   the two states must stay exactly equal over the whole run, and the
   twin's byte tally gives each chunk's bound (the bytes the chunk needs
   at least over the H100's 3.35 TB/s). Two chunks, the first and the
   last, also run under torch.profiler: their device time per kernel,
   the kernels' launch counts and the device's busy share of the
   chunk's wall time.

Needs one CUDA device; imports nothing of JAX or of the JAX package.
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


def union_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) spans."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
    from yabpe_tpu_torch.core.vocab import Vocab
    from yabpe_tpu_torch.core.wordtable import WordTable
    from yabpe_tpu_torch.kernels import hbm_loop
    from yabpe_tpu_torch.pretok.ingest import count_pretokens_raw
    from yabpe_tpu_torch.train import hbm_driver
    from yabpe_tpu_torch.utils import profiling

    STATS = {
        "rounds": hbm_loop.STAT_ROUNDS, "verified": hbm_loop.STAT_VERIFIED,
        "bound": hbm_loop.STAT_NS_BOUND, "verify": hbm_loop.STAT_NS_VERIFY,
        "compare": hbm_loop.STAT_NS_COMPARE, "vocab": hbm_loop.STAT_NS_VOCAB,
        "step": hbm_loop.STAT_NS_STEP, "barrier": hbm_loop.STAT_NS_BARRIER,
    }

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    config = BBPETrainerConfig(
        vocab_size=args.vocab, special_tokens=SPECIALS, min_frequency=2,
        chunk_size_bytes=32 << 20, max_workers=8, align_chunks_to_newline=True,
        merge_chunk_size=args.chunk,
    )
    with tempfile.TemporaryDirectory(prefix="yabpe_profile_") as tmp:
        corpus = Path(tmp) / "corpus.txt"
        generate(str(corpus), args.size_mb, lexicon_size=args.lexicon, seed=args.seed)

        # ---- 1. one training under the profiler, split by the program's spans
        BBPETrainer(config).train([corpus])  # CUDA context and kernel build, untimed
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            trainer = BBPETrainer(config)
            trainer.train([corpus])
            torch.cuda.synchronize()
        raw = count_pretokens_raw(
            [corpus], SPECIALS, chunk_size_bytes=32 << 20, max_workers=8,
            align_to_newline=True,
        )
    spans = profiling.spans()
    root = max(s["id"] for s in spans if s["name"] == "yabpe.train")
    mine = [s for s in spans if s["train"] == root]
    split: dict[str, float] = {}
    for s in mine:
        split[s["name"]] = split.get(s["name"], 0.0) + (s["end_ns"] - s["start_ns"]) / 1e9
    workers = [(s["end_ns"] - s["start_ns"]) / 1e9 for s in mine
               if s["name"] == "yabpe.ingest.worker"]
    st = trainer.last_stats
    route = {k[len("yabpe.route."):]: v for k, v in split.items() if k.startswith("yabpe.route.")}
    print(f"route {trainer.route}; merge_seconds {st['merge_seconds']} s: " + ", ".join(
        f"{name} {sec} s" for name, sec in route.items())
        + f"; the route's choice and the rest {st['merge_seconds'] - sum(route.values())} s [{card}]")
    print(f"ingest_seconds {st['ingest_seconds']} s: scan {split.get('yabpe.ingest.scan')} s, "
          f"fold {split.get('yabpe.ingest.fold')} s; {len(workers)} workers "
          f"{min(workers, default=0)}-{max(workers, default=0)} s [{card}]")
    k2 = profiling.counters().get(root, {})
    if k2.get("k2.steps"):
        print(f"K2: {k2['k2.steps']} live steps, {k2['k2.rows_verified'] / k2['k2.steps']} "
              f"verified rows/step, select {k2['k2.select_ns'] / k2['k2.steps'] / 1e3} us/step "
              f"[{card}]")
    base_vocab = Vocab.base(SPECIALS)
    base = list(base_vocab.tokens())
    num = args.vocab - len(base)
    table = WordTable.from_raw(*raw)
    del raw

    state = hbm_driver.state_from_numpy(
        table.words, table.freqs, base, args.vocab, "cuda", num_merges=num
    )
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
        stats0 = state.stats.clone()
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
        stat = [(int(x) % 2**32) for x in (state.stats.long() - stats0.long())]
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
        steps = int(state.scalars[hbm_loop.NUM_DONE]) - start
        per_step = {name: stat[i] / max(steps, 1) for name, i in STATS.items()}
        print(f"chunk {start}: {ms} ms, {ms * 1e3 / steps} us/step, bound {bound_ms} ms "
              f"by bytes, {tally.get('affected_words', 0)} affected words, "
              f"{per_step['rounds']} verify rounds/step, {per_step['verified']} verified "
              f"rows/step; step kernel {per_step['step'] / 1e3} us/step by its own timer "
              f"(bound {per_step['bound'] / 1e3}, verify {per_step['verify'] / 1e3}, "
              f"compare {per_step['compare'] / 1e3}, vocab {per_step['vocab'] / 1e3} us; "
              f"the first cluster barrier {per_step['barrier'] / 1e3} us), "
              f"apply and gaps {ms * 1e3 / steps - per_step['step'] / 1e3} us/step [{card}]")
        if start in profiled:
            rows = []
            spans = []
            for e in prof.key_averages():
                dev = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
                if dev and e.key.find("kernel") >= 0:
                    rows.append((dev, e.count, e.key))
            for e in prof.events():
                if e.device_type == DeviceType.CUDA and e.name.find("kernel") >= 0:
                    spans.append((e.time_range.start, e.time_range.end))
            for dev, count, key in sorted(rows, reverse=True):
                print(f"  {key[:60]}: {dev / 1e3} ms device, {count} launches, "
                      f"{dev / count} us each (spans overlap under PDL)")
            busy_us = union_us(spans)
            print(f"  device busy {busy_us / 1e3} ms of {wall_ms} ms wall "
                  f"({100 * busy_us / 1e3 / wall_ms} %), the union of the kernels' spans, "
                  f"under the profiler [{card}]")
        if int(state.scalars[hbm_loop.STOPPED]):
            break
    done = int(state.scalars[hbm_loop.NUM_DONE])
    print(f"all chunks: {total_ms} ms for {done} merges, bound {total_bound_ms} ms by bytes, "
          f"{int(state.stats[hbm_loop.STAT_ROUNDS]) / max(done, 1)} verify rounds/step; "
          f"kernel == twin after every chunk [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
