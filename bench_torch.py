#!/usr/bin/env python3
"""Benchmark harness of the PyTorch/CUDA port (src/yabpe_tpu_torch) on one GPU.

    python3 bench_torch.py          (or the console script yabpe-torch-bench)

The port's counterpart of bench.py, in one process. It imports torch,
numpy, yabpe_tpu_torch and scripts/gen_corpus.py, never JAX or the JAX
package. The first line of stdout is the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``); every
leg's numbers go to stderr, each beside that line, one ``bench_leg {...}``
JSON line a leg; the last line of stdout is one JSON object of bench.py's
shape:

    {"metric": "train_bpe_realistic5MB_vocab1000_bytes_per_s",
     "value": N, "unit": "bytes/s", "vs_baseline": N}

``value`` is the headline leg's best end-to-end bytes/s on the port's
default route (``use_native_loop=None``: the merge loop on the card).
``vs_baseline`` is that over the native C++ host loop's best bytes/s on
the same leg in the same run (the JAX package's default route for a
one-device run), so above 1 means the card beats that route. No number
measured on another machine enters the line.

Legs, at bench.py's sizes and configurations (one special
``<|endoftext|>``, 8 ingest workers, newline-aligned chunks):

- ``train_real5m`` (headline): tests/fixtures_gpt2/bench_5M_realistic.txt
  at vocab 1000, ``min_frequency=1``, 1 MiB chunks; a warm-up, then the
  best of 4, on the default route and on the native loop.
- ``train_5m_repeated``: tests/fixtures_gpt2/tinystories_sample_5M.txt,
  the same configuration and timing.
- ``encode_5m``: GPT-2's own 50,000 merges, derived from
  tests/fixtures_gpt2/gpt2_vocab.json; ``encode_batch([text],
  device=True)`` on the 5 MB TinyStories text (a warm-up, then one timed
  call; the ids must equal ``encode``'s) and ``encode`` on the realistic
  5 MB text.
- ``train_100m``: 100 MB of scripts/gen_corpus.py (lexicon 200,000) at
  vocab 32,000, ``min_frequency=2``, 32 MiB chunks, after
  ``warm_heap(1024)``; the native loop and the forced device route
  (``use_native_loop=False, use_hbm_kernel=True``), each a warm-up and
  one timed run.
- ``train_1g``: 1 GB (lexicon 400,000), 64 MiB chunks, after
  ``warm_heap(2048)``; as ``train_100m``.

Each leg logs, per route, seconds with ingest and merge split out, MB/s,
merges, the route the trainer took and peak device memory (reset per leg
and route). Every device run must give merges and vocab equal to the
native loop's. No failure is caught and there is no CPU mode: without a
CUDA device the script exits 1 before it generates anything, and no leg
that fails prints the JSON line. The 100 MB and 1 GB corpora are written
to the temporary directory ($TMPDIR) and reused by later runs.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
for _path in (REPO / "scripts", REPO / "src"):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))

SPECIALS = ["<|endoftext|>"]
FIXTURES = REPO / "tests" / "fixtures_gpt2"
FIVE_M = FIXTURES / "tinystories_sample_5M.txt"
REAL_5M = FIXTURES / "bench_5M_realistic.txt"
METRIC = "train_bpe_realistic5MB_vocab1000_bytes_per_s"


class BenchFailure(AssertionError):
    """A device run disagreed with the native loop or the host encoder."""


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise BenchFailure(msg)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _reset_peak(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(device: str) -> int | None:
    import torch

    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else None


def time_route(label: str, files: list[Path], cfg, *, reps: int, card: str):
    """A warm-up run, then ``reps`` timed runs of one trainer; every run
    must give the warm-up's model. Returns (model, the best run's numbers
    with every run's seconds)."""
    from yabpe_tpu_torch import BBPETrainer

    size = sum(p.stat().st_size for p in files)
    trainer = BBPETrainer(cfg)
    _reset_peak(cfg.device)
    t0 = time.perf_counter()
    want = trainer.train(files)
    warm_s = time.perf_counter() - t0
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model = trainer.train(files)
        dt = time.perf_counter() - t0
        require(model.merges == want.merges and model.vocab == want.vocab,
                f"{label} {trainer.route}: a timed run differs from the warm-up")
        stats = trainer.last_stats
        runs.append({
            "seconds": dt,
            "ingest_seconds": stats["ingest_seconds"],
            "merge_seconds": stats["merge_seconds"],
            "bytes_per_s": size / dt,
            "mb_per_s": size / dt / 1e6,
        })
        log(f"{label} [{trainer.route}]: {dt} s (ingest {stats['ingest_seconds']} s, "
            f"merge {stats['merge_seconds']} s) = {size / dt / 1e6} MB/s, "
            f"{len(model.merges)} merges [{card}]")
    best = max(runs, key=lambda r: r["bytes_per_s"])
    return want, {
        **best,
        "route": trainer.route,
        "merges": len(want.merges),
        "unique_pretokens": int(trainer.last_stats["unique_pretokens"]),
        "peak_device_bytes": _peak(cfg.device),
        "warmup_seconds": warm_s,
        "seconds_each": [r["seconds"] for r in runs],
    }


def _leg_line(leg: dict) -> None:
    log("bench_leg " + json.dumps(leg))


def native_vs_device(label: str, corpus: Path, kw: dict, device_kw: dict, *,
                     reps: int, card: str) -> dict:
    """One leg: the native host loop, then the device route set by
    ``device_kw``, on one config; the device's merges and vocab must
    equal the native loop's."""
    from yabpe_tpu_torch import BBPETrainerConfig

    native_model, native = time_route(
        label, [corpus], BBPETrainerConfig(**kw, use_native_loop=True), reps=reps, card=card
    )
    model, dev = time_route(
        label, [corpus], BBPETrainerConfig(**kw, **device_kw), reps=reps, card=card
    )
    require(model.merges == native_model.merges,
            f"{label}: device merges differ from the native loop")
    require(model.vocab == native_model.vocab,
            f"{label}: device vocab differs from the native loop")
    leg = {
        "leg": label, "corpus": corpus.name, "bytes": corpus.stat().st_size,
        "vocab_size": kw["vocab_size"], "card": card,
        "device": dev, "native": native,
        "device_over_native": dev["bytes_per_s"] / native["bytes_per_s"],
    }
    _leg_line(leg)
    return leg


def train_leg(path: Path, label: str, *, vocab_size: int = 1000, reps: int = 4,
              device: str = "cuda", card: str = "") -> dict:
    """bench.py's ``_train_bps``: the default route (``use_native_loop=
    None``, on ``device``) against the native host loop, each a warm-up
    and the best of ``reps``."""
    kw = dict(
        vocab_size=vocab_size, min_frequency=1, max_workers=8,
        chunk_size_bytes=1 << 20, special_tokens=SPECIALS,
        align_chunks_to_newline=True, device=device,
    )
    return native_vs_device(label, path, kw, {}, reps=reps, card=card)


def bench_corpus(name: str, size_mb: float, lexicon: int) -> Path:
    """scripts/gen_corpus.py's corpus in the temporary directory, written
    once and reused while it is whole."""
    from gen_corpus import generate

    path = Path(tempfile.gettempdir()) / name
    if not path.exists() or path.stat().st_size < int(size_mb * 1024 * 1024):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):  # stdout: the card and result lines
            generate(str(path), size_mb, lexicon_size=lexicon)
        log(f"{name}: generated in {time.perf_counter() - t0} s (host)")
    return path


def big_leg(label: str, corpus: Path, *, chunk_mb: int, heap_mb: int,
            device: str = "cuda", card: str = "") -> dict:
    """bench.py's 100 MB and 1 GB legs at vocab 32,000: the native loop
    (the JAX package's default route) against the forced device route
    (K2), each a warm-up and one timed run."""
    from yabpe_tpu_torch.utils import hostmem

    t0 = time.perf_counter()
    warmed = hostmem.warm_heap(heap_mb)
    log(f"{label}: warm_heap({heap_mb}) faulted {warmed} bytes in {time.perf_counter() - t0} s")
    kw = dict(
        vocab_size=32000, min_frequency=2, max_workers=8,
        chunk_size_bytes=chunk_mb << 20, special_tokens=SPECIALS,
        align_chunks_to_newline=True, device=device,
    )
    return native_vs_device(label, corpus, kw, dict(use_native_loop=False, use_hbm_kernel=True),
                            reps=1, card=card)


def encode_leg(*, device: str = "cuda", card: str = "") -> dict:
    """bench.py's ``bench_encode_5m`` with GPT-2's derived model:
    ``encode_batch([text], device=True)`` on the 5 MB TinyStories text
    (ids equal to ``encode``'s), then ``encode`` on the realistic 5 MB
    text, each after a warm-up call."""
    from yabpe_tpu_torch import BBPETokenizer
    from yabpe_tpu_torch.io import gpt2

    t0 = time.perf_counter()
    vocab = gpt2.load_gpt2_vocab(FIXTURES / "gpt2_vocab.json")
    merges = gpt2.derive_gpt2_merges(vocab)
    derive_s = time.perf_counter() - t0
    tok = BBPETokenizer(vocab, merges, SPECIALS, compute_device=device)
    text = FIVE_M.read_text(encoding="utf-8")
    nbytes = len(text.encode("utf-8"))
    _reset_peak(device)
    t0 = time.perf_counter()
    tok.encode_batch([text], device=True)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    [ids] = tok.encode_batch([text], device=True)
    batch_s = time.perf_counter() - t0
    peak = _peak(device)
    t0 = time.perf_counter()
    want = tok.encode(text)
    host_s = time.perf_counter() - t0
    require(ids == want, "encode_5m: encode_batch(device=True) differs from encode")
    real = REAL_5M.read_text(encoding="utf-8")
    nreal = len(real.encode("utf-8"))
    tok.encode(real)
    t0 = time.perf_counter()
    ids_r = tok.encode(real)
    real_s = time.perf_counter() - t0
    log(f"encode_5m_repeated (device batch): {batch_s} s = {nbytes / batch_s / 1e6} MB/s "
        f"warm, {nbytes / cold_s / 1e6} MB/s first call, {len(ids)} tokens; host encode "
        f"{nbytes / host_s / 1e6} MB/s [{card}]")
    log(f"encode_real5m (host): {real_s} s = {nreal / real_s / 1e6} MB/s, "
        f"{len(ids_r)} tokens [{card}]")
    leg = {
        "leg": "encode_5m", "card": card,
        "gpt2_derive_seconds": derive_s,
        "batch_device": {
            "bytes": nbytes, "tokens": len(ids), "seconds": batch_s,
            "mb_per_s": nbytes / batch_s / 1e6, "first_call_seconds": cold_s,
            "peak_device_bytes": peak,
        },
        "host_encode_repeated": {"seconds": host_s, "mb_per_s": nbytes / host_s / 1e6},
        "host_encode_real": {
            "bytes": nreal, "tokens": len(ids_r), "seconds": real_s,
            "mb_per_s": nreal / real_s / 1e6,
        },
    }
    _leg_line(leg)
    return leg


def result_line(headline: dict) -> dict:
    """bench.py's last line from the headline leg: the default route's
    best bytes/s, and that over the native loop's on the same leg."""
    value = headline["device"]["bytes_per_s"]
    return {
        "metric": METRIC,
        "value": round(value, 1),
        "unit": "bytes/s",
        "vs_baseline": round(value / headline["native"]["bytes_per_s"], 3),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device (the harness has no CPU mode)", file=sys.stderr)
        return 1
    from yabpe_tpu_torch.utils import hostmem

    t_all = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} [{card}]")
    t0 = time.perf_counter()
    warmed = hostmem.warm_heap(512)
    log(f"heap warm: {warmed} bytes in {time.perf_counter() - t0} s")

    headline = train_leg(REAL_5M, "train_real5m", card=card)
    train_leg(FIVE_M, "train_5m_repeated", card=card)
    encode_leg(card=card)
    big_leg("train_100m", bench_corpus("yabpe_bench_100M.txt", 100.0, 200_000),
            chunk_mb=32, heap_mb=1024, card=card)
    big_leg("train_1g", bench_corpus("yabpe_bench_1G.txt", 1024.0, 400_000),
            chunk_mb=64, heap_mb=2048, card=card)
    log(f"total: {time.perf_counter() - t_all} s [{card}]")
    print(json.dumps(result_line(headline)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
