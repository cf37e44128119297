"""Training CLI (``yabpe-torch-train``).

Counterpart of yabpe_tpu/cli/train_bpe.py: input files, vocab size,
specials, workers, backend, device and mesh shape are flags; a summary is
printed on completion (rich if available, plain otherwise). The flags are
the JAX CLI's, with these changes:

- ``--backend`` takes ``torch`` (the default) or ``numpy`` (the host
  oracle);
- ``--device`` (default ``cuda``) says where the device merge loop runs.

``--ingest-processes`` and ``--count-strategy`` go to the config as in
the JAX CLI: the first acts on the ``regex`` ingest path only (the native
scanner runs on threads), the second on the fallback engines' counts.
:func:`main_tiny_stories` is the console script
``yabpe-torch-train-tiny-stories``. The benchmark's console script,
``yabpe-torch-bench``, is cli/bench.py.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="yabpe-torch-train",
        description="Train a byte-level BPE tokenizer (PyTorch/CUDA merge loop).",
    )
    p.add_argument("inputs", nargs="+", help="UTF-8 corpus files")
    p.add_argument("-o", "--output", default="models/bpe", help="model dir")
    p.add_argument("--vocab-size", type=int, default=5000)
    p.add_argument("--min-frequency", type=int, default=2)
    p.add_argument(
        "--special-token",
        action="append",
        default=None,
        dest="special_tokens",
        help="repeatable; default: <|endoftext|>",
    )
    p.add_argument("--max-workers", type=int, default=8)
    p.add_argument("--chunk-size", type=int, default=20 * 1024 * 1024)
    p.add_argument("--backend", choices=["torch", "numpy"], default="torch")
    p.add_argument("--count-strategy", choices=["dense", "matmul", "auto"], default="dense")
    p.add_argument(
        "--device", default="cuda",
        help="where the device merge loop runs: cuda (default) or cpu",
    )
    p.add_argument("--data-shards", type=int, default=None)
    p.add_argument("--vocab-shards", type=int, default=1)
    p.add_argument("--ingest-processes", action="store_true")
    p.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler Chrome trace (trace.json) and the "
        "training's spans and counters (spans.json) here",
    )
    p.add_argument(
        "--checkpoint-dir",
        default=None,
        help="save mid-training merge checkpoints here and resume from "
        "them on restart",
    )
    p.add_argument(
        "--checkpoint-every-chunks",
        type=int,
        default=4,
        help="checkpoint save cadence, in merge chunks",
    )
    p.add_argument(
        "--engine",
        choices=["auto", "native", "device"],
        default="auto",
        help="merge-loop engine: auto-routed (default), the C++ host "
        "loop, or the device loop",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
    from yabpe_tpu_torch.utils.profiling import maybe_trace

    specials = (
        args.special_tokens if args.special_tokens is not None else ["<|endoftext|>"]
    )
    use_native = {"auto": None, "native": True, "device": False}[args.engine]
    cfg = BBPETrainerConfig(
        vocab_size=args.vocab_size,
        min_frequency=args.min_frequency,
        max_workers=args.max_workers,
        chunk_size_bytes=args.chunk_size,
        special_tokens=specials,
        backend=args.backend,
        count_strategy=args.count_strategy,
        data_shards=args.data_shards,
        vocab_shards=args.vocab_shards,
        ingest_processes=args.ingest_processes,
        align_chunks_to_newline=True,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every_chunks=args.checkpoint_every_chunks,
        use_native_loop=use_native,
        device=args.device,
    )
    trainer = BBPETrainer(cfg)

    t0 = time.perf_counter()
    with maybe_trace(args.profile_dir):
        model = trainer.train([Path(f) for f in args.inputs])
    elapsed = time.perf_counter() - t0
    trainer.save(args.output)

    stats = trainer.last_stats
    summary = {
        "vocab size": len(model.vocab),
        "merges": len(model.merges),
        "special tokens": ", ".join(specials),
        "elapsed": f"{elapsed:.2f}s",
        "throughput": f"{stats.get('bytes_per_second', 0) / 1e6:.2f} MB/s",
        "unique pre-tokens": int(stats.get("unique_pretokens", 0)),
        "merge loop": trainer.route,
        "output": str(args.output),
    }
    _print_summary(summary)
    return 0


def _print_summary(summary: dict) -> None:
    try:
        from rich.console import Console
        from rich.panel import Panel

        lines = "\n".join(f"[bold]{k}[/bold]: {v}" for k, v in summary.items())
        Console().print(Panel(lines, title="BPE training complete"))
    except ImportError:
        print("=== BPE training complete ===")
        for k, v in summary.items():
            print(f"  {k}: {v}")


def main_tiny_stories() -> int:
    """The reference's ``train-tiny-stories`` workload
    (TinyStoriesV2-GPT4-valid.txt, vocab 5000, min_freq 2, 8 workers, 20
    MiB chunks, special <|endoftext|>, output models/tinystories_bpe); a
    corpus path may be passed to override the default (the TinyStories
    file is a large blob not bundled here)."""
    repo = Path(__file__).resolve().parents[3]
    default = repo / "tests" / "data" / "TinyStoriesV2-GPT4-valid.txt"
    data = Path(sys.argv[1]) if len(sys.argv) > 1 else default
    if not data.exists():
        raise FileNotFoundError(f"Data file not found: {data}")
    return main(
        [
            str(data),
            "-o", str(repo / "models" / "tinystories_bpe"),
            "--vocab-size", "5000",
            "--min-frequency", "2",
            "--max-workers", "8",
            "--chunk-size", str(20 * 1024 * 1024),
            "--special-token", "<|endoftext|>",
        ]
    )


if __name__ == "__main__":
    sys.exit(main())
