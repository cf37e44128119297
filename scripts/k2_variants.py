#!/usr/bin/env python3
"""Time variants of K2's launch shape (src/yabpe_tpu_torch/csrc/hbm_loop.cu)
on one GPU, for the design choices its source note states.

    python3 scripts/k2_variants.py [--reps 2]

Each variant is the committed source with one constant or launch attribute
changed (threads per CTA of the step kernel, the cluster size, the load
batch of the verify, programmatic dependent launch off), built with nvcc
next to the committed one into src/yabpe_tpu_torch/_build/variants/. On
the corpus of chip_smoke.py's full-width phase (scripts/gen_corpus.py,
100 MB, lexicon 200,000, seed 7) at vocab 32,000, every variant runs the
whole merge loop, 16 chunks of 2048 steps, from one initial state, --reps
times in turn, and prints the total by CUDA events and, for the first,
a middle and the last chunk, the us per step and the step kernel's own
phase times (HbmState.stats). Every variant's merges must equal the
committed kernel's. Needs one CUDA device; imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SPECIALS = ["<|endoftext|>"]
CHUNK = 2048


def variants(src: str) -> dict[str, str]:
    """Name -> source; each edit must hit the committed source."""

    def edit(old: str, new: str, text: str = src) -> str:
        if old not in text:
            raise SystemExit(f"k2_variants: {old!r} not in csrc/hbm_loop.cu")
        return text.replace(old, new)

    threads = "constexpr int kStepThreads = 256;"
    no_pdl = edit("attrs[1].val.programmaticStreamSerializationAllowed = 1;",
                  "attrs[1].val.programmaticStreamSerializationAllowed = 0;")
    no_pdl = edit("attr.val.programmaticStreamSerializationAllowed = 1;",
                  "attr.val.programmaticStreamSerializationAllowed = 0;", no_pdl)
    return {
        "committed": src,
        "threads_1024": edit(threads, "constexpr int kStepThreads = 1024;"),
        "threads_512": edit(threads, "constexpr int kStepThreads = 512;"),
        "threads_128": edit(threads, "constexpr int kStepThreads = 128;"),
        "cluster_8": edit("const int sizes[2] = {16, 8};", "const int sizes[2] = {8, 8};"),
        "batch_16": edit("constexpr int kBatch = 8;", "constexpr int kBatch = 16;"),
        "no_pdl": no_pdl,
    }


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO / "scripts"))
    from gen_corpus import generate

    from yabpe_tpu_torch.core.vocab import Vocab
    from yabpe_tpu_torch.core.wordtable import WordTable
    from yabpe_tpu_torch.kernels import _build, hbm_loop
    from yabpe_tpu_torch.pretok.ingest import count_pretokens
    from yabpe_tpu_torch.train import hbm_driver

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    out_dir = _build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    for header in _build.CSRC.glob("*.cuh"):
        (out_dir / header.name).write_bytes(header.read_bytes())
    builds = {}
    for name, text in variants((_build.CSRC / "hbm_loop.cu").read_text()).items():
        cu = out_dir / f"hbm_loop_{name}.cu"
        cu.write_text(text)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(cu)]
        builds[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"k2_variants: {name} did not build:\n{log}")
        regs = [line.split(":", 1)[1].strip() for line in log.splitlines() if "registers" in line]
        print(f"{name}: {regs}")

    with tempfile.TemporaryDirectory(prefix="yabpe_variants_") as tmp:
        corpus = Path(tmp) / "corpus.txt"
        generate(str(corpus), 100.0, lexicon_size=200_000)
        table = WordTable.from_counter(count_pretokens(
            [corpus], SPECIALS, chunk_size_bytes=32 << 20, max_workers=8, align_to_newline=True,
        ))
    base = list(Vocab.base(SPECIALS).tokens())
    num = 32000 - len(base)
    starts = list(range(0, num, CHUNK))
    shown = {starts[0], starts[len(starts) // 2], starts[-1]}
    committed = hbm_loop._library()
    want = None
    for rep in range(args.reps):
        for name in builds:
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            for fn in ("yabpe_hbm_merge_chunk", "yabpe_cuda_error_string"):
                getattr(lib, fn).restype = getattr(committed, fn).restype
                getattr(lib, fn).argtypes = getattr(committed, fn).argtypes
            hbm_loop._library = lambda lib=lib: lib
            state = hbm_driver.state_from_numpy(table.words, table.freqs, base, 32000, "cuda",
                                                num_merges=num)
            cells = []
            total_ms = 0.0
            for start in starts:
                stats0 = state.stats.clone()
                ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                ev0.record()
                hbm_loop.hbm_merge_chunk(state, chunk_start=start, chunk_size=CHUNK,
                                         num_merges=num, min_frequency=2)
                ev1.record()
                torch.cuda.synchronize()
                ms = ev0.elapsed_time(ev1)
                total_ms += ms
                if start not in shown:
                    continue
                steps = min(start + CHUNK, num) - start
                d = [(int(x) % 2**32) / steps for x in (state.stats.long() - stats0.long())]
                cells.append(
                    f"chunk {start} {1e3 * ms / steps} us/step, step kernel "
                    f"{d[hbm_loop.STAT_NS_STEP] / 1e3} (bound {d[hbm_loop.STAT_NS_BOUND] / 1e3}, "
                    f"verify {d[hbm_loop.STAT_NS_VERIFY] / 1e3}, compare "
                    f"{d[hbm_loop.STAT_NS_COMPARE] / 1e3}, vocab {d[hbm_loop.STAT_NS_VOCAB] / 1e3}, "
                    f"first barrier {d[hbm_loop.STAT_NS_BARRIER] / 1e3}), "
                    f"{d[hbm_loop.STAT_ROUNDS]} rounds"
                )
            merges = state.merges.cpu()
            if want is None:
                want = merges
            if not torch.equal(merges, want):
                raise SystemExit(f"k2_variants: {name} merges differ from the committed kernel's")
            print(f"rep {rep} {name}: all chunks {total_ms} ms | " + " | ".join(cells)
                  + f" [{card}]", flush=True)
    print(f"every variant's {num} merges equal the committed kernel's [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
