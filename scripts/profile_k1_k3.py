#!/usr/bin/env python3
"""Time K1 (csrc/fused_loop.cu) and K3 (csrc/replay_emit.cu) against their
first designs (csrc/*_v1.cu) on one GPU, with K1's phase timer.

    python3 scripts/profile_k1_k3.py [--reps 2] [--only k1|k1wide|k3]

K1, from one initial state each, every chunk timed by CUDA events, the
merges of every variant equal to the committed launch's:
  - the 5 MB TinyStories fixture at vocab 1000 (min_frequency 1, chunks of
    256; 512 rows) and tests/data/large.txt at vocab 1024 (min_frequency
    2, chunks of 200): us per step by chunk, and the phase timer's split
    of a step (select, rank search, vocab, first barrier, apply, second
    barrier) and verify rounds;
  - the committed cluster size against 1, 2, 4, 8 and 16 CTAs forced,
    builds with 256- and 1024-thread CTAs (8 and 32 select stripes; the
    committed CTAs have 512 threads, 16 stripes), and the first design,
    on the TinyStories run and on the top of K1's admission:
    scripts/gen_corpus.py at 1 MB with a 12,000-word lexicon (26,624 rows
    of width 16) at vocab 500, min_frequency 2;
  - words past 64 symbols: tests/data/large.txt plus 2,000 lines of
    scripts/wide_lines.py (seed 0; 1,024 rows of width 304) at vocab 1024
    (the token bytes in device memory; chunks of 200) and at vocab 320
    (in shared memory; chunks of 32), min_frequency 2: us per step by
    chunk and the phase split, and against the wide apply's earlier forms
    (the first design takes at most 64 symbols): the whole changed window,
    as first built, and the changed pairs alone read one symbol a load.
    ``--only k1wide`` runs these alone.
K3, on the 4 shards of chip_smoke.py's 100 MB table (scripts/gen_corpus.py,
lexicon 200,000, seed 7) with K2's first 16 merges as the chain, cps 64:
each shard's device time per call (5 calls queued behind a spin kernel)
and host-paced time, the first design's, and a build that reserves each
word's slots with its own atomicAdd (the committed kernel reserves a
warp's with one), the results equal. Variant builds are the committed sources with one edit
each, built next to them into src/yabpe_tpu_torch/_build/variants/.

Needs one CUDA device; imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SPECIALS = ["<|endoftext|>"]

#: K3's reservation by warp (committed) and by word (a variant).
K3_PER_WORD = """      const yabpe::RegsMerge m = yabpe::plan_regs<WB>(w, a, s_chain[3 * j + 1]);
      if (m.take == 0) continue;
      const size_t base =
          static_cast<size_t>(j == 0 ? 0 : cps0 + (j - 1) * cps) * kLane;
      yabpe::LogSink sink{log_l + base, log_r + base, log_w + base,
                          step_capacity(j, cps, cps0), &cursor[j], nullptr, 0};"""
K3_PER_WARP = """      const yabpe::RegsMerge m = yabpe::plan_regs<WB>(w, a, s_chain[3 * j + 1]);
      if (__ballot_sync(act, m.take != 0) == 0) continue;
      const int need = m.cells();
      int incl = need;  // scan of the warp's cell counts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(act, incl, o);
        if (lane >= o) incl += t;
      }
      const int top = 31 - __clz(act);
      int run = lane == top ? atomicAdd(&cursor[j], incl) : 0;
      run = __shfl_sync(act, run, top);
      if (m.take == 0) continue;
      const size_t base =
          static_cast<size_t>(j == 0 ? 0 : cps0 + (j - 1) * cps) * kLane;
      yabpe::LogSink sink{log_l + base, log_r + base, log_w + base,
                          step_capacity(j, cps, cps0), nullptr, nullptr,
                          run + incl - need};"""


#: K1's wide apply as first built: it hands the table the whole changed
#: window, the cells of merge_word in its order, one load a symbol, after
#: word_has_pair (a variant; --only k1wide).
WIDE_WHOLE_WINDOW = """template <class Sink>
__device__ __forceinline__ void merge_word_window(int* w, int W, int f, int a,
                                                  int b, int c, Sink& sink) {
  int n = 0, first = -1, last = -1, takes = 0;
  bool prev = false;
  for (; n < W && w[n] >= 0; ++n) {
    const bool t = !prev && n + 1 < W && w[n] == a && w[n + 1] == b;
    if (t) {
      if (first < 0) first = n;
      last = n;
      ++takes;
    }
    prev = t;
  }
  if (takes == 0) return;
  const int m = n - takes;
  const int lo = max(first - 1, 0);
  const int old_hi = min(last + 1, n - 2);
  const int new_hi = min(last - (takes - 1), m - 2);
  for (int k = lo; k <= old_hi; ++k) sink.sub(w[k], w[k + 1], f);
  sink.fence();
  int q = first;
  for (int k = first; k < n;) {
    if (k + 1 < n && w[k] == a && w[k + 1] == b) {
      w[q++] = c;
      k += 2;
    } else {
      w[q++] = w[k++];
    }
  }
  for (int k = m; k < n; ++k) w[k] = -1;
  for (int k = lo; k <= new_hi; ++k) sink.add(w[k], w[k + 1], f);
}

"""
#: The committed apply's cells (only the changed pairs), one load a
#: symbol, after word_has_pair (a variant; --only k1wide).
WIDE_CHANGED_UNBATCHED = """template <class Sink>
__device__ __forceinline__ void merge_word_changed(int* w, int W, int f, int a,
                                                   int b, int c, Sink& sink) {
  int n = 0, first = -1;
  bool t2 = false, t1 = false;
  int prev = -1, cur = W > 0 ? w[0] : -1;
  for (; n < W && cur >= 0; ++n) {
    const int next = n + 1 < W ? w[n + 1] : -1;
    const bool t0 = !t1 && cur == a && next == b;
    if (t0 && first < 0) first = n;
    if (n > 0 && (t2 || t1 || t0)) sink.sub(prev, cur, f);
    t2 = t1;
    t1 = t0;
    prev = cur;
    cur = next;
  }
  if (first < 0) return;
  sink.fence();
  int q = first;
  int left = first > 0 ? w[first - 1] : -1;
  bool left_merged = false;
  for (int k = first; k < n;) {
    const bool take = k + 1 < n && w[k] == a && w[k + 1] == b;
    const int sym = take ? c : w[k];
    k += take ? 2 : 1;
    if (left >= 0 && (take || left_merged)) sink.add(left, sym, f);
    w[q++] = sym;
    left = sym;
    left_merged = take;
  }
  for (int k = q; k < n; ++k) w[k] = -1;
}

"""
REGS_ANCHOR = "// A merge of (a, b) in a word held in registers"
WIDE_CALL = """      if constexpr (kWide)
        yabpe::merge_word_wide(w, W, freqs[i], a, b, c, sink);
      else if (yabpe::word_has_pair(w, W, a, b))
        yabpe::merge_word(w, W, freqs[i], a, b, c, sink);"""
WIDE_CALL_GUARDED = """      if (yabpe::word_has_pair(w, W, a, b)) {
        if constexpr (kWide)
          yabpe::{fn}(w, W, freqs[i], a, b, c, sink);
        else
          yabpe::merge_word(w, W, freqs[i], a, b, c, sink);
      }"""


def build_variant(name: str, source: str, edits: list[tuple[str, str, str]]):
    """Build csrc/<source>.cu with ``edits`` (file, old, new), each of
    which must hit the committed text, into _build/variants/; returns the
    loaded library."""
    import ctypes

    from yabpe_tpu_torch.kernels import _build

    out_dir = _build.BUILD_DIR.parent / "variants" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    files = {p.name: p.read_text() for p in _build.CSRC.glob("*.cuh")}
    files[f"{source}.cu"] = (_build.CSRC / f"{source}.cu").read_text()
    for file, old, new in edits:
        if old not in files[file]:
            raise SystemExit(f"profile_k1_k3: {name}: {old[:60]!r} not in {file}")
        files[file] = files[file].replace(old, new)
    for file, text in files.items():
        (out_dir / file).write_text(text)
    lib_path = out_dir / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(out_dir / f"{source}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"profile_k1_k3: {name} did not build:\n{proc.stdout}{proc.stderr}")
    print(f"{name}: {[l.split(':', 1)[1].strip() for l in proc.stderr.splitlines() if 'registers' in l]}")
    return ctypes.CDLL(str(lib_path))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--only", choices=["k1", "k1wide", "k3"], default=None,
                        help="profile one kernel, or K1's wide tables alone (default: both)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_k1_k3: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO / "scripts"))
    sys.path.insert(0, str(REPO))
    from chip_smoke import per_call_ms, v1_fused_chunk, v1_replay
    from gen_corpus import generate
    from wide_lines import wide_lines

    from yabpe_tpu_torch.core.vocab import Vocab
    from yabpe_tpu_torch.core.wordtable import WordTable
    from yabpe_tpu_torch.dist.hbm_sharded import log_plan, shard_rows
    from yabpe_tpu_torch.kernels import fused_loop, hbm_loop, replay_emit
    from yabpe_tpu_torch.pretok.ingest import count_pretokens
    from yabpe_tpu_torch.train import hbm_driver
    from yabpe_tpu_torch.train.fused_driver import fused_state_from_numpy

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    base = list(Vocab.base(SPECIALS).tokens())
    lib = fused_loop._library()
    fused_loop._prepare(torch.cuda.current_device())

    k1_threads = {}
    for threads in (256, 1024) if args.only in (None, "k1") else ():
        name = f"fused_loop_threads_{threads}"
        k1 = build_variant(name, "fused_loop", [
            ("fused_loop.cu", "constexpr int kThreads = 512;", f"constexpr int kThreads = {threads};"),
        ])
        k1.yabpe_fused_merge_chunk.argtypes = lib.yabpe_fused_merge_chunk.argtypes
        k1.yabpe_fused_cluster_ctas.argtypes = lib.yabpe_fused_cluster_ctas.argtypes
        if k1.yabpe_fused_prepare() != 0:
            raise SystemExit(f"profile_k1_k3: {name} set-up failed")
        k1_threads[threads] = k1
    k1_wide = {}  # the wide apply's earlier forms
    forms = (("whole_window", "merge_word_window", WIDE_WHOLE_WINDOW),
             ("changed_unbatched", "merge_word_changed", WIDE_CHANGED_UNBATCHED))
    for name, fn, text in forms if args.only in (None, "k1", "k1wide") else ():
        k1 = build_variant(f"fused_loop_{name}", "fused_loop", [
            ("merge_apply.cuh", REGS_ANCHOR, text + REGS_ANCHOR),
            ("fused_loop.cu", WIDE_CALL, WIDE_CALL_GUARDED.replace("{fn}", fn)),
        ])
        k1.yabpe_fused_merge_chunk.argtypes = lib.yabpe_fused_merge_chunk.argtypes
        k1.yabpe_fused_cluster_ctas.argtypes = lib.yabpe_fused_cluster_ctas.argtypes
        if k1.yabpe_fused_prepare() != 0:
            raise SystemExit(f"profile_k1_k3: fused_loop_{name} set-up failed")
        k1_wide[name] = k1
    if args.only in (None, "k3"):
        k3_word = build_variant("replay_emit_per_word", "replay_emit", [
            ("replay_emit.cu", K3_PER_WARP, K3_PER_WORD),
            ("merge_apply.cuh", "    if (slot + n > cap) *ok = 0;",
             "    if (slot + n > cap && ok != nullptr) *ok = 0;"),
        ])
        k3_word.yabpe_replay_emit_chunk.argtypes = (
            replay_emit._library().yabpe_replay_emit_chunk.argtypes
        )

    def forced(ctas, lib=lib):
        """fused_merge_chunk with the cluster size forced to ``ctas``."""

        def run(state, *, chunk_start, chunk_size, num_merges, min_frequency):
            n, w = state.words.shape
            v, byte_width = state.token_bytes.shape
            layout = fused_loop.TOKEN_LAYOUTS.index(fused_loop.token_layout(v, byte_width))
            rc = lib.yabpe_fused_merge_chunk(
                *(t.data_ptr() for t in state.tensors()), None, n, w, v, byte_width,
                chunk_start, min(chunk_start + chunk_size, num_merges), min_frequency, ctas,
                layout, torch.cuda.current_stream().cuda_stream,
            )
            if rc != 0:
                raise RuntimeError(f"fused_merge_chunk with {ctas} CTAs: CUDA error {rc}")

        return run

    def run_all(fn, table, vocab_cap, min_freq, chunk, phases=None):
        """(total ms, ms by chunk, steps by chunk, merges) of a whole run."""
        num = vocab_cap - len(base)
        state = fused_state_from_numpy(table.words, table.freqs, base, vocab_cap, "cuda",
                                       num_merges=num)
        fn(state.clone(), chunk_start=0, chunk_size=1, num_merges=num, min_frequency=min_freq)
        ms, steps = [], []
        for start in range(0, num, chunk):
            done = int(state.scalars[2])
            kw = dict(chunk_start=start, chunk_size=chunk, num_merges=num, min_frequency=min_freq)
            if phases is not None:
                kw["phases"] = phases
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            ev0.record()
            fn(state, **kw)
            ev1.record()
            torch.cuda.synchronize()
            ms.append(ev0.elapsed_time(ev1))
            steps.append(int(state.scalars[2]) - done)
            if int(state.scalars[1]):
                break
        return sum(ms), ms, steps, state.merges.cpu()

    with tempfile.TemporaryDirectory(prefix="yabpe_k1k3_") as tmp:
        top = Path(tmp) / "top.txt"
        generate(str(top), 1.0, lexicon_size=12_000)
        tables = {
            "tinystories_v1000": (WordTable.from_counter(count_pretokens(
                [REPO / "tests" / "fixtures_gpt2" / "tinystories_sample_5M.txt"], SPECIALS,
                max_workers=1)), 1000, 1, 256),
            "large_v1024": (WordTable.from_counter(count_pretokens(
                [REPO / "tests" / "data" / "large.txt"], SPECIALS)), 1024, 2, 200),
            "top_of_admission_v500": (WordTable.from_counter(count_pretokens(
                [top], SPECIALS, max_workers=8)), 500, 2, 256),
        }
        wide = Path(tmp) / "wide.txt"
        wide.write_text((REPO / "tests" / "data" / "large.txt").read_text(encoding="utf-8") + "\n"
                        + "\n".join(wide_lines(2000, 0)) + "\n", encoding="utf-8")
        wide_table = WordTable.from_counter(count_pretokens([wide], SPECIALS))
        tables["wide_large_v1024"] = (wide_table, 1024, 2, 200)
        tables["wide_large_v320"] = (wide_table, 320, 2, 32)
        if args.only == "k3":
            tables = {}
        elif args.only == "k1wide":
            tables = {k: v for k, v in tables.items() if k.startswith("wide")}

    # ---- K1: the committed launch, its phases, and the variants
    for label, (table, vocab_cap, min_freq, chunk) in tables.items():
        n, w = table.words.shape
        auto = fused_loop.cluster_ctas(n, vocab_cap, hbm_driver.byte_width(table.width, base),
                                       width=w)
        phases = torch.zeros(len(fused_loop.PHASES), dtype=torch.int64, device="cuda")
        total, ms, steps, want = run_all(fused_loop.fused_merge_chunk, table, vocab_cap,
                                         min_freq, chunk, phases)
        ph = dict(zip(fused_loop.PHASES, phases.tolist()))
        per = {k: ph[k] / max(ph["steps"], 1) / 1e3 for k in fused_loop.PHASES[2:]}
        print(f"K1 {label}: N={n} W={w} V={vocab_cap} cluster_ctas={auto} all_chunks_ms={total} "
              f"us_per_step_by_chunk={[1e3 * t / max(k, 1) for t, k in zip(ms, steps)]} "
              f"steps={sum(steps)} verify_rounds_per_step={ph['rounds'] / max(ph['steps'], 1)} "
              f"phase_us_per_step={per} [{card}]", flush=True)
        if label == "large_v1024":
            continue
        byte_width = hbm_driver.byte_width(table.width, base)
        layout = fused_loop.TOKEN_LAYOUTS.index(fused_loop.token_layout(vocab_cap, byte_width))
        if label.startswith("wide"):
            variants = {"committed": fused_loop.fused_merge_chunk}
            variants.update({name: forced(k1.yabpe_fused_cluster_ctas(
                n, w, vocab_cap, byte_width, layout), k1) for name, k1 in k1_wide.items()})
        else:
            variants = {"committed": fused_loop.fused_merge_chunk, "first_design": v1_fused_chunk}
        for threads, k1 in k1_threads.items() if not label.startswith("wide") else ():
            variants[f"threads_{threads}"] = forced(k1.yabpe_fused_cluster_ctas(
                n, w, vocab_cap, byte_width, layout), k1)
        if not label.startswith("wide"):
            variants.update({f"ctas_{c}": forced(c) for c in (1, 2, 4, 8, 16) if c != auto})
        for rep in range(args.reps):
            for name, fn in variants.items():
                total, ms, steps, merges = run_all(fn, table, vocab_cap, min_freq, chunk)
                if not torch.equal(merges, want):
                    raise SystemExit(f"profile_k1_k3: {label} {name} merges differ")
                print(f"K1 {label} rep {rep} {name}: all_chunks_ms={total} "
                      f"us_per_step={1e3 * total / max(sum(steps), 1)} "
                      f"us_per_step_by_chunk={[1e3 * t / max(k, 1) for t, k in zip(ms, steps)]} "
                      f"[{card}]", flush=True)

    # ---- K3 on the 4 shards of the 100 MB table
    if args.only in ("k1", "k1wide"):
        return 0
    with tempfile.TemporaryDirectory(prefix="yabpe_k1k3_") as tmp:
        corpus = Path(tmp) / "corpus_100M.txt"
        generate(str(corpus), 100.0, lexicon_size=200_000)
        table = WordTable.from_counter(count_pretokens(
            [corpus], SPECIALS, chunk_size_bytes=32 << 20, max_workers=8, align_to_newline=True,
        ))
    state = hbm_driver.state_from_numpy(table.words, table.freqs, base, 32000, "cuda",
                                        num_merges=16)
    hbm_loop.hbm_merge_chunk(state, chunk_start=0, chunk_size=16, num_merges=16, min_frequency=2)
    chain = state.merges[:16].contiguous()
    del state
    n = table.words.shape[0]
    cps = 64
    cps0 = log_plan(n, table.width, 4, 16, cps)[1]
    kw = dict(cps=cps, cps0=cps0)
    for d, (lo, hi) in enumerate(shard_rows(n, 4)):
        words = torch.tensor(table.words[lo:hi], dtype=torch.int32, device="cuda")
        freqs = torch.tensor(table.freqs[lo:hi], dtype=torch.int32, device="cuda")
        call = lambda: replay_emit.replay_emit_chunk(words, freqs, chain, **kw)  # noqa: E731
        call_v1 = lambda: v1_replay(words, freqs, chain, **kw)  # noqa: E731

        def call_word():
            out = replay_emit._outputs(words, 16, cps, cps0)
            rc = k3_word.yabpe_replay_emit_chunk(
                words.data_ptr(), freqs.data_ptr(), chain.data_ptr(),
                *(t.data_ptr() for t in out), hi - lo, words.shape[1], 16, cps, cps0,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"profile_k1_k3: replay_emit_per_word: CUDA error {rc}")
            return (*out[:4], out[4][16:], out[4][:16])

        call()
        call_v1()
        call_word()
        twin = replay_emit.replay_emit_chunk_reference(words, freqs, chain, **kw)
        for rep in range(args.reps):
            ms, out = per_call_ms(call, 5, ahead=True)
            old_ms, old = per_call_ms(call_v1, 5, ahead=True)
            word_ms, word = per_call_ms(call_word, 5, ahead=True)
            paced = per_call_ms(call, 5, ahead=False)[0]
            for got in (out, word):
                if not (torch.equal(got[0], twin[0]) and torch.equal(got[4], twin[4])
                        and torch.equal(got[5], twin[5])):
                    raise SystemExit(f"profile_k1_k3: K3 shard {d} differs from the twin")
            if not torch.equal(old[0], twin[0]):
                raise SystemExit(f"profile_k1_k3: K3's first design differs on shard {d}")
            print(f"K3 shard {d} rep {rep}: N={hi - lo} cells={int(twin[5].sum())} "
                  f"device_ms={ms} per_word_device_ms={word_ms} first_design_device_ms={old_ms} "
                  f"host_paced_ms={paced} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
