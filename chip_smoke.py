#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/yabpe_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or /usr/local/cuda) and g++; it
exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. It imports nothing of JAX or of the JAX
package. Phases, none of whose failures is caught:

1. card: the device's name and power limit;
2. build: nvcc builds csrc/hbm_loop.cu (K2), csrc/fused_loop.cu (K1),
   csrc/replay_emit.cu (K3) and the first designs of K1 and K3
   (csrc/*_v1.cu, timed beside the redesigns as old_ms) for sm_90a, and
   g++ the native library, all side by side; prints the build time and
   the ptxas register and shared-memory lines;
3. K2 against its twin: one 2048-step chunk of the large-vocabulary
   kernel and of its plain twin from one state, on the 5 MB realistic
   fixture at vocab 4096; merges, words, counts and the vocab tensors
   must be exactly equal and row_max at least each row's max; prints the
   kernel's us per step, the select's verify rounds and rows verified per
   step, and its cluster size;
4. K2 at full width: a 100 MB corpus from scripts/gen_corpus.py (lexicon
   200,000, seed 7) at vocab 32,000, the configuration of bench.py's
   bench_train_100m_hbm:
   a. K2 against its twin again, for the first chunk at these shapes,
      timed by CUDA events, with the bytes the chunk needs at least, the
      us per step and the verify rounds per step;
   b. the large-vocabulary main path: BBPETrainer(...).train(files) on
      the card, with K2's launch count zeroed before and read after;
   c. the same corpus through the native C++ host loop: the merges must
      be byte-identical;
   d. save() both models and load_model() them back: the files must be
      byte-identical and the vocab must round-trip;
5. K1 against its twin, chunk by chunk from one state: tests/data/
   large.txt at vocab 1024, min_frequency 2, in chunks of 200 steps (a
   chunk that does not divide the 767 merges), then the 5 MB TinyStories
   fixture at vocab 1000, min_frequency 1, in chunks of 256; after every
   chunk the whole state but row_max must be exactly equal and row_max at
   least each row's max. The process's first K1 launch is timed apart
   first, split into the library load, the function attributes, the
   cluster-size query and the launch itself, beside the first design's
   library load and first call; then every chunk is timed by
   CUDA events (us per step early and late), the first one beside the
   bytes it needs at least and the first design's time for it; the
   TinyStories us per step is printed beside the 8.3-9.1 us that
   PERF.md §6 records for the narrow kernel before it took wide words;
5w. K1 on words past 64 symbols: tests/data/large.txt plus 2,000 lines of
   65-300-byte pre-tokens (scripts/wide_lines.py, seed 0), a table of
   1,024 rows x 304, against the twin chunk by chunk as in phase 5, at
   vocab 1024 (the token bytes in device memory: they do not fit CTA 0's
   shared memory) and at vocab 320 in both layouts (shared, then the
   global one forced); prints the kernel's ms per chunk and us per step,
   the twin's ms and the bound by bytes from the twin's tally. Then the
   trainer on TinyStories 5 MB plus 2,000 such lines at vocab 1000
   (min_frequency 1, one special) with the launch counts zeroed: route K1,
   K1 launched and no other kernel, merges and vocab equal to the native
   loop's;
6. the small-vocabulary main path: the settings of the JAX package's
   snapshot tests/_snapshots/test_train_bpe_special_tokens.pkl
   (TinyStories 5 MB, vocab 1000) through BBPETrainer(...).train(files)
   on the card, with both kernels' launch counts zeroed before and read
   after: K1 must have run and K2 not; the merges and vocab must equal
   the snapshot and the native host loop's;
7. the flow's second half: save() and BBPETokenizer.from_file(); decode
   (encode(text)) must give back the first 1 MB of the fixture and the
   inline snippets of tests/fixtures_gpt2/golden_encode/gpt2_golden.json,
   and on the snippets the native encoder's ids must equal the plain
   per-word encoder's over the native scanner's pre-tokens;
8. the data-sharded flow on phase 4's 100 MB table at vocab 32,000, in 4
   word shards cut as dist/hbm_sharded.py cuts them:
   a. the replay kernel K3 (csrc/replay_emit.cu) against its twin on every
      shard from one state, with phase 4b's first 16 merges as the chain,
      cps 64 and the loop's cps0, the kernel's outputs allocated over
      memory filled with ids >= 0: the words, the ok flags, the cursors and
      every step's net delta (read up to the cursor, summed by cell on the
      card) must be exactly equal, and each call must be one launch and one
      memset; each call timed by CUDA events beside the bytes it must move
      and the first design's time for it;
   b. the sharded main path: BBPETrainer(...).train(files) with
      data_shards=4 and use_hbm_kernel=True on the card, with K3's call,
      launch and memset counts zeroed before and read after; the merges
      and vocab must equal phase 4c's native loop; prints the merge
      seconds, epochs, commits per epoch, fallbacks, peak device memory and
      the epochs' split into select / replay / validate / commit;
9. checkpoint and resume, and words past 64 symbols:
   a. K2's replay mode against its twin: from phase 3's starting state
      (5 MB realistic fixture, vocab 4096) with phase 3's first 1,000
      merges preloaded, one 2048-step chunk with replay_until = 1,000 on
      the kernel and on the twin; merges, words, counts and the vocab
      tensors must be exactly equal, row_max at least each row's max, and
      the merges phase 3's; then, on another copy, the 1,000 replayed
      steps and the 1,048 live ones as two calls timed by CUDA events
      (us per step each, the replayed chunk's bound by bytes, and the
      kernel's own replay timer);
   b. the slice at full width: phase 4's 100 MB corpus at vocab 32,000
      through BBPETrainer(..., checkpoint_dir=tmp,
      checkpoint_every_chunks=1) on the card; the saved record cut to
      step 10,000 (4 x 2048 + 1,808, not on a chunk boundary), then the
      same training again from it, with K2's launch count zeroed before:
      K2 replays 10,000 steps and trains the rest; the merges and vocab of
      both runs must be byte-identical to phase 4c's native loop; prints
      both runs' merge seconds and the replayed steps;
   c. words past 64 symbols on the card: the 5 MB realistic fixture plus
      2,000 lines of 65-300-byte pre-tokens (scripts/wide_lines.py, seed
      0) at vocab 4,096, min_frequency 2 (the bigvocab engine);
      tests/data/large.txt plus 2,000 such lines (seed 0; 1,024 rows x
      304) at vocab 1024, min_frequency 2, through K1 (which must launch),
      and again with use_fused_kernel=False (the incremental engine); and
      large.txt plus 2,000 lines of seed 1 (1,027 words, 2,048 rows, past
      K1's admission at 1024, as in the JAX trainer) on the incremental
      engine; each with the K1, K2 and K3 launch counts zeroed before and
      read after (on an engine all 0); the merges and vocab must equal the
      native loop's; prints the merge seconds and the us per merge. Cuts:
      vocab 4,096, not 32,000, because the engines hold no kernel of
      their own and are plain torch ops; the chip time goes to 9b;
10. file and device encoding (tok/parallel_encode.py, tok/device_encode.py;
    plain torch on the card, no kernel of this repository):
   a. the merge-rank scan on the card against the same function on the
      CPU, on the tiles of the first 4 MiB chunk of phase 4's corpus with
      the 32,000-token model: the outputs must be equal arrays; prints the
      tiles' shapes, their scan iterations and host syncs, each tile's time
      by CUDA events as the host issues it, and again queued ahead of the
      device with no test for work (the device's own time, which must give
      the same rows), beside the bytes' bound;
   b. full width: phase 4's 100 MB corpus with the 32,000-token model,
      <|endoftext|> as the special token: encode_file(path, device=True)
      on the card, encode_file(path) on the host (native threads), and
      encode_file(path, device=True) again with the word cache warm (no
      new unique word); all three must equal the whole text's encode as
      int32, which must decode back to the file; then a fresh encoder that
      waits for each chunk's scans before the next chunk's native scan
      (the same ids): the device work it waits for is what the cold run
      overlapped, and its extra time what the overlap saved; prints MB/s
      of each run, unique words, tiles, iterations and host syncs per tile,
      the scans' time on the device timeline by CUDA events, the host's
      seconds in the native scans, the scans' dispatch and the readbacks,
      and peak device memory;
   c. batches: phase 7's vocab-1000 model on the 5 MB TinyStories text as
      one batch and on the golden snippets: encode_batch(device=True),
      cold and warm, and encode_batch(device=True, data_shards=4) must
      equal the host's encode_batch; prints MB/s. Each device encoder must
      exist (no host fallback), have run tiles and hold its tables on cuda;
11. the distributed layer (dist/sharded.py, dist/speculative.py,
    dist/ingest.py, dist/mesh.py; plain torch, no kernel of its own) and
    the CLI, each part with every kernel's launch count zeroed before and
    read after:
   a. the slice at full width: phase 4's 100 MB corpus at vocab 32,000 in
      2 data x 2 vocab shards on the card (two [16,000 x 32,000] count
      slabs), resumed from a checkpoint of the native loop's first 29,743
      merges written by hand, so that the last 2,000 merges run live at
      the full table (the depth cut, to keep the phase short); the merges
      and vocab must equal phase 4c's native loop and no kernel may run;
      prints the resume (replay) and slab-init seconds, ms and host syncs
      per merge, and peak device memory;
   b. the 5 MB realistic fixture at vocab 2,048, min_frequency 2, 4 data
      shards, per step from step 0 (the full recount of the first merges
      included), and c. the same in speculative epochs of 16: each equal
      to the native loop; prints merge seconds, steps or epochs and
      commits per epoch;
   d. two processes on the card (torch.multiprocessing, spawn) over gloo,
      4 data shards, two a process: count_pretokens_global over the two 5
      MB fixtures, one file a process, must equal one process's ingest of
      both; the kernel-sharded route (K3 on each process's shards, which
      must launch) and the sharded loop at vocab 2,048 must equal one
      process's native loop; a process that fails or passes 360 s fails
      the phase;
   e. the CLI (cli/train_bpe.py) on tests/data/large.txt at vocab 1024
      with --device cuda, then with --profile-dir: the saved files must
      equal BBPETrainer.save's for the same config, and the trace must
      exist and not be empty;
12. GPT-2's 50,000-merge model on the card: the merges derived from
    tests/fixtures_gpt2/gpt2_vocab.json by bench_torch.py's
    derive_gpt2_merges (ids 256..50255 are the merge ranks: each token,
    BPE-encoded with the merges before it, splits into its rank's two
    parts); encode, encode_batch(device=True) and encode_file (host
    threads, and the device scan) with compute_device="cuda" must give the
    golden ids of the 11 snippets and the two special-token texts (the
    golden no_special ids decoded), with and without <|endoftext|>;
13. the benchmark harness's 5 MB legs through bench_torch.py's own
    functions, with every kernel's launch count zeroed before and read
    after: train_real5m (the headline: the realistic fixture at vocab
    1000 on the default route, which must be K2, against the native
    loop), train_5m_repeated (TinyStories, which must be K1) and encode_5m
    (GPT-2's model, encode_batch(device=True) against encode); each
    device run must equal the native loop or the host encoder, K1 and K2
    must have launched, and the harness's last line must have bench.py's
    four keys and a positive value. The 100 MB and 1 GB legs stay in the
    harness (phases 4 and 6 run 100 MB through K2 already).

Every number printed is from this run on this card; the last two lines
are the kernels' JSON record and {"ok": true, "device": {...}}. K1's and
K3's entries carry old_ms, the first design's time for the same call on
the same inputs, and K3's calls beside its launches and memsets. K1's
entry carries its wide leg too (phase 5w): wide_launches (the trainer's
run), wide_steps, wide_ms, wide_plain_ms and wide_bound_ms (the first
chunk at vocab 1024) and wide_max_abs_err (all three comparisons).
"""

from __future__ import annotations

import json
import pickle
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SPECIALS = ["<|endoftext|>"]
CHUNK = 2048
TINYSTORIES = REPO / "tests" / "fixtures_gpt2" / "tinystories_sample_5M.txt"
#: H100 SXM device-memory rate (NVIDIA data sheet), for the bound.
HBM_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def per_call_ms(fn, reps: int, *, ahead: bool) -> tuple[float, object]:
    """Milliseconds per call of ``fn()`` over ``reps`` calls by CUDA events,
    and its last result. With ``ahead`` a 10 ms spin kernel runs first, so
    that the host has queued every call before the first starts: the time
    is the device's alone. Without it the calls run as the host issues
    them, so the time is the larger of the host's and the device's."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if ahead:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def timed_chunk(fn, state, **kw) -> float:
    """Milliseconds of one chunk by CUDA events around it."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn(state, **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def kernel_vs_twin(label, table, base, vocab_cap, min_frequency, card):
    """One chunk through the kernel and through the twin from one state;
    returns (kernel ms, twin ms, bytes needed, max abs difference, steps,
    the select's verify rounds, the kernel's merge record on the host)."""
    import torch

    from yabpe_tpu_torch.kernels import hbm_loop
    from yabpe_tpu_torch.train.hbm_driver import state_from_numpy

    num = vocab_cap - len(base)
    twin = state_from_numpy(table.words, table.freqs, base, vocab_cap, "cuda", num_merges=num)
    kern = twin.clone()
    kw = dict(chunk_start=0, chunk_size=CHUNK, num_merges=num, min_frequency=min_frequency)
    tally: dict[str, int] = {}
    plain_ms = timed_chunk(hbm_loop.hbm_merge_chunk_reference, twin, tally=tally, **kw)
    ms = timed_chunk(hbm_loop.hbm_merge_chunk, kern, **kw)
    err = 0
    for name in ("merges", "words", "counts", "token_bytes", "token_len", "lex_rank"):
        a, b = getattr(kern, name), getattr(twin, name)
        diff = int((a.long() - b.long()).abs().max())
        err = max(err, diff)
        check(diff == 0, f"{label}: kernel and twin differ in {name} (max {diff})")
    check(torch.equal(kern.scalars[:3], twin.scalars[:3]), f"{label}: scalars differ")
    check(bool((kern.row_max >= kern.counts.amax(dim=1)).all()), f"{label}: row_max below a row max")
    steps = int(kern.scalars[2])
    rounds, verified = (int(x) for x in kern.stats[:2])
    ctas = hbm_loop.cluster_ctas(vocab_cap, kern.token_bytes.shape[1])
    print(f"{label}: V={vocab_cap} N={table.words.shape[0]} W={table.words.shape[1]} "
          f"steps={steps} affected_words={tally.get('affected_words', 0)} "
          f"kernel_chunk_ms={ms} kernel_us_per_step={1e3 * ms / max(steps, 1)} "
          f"verify_rounds_per_step={rounds / max(steps, 1)} "
          f"verified_rows_per_step={verified / max(steps, 1)} cluster_ctas={ctas} "
          f"twin_chunk_ms={plain_ms} needed_bytes={tally['bytes']} "
          f"max_abs_err={err} (tolerance: exact) [{card}]")
    merges = kern.merges.cpu().numpy()
    del twin, kern
    torch.cuda.empty_cache()
    return ms, plain_ms, tally["bytes"], err, steps, rounds, merges


def k2_replay_vs_twin(table, base, vocab_cap, min_frequency, record, until, card):
    """K2's replay mode against its twin: one CHUNK-step chunk from the
    starting state with ``record``'s first ``until`` rows preloaded and
    replay_until = ``until``; then, on another copy, the replayed steps and
    the live ones as two timed calls. Returns (replay ms, twin replay ms,
    replay bytes needed, replayed steps, max abs difference)."""
    import torch

    from yabpe_tpu_torch.kernels import hbm_loop
    from yabpe_tpu_torch.train.hbm_driver import state_from_numpy

    num = vocab_cap - len(base)
    start = state_from_numpy(table.words, table.freqs, base, vocab_cap, "cuda", num_merges=num)
    start.merges[:until] = torch.as_tensor(record[:until], device="cuda")
    twin, kern, split = start.clone(), start.clone(), start
    kw = dict(chunk_start=0, chunk_size=CHUNK, num_merges=num, min_frequency=min_frequency,
              replay_until=until)
    chunk_plain_ms = timed_chunk(hbm_loop.hbm_merge_chunk_reference, twin, **kw)
    chunk_ms = timed_chunk(hbm_loop.hbm_merge_chunk, kern, **kw)
    err = 0
    for name in ("merges", "words", "counts", "token_bytes", "token_len", "lex_rank"):
        a, b = getattr(kern, name), getattr(twin, name)
        diff = int((a.long() - b.long()).abs().max())
        err = max(err, diff)
        check(diff == 0, f"k2 replay: kernel and twin differ in {name} (max {diff})")
    check(torch.equal(kern.scalars[:3], twin.scalars[:3])
          and int(kern.scalars[hbm_loop.DIVERGED]) == int(twin.scalars[hbm_loop.DIVERGED]) == 0,
          "k2 replay: scalars differ")
    check(bool((kern.row_max >= kern.counts.amax(dim=1)).all()), "k2 replay: row_max below a row max")
    check((kern.merges.cpu().numpy()[:CHUNK] == record[:CHUNK]).all(),
          "k2 replay: merges differ from phase 3's")
    replayed = int(kern.stats[hbm_loop.STAT_REPLAYED])
    check(replayed == until, f"k2 replay: {replayed} steps replayed, expected {until}")

    # the same steps as two calls: the replayed ones, then the live ones
    replay_twin, tally = split.clone(), {}
    replay_plain_ms = timed_chunk(hbm_loop.hbm_merge_chunk_reference, replay_twin, tally=tally,
                                  **{**kw, "chunk_size": until})
    del replay_twin
    replay_ms = timed_chunk(hbm_loop.hbm_merge_chunk, split, **{**kw, "chunk_size": until})
    live_ms = timed_chunk(hbm_loop.hbm_merge_chunk, split,
                          **{**kw, "chunk_start": until, "chunk_size": CHUNK - until})
    for name in ("merges", "words", "counts", "token_bytes", "token_len", "lex_rank"):
        check(torch.equal(getattr(split, name), getattr(kern, name)),
              f"k2 replay: the split run differs in {name}")
    live = int(kern.scalars[2]) - until
    ns_replay = (int(split.stats[hbm_loop.STAT_NS_REPLAY]) % 2**32) / until
    print(f"k2_replay_vs_twin_5M_v4096: V={vocab_cap} replay_until={until} chunk={CHUNK} "
          f"kernel_chunk_ms={chunk_ms} twin_chunk_ms={chunk_plain_ms} "
          f"replayed_steps={replayed} live_steps={live} "
          f"replay_us_per_step={1e3 * replay_ms / until} live_us_per_step={1e3 * live_ms / live} "
          f"replay_step_kernel_us={ns_replay / 1e3} (own timer) "
          f"replay_twin_ms={replay_plain_ms} replay_needed_bytes={tally['bytes']} "
          f"max_abs_err={err} (tolerance: exact) [{card}]")
    del twin, kern, split
    torch.cuda.empty_cache()
    return replay_ms, replay_plain_ms, tally["bytes"], replayed, err


def wide_words_run(label, files, vocab_cap, route, card, min_frequency=2, **extra):
    """Train ``files`` on the card (config ``extra``) with the merge
    kernels' launch counts zeroed: the route must be ``route``; on K1 only
    K1 may launch and it must, on a fallback engine no kernel may launch;
    the merges and vocab must equal the native loop's. Returns K1's
    launches."""
    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
    from yabpe_tpu_torch.kernels import fused_loop, hbm_loop, replay_emit

    cfg = dict(vocab_size=vocab_cap, min_frequency=min_frequency, max_workers=8,
               chunk_size_bytes=32 << 20, special_tokens=SPECIALS)
    cfg.update(extra)
    counts = ((hbm_loop.LAUNCHES, "hbm_merge_chunk"), (fused_loop.LAUNCHES, "fused_merge_chunk"),
              (replay_emit.LAUNCHES, "replay_emit_chunk"))
    for launches, name in counts:
        launches[name] = 0
    trainer = BBPETrainer(BBPETrainerConfig(**cfg, device="cuda"))
    model = trainer.train(files)
    launched = {name: launches[name] for launches, name in counts}
    stats = trainer.last_stats
    n = len(model.merges)
    native_trainer = BBPETrainer(BBPETrainerConfig(**cfg, use_native_loop=True))
    native_model = native_trainer.train(files)
    print(f"{label}: route={trainer.route} merges={n} ingest_s={stats['ingest_seconds']} "
          f"merge_s={stats['merge_seconds']} us_per_merge={1e6 * stats['merge_seconds'] / max(n, 1)} "
          f"unique_pretokens={int(stats['unique_pretokens'])} kernel_launches={launched} "
          f"native_merge_s={native_trainer.last_stats['merge_seconds']} [{card}]")
    check(trainer.route == route, f"{label}: route {trainer.route}, expected {route}")
    k1 = launched.pop("fused_merge_chunk")
    check(not any(launched.values()), f"{label}: a merge kernel launched: {launched}")
    check((k1 > 0) == (route == "K1"), f"{label}: {k1} K1 launches on route {route}")
    check(model.merges == native_model.merges, f"{label}: merges differ from the native loop")
    check(model.vocab == native_model.vocab, f"{label}: vocab differs from the native loop")
    return k1


def v1_library(name: str, entry: str, n_ptrs: int, n_ints: int):
    """The first design's library (csrc/<name>_v1.cu): its C entry point
    ``entry`` takes ``n_ptrs`` pointers, ``n_ints`` ints and the stream."""
    import ctypes

    from yabpe_tpu_torch.kernels import _build

    lib = _build.load(f"{name}_v1")
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    return lib


def v1_fused_chunk(state, *, chunk_start, chunk_size, num_merges, min_frequency):
    """K1's first design (csrc/fused_loop_v1.cu: one cooperative grid, three
    grid barriers a step) on a FusedState, row_max left alone."""
    import torch

    lib = v1_library("fused_loop", "yabpe_fused_v1_merge_chunk", 9, 7)
    n, w = state.words.shape
    v, byte_width = state.token_bytes.shape
    slots = torch.empty(lib.yabpe_fused_v1_slots_bytes(), dtype=torch.uint8, device="cuda")
    tensors = (state.words, state.freqs, state.counts, state.token_bytes, state.token_len,
               state.lex_rank, state.merges, state.scalars)
    rc = lib.yabpe_fused_v1_merge_chunk(
        *(t.data_ptr() for t in tensors), slots.data_ptr(), n, w, v, byte_width, chunk_start,
        min(chunk_start + chunk_size, num_merges), min_frequency,
        torch.cuda.current_stream().cuda_stream,
    )
    check(rc == 0, f"fused_loop_v1: CUDA error {rc}")


def k1_first_launch(table, base, vocab_cap, min_frequency, card):
    """The process's first K1 launch, split: the library load (dlopen), the
    function attributes, the cluster-size query and the first launch (host
    clock to its end, and CUDA events around it); then the first design's
    library load and first call (host clock). Returns the split in ms."""
    import torch

    from yabpe_tpu_torch.kernels import fused_loop
    from yabpe_tpu_torch.train.fused_driver import fused_state_from_numpy

    num = vocab_cap - len(base)
    state = fused_state_from_numpy(table.words, table.freqs, base, vocab_cap, "cuda", num_merges=num)
    n, v, byte_width = state.words.shape[0], vocab_cap, state.token_bytes.shape[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_loop._library()
    t1 = time.perf_counter()
    fused_loop._prepare(torch.cuda.current_device())
    t2 = time.perf_counter()
    ctas = fused_loop.cluster_ctas(n, v, byte_width)
    t3 = time.perf_counter()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fused_loop.fused_merge_chunk(state, chunk_start=0, chunk_size=200, num_merges=num,
                                 min_frequency=min_frequency)
    end.record()
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    # the first design's first launch: its library load, then one call that
    # sets its attributes, queries its occupancy and launches, as every call did
    old = fused_state_from_numpy(table.words, table.freqs, base, vocab_cap, "cuda", num_merges=num)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    v1_library("fused_loop", "yabpe_fused_v1_merge_chunk", 9, 7)
    t6 = time.perf_counter()
    v1_fused_chunk(old, chunk_start=0, chunk_size=200, num_merges=num, min_frequency=min_frequency)
    torch.cuda.synchronize()
    t7 = time.perf_counter()
    split = {
        "library_load_ms": 1e3 * (t1 - t0), "attributes_ms": 1e3 * (t2 - t1),
        "cluster_query_ms": 1e3 * (t3 - t2), "first_launch_host_ms": 1e3 * (t4 - t3),
        "first_launch_device_ms": start.elapsed_time(end),
        "old_library_load_ms": 1e3 * (t6 - t5), "old_first_call_host_ms": 1e3 * (t7 - t6),
    }
    print("k1_first_launch: " + " ".join(f"{k}={x}" for k, x in split.items())
          + f" cluster_ctas={ctas} N={n} V={v} [{card}]")
    del state, old
    return split


def fused_vs_twin(label, table, base, vocab_cap, min_frequency, chunk, card, *,
                  layout=None, old=True):
    """K1 (its token bytes in ``layout``, None for the kernel's choice) and
    its twin chunk by chunk from one state, the whole state but row_max
    exactly equal after every chunk and row_max at least each row's max;
    then, with ``old``, the first chunk through K1's first design (words of
    at most 64 symbols) from the same state. Returns (kernel ms, twin ms,
    bytes needed, max abs difference, first design's ms or None, steps),
    of the first chunk."""
    import torch

    from yabpe_tpu_torch.kernels import fused_loop
    from yabpe_tpu_torch.train.fused_driver import fused_state_from_numpy

    num = vocab_cap - len(base)
    twin = fused_state_from_numpy(table.words, table.freqs, base, vocab_cap, "cuda", num_merges=num)
    start_state = twin.clone()
    kern = twin.clone()
    first = None
    err = 0
    chunk_ms, chunk_steps = [], []
    for start in range(0, num, chunk):
        kw = dict(chunk_start=start, chunk_size=chunk, num_merges=num, min_frequency=min_frequency)
        tally: dict[str, int] = {}
        plain_ms = timed_chunk(fused_loop.fused_merge_chunk_reference, twin, tally=tally, **kw)
        done = int(kern.scalars[2])
        ms = timed_chunk(fused_loop.fused_merge_chunk, kern, _layout=layout, **kw)
        chunk_ms.append(ms)
        chunk_steps.append(int(kern.scalars[2]) - done)
        for name in ("words", "counts", "token_bytes", "token_len", "lex_rank", "merges"):
            a, b = getattr(kern, name), getattr(twin, name)
            diff = int((a.long() - b.long()).abs().max())
            err = max(err, diff)
            check(diff == 0, f"{label}: K1 and twin differ in {name} after the chunk at {start} (max {diff})")
        check(torch.equal(kern.scalars[:3], twin.scalars[:3]), f"{label}: scalars differ after the chunk at {start}")
        check(bool((kern.row_max >= kern.counts.amax(dim=1)).all()),
              f"{label}: row_max below a row max after the chunk at {start}")
        if first is None:
            first = (ms, plain_ms, tally.get("bytes", 0), int(kern.scalars[2]))
        if int(kern.scalars[1]):
            break
    ms, plain_ms, need, steps = first
    old_ms = None
    if old:
        # the first design on the first chunk, from the same state, warmed up once
        kw = dict(chunk_start=0, chunk_size=chunk, num_merges=num, min_frequency=min_frequency)
        v1_fused_chunk(start_state.clone(), **kw)
        first_design = start_state.clone()
        old_ms = timed_chunk(v1_fused_chunk, first_design, **kw)
        check(torch.equal(first_design.merges[:steps], kern.merges[:steps]),
              f"{label}: the first design's merges differ")
    n, w = table.words.shape
    byte_width = kern.token_bytes.shape[1]
    used = layout or fused_loop.token_layout(vocab_cap, byte_width)
    us = [1e3 * t / max(k, 1) for t, k in zip(chunk_ms, chunk_steps)]
    print(f"{label}: V={vocab_cap} N={n} W={w} L={byte_width} token_layout={used} "
          f"chunk={chunk} first_chunk_steps={steps} kernel_chunk_ms={ms} twin_chunk_ms={plain_ms} "
          f"kernel_us_per_step={1e3 * ms / max(steps, 1)} needed_bytes={need} "
          + (f"old_kernel_chunk_ms={old_ms} old_kernel_us_per_step={1e3 * old_ms / max(steps, 1)} "
             if old else "")
          + f"merges={int(kern.scalars[2])} stopped={int(kern.scalars[1])} "
          f"kernel_ms_by_chunk={chunk_ms} steps_by_chunk={chunk_steps} us_per_step_by_chunk={us} "
          f"cluster_ctas={fused_loop.cluster_ctas(n, vocab_cap, byte_width, width=w, _layout=used)} "
          f"max_abs_err={err} (tolerance: exact; row_max a bound) [{card}]")
    return ms, plain_ms, need, err, old_ms, steps


def wide_text(path: Path, lines: int, seed: int) -> str:
    """The text of ``path`` plus ``lines`` lines of 65-300-byte pre-tokens
    (scripts/wide_lines.py)."""
    from wide_lines import wide_lines

    return path.read_text(encoding="utf-8") + "\n" + "\n".join(wide_lines(lines, seed)) + "\n"


def wide_k1_run(base, tmp: Path, card):
    """Phase 5w: K1 on words past 64 symbols. Returns (kernel ms, twin ms,
    bytes needed, max abs difference, steps) of the first chunk at V =
    1024, and K1's launches on the trainer's run."""
    import torch

    from yabpe_tpu_torch.core.wordtable import WordTable
    from yabpe_tpu_torch.kernels import fused_loop
    from yabpe_tpu_torch.pretok.ingest import count_pretokens

    path = tmp / "wide_large_seed0.txt"
    path.write_text(wide_text(REPO / "tests" / "data" / "large.txt", 2000, 0), encoding="utf-8")
    table = WordTable.from_counter(count_pretokens([path], SPECIALS))
    check(table.words.shape == (1024, 304), f"the wide table is {table.words.shape}, not 1024 x 304")
    check(fused_loop.token_layout(1024, 304) == "global", "the token bytes at V=1024 fit shared memory")
    check(fused_loop.token_layout(320, 304) == "shared", "the token bytes at V=320 do not fit")
    wide = fused_vs_twin("fused_vs_twin_wide_large_v1024", table, base, 1024, 2, 200, card, old=False)
    small = {
        layout: fused_vs_twin(f"fused_vs_twin_wide_large_v320_{layout}", table, base, 320, 2, 32,
                              card, layout=layout, old=False)
        for layout in fused_loop.TOKEN_LAYOUTS
    }
    for label, (ms, plain_ms, need, _, _, steps) in (("v1024_global", wide),
                                                     *((f"v320_{k}", r) for k, r in small.items())):
        print(f"K1 wide words {label}: kernel_ms_first_chunk={ms} kernel_us_per_step={1e3 * ms / steps} "
              f"twin_ms={plain_ms} bound_ms={need / HBM_BYTES_PER_S * 1e3} by bytes [{card}]")
    del table
    torch.cuda.empty_cache()
    # the trainer on TinyStories plus wide lines at V = 1000, through K1
    story = tmp / "wide_tinystories_seed0.txt"
    story.write_text(wide_text(TINYSTORIES, 2000, 0), encoding="utf-8")
    t0 = time.perf_counter()
    launches = wide_words_run("wide_words_tinystories_v1000", [story], 1000, "K1", card,
                              min_frequency=1, max_workers=1, chunk_size_bytes=1 << 30)
    print(f"phase 5w trainer: {time.perf_counter() - t0} s [{card}]")
    ms, plain_ms, need, err, _, steps = wide
    return ms, plain_ms, need, max(err, *(r[3] for r in small.values())), steps, launches


def load_bench():
    """bench_torch.py, the benchmark harness at the repository's root,
    loaded by path (it runs nothing on import)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_torch", REPO / "bench_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def gpt2_run(tmp: Path, bench, card) -> None:
    """Phase 12: GPT-2's 50,000-merge model on the card: encode,
    encode_batch(device=True) and encode_file (host threads and device
    scan) on the golden snippets and special-token texts, with and
    without <|endoftext|>, against the golden ids."""
    from yabpe_tpu_torch import BBPETokenizer
    from yabpe_tpu_torch.io import gpt2

    fixtures = REPO / "tests" / "fixtures_gpt2"
    t0 = time.perf_counter()
    vocab = gpt2.load_gpt2_vocab(fixtures / "gpt2_vocab.json")
    merges = bench.derive_gpt2_merges(vocab)
    derive_s = time.perf_counter() - t0
    check(len(vocab) == 50257 and len(merges) == 50000, "gpt2: not 50,000 merges")
    golden = json.loads((fixtures / "golden_encode" / "gpt2_golden.json").read_text(encoding="utf-8"))
    snippets = golden["snippets"]
    cases = list(zip(snippets["texts"], snippets["with_special"], snippets["no_special"]))
    plain = BBPETokenizer(vocab, merges, [], compute_device="cuda")
    for key in ("special_trailing", "special_double"):
        entry = golden[key]
        cases.append((plain.decode(entry["no_special"]), entry["with_special"], entry["no_special"]))
    texts = [text for text, _, _ in cases]
    for i, text in enumerate(texts):
        (tmp / f"gpt2_{i}.txt").write_bytes(text.encode("utf-8"))
    for mode, specials in (("with_special", SPECIALS), ("no_special", [])):
        want = [w if mode == "with_special" else n for _, w, n in cases]
        tok = BBPETokenizer(vocab, merges, specials, compute_device="cuda")
        t1 = time.perf_counter()
        check([tok.encode(t) for t in texts] == want, f"gpt2 {mode}: encode differs from the golden ids")
        check(tok.encode_batch(texts, device=True) == want,
              f"gpt2 {mode}: encode_batch(device=True) differs from the golden ids")
        for device in (False, True):
            got = [tok.encode_file(tmp / f"gpt2_{i}.txt", device=device).tolist() for i in range(len(texts))]
            check(got == want, f"gpt2 {mode}: encode_file(device={device}) differs from the golden ids")
        enc = tok._get_device_encoder(None)
        check(enc is not None and enc.stats["tiles"] > 0 and enc._sorted_keys.device.type == "cuda",
              f"gpt2 {mode}: the device encoder did not run on the card")
        print(f"gpt2_golden_{mode}: {len(texts)} texts exact through encode, encode_batch(device=True), "
              f"encode_file host and device; tiles={enc.stats['tiles']} "
              f"{time.perf_counter() - t1} s [{card}]")
    print(f"gpt2: 50,000 merges derived from gpt2_vocab.json in {derive_s} s (host)")


def v1_replay(words, freqs, chain, *, cps, cps0):
    """K3's first design (csrc/replay_emit_v1.cu: a copy, three memsets of
    the logs and one launch per chain step) on one shard; returns (words',
    ok)."""
    import torch

    from yabpe_tpu_torch.kernels.replay_emit import LANES, log_rows

    lib = v1_library("replay_emit", "yabpe_replay_v1_emit_chunk", 9, 5)
    n, w = words.shape
    k = chain.shape[0]
    rows = log_rows(k, cps, cps0)
    out = torch.empty_like(words)
    logs = [torch.empty((rows, LANES), dtype=torch.int32, device="cuda") for _ in range(3)]
    ok, cursor = (torch.empty(k, dtype=torch.int32, device="cuda") for _ in range(2))
    rc = lib.yabpe_replay_v1_emit_chunk(
        words.data_ptr(), freqs.data_ptr(), chain.data_ptr(), out.data_ptr(),
        *(t.data_ptr() for t in logs), ok.data_ptr(), cursor.data_ptr(), n, w, k, cps, cps0,
        torch.cuda.current_stream().cuda_stream,
    )
    check(rc == 0, f"replay_emit_v1: CUDA error {rc}")
    return out, ok


def replay_vs_twin(table, chain, shards, cps, card):
    """K3 and its twin from one state on every shard of ``table``, cut as
    the sharded loop cuts it, the kernel's outputs allocated over memory
    filled with ids >= 0; returns (kernel ms, twin ms, bytes to move, max
    abs difference, first design's ms), each summed or maxed over the
    shards: one epoch's replay. Each kernel ms is the device's time, the
    mean of 5 calls queued ahead (per_call_ms); the calls' pace as the
    host issues them is printed beside it."""
    import torch

    from yabpe_tpu_torch.dist.hbm_sharded import log_plan, shard_rows
    from yabpe_tpu_torch.kernels import replay_emit

    n = table.words.shape[0]
    cps0 = log_plan(n, table.width, shards, len(chain), cps)[1]
    chain_t = torch.tensor(chain, dtype=torch.int32, device="cuda")
    parts = [
        (torch.tensor(table.words[lo:hi], dtype=torch.int32, device="cuda"),
         torch.tensor(table.freqs[lo:hi], dtype=torch.int32, device="cuda"))
        for lo, hi in shard_rows(n, shards)
    ]
    kw = dict(cps=cps, cps0=cps0)
    replay_emit.replay_emit_chunk(*parts[0], chain_t, **kw)  # first launch of the process
    v1_replay(*parts[0], chain_t, **kw)
    counters = (replay_emit.CALLS, replay_emit.LAUNCHES, replay_emit.MEMSETS)
    total_ms = total_plain_ms = total_need = err = total_old_ms = 0
    for d, (words, freqs) in enumerate(parts):
        tally: dict[str, int] = {}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        twin = replay_emit.replay_emit_chunk_reference(words, freqs, chain_t, tally=tally, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        # garbage where the outputs will be: ids >= 0 that a reader could take for cells
        torch.full((16 << 20,), 0x01010101, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        before = [c["replay_emit_chunk"] for c in counters]
        kern = replay_emit.replay_emit_chunk(words, freqs, chain_t, **kw)
        ops = [c["replay_emit_chunk"] - b for c, b in zip(counters, before)]
        check(ops == [1, 1, 1], f"replay shard {d}: calls, launches, memsets {ops}, expected one each")
        # warm: the outputs' blocks come from the allocator's cache
        call = lambda: replay_emit.replay_emit_chunk(words, freqs, chain_t, **kw)  # noqa: E731
        call_v1 = lambda: v1_replay(words, freqs, chain_t, **kw)  # noqa: E731
        ms = per_call_ms(call, 5, ahead=True)[0]
        old_ms, old = per_call_ms(call_v1, 5, ahead=True)
        paced_ms = per_call_ms(call, 5, ahead=False)[0]
        old_paced_ms = per_call_ms(call_v1, 5, ahead=False)[0]
        diff = int((kern[0].long() - twin[0].long()).abs().max())
        check(diff == 0, f"replay shard {d}: K3 and twin differ in words (max {diff})")
        check(torch.equal(kern[4], twin[4]), f"replay shard {d}: ok flags differ")
        check(torch.equal(kern[5], twin[5]), f"replay shard {d}: cursors differ")
        check(torch.equal(old[0], twin[0]) and torch.equal(old[1], twin[4]),
              f"replay shard {d}: the first design differs from the twin")
        for j, ok in enumerate(kern[4].tolist()):
            if not ok:
                continue
            a = replay_emit.step_net_delta(*kern[1:4], j, cursor=kern[5], vocab_cap=32000, **kw)
            b = replay_emit.step_net_delta(*twin[1:4], j, cursor=twin[5], vocab_cap=32000, **kw)
            check(torch.equal(a[0], b[0]), f"replay shard {d}: step {j} cells differ")
            step_diff = int((a[1] - b[1]).abs().max()) if a[1].numel() else 0
            diff = max(diff, step_diff)
            check(step_diff == 0, f"replay shard {d}: step {j} net deltas differ")
        print(f"replay_vs_twin_100M_v32000 shard {d}: N={words.shape[0]} W={words.shape[1]} "
              f"K={len(chain)} cps={cps} cps0={cps0} ok={kern[4].tolist()} "
              f"cursor={kern[5].tolist()} affected_words={tally['affected_words']} "
              f"cells={tally['cells']} kernel_ms={ms} old_kernel_ms={old_ms} "
              f"host_paced_ms={paced_ms} old_host_paced_ms={old_paced_ms} twin_ms={plain_ms} "
              f"bytes={tally['bytes']} calls_launches_memsets={ops} "
              f"max_abs_err={diff} (tolerance: exact) [{card}]")
        total_ms += ms
        total_old_ms += old_ms
        total_plain_ms += plain_ms
        total_need += tally["bytes"]
        err = max(err, diff)
    return total_ms, total_plain_ms, total_need, err, total_old_ms


def plain_ids(tok, text: str) -> list[int]:
    """The plain per-word encoder over the native scanner's split: the
    special tokens (longest first), then GPT-2 pre-tokens."""
    from yabpe_tpu_torch import native

    data = text.encode("utf-8")
    specials = sorted((t.encode("utf-8") for t in tok.special_tokens), key=len, reverse=True)
    starts, which = native.find_specials(data, specials)
    ids: list[int] = []
    pos = 0
    for at, i in zip([*starts.tolist(), len(data)], [*which.tolist(), -1]):
        segment = data[pos:at]
        begin = 0
        for end in native.pretok_offsets(segment).tolist():
            ids.extend(tok._encode_bytes_impl(segment[begin:end]))
            begin = end
        if i >= 0:
            ids.append(tok._vocab[specials[i]])
            pos = at + len(specials[i])
    return ids


def scan_tiles_vs_cpu(tok, corpus: Path, card) -> None:
    """Phase 10a: the scan on the card against the same function on the
    CPU, tile by tile, on the new words of the first 4 MiB chunk."""
    import numpy as np
    import torch

    from yabpe_tpu_torch import native
    from yabpe_tpu_torch.tok.device_encode import DeviceEncoder, scan_encode
    from yabpe_tpu_torch.tok.parallel_encode import safe_cut_points

    start, end = safe_cut_points(corpus, 4 << 20, SPECIALS)[0]
    with open(corpus, "rb") as f:
        data = f.read(end - start)
    counter = native.NativeCounter(tuple(SPECIALS))
    counter.add_word_ids_specials(data)
    words = counter.export_words()
    counter.close()
    cuda = DeviceEncoder(tok._vocab, tok._merges, SPECIALS, device="cuda")
    cpu = DeviceEncoder(tok._vocab, tok._merges, SPECIALS, device="cpu")
    tables = (cuda._sorted_keys, cuda._sorted_ranks, cuda._sorted_new_syms, cuda._n_syms)
    table_bytes = sum(t.numel() * t.element_size() for t in tables[:3])
    shapes, iters, syncs, ms, device_ms, bound_ms = [], [], [], [], [], []
    for _, tile, row_lens in cuda.pack_tiles(words):
        before = (cuda.stats["iterations"], cuda.stats["syncs"])
        t = torch.from_numpy(tile).cuda()
        cuda.scan_tile(t, row_lens)  # warm
        cuda.stats.update(iterations=before[0], syncs=before[1])
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        got = cuda.scan_tile(t, row_lens)
        e1.record()
        torch.cuda.synchronize()
        want = cpu.scan_tile(torch.from_numpy(tile), row_lens)
        check(np.array_equal(got.cpu().numpy(), want.numpy()),
              f"device encode: the scan on the card differs from the CPU on a {tile.shape} tile")
        shapes.append(tile.shape)
        iters.append(cuda.stats["iterations"] - before[0])
        syncs.append(cuda.stats["syncs"] - before[1])
        ms.append(e0.elapsed_time(e1))
        # the device's own time: the same iterations with no test for work,
        # all queued behind a spin kernel before the first starts
        torch.cuda._sleep(100_000_000)
        e0.record()
        again = scan_encode(t, *tables, max_iters=int(row_lens.max()) - 1, check_every=tile.shape[1])
        e1.record()
        torch.cuda.synchronize()
        check(torch.equal(again, got), "device encode: the scan without tests for work differs")
        device_ms.append(e0.elapsed_time(e1))
        bound_ms.append((2 * tile.nbytes + table_bytes) / HBM_BYTES_PER_S * 1e3)
    check(cuda.stats["iterations"] == cpu.stats["iterations"], "device encode: iteration counts differ")
    print(f"device_encode_scan_vs_cpu_100M_v32000 (first 4 MiB chunk): words={len(words)} "
          f"tiles={len(shapes)} shapes={shapes} iterations_per_tile={iters} "
          f"host_syncs_per_tile={syncs} scan_ms_per_tile={ms} scan_ms={sum(ms)} "
          f"queued_ahead_ms_per_tile={device_ms} queued_ahead_ms={sum(device_ms)} "
          f"bound_ms={sum(bound_ms)} by bytes "
          f"max_abs_err=0 (tolerance: exact) [{card}]")


def device_encode_run(big_vocab, big_merges, corpus: Path, small_tok, card) -> None:
    """Phases 10b and 10c: the device and host file encoders at full width,
    and the batched device encoder."""
    import numpy as np
    import torch

    from yabpe_tpu_torch import BBPETokenizer, native
    from yabpe_tpu_torch.tok.device_encode import DeviceEncoder

    check(native.available(), "the native library did not build")
    tok = BBPETokenizer(big_vocab, big_merges, SPECIALS)
    scan_tiles_vs_cpu(tok, corpus, card)

    # ---- 10b. the 100 MB corpus through both file encoders
    text = corpus.read_text(encoding="utf-8")
    nbytes = corpus.stat().st_size
    t0 = time.perf_counter()
    want = np.asarray(tok.encode(text), dtype=np.int32)
    whole_s = time.perf_counter() - t0
    enc = tok._get_device_encoder(None)
    check(enc is not None, "no device encoder for the 32k model")
    enc.scan_events = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dev_ids = tok.encode_file(corpus, device=True)
    dev_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    scan_ms = sum(a.elapsed_time(b) for a, b in enc.scan_events)
    cold = dict(enc.stats)
    enc.scan_events = None
    t0 = time.perf_counter()
    host_ids = tok.encode_file(corpus)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm_ids = tok.encode_file(corpus, device=True)
    warm_s = time.perf_counter() - t0
    warm_new = enc.stats["new_words"] - cold["new_words"]
    # the overlap: a fresh encoder that waits for each chunk's scans before
    # the next chunk's native scan; what it waits for is what ran under that
    # scan in the cold run, and its extra wall time what the overlap saved
    seq = DeviceEncoder(big_vocab, big_merges, SPECIALS, device="cuda")
    dispatch, queued = seq._dispatch_word_rows, []

    def dispatch_and_wait(encoded):
        pending = dispatch(encoded)
        t = time.perf_counter()
        torch.cuda.synchronize()
        queued.append(time.perf_counter() - t)
        return pending

    seq._dispatch_word_rows = dispatch_and_wait
    t0 = time.perf_counter()
    seq_ids = seq.encode_file(corpus)
    seq_s = time.perf_counter() - t0
    for name, ids in (("device", dev_ids), ("host", host_ids), ("warm device", warm_ids),
                      ("waiting device", seq_ids)):
        check(ids.dtype == np.int32 and np.array_equal(ids, want),
              f"device encode: {name} encode_file differs from the whole text's encode")
    check(warm_new == 0, f"device encode: the warm run found {warm_new} new words")
    check(tok.decode(want.tolist()) == text, "device encode: the ids do not decode to the file")
    tiles = max(cold["tiles"], 1)
    print(f"device_encode_file_100M_v32000: bytes={nbytes} ids={len(want)} "
          f"whole_text_encode_s={whole_s} ({nbytes / whole_s / 1e6} MB/s, one native pass) "
          f"device_s={dev_s} ({nbytes / dev_s / 1e6} MB/s) host_threads_s={host_s} "
          f"({nbytes / host_s / 1e6} MB/s) warm_device_s={warm_s} ({nbytes / warm_s / 1e6} MB/s) "
          f"waiting_device_s={seq_s} overlapped_s={sum(queued)} (device work queued when the host "
          f"turned to the next chunk) saved_s={seq_s - dev_s} [{card}]")
    print(f"device_encode_file_100M_v32000: unique_words={cold['new_words']} tiles={cold['tiles']} "
          f"iterations_per_tile={cold['iterations'] / tiles} host_syncs_per_tile={cold['syncs'] / tiles} "
          f"readbacks={cold['readbacks']} scan_device_ms={scan_ms} (CUDA events) "
          f"host_scan_s={cold['host_scan_s']} dispatch_s={cold['dispatch_s']} "
          f"collect_s={cold['collect_s']} warm_new_words={warm_new} max_memory_allocated={peak} B [{card}]")
    del text, want, dev_ids, host_ids, warm_ids, seq_ids, seq

    # ---- 10c. batches with the vocab-1000 model
    golden = REPO / "tests" / "fixtures_gpt2" / "golden_encode" / "gpt2_golden.json"
    snippets = json.loads(golden.read_text(encoding="utf-8"))["snippets"]["texts"]
    story = TINYSTORIES.read_text(encoding="utf-8")
    for label, texts in (("tinystories_5M", [story]), ("snippets", snippets)):
        nb = sum(len(t.encode("utf-8")) for t in texts)
        t0 = time.perf_counter()
        host = small_tok.encode_batch(texts)
        host_s = time.perf_counter() - t0
        times = {}
        for run, shards in (("cold", None), ("warm", None), ("shards4", 4)):
            t0 = time.perf_counter()
            got = small_tok.encode_batch(texts, device=True, data_shards=shards)
            times[run] = time.perf_counter() - t0
            check(got == host, f"device encode: encode_batch({label}, {run}) differs from the host")
        print(f"device_encode_batch_{label}_v1000: bytes={nb} host_s={host_s} "
              + " ".join(f"{run}_s={t} ({nb / t / 1e6} MB/s)" for run, t in times.items())
              + f" [{card}]")
    for t, shards in ((tok, None), (small_tok, None), (small_tok, 4)):
        enc = t._get_device_encoder(shards)
        check(enc is not None and enc.stats["tiles"] > 0 and enc._sorted_keys.device.type == "cuda",
              "device encode: a device path fell back to the host")


# ---- phase 11: the distributed layer (dist/, cli/; plain torch, no kernel)


def kernel_launches() -> dict[str, int]:
    from yabpe_tpu_torch.kernels import fused_loop, hbm_loop, replay_emit

    return {
        "fused_merge_chunk": fused_loop.LAUNCHES["fused_merge_chunk"],
        "hbm_merge_chunk": hbm_loop.LAUNCHES["hbm_merge_chunk"],
        "replay_emit_chunk": replay_emit.LAUNCHES["replay_emit_chunk"],
    }


def zero_kernel_launches() -> None:
    from yabpe_tpu_torch.kernels import fused_loop, hbm_loop, replay_emit

    fused_loop.LAUNCHES["fused_merge_chunk"] = 0
    hbm_loop.LAUNCHES["hbm_merge_chunk"] = 0
    for counter in (replay_emit.CALLS, replay_emit.LAUNCHES, replay_emit.MEMSETS):
        counter["replay_emit_chunk"] = 0


def loop_line(loop: dict) -> str:
    """A sharded loop's counters, per step where they are per step."""
    steps = loop.get("steps", 0)
    merges = steps + loop.get("spec_commits", 0)
    parts = [f"{k}={loop[k]}" for k in (
        "steps", "full_recounts", "select_finishes", "spec_epochs", "spec_commits",
        "commits_per_epoch", "fallback_chunks", "final_k", "resume_seconds",
        "slab_init_seconds", "loop_seconds",
    ) if k in loop]
    if merges:
        parts.append(f"ms_per_merge={1e3 * loop['loop_seconds'] / merges}")
        parts.append(f"host_syncs_per_merge={loop['host_syncs'] / merges}")
    parts.append(f"host_syncs={loop['host_syncs']}")
    return " ".join(parts)


def sharded_resume_run(corpus: Path, native_model, card: str) -> None:
    """11a: the 100 MB corpus at vocab 32,000 in 2 data x 2 vocab shards,
    resumed from a checkpoint of the native loop's first 29,743 merges."""
    import numpy as np
    import torch

    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
    from yabpe_tpu_torch.train import checkpoint as ckpt

    done = 29_743
    ids = native_model.vocab
    record = np.array(
        [(ids[left], ids[right], ids[left + right]) for left, right in native_model.merges],
        dtype=np.int32,
    )
    record[done:] = -1
    with tempfile.TemporaryDirectory(prefix="yabpe_chip_smoke_2d_") as ckdir:
        cfg = BBPETrainerConfig(
            vocab_size=32000, min_frequency=2, max_workers=8,
            chunk_size_bytes=32 << 20, special_tokens=SPECIALS,
            align_chunks_to_newline=True, device="cuda", data_shards=2,
            vocab_shards=2, checkpoint_dir=ckdir, checkpoint_every_chunks=1 << 20,
        )
        ckpt.save_checkpoint(ckdir, record, done, cfg)
        trainer = BBPETrainer(cfg)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_kernel_launches()
        model = trainer.train([corpus])
        launches = kernel_launches()
        peak = torch.cuda.max_memory_allocated()
    loop, stats = trainer.loop_stats, trainer.last_stats
    print(f"11a 2x2 sharded loop, 100 MB at V=32000, resumed at merge {done} "
          f"(depth cut: the last {len(native_model.merges) - done} of "
          f"{len(native_model.merges)} merges run live): route={trainer.route} "
          f"merge_s={stats['merge_seconds']} {loop_line(loop)} "
          f"max_memory_allocated={peak} B kernel_launches={launches} [{card}]")
    check(trainer.route == "sharded_loop", f"11a took {trainer.route}")
    check(loop["steps"] == len(native_model.merges) - done, f"11a ran {loop['steps']} steps")
    check(model.merges == native_model.merges, "11a merges differ from the native loop")
    check(model.vocab == native_model.vocab, "11a vocab differs from the native loop")
    check(not any(launches.values()), f"11a launched a kernel: {launches}")


def sharded_loop_runs(card: str) -> None:
    """11b/11c: the 5 MB realistic fixture at vocab 2,048 in 4 data shards,
    per step and in speculative epochs of 16, from step 0."""
    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig

    fixture = REPO / "tests" / "fixtures_gpt2" / "bench_5M_realistic.txt"
    cfg = dict(
        vocab_size=2048, min_frequency=2, max_workers=8,
        chunk_size_bytes=32 << 20, special_tokens=SPECIALS,
        align_chunks_to_newline=True, merge_chunk_size=256,
    )
    native = BBPETrainer(BBPETrainerConfig(**cfg, use_native_loop=True)).train([fixture])
    for label, extra in (("11b per step", {}), ("11c speculative k=16", dict(spec_merges_per_round=16))):
        trainer = BBPETrainer(BBPETrainerConfig(**cfg, device="cuda", data_shards=4, **extra))
        zero_kernel_launches()
        model = trainer.train([fixture])
        launches = kernel_launches()
        print(f"{label}, 5 MB at V=2048, 4 data shards: route={trainer.route} "
              f"merge_s={trainer.last_stats['merge_seconds']} merges={len(model.merges)} "
              f"{loop_line(trainer.loop_stats)} kernel_launches={launches} [{card}]")
        check(trainer.route == "sharded_loop", f"{label} took {trainer.route}")
        check(model.merges == native.merges, f"{label}: merges differ from the native loop")
        check(model.vocab == native.vocab, f"{label}: vocab differs from the native loop")
        check(not any(launches.values()), f"{label} launched a kernel: {launches}")


def _mp_child(rank: int, port: int, files: list[str], out_dir: str) -> None:
    """11d: one of two processes on the card, over gloo."""
    import hashlib

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(REPO / "src"))
    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
    from yabpe_tpu_torch.dist.ingest import count_pretokens_global
    from yabpe_tpu_torch.kernels import replay_emit
    from yabpe_tpu_torch.pretok.ingest import counter_from_raw

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
    result: dict = {}
    try:
        t0 = time.perf_counter()
        table = counter_from_raw(*count_pretokens_global(files, SPECIALS, max_workers=4))
        result["ingest_s"] = time.perf_counter() - t0
        result["ingest"] = hashlib.sha256(repr(sorted(table.items())).encode()).hexdigest()
        cfg = dict(
            vocab_size=2048, min_frequency=2, max_workers=4,
            chunk_size_bytes=32 << 20, special_tokens=SPECIALS,
            align_chunks_to_newline=True, device="cuda", data_shards=4,
            merge_chunk_size=256,
        )
        for name, extra in (("kernel_sharded", dict(use_hbm_kernel=True)), ("sharded_loop", {})):
            zero_kernel_launches()
            trainer = BBPETrainer(BBPETrainerConfig(**cfg, **extra))
            model = trainer.train(files)
            result[name] = dict(
                route=trainer.route,
                merges=hashlib.sha256(repr(model.merges).encode()).hexdigest(),
                merge_s=trainer.last_stats["merge_seconds"],
                replay_calls=replay_emit.CALLS["replay_emit_chunk"],
                replay_launches=replay_emit.LAUNCHES["replay_emit_chunk"],
                loop={k: v for k, v in trainer.loop_stats.items() if k != "phase_ms"},
            )
    finally:
        dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(result))


def multiprocess_run(card: str) -> None:
    """11d: two processes on the one card over gloo, 4 data shards (two a
    process): the global ingest, the kernel-sharded route and the sharded
    loop, against one process."""
    import hashlib
    import socket

    import torch.multiprocessing as mp

    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
    from yabpe_tpu_torch.pretok.ingest import count_pretokens

    files = [str(REPO / "tests" / "fixtures_gpt2" / name)
             for name in ("bench_5M_realistic.txt", "tinystories_sample_5M.txt")]
    ingest = count_pretokens(files, SPECIALS, chunk_size_bytes=32 << 20, max_workers=8, align_to_newline=True)
    want_ingest = hashlib.sha256(repr(sorted(ingest.items())).encode()).hexdigest()
    native = BBPETrainer(BBPETrainerConfig(
        vocab_size=2048, min_frequency=2, max_workers=8, chunk_size_bytes=32 << 20,
        special_tokens=SPECIALS, align_chunks_to_newline=True, use_native_loop=True,
    )).train(files)
    want = hashlib.sha256(repr(native.merges).encode()).hexdigest()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="yabpe_chip_smoke_mp_") as out_dir:
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_mp_child, args=(r, port, files, out_dir)) for r in range(2)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + 360
        for proc in procs:
            proc.join(max(1.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for proc in hung:
            proc.kill()
            proc.join()
        check(not hung, "11d: a process did not finish in 360 s")
        check(all(p.exitcode == 0 for p in procs), f"11d: exit codes {[p.exitcode for p in procs]}")
        results = [json.loads((Path(out_dir) / f"rank{r}.json").read_text()) for r in range(2)]
    print(f"11d two processes over gloo on one card: {time.perf_counter() - t0} s in all [{card}]")
    for r, res in enumerate(results):
        check(res["ingest"] == want_ingest, f"11d rank {r}: the global ingest differs")
        for name, route in (("kernel_sharded", "sharded"), ("sharded_loop", "sharded_loop")):
            run = res[name]
            print(f"11d rank {r} {name}: route={run['route']} merge_s={run['merge_s']} "
                  f"replay_calls={run['replay_calls']} replay_launches={run['replay_launches']} "
                  f"loop={run['loop']} [{card}]")
            check(run["route"] == route, f"11d rank {r} {name} took {run['route']}")
            check(run["merges"] == want, f"11d rank {r} {name}: merges differ from one process's")
        check(res["kernel_sharded"]["replay_launches"] > 0, f"11d rank {r}: K3 never launched")
        check(res["sharded_loop"]["replay_launches"] == 0, f"11d rank {r}: the sharded loop launched K3")
        print(f"11d rank {r}: ingest_s={res['ingest_s']} (host) [{card}]")


def cli_run(card: str) -> None:
    """11e: the CLI on tests/data/large.txt at vocab 1024 on the card, then
    with --profile-dir; the files equal BBPETrainer.save's."""
    from yabpe_tpu_torch import BBPETrainer, BBPETrainerConfig
    from yabpe_tpu_torch.cli import train_bpe

    large = REPO / "tests" / "data" / "large.txt"
    with tempfile.TemporaryDirectory(prefix="yabpe_chip_smoke_cli_") as tmp:
        tmp = Path(tmp)
        args = [str(large), "--vocab-size", "1024", "--device", "cuda"]
        t0 = time.perf_counter()
        check(train_bpe.main([*args, "-o", str(tmp / "cli")]) == 0, "the CLI failed")
        t1 = time.perf_counter()
        check(train_bpe.main([*args, "-o", str(tmp / "cli_prof"), "--profile-dir", str(tmp / "trace")]) == 0,
              "the CLI failed with --profile-dir")
        t2 = time.perf_counter()
        trainer = BBPETrainer(BBPETrainerConfig(
            vocab_size=1024, min_frequency=2, max_workers=8, chunk_size_bytes=20 << 20,
            special_tokens=SPECIALS, align_chunks_to_newline=True, device="cuda",
        ))
        trainer.train([large])
        trainer.save(tmp / "api")
        for out in ("cli", "cli_prof"):
            for name in ("vocab.json", "merges.txt", "special_tokens.json"):
                check((tmp / out / name).read_bytes() == (tmp / "api" / name).read_bytes(),
                      f"11e: {out}/{name} differs from BBPETrainer.save's")
        trace = tmp / "trace" / "trace.json"
        check(trace.exists() and trace.stat().st_size > 0, "11e: no trace written")
        print(f"11e CLI at V=1024: {t1 - t0} s, with --profile-dir {t2 - t1} s, "
              f"trace {trace.stat().st_size} B, route {trainer.route} [{card}]")


def distributed_run(corpus: Path, native_model, card: str) -> None:
    """Phase 11, each part timed."""
    for label, fn in (
        ("11a", lambda: sharded_resume_run(corpus, native_model, card)),
        ("11b-c", lambda: sharded_loop_runs(card)),
        ("11d", lambda: multiprocess_run(card)),
        ("11e", lambda: cli_run(card)),
    ):
        t0 = time.perf_counter()
        fn()
        print(f"phase {label}: {time.perf_counter() - t0} s [{card}]")


def bench_line(leg: dict) -> str:
    """One train leg of the harness: each route's best run."""
    parts = [leg["leg"]]
    for name in ("device", "native"):
        r = leg[name]
        parts.append(
            f"{name}[{r['route']}]: {r['seconds']} s (ingest {r['ingest_seconds']} s, "
            f"merge {r['merge_seconds']} s) = {r['mb_per_s']} MB/s, {r['merges']} merges, "
            f"peak {r['peak_device_bytes']} B, runs {r['seconds_each']} s"
        )
    parts.append(f"device/native {leg['device_over_native']}")
    return "; ".join(parts)


def bench_run(bench, card: str) -> None:
    """Phase 13: the harness's 5 MB legs on the card through its own
    functions, each device run equal to the native loop (the harness
    raises otherwise), with the kernels' launch counts zeroed before and
    read after."""
    zero_kernel_launches()
    real = bench.train_leg(bench.REAL_5M, "train_real5m", card=card)
    repeated = bench.train_leg(bench.FIVE_M, "train_5m_repeated", card=card)
    enc = bench.encode_leg(card=card)
    launches = kernel_launches()
    print(f"bench launches: {launches}")
    check(real["device"]["route"] == "K2", f"train_real5m took {real['device']['route']}, not K2")
    check(repeated["device"]["route"] == "K1",
          f"train_5m_repeated took {repeated['device']['route']}, not K1")
    check(launches["hbm_merge_chunk"] > 0, "the bench legs never launched hbm_merge_chunk")
    check(launches["fused_merge_chunk"] > 0, "the bench legs never launched fused_merge_chunk")
    for leg in (real, repeated):
        print(f"{bench_line(leg)} [{card}]")
    batch, host = enc["batch_device"], enc["host_encode_real"]
    print(f"encode_5m: device batch {batch['mb_per_s']} MB/s warm ({batch['tokens']} tokens, "
          f"first call {batch['first_call_seconds']} s, peak {batch['peak_device_bytes']} B); "
          f"host encode of the realistic text {host['mb_per_s']} MB/s [{card}]")
    line = bench.result_line(real)
    print(f"bench line: {json.dumps(line)}")
    check(set(line) == {"metric", "value", "unit", "vs_baseline"},
          f"the bench line's keys are {sorted(line)}")
    check(line["metric"] == "train_bpe_realistic5MB_vocab1000_bytes_per_s" and line["unit"] == "bytes/s",
          f"the bench line names {line['metric']} in {line['unit']}")
    check(line["value"] > 0 and line["vs_baseline"] > 0, f"the bench line's numbers: {line}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (REPO / "src" / "yabpe_tpu_torch").is_dir():
        print(f"chip_smoke: {REPO} is not a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src"))
    sys.path.insert(0, str(REPO / "scripts"))
    bench = load_bench()

    from gen_corpus import generate

    from yabpe_tpu_torch import BBPETokenizer, BBPETrainer, BBPETrainerConfig, native
    from yabpe_tpu_torch.core.vocab import Vocab
    from yabpe_tpu_torch.core.wordtable import WordTable
    from yabpe_tpu_torch.io.native import load_model
    from yabpe_tpu_torch.kernels import _build, fused_loop, hbm_loop, replay_emit
    from yabpe_tpu_torch.pretok.ingest import count_pretokens
    from yabpe_tpu_torch.train import checkpoint as ckpt

    t_all = time.perf_counter()
    # ---- 1. card
    card = card_line()
    print(card)
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- 2. build, the three kernels and the native library side by side
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=6) as pool:
        kernel_builds = [
            pool.submit(_build.build, n)
            for n in ("hbm_loop", "fused_loop", "replay_emit", "fused_loop_v1", "replay_emit_v1")
        ]
        native_build = pool.submit(native.load)
        built = [b.result() for b in kernel_builds]
        native_build.result()
    names = ", ".join(path.name for path, _ in built)
    print(f"build: {time.perf_counter() - t0:.3f} s for {names} and the native library")
    for _, ptxas in built:
        for line in ptxas.splitlines():
            if "ptxas info" in line and ("registers" in line or "Compiling" in line or "smem" in line):
                print(f"  {line.strip()}")
            elif "stack frame" in line:
                print(f"  {line.strip()}")

    base = list(Vocab.base(SPECIALS).tokens())
    ingest = dict(chunk_size_bytes=32 << 20, max_workers=8, align_to_newline=True)

    # ---- 3. kernel against twin, 5 MB realistic fixture at vocab 4096
    fixture = REPO / "tests" / "fixtures_gpt2" / "bench_5M_realistic.txt"
    small = WordTable.from_counter(count_pretokens([fixture], SPECIALS, **ingest))
    small_merges = kernel_vs_twin("kernel_vs_twin_5M_v4096", small, base, 4096, 2, card)[-1]

    # the 100 MB corpus and its word table serve phases 4 and 8
    corpus_dir = tempfile.TemporaryDirectory(prefix="yabpe_chip_smoke_corpus_")
    corpus = Path(corpus_dir.name) / "corpus_100M.txt"
    with tempfile.TemporaryDirectory(prefix="yabpe_chip_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        generate(str(corpus), 100.0, lexicon_size=200_000)
        print(f"corpus: {corpus.stat().st_size} bytes in {time.perf_counter() - t0:.3f} s (host)")

        # ---- 4a. kernel against twin at the main path's shapes
        t0 = time.perf_counter()
        full = WordTable.from_counter(count_pretokens([corpus], SPECIALS, **ingest))
        print(f"word table: {full.num_words} words, width {full.width}, "
              f"{time.perf_counter() - t0:.3f} s (host)")
        ms, plain_ms, need, err, k2_steps, k2_rounds, _ = kernel_vs_twin(
            "kernel_vs_twin_100M_v32000", full, base, 32000, 2, card
        )

        # ---- 4b. the main path through the kernel
        cfg = dict(
            vocab_size=32000, min_frequency=2, max_workers=8,
            chunk_size_bytes=32 << 20, special_tokens=SPECIALS,
            align_chunks_to_newline=True,
        )
        trainer = BBPETrainer(BBPETrainerConfig(**cfg, use_native_loop=False, device="cuda"))
        torch.cuda.reset_peak_memory_stats()
        hbm_loop.LAUNCHES["hbm_merge_chunk"] = 0
        model = trainer.train([corpus])
        launches = hbm_loop.LAUNCHES["hbm_merge_chunk"]
        peak = torch.cuda.max_memory_allocated()
        stats = trainer.last_stats
        n = len(model.merges)
        print(f"main path (device): ingest_s={stats['ingest_seconds']} "
              f"merge_s={stats['merge_seconds']} merges={n} "
              f"merges_per_s={n / stats['merge_seconds']} "
              f"unique_pretokens={int(stats['unique_pretokens'])} [{card}]")
        print(f"main path (device): max_memory_allocated={peak} B "
              f"count_table={4 * 32000 * 32000} B kernel_launches={launches} [{card}]")
        check(launches > 0, "the main path never launched hbm_merge_chunk")
        check(n == 32000 - len(base), f"{n} merges, expected {32000 - len(base)}")

        # ---- 4c. byte-identical to the native host loop
        native_trainer = BBPETrainer(BBPETrainerConfig(**cfg, use_native_loop=True))
        native_model = native_trainer.train([corpus])
        print(f"native host loop: merge_s={native_trainer.last_stats['merge_seconds']} "
              f"merges={len(native_model.merges)} (host)")
        check(model.merges == native_model.merges, "device merges differ from the native loop")
        check(model.vocab == native_model.vocab, "device vocab differs from the native loop")
        big_native = native_model  # phase 8's reference

        # ---- 4d. save and load
        trainer.save(tmp / "device_model")
        native_trainer.save(tmp / "native_model")
        for name in ("vocab.json", "merges.txt", "special_tokens.json"):
            check((tmp / "device_model" / name).read_bytes()
                  == (tmp / "native_model" / name).read_bytes(), f"{name} differs")
        vocab, merges, specials = load_model(tmp / "device_model")
        check(vocab == model.vocab and specials == SPECIALS, "saved model does not load back")
        check(merges == load_model(tmp / "native_model")[1], "loaded merges differ")

    bound_ms = need / HBM_BYTES_PER_S * 1e3
    print(f"hbm_merge_chunk first chunk at V=32000: kernel {ms} ms "
          f"({1e3 * ms / k2_steps} us/step, {k2_rounds / k2_steps} verify rounds/step), "
          f"twin {plain_ms} ms, bound {bound_ms} ms by bytes "
          f"({1e3 * bound_ms / k2_steps} us/step) [{card}]")

    # ---- 5. K1 against its twin, chunk by chunk
    large = WordTable.from_counter(count_pretokens([REPO / "tests" / "data" / "large.txt"], SPECIALS))
    k1_first = k1_first_launch(large, base, 1024, 2, card)
    fused_vs_twin("fused_vs_twin_large_v1024", large, base, 1024, 2, 200, card)
    t0 = time.perf_counter()
    tiny = WordTable.from_counter(count_pretokens([TINYSTORIES], SPECIALS, max_workers=1))
    print(f"tinystories word table: {tiny.num_words} words, width {tiny.width}, "
          f"{time.perf_counter() - t0:.3f} s (host)")
    k1_ms, k1_plain_ms, k1_need, k1_err, k1_old_ms, k1_steps = fused_vs_twin(
        "fused_vs_twin_tinystories_v1000", tiny, base, 1000, 1, 256, card
    )
    print(f"K1 narrow words, TinyStories at V=1000, first chunk: {1e3 * k1_ms / k1_steps} us per step "
          f"(before wide words: 8.3-9.1 us on NVIDIA H100 80GB HBM3, 700.00 W, PERF.md §6) [{card}]")
    del large, tiny
    torch.cuda.empty_cache()

    # ---- 5w. K1 on words past 64 symbols, both token-byte layouts
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="yabpe_chip_smoke_k1_wide_") as tmp:
        (wide_ms, wide_plain_ms, wide_need, wide_err, wide_steps,
         wide_launches) = wide_k1_run(base, Path(tmp), card)
    wide_bound_ms = wide_need / HBM_BYTES_PER_S * 1e3
    print(f"phase 5w: {time.perf_counter() - t0} s [{card}]")

    with tempfile.TemporaryDirectory(prefix="yabpe_chip_smoke_k1_") as tmp:
        tmp = Path(tmp)
        # ---- 6. the small-vocabulary main path: the snapshot's settings
        cfg = dict(
            vocab_size=1000, min_frequency=1, max_workers=1,
            chunk_size_bytes=1 << 30, special_tokens=SPECIALS,
        )
        trainer = BBPETrainer(BBPETrainerConfig(**cfg, device="cuda"))
        fused_loop.LAUNCHES["fused_merge_chunk"] = 0
        hbm_loop.LAUNCHES["hbm_merge_chunk"] = 0
        model = trainer.train([TINYSTORIES])
        k1_launches = fused_loop.LAUNCHES["fused_merge_chunk"]
        k2_moved = hbm_loop.LAUNCHES["hbm_merge_chunk"]
        stats = trainer.last_stats
        n = len(model.merges)
        print(f"small-vocab main path (device): ingest_s={stats['ingest_seconds']} "
              f"merge_s={stats['merge_seconds']} merges={n} "
              f"merges_per_s={n / stats['merge_seconds']} fused_launches={k1_launches} "
              f"hbm_launches={k2_moved} [{card}]")
        check(k1_launches > 0, "the small-vocab main path never launched fused_merge_chunk")
        check(k2_moved == 0, "the small-vocab main path launched hbm_merge_chunk")
        with open(REPO / "tests" / "_snapshots" / "test_train_bpe_special_tokens.pkl", "rb") as f:
            snapshot = pickle.load(f)
        check(model.merges == snapshot["merges"], "K1 merges differ from the snapshot")
        check(set(model.vocab) == snapshot["vocab_values"], "K1 vocab tokens differ from the snapshot")
        check(set(model.vocab.values()) == snapshot["vocab_keys"], "K1 vocab ids differ from the snapshot")
        native_trainer = BBPETrainer(BBPETrainerConfig(**cfg, use_native_loop=True))
        native_model = native_trainer.train([TINYSTORIES])
        print(f"native host loop: merge_s={native_trainer.last_stats['merge_seconds']} "
              f"merges={len(native_model.merges)} (host)")
        check(model.merges == native_model.merges, "K1 merges differ from the native loop")
        check(model.vocab == native_model.vocab, "K1 vocab differs from the native loop")

        # ---- 7. save, load, encode and decode
        trainer.save(tmp / "model")
        tok = BBPETokenizer.from_file(tmp / "model")
        with open(TINYSTORIES, encoding="utf-8") as f:
            text = f.read(1 << 20)
        t0 = time.perf_counter()
        ids = tok.encode(text)
        encode_s = time.perf_counter() - t0
        check(tok.decode(ids) == text, "decode(encode(text)) differs on the first 1 MB")
        golden = REPO / "tests" / "fixtures_gpt2" / "golden_encode" / "gpt2_golden.json"
        snippets = json.loads(golden.read_text(encoding="utf-8"))["snippets"]["texts"]
        for snippet in snippets:
            got = tok.encode(snippet)
            check(tok.decode(got) == snippet, f"round trip differs on {snippet!r}")
            check(got == plain_ids(tok, snippet), f"native and plain encoders differ on {snippet!r}")
        nbytes = len(text.encode("utf-8"))
        print(f"tokenizer: {len(ids)} ids for {nbytes} bytes, host encode "
              f"{nbytes / encode_s / 1e6} MB/s (one thread, host); round trip exact on "
              f"{len(snippets)} snippets and the 1 MB prefix")

    k1_bound_ms = k1_need / HBM_BYTES_PER_S * 1e3
    print(f"fused_merge_chunk first chunk at V=1000: kernel {k1_ms} ms (first design {k1_old_ms} ms), "
          f"twin {k1_plain_ms} ms, bound {k1_bound_ms} ms by bytes [{card}]")

    # ---- 8a. K3 against its twin on the 4 shards of the 100 MB table
    vocab_ids = big_native.vocab
    chain = [
        (vocab_ids[left], vocab_ids[right], vocab_ids[left + right])
        for left, right in big_native.merges[:16]
    ]
    k3_ms, k3_plain_ms, k3_need, k3_err, k3_old_ms = replay_vs_twin(full, chain, 4, 64, card)
    k3_bound_ms = k3_need / HBM_BYTES_PER_S * 1e3
    del full

    # ---- 8b. the sharded main path
    cfg = dict(
        vocab_size=32000, min_frequency=2, max_workers=8,
        chunk_size_bytes=32 << 20, special_tokens=SPECIALS,
        align_chunks_to_newline=True,
    )
    trainer = BBPETrainer(BBPETrainerConfig(
        **cfg, data_shards=4, use_hbm_kernel=True, device="cuda",
    ))
    torch.cuda.reset_peak_memory_stats()
    for counter in (replay_emit.CALLS, replay_emit.LAUNCHES, replay_emit.MEMSETS):
        counter["replay_emit_chunk"] = 0
    sharded_model = trainer.train([corpus])
    k3_calls = replay_emit.CALLS["replay_emit_chunk"]
    k3_launches = replay_emit.LAUNCHES["replay_emit_chunk"]
    k3_memsets = replay_emit.MEMSETS["replay_emit_chunk"]
    peak = torch.cuda.max_memory_allocated()
    stats, loop = trainer.last_stats, trainer.loop_stats
    n = len(sharded_model.merges)
    epochs = loop["epochs"]
    print(f"sharded main path (device, 4 shards): ingest_s={stats['ingest_seconds']} "
          f"merge_s={stats['merge_seconds']} merges={n} "
          f"merges_per_s={n / stats['merge_seconds']} epochs={epochs} "
          f"commits_per_epoch={n / epochs} fallbacks={loop['fallbacks']} "
          f"select_cuts={loop['select_cuts']} chain_inexact={loop['chain_inexact']} "
          f"replay_calls={k3_calls} replay_launches={k3_launches} replay_memsets={k3_memsets} "
          f"max_memory_allocated={peak} B [{card}]")
    total = sum(loop["phase_ms"].values())
    print("sharded main path per epoch: " + ", ".join(
        f"{name} {phase_ms / epochs} ms ({100 * phase_ms / total} %)"
        for name, phase_ms in loop["phase_ms"].items()
    ) + f"; loop {1e3 * loop['loop_seconds'] / epochs} ms by the host clock [{card}]")
    check(k3_launches > 0, "the sharded main path never launched replay_emit_chunk")
    check(k3_launches == k3_calls == k3_memsets, "a replay call was not one launch and one memset")
    check(sharded_model.merges == big_native.merges, "sharded merges differ from the native loop")
    check(sharded_model.vocab == big_native.vocab, "sharded vocab differs from the native loop")
    print(f"replay_emit_chunk, one epoch's chain over 4 shards at V=32000: kernel {k3_ms} ms "
          f"(first design {k3_old_ms} ms), twin {k3_plain_ms} ms, bound {k3_bound_ms} ms by bytes [{card}]")

    # ---- 9a. K2's replay mode against its twin, phase 3's state and merges
    rp_ms, rp_plain_ms, rp_need, rp_steps, rp_err = k2_replay_vs_twin(
        small, base, 4096, 2, small_merges, 1000, card
    )
    rp_bound_ms = rp_need / HBM_BYTES_PER_S * 1e3
    del small

    # ---- 9b. checkpointed training at full width, then a resume through
    # K2's replay mode from a record cut off the chunk grid
    cut = 10_000
    with tempfile.TemporaryDirectory(prefix="yabpe_chip_smoke_ckpt_") as ckdir:
        cfg = BBPETrainerConfig(
            vocab_size=32000, min_frequency=2, max_workers=8,
            chunk_size_bytes=32 << 20, special_tokens=SPECIALS,
            align_chunks_to_newline=True, device="cuda",
            checkpoint_dir=ckdir, checkpoint_every_chunks=1,
        )
        trainer = BBPETrainer(cfg)
        hbm_loop.LAUNCHES["hbm_merge_chunk"] = 0
        ck_model = trainer.train([corpus])
        ck_launches = hbm_loop.LAUNCHES["hbm_merge_chunk"]
        ck_stats = trainer.last_stats
        check(trainer.route == "K2", f"checkpointed run took {trainer.route}, not K2")
        check(ck_model.merges == big_native.merges, "checkpointed merges differ from the native loop")
        check(ck_model.vocab == big_native.vocab, "checkpointed vocab differs from the native loop")
        merges_ids, saved = ckpt.load_checkpoint(ckdir, cfg)
        check(saved == 32000 - len(base), f"the last checkpoint is at step {saved}")
        record = merges_ids.copy()
        record[cut:] = -1
        ckpt.save_checkpoint(ckdir, record, cut, cfg)
        trainer = BBPETrainer(cfg)
        hbm_loop.LAUNCHES["hbm_merge_chunk"] = 0
        resumed = trainer.train([corpus])
        replay_launches = hbm_loop.LAUNCHES["hbm_merge_chunk"]
        rs_stats = trainer.last_stats
    print(f"checkpointed main path (device): merge_s={ck_stats['merge_seconds']} "
          f"kernel_launches={ck_launches} [{card}]")
    print(f"resumed main path (device, K2 replay): merge_s={rs_stats['merge_seconds']} "
          f"replayed_steps={cut} live_steps={len(resumed.merges) - cut} "
          f"kernel_launches={replay_launches} [{card}]")
    check(replay_launches > 0, "the resumed run never launched hbm_merge_chunk")
    check(resumed.merges == big_native.merges, "resumed merges differ from the native loop")
    check(resumed.vocab == big_native.vocab, "resumed vocab differs from the native loop")

    # ---- 9c. words past 64 symbols on the card: K1 where it admits them,
    # else the fallback engines
    with tempfile.TemporaryDirectory(prefix="yabpe_chip_smoke_wide_") as tmp:
        tmp = Path(tmp)
        large_txt = REPO / "tests" / "data" / "large.txt"
        for name, lines, seed in (("wide_5M.txt", fixture, 0), ("wide_large.txt", large_txt, 0),
                                  ("wide_large_seed1.txt", large_txt, 1)):
            (tmp / name).write_text(wide_text(lines, 2000, seed), encoding="utf-8")
        wide_words_run("wide_words_5M_v4096", [tmp / "wide_5M.txt"], 4096, "bigvocab", card)
        wide_words_run("wide_words_large_v1024", [tmp / "wide_large.txt"], 1024, "K1", card)
        wide_words_run("wide_words_large_v1024_no_k1", [tmp / "wide_large.txt"], 1024, "incremental",
                       card, use_fused_kernel=False)
        # seed 1: 1,027 words, 2,048 rows, past K1's admission at V=1024
        wide_words_run("wide_words_large_2048rows_v1024", [tmp / "wide_large_seed1.txt"], 1024,
                       "incremental", card)

    # ---- 10. file and device encoding
    t0 = time.perf_counter()
    device_encode_run(big_native.vocab, big_native.merges, corpus, tok, card)
    print(f"phase 10: {time.perf_counter() - t0:.3f} s")

    # ---- 11. the distributed layer and the CLI
    t0 = time.perf_counter()
    distributed_run(corpus, big_native, card)
    print(f"phase 11: {time.perf_counter() - t0:.3f} s [{card}]")
    corpus_dir.cleanup()

    # ---- 12. GPT-2's 50,000-merge model on the card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="yabpe_chip_smoke_gpt2_") as tmp:
        gpt2_run(Path(tmp), bench, card)
    print(f"phase 12: {time.perf_counter() - t0:.3f} s [{card}]")

    # ---- 13. the benchmark harness's 5 MB legs
    t0 = time.perf_counter()
    bench_run(bench, card)
    print(f"phase 13: {time.perf_counter() - t0:.3f} s [{card}]")
    print(f"total: {time.perf_counter() - t_all:.3f} s")
    record = {
        "kernels": [
            {
                "name": "hbm_merge_chunk",
                "route": "cuda",
                "source": "src/yabpe_tpu_torch/csrc/hbm_loop.cu",
                "replaces": "src/yabpe_tpu/kernels/hbm_loop.py:227",
                "launches": launches,
                "max_abs_err": max(err, rp_err),
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes",
                "library_ms": None,
                "replay_launches": replay_launches,
                "replay_steps": rp_steps,
                "replay_ms": rp_ms,
                "replay_plain_ms": rp_plain_ms,
                "replay_bound_ms": rp_bound_ms,
            },
            {
                "name": "fused_merge_chunk",
                "route": "cuda",
                "source": "src/yabpe_tpu_torch/csrc/fused_loop.cu",
                "replaces": "src/yabpe_tpu/kernels/fused_loop.py:161",
                "launches": k1_launches,
                "max_abs_err": k1_err,
                "ms": k1_ms,
                "old_ms": k1_old_ms,
                "first_launch_ms": k1_first,
                "plain_ms": k1_plain_ms,
                "bound_ms": k1_bound_ms,
                "bound_by": "bytes",
                "library_ms": None,
                "wide_launches": wide_launches,
                "wide_steps": wide_steps,
                "wide_ms": wide_ms,
                "wide_plain_ms": wide_plain_ms,
                "wide_bound_ms": wide_bound_ms,
                "wide_max_abs_err": wide_err,
            },
            {
                "name": "replay_emit_chunk",
                "route": "cuda",
                "source": "src/yabpe_tpu_torch/csrc/replay_emit.cu",
                "replaces": "src/yabpe_tpu/kernels/replay_emit.py:82",
                "launches": k3_launches,
                "calls": k3_calls,
                "memsets": k3_memsets,
                "max_abs_err": k3_err,
                "ms": k3_ms,
                "old_ms": k3_old_ms,
                "plain_ms": k3_plain_ms,
                "bound_ms": k3_bound_ms,
                "bound_by": "bytes",
                "library_ms": None,
            },
        ]
    }
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
