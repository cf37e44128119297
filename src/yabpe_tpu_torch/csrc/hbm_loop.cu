// Merge-loop kernels for Hopper (sm_90a): the CUDA counterpart of the TPU
// kernel yabpe_tpu/kernels/hbm_loop.py::_hbm_loop_kernel.
//
// What it computes. One call runs merge steps [step_begin, step_end) of
// byte-level BPE training over state that lives in device memory:
//   words       [N, W] int32   symbol ids, -1 padded; updated in place
//   freqs       [N]    int32   word frequencies
//   counts      [V, V] int32   exact pair counts
//   row_max     [V]    int32   an upper bound on each row's max count
//   block_max   [V, NB] int32  an upper bound on the max count of each
//                              block of kBlockCols columns of a row
//                              (NB = block_count(V), merge_apply.cuh)
//   token_bytes [V, L] int32   token byte strings, -1 padded
//   token_len   [V], lex_rank [V] int32 (dense lex rank, -1 = inactive)
//   token_key   [V4]   u64     each token's prefix key (prefix_key below),
//                              V4 = V rounded up to a multiple of 4
//   merges      [M, 3] int32   (a, b, c) per step, -1 where not taken
//   scalars     [8]    int32   next_id, stopped, num_done, this step's
//                              (a, b, c) for the apply kernel, and the
//                              replay divergence flag
//   stats       [12]   int32   verify rounds, rows verified, the step
//                              kernel's time by phase, the replayed
//                              steps and their time, the column blocks
//                              the verifies read, and the token rows the
//                              dedup compare read (enum Stat)
// Each step is the JAX kernel's chain: select the pair with the highest
// count (ties to the lexicographically greatest (left, right) byte
// strings), grow the vocab (merged bytes, dedup against live tokens,
// lex-rank insertion), apply the leftmost non-overlapping merge to every
// word that holds the pair, and fold the count deltas into the table. A
// count below min_frequency sets `stopped`, and every later kernel returns
// at once.
//
// Replay mode (checkpoint resume; the JAX kernel's `replay_until`,
// hbm_loop.py:375,394-400,496-515). A step below `replay_until` takes
// (a, b) from its row of `merges`, which the driver preloaded with the
// checkpoint's record, in place of the select: it skips the bound pass and
// the verify rounds and runs the dedup compare, the lex rank, the vocab
// update, the record write and the apply exactly as a live step does. So
// the words, counts and vocab it leaves are a live run's. A record with
// a < 0 stops the loop, as the JAX kernel's _SEL_STOP does. A record
// whose ids are not live, or whose merged id differs from the id the vocab
// update gives, sets scalars[kDiverged] to the step + 1 and stops; the
// driver raises. Replay reads no count row and tightens no bound: row_max
// and block_max stay upper bounds through the apply's atomicMax, so the
// lazy select is exact when the live steps begin.
//
// Launch shape. Two launches per step, chained by programmatic dependent
// launch (PDL: each kernel lets the next one launch at its start, and
// waits on griddepcontrol.wait before it reads any state), so the launch
// of one hides behind the other's run:
//   1. step_kernel, ONE thread-block cluster of 16 CTAs of 256 threads
//      on neighbouring SMs (8 CTAs where 16 do not fit, as
//      cudaOccupancyMaxActiveClusters says; a cluster that fits nowhere
//      raises): the lazy select, the dedup compare and lex rank, and the
//      vocab update, as phases separated by cluster barriers. The CTAs
//      trade keys and counts through distributed shared memory, never
//      through a grid barrier or global atomics. 256 threads, not 1024:
//      the phases are chains of block reductions and barriers, and with
//      1024 threads the whole run's chunks took 1.45x as long (PERF.md);
//   2. apply_kernel, a grid over the words (merge_apply.cuh).
// The first CUDA version made five launches per step and selected in
// ONE block: on an H100 at 100 MB / vocab 32,000 its select took 31.5 us
// of a 49.6 us step late in the run (42.4 us early), at 2.1 verify rounds
// per step, each round 256 KB of row_max/lex_rank and 256 KB of one count
// row and lex_rank read by one SM (PERF.md).
//
// The select. CTA r owns a stripe of the live rows [0, next_id) (a
// multiple of 4 rows, read with 16-byte loads). A round:
//   - bound pass: each CTA finds the top two bound keys of its stripe,
//     key = pack_row_key(row_max, lex_rank, the row's slot in the stripe)
//     (select_keys.cuh), and keeps the stripe's keys in shared memory for
//     the step's later rounds;
//   - verify: each CTA whose stripe top beats the best exact key found so
//     far finds that row's exact max over the live columns [0, next_id)
//     (verify_row). A row of at most 8 blocks of 1,024 columns is read
//     whole, one 32 KB batch; a longer one through its block bounds:
//     block 0 and the bounds at once, then in full only the blocks whose
//     bound reaches a count the blocks read can still be beaten by, each
//     tightened to its exact max. lex_rank is read only at the columns
//     that hold the max, never in full, and a block max gives the column.
//     Up to 16 rows are verified per round, one per SM, in parallel;
//   - acceptance: the best verified exact key E = pack_row_key(exact max,
//     lex_rank, slot) is taken when E >= every bound key of a row not
//     verified in the round (the second key of a verified stripe, the top
//     key of any other stripe); else another round runs. E's row is its
//     stripe's first row + its slot: the stripe travels with E across the
//     cluster as the lane that read it.
// Exactness rule. row_max[r] >= max(counts[r]) and block_max[r, k] >=
// max(counts[r, k*kBlockCols:(k+1)*kBlockCols]) hold for every row and
// block after every step: bounds only go up (atomicMax in the apply's
// TableSink), and a verified row's bound and each block it read are
// tightened to their exact max. A block the verify leaves unread has a
// bound below the best count it read (or no count, bound 0), so it holds
// neither the row's max nor a tie of it: the read blocks give the row's
// exact max and its column. So an E that beats every unverified bound
// beats every row's exact key, and the row it names is the twin's: the
// highest count, ties to the greatest lex rank; its column is the
// greatest lex rank among the columns equal to that count. A row key
// holds the row's slot, not its id, and the column's pick packs (lex rank
// + 1, column) in 32 bits each, so ids and lex ranks reach
// kRowKeyMaxVocab = 2^17 (select_keys.cuh) with counts of 31 bits.
// kernels/hbm_loop.py::cluster_select_reference is this round structure
// in torch, and yabpe_hbm_select runs this kernel's select alone, so the
// rounds, the blocks read and the tightened row_max and block_max are
// held to it.
//
// The vocab phases. After the select, the merged string (rows a and b)
// is compared with every live token, to find a duplicate and the count
// of tokens below it (its lex rank); then the ranks at or above that are
// bumped. Reading a token row a thread at a time made that a chain of
// dependent loads, n / 4,096 deep, that grew with the live ids. Instead
// each token has a 64-bit prefix key (token_key, prefix_key below), kept
// beside its bytes. Right after its wait on the previous kernel, one
// thread of each CTA starts a bulk asynchronous copy (TMA, cp.async.bulk
// on an mbarrier) of its stripe's keys into shared memory, which lands
// while the select runs; the compare waits on that barrier, then orders
// each key against the merged string's in shared memory. Only equal keys
// of two strings longer than the key send a thread to the token's row
// (stats kTieRows counts those rows). The bump takes the stripe's ranks
// from its row keys, which the bound pass packed from lex_rank, so it
// loads nothing and stores only the ranks that change. A cluster is
// given room for the keys where it fits with it (pick_cluster: 16 CTAs
// hold them up to V = 131,072 in 128 KB, 8 up to ~113,000); without the
// room the compare reads the keys from device memory, a batch of loads
// in flight at a time. yabpe_hbm_select, the select alone, copies none.
//
// What bounds it now (H100 at 700 W, 100 MiB, PERF.md section 5). A step
// is a chain of dependent latencies, not bytes: 13.6 us of step kernel at
// vocab 100,001, 1.36-1.42 verify rounds a step. Each round is a bound
// pass over the stripe's row_max and lex_rank (3.2 us a step at 100k and
// 2.8 at 32,000, the first round's; later rounds reuse the keys in shared
// memory), the verify (6.7 and 6.5 us a step: block 0 and the bounds, 2.3
// and 2.7 blocks a row in all, the lex rank, two block reductions, a
// cluster barrier of ~0.6 us); then the vocab phases, 3.7 and 3.3 us a
// step and nearly flat in the live ids: rows a and b, the compare in
// shared memory, the exchange and its cluster barrier, the bump and the
// record. The apply kernel and the hand-offs take the other ~7 us;
// visiting only the words that hold the pair did not shorten them
// (PERF.md), so the kernel boundaries hold most of it. PDL saves about
// 1.8 us a step over plain stream order. Left for later: those hand-offs
// (one persistent kernel).
//
// Exactness of the table. The apply step (merge_apply.cuh, shared with
// fused_loop.cu and replay_emit.cu), with its table sink, keeps counts
// exact while the table's total pair mass stays below 2^31, which
// hbm_driver.py checks.
//
// Build. nvcc -gencode arch=compute_90a,code=sm_90a (kernels/_build.py):
// clusters, distributed shared memory and griddepcontrol need no other
// flag and no relocatable device code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_apply.cuh"
#include "select_keys.cuh"

namespace cg = cooperative_groups;

namespace {

using yabpe::kFullMask;
using yabpe::kMaxWidth;
using yabpe::kRowKeyMaxVocab;
using yabpe::max_u64;
using yabpe::pack_row_key;
using yabpe::row_key_count;
using yabpe::row_key_slot;
using yabpe::row_key_with_count;
using yabpe::stripe_rows;
using yabpe::top2_add;
using yabpe::top2_merge;
using yabpe::u64;
using yabpe::warp_max;
using yabpe::warp_top2;

enum Scalar : int {
  kNextId = 0,   // first free token id
  kStopped = 1,  // 1 once a step found no pair at min_frequency
  kNumDone = 2,  // merge steps taken
  kSelA = 3,     // this step's left id
  kSelB = 4,     // this step's right id
  kSelC = 5,     // this step's merged id (new, or the live duplicate)
  kDiverged = 6, // 1 + the replayed step whose record the vocab disagrees with
};

// HbmState.stats: counters, and nanoseconds by %globaltimer that CTA 0
// spends in each phase of the step kernel (after its wait on the previous
// kernel), each phase up to and including its cluster barrier.
enum Stat : int {
  kRounds = 0,     // verify rounds
  kVerified = 1,   // rows verified
  kNsBound = 2,    // bound passes
  kNsVerify = 3,   // verifies and acceptance
  kNsCompare = 4,  // merged bytes, dedup compare and lex rank
  kNsVocab = 5,    // vocab update and the record, to the last barrier
  kNsStep = 6,     // the whole step kernel
  kNsBarrier = 7,  // the first round's first cluster barrier alone
  kReplayed = 8,   // replayed steps (in none of the slots above)
  kNsReplay = 9,   // the whole step kernel of the replayed steps
  kBlocksRead = 10,  // column blocks the verifies read in full
  kTieRows = 11,     // token rows the dedup compare read (live steps)
};

// yabpe_hbm_select's output.
enum Out : int {
  kOutA = 0, kOutB, kOutCount, kOutRounds, kOutVerified, kOutCtas,
  kOutBlocks, kNumOut
};

constexpr int kStepThreads = 256;
constexpr int kMaxCtas = 16;  // CTAs of the step kernel's cluster, at most
constexpr int kStepWarps = kStepThreads / 32;
using yabpe::block_count;
using yabpe::kBlockCols;
using yabpe::kBlockShift;
// A verify keeps a row's block list in shared memory, and thread t holds
// the bound of block t.
constexpr int kMaxBlocks = (kRowKeyMaxVocab + kBlockCols - 1) / kBlockCols;
static_assert(kMaxBlocks <= kStepThreads, "a thread per block bound");
constexpr int kApplyThreads = 256;

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void launch_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// The two halves of the kernel's last cluster barrier: no CTA leaves
// while another may still read its shared memory.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Top two keys over the block; every thread gets them. `red` holds 66.
__device__ void block_top2(u64& t1, u64& t2, u64* red) {
  warp_top2(t1, t2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[2 * warp] = t1;
    red[2 * warp + 1] = t2;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < static_cast<int>(blockDim.x >> 5);
    t1 = in ? red[2 * lane] : 0ull;
    t2 = in ? red[2 * lane + 1] : 0ull;
    warp_top2(t1, t2);
    if (lane == 0) {
      red[64] = t1;
      red[65] = t2;
    }
  }
  __syncthreads();
  t1 = red[64];
  t2 = red[65];
  __syncthreads();  // red is reused by the next call
}

// Max over the block; every thread gets the result. `red` holds 33 or more.
__device__ u64 reduce_max(u64 v, u64* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0ull;
    v = warp_max(v);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();
  return v;
}

// Calls f(c, counts of column c) for this thread's share of the live
// columns [0, n) of a count row: the columns before the row's first
// 16-byte boundary, then int4 loads in batches of kBatch per thread, all
// of a batch issued before any is used (at 256 threads one batch covers
// 32 KB of the row), then the tail.
constexpr int kBatch = 8;

template <class F>
__device__ __forceinline__ void for_my_columns(const int* row, int n, F&& f) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int head = min(
      static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) >> 2),
      n);
  if (tid < head) f(tid, row[tid]);
  const int4* p = reinterpret_cast<const int4*>(row + head);
  const int n4 = (n - head) >> 2;
  for (int base = tid; base < n4; base += kBatch * T) {
    int4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = base + u * T;
      v[u] = j < n4 ? p[j] : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = base + u * T;
      if (j < n4) {
        const int c = head + 4 * j;
        f(c, v[u].x);
        f(c + 1, v[u].y);
        f(c + 2, v[u].z);
        f(c + 3, v[u].w);
      }
    }
  }
  for (int c = head + 4 * n4 + tid; c < n; c += T) f(c, row[c]);
}

// Rows of at most this many blocks (one batch of for_my_columns, 32 KB)
// are verified whole: below it the block bounds' extra ballots and
// barriers cost more than the batch they save.
constexpr int kWholeBlocks = kBatch * kStepThreads * 4 / kBlockCols;

// verify_row for a row of at most kWholeBlocks blocks, read whole in one
// batch: the max, with no lex_rank read, then lex_rank only at the
// columns that hold it (one load where a thread saw the max once, a
// re-read of its columns, from L1, on a tie), and a block max over (lex
// rank + 1, column). No block bound is read or tightened.
__device__ int verify_whole(const int* row, const int* lex_rank, int n,
                            u64* red, int* col_out) {
  int m = -1, col = 0, ties = 0;
  for_my_columns(row, n, [&](int c, int v) {
    if (v > m) {
      m = v;
      col = c;
      ties = 1;
    } else if (v == m) {
      ++ties;
    }
  });
  const int best = static_cast<int>(
      reduce_max(static_cast<u64>(static_cast<unsigned>(max(m, 0))), red));
  *col_out = 0;
  if (best <= 0) return 0;
  int l = -1;
  if (m == best) {
    if (ties == 1) {
      l = lex_rank[col];
    } else {
      for_my_columns(row, n, [&](int c, int v) {
        if (v == best) {
          const int x = lex_rank[c];
          if (x > l) {
            l = x;
            col = c;
          }
        }
      });
    }
  }
  const u64 pick = reduce_max(
      l < 0 ? 0ull
            : (static_cast<u64>(l + 1) << 32) | static_cast<unsigned>(col),
      red);
  *col_out = static_cast<int>(pick & 0xFFFFFFFFull);
  return best;
}

// Calls f(c, counts of column c) for lane `lane`'s share of the columns
// [c0, c1) of a count row, c1 - c0 <= kBlockCols, read by one warp: int4
// loads over the 16-byte-aligned body, all issued before any is used (8 a
// lane, so a warp holds a whole block of 4 KB in flight), and the at most
// three columns on either side of it. Lane j reads body int4s j, j + 32, ...
constexpr int kLaneLoads = kBlockCols / 128;

template <class F>
__device__ __forceinline__ void for_block_columns(const int* row, int c0, int c1,
                                                  int lane, F&& f) {
  const int* p = row + c0;
  const int len = c1 - c0;
  const int head = min(
      static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2),
      len);
  const int n4 = (len - head) >> 2;
  const int tail = head + 4 * n4;
  const int4* q = reinterpret_cast<const int4*>(p + head);
  int4 v[kLaneLoads];
#pragma unroll
  for (int u = 0; u < kLaneLoads; ++u) {
    const int j = lane + 32 * u;
    v[u] = j < n4 ? q[j] : make_int4(0, 0, 0, 0);
  }
  const int hv = lane < head ? p[lane] : 0;
  const int tv = tail + lane < len ? p[tail + lane] : 0;
  if (lane < head) f(c0 + lane, hv);
#pragma unroll
  for (int u = 0; u < kLaneLoads; ++u) {
    const int j = lane + 32 * u;
    if (j < n4) {
      const int c = c0 + head + 4 * j;
      f(c, v[u].x);
      f(c + 1, v[u].y);
      f(c + 2, v[u].z);
      f(c + 3, v[u].w);
    }
  }
  if (tail + lane < len) f(c0 + tail + lane, tv);
}

// The first index i >= start of a block list that warp `warp` reads: entry
// i goes to warp i % kStepWarps, in every pass and in the tie re-read.
__device__ __forceinline__ int first_entry(int start, int warp) {
  return start + ((warp - start) & (kStepWarps - 1));
}

// Shared memory of verify_row: the blocks read, in order, their exact
// maxima by block, and each ballot's counts and the warps' maxima.
struct VerifyScratch {
  int list[kMaxBlocks];
  int exact[kMaxBlocks];
  int warp_count[3][kStepWarps];
  int warp_max[kStepWarps];
};

// The exact max count of count row `row` over its live columns [0, n), 0
// for a row without a count; a row of more than kWholeBlocks blocks is
// read through its block bounds `bounds` (its row of block_max) and
// `bound`, the row's own bound (>= 1):
//   - Block 0, which holds the byte tokens and the first merges (a row's
//     max more often than any later block), is read by warp 0 while thread
//     t loads the bound of live block t: one latency for both.
//   - Where at most a block a warp of the others has a bound that reaches
//     max(best, 1), one pass reads them all, `>=` for a tie of greater lex
//     rank, and no unread block can then hold the max or a tie.
//   - Else pass 1 reads every unread block whose bound reaches `bound`:
//     under K2 row_max equals the largest of its row's block bounds (the
//     apply raises both with the same values, and a verify tightens the
//     row and its max's block to the same count), so these may hold it.
//     Pass 2, only where the blocks read hold less than `bound`, reads
//     every unread block whose bound reaches max(best, 1); after it no
//     unread block can hold the max or a tie, so there is no pass 3.
// A warp reads a block at a time, and every block read is tightened to its
// exact max. *col_out gets the column with the greatest lex rank among
// those equal to the max (0 for none): a thread loads the lex rank of its
// own max's column as soon as its counts arrive, so a pick without ties
// waits on no load; on a tie it re-reads its columns of the blocks that
// hold the max, from L1, and loads lex_rank where they equal it. A block
// max over (lex rank + 1, column) picks. *read_out gets the blocks read.
__device__ int verify_row(const int* row, int* bounds, const int* lex_rank,
                          int n, int bound, u64* red, VerifyScratch& vs,
                          int* col_out, int* read_out) {
  const int live = block_count(n);
  if (live <= kWholeBlocks) {
    *read_out = live;
    return verify_whole(row, lex_rank, n, red, col_out);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int m = -1, col = 0, ties = 0;  // over the columns this thread read
  int lx = -1, lx_col = -1;       // lex_rank[lx_col], loaded ahead
  auto load_lex = [&]() {
    if (m > 0 && col != lx_col) {
      lx = lex_rank[col];
      lx_col = col;
    }
  };
  // Reads block k (this warp), tightens its bound and returns its max.
  auto read_block = [&](int k) {
    int km = 0;
    for_block_columns(row, k << kBlockShift, min((k + 1) << kBlockShift, n),
                      lane, [&](int c, int v) {
                        km = max(km, v);
                        if (v > m) {
                          m = v;
                          col = c;
                          ties = 1;
                        } else if (v == m) {
                          ++ties;
                        }
                      });
    km = static_cast<int>(warp_max(static_cast<u64>(km)));
    if (lane == 0) {
      vs.exact[k] = km;
      bounds[k] = km;
    }
    return km;
  };
  const int bnd = tid < live ? bounds[tid] : 0;
  if (tid == 0) vs.list[0] = 0;
  int pass_max = warp == 0 ? read_block(0) : 0;
  load_lex();
  if (lane == 0) vs.warp_max[warp] = pass_max;
  __syncthreads();
  int best = 0;
#pragma unroll
  for (int w = 0; w < kStepWarps; ++w) best = max(best, vs.warp_max[w]);
  bool taken = tid == 0;  // thread t holds block t's bound
  int total = 1;          // blocks in the list
  // Ballot 0 counts the blocks one pass would read; ballots 1 and 2 are
  // passes 1 and 2 where it counts more than a block a warp.
  for (int ballot = 0, theta = max(best, 1);; ++ballot) {
    // The blocks of this pass, appended to the list in block order.
    const bool sel = tid < live && !taken && bnd >= theta;
    const unsigned bal = __ballot_sync(kFullMask, sel);
    if (lane == 0) vs.warp_count[ballot][warp] = __popc(bal);
    __syncthreads();
    int off = total, cnt = 0;
#pragma unroll
    for (int w = 0; w < kStepWarps; ++w) {
      const int c = vs.warp_count[ballot][w];
      off += w < warp ? c : 0;
      cnt += c;
    }
    if (ballot == 0 && cnt > kStepWarps && theta < max(bound, 1)) {
      theta = max(bound, 1);
      continue;
    }
    if (cnt > 0) {
      if (sel) {
        vs.list[off + __popc(bal & ((1u << lane) - 1))] = tid;
        taken = true;
      }
      __syncthreads();
      pass_max = 0;
      for (int i = first_entry(total, warp); i < total + cnt; i += kStepWarps)
        pass_max = max(pass_max, read_block(vs.list[i]));
      load_lex();
      if (lane == 0) vs.warp_max[warp] = pass_max;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kStepWarps; ++w) best = max(best, vs.warp_max[w]);
      total += cnt;
    }
    const int next = max(best, 1);
    if (next >= theta) break;
    theta = next;
  }
  *read_out = total;
  *col_out = 0;
  if (best <= 0) return 0;
  int l = -1;
  if (m == best) {
    if (ties == 1) {
      l = lx;
    } else {
      for (int i = first_entry(0, warp); i < total; i += kStepWarps) {
        const int k = vs.list[i];
        if (vs.exact[k] != best) continue;
        for_block_columns(row, k << kBlockShift, min((k + 1) << kBlockShift, n),
                          lane, [&](int c, int v) {
                            if (v == best) {
                              const int x = lex_rank[c];
                              if (x > l) {
                                l = x;
                                col = c;
                              }
                            }
                          });
      }
    }
  }
  const u64 pick = reduce_max(
      l < 0 ? 0ull
            : (static_cast<u64>(l + 1) << 32) | static_cast<unsigned>(col),
      red);
  *col_out = static_cast<int>(pick & 0xFFFFFFFFull);
  return best;
}

// A token's prefix key (core/lexkey.py::prefix_keys) from its -1 padded
// bytes: the first kKeyBytes bytes big-endian in 9 bits each, byte + 1 or
// 0 past its end, and in the lowest bit whether it is longer than
// kKeyBytes bytes. Two keys that differ order as the byte strings do (a
// prefix first); equal keys are equal strings unless both strings are
// longer than kKeyBytes bytes. No key is ~0 (a field holds at most 256).
constexpr int kKeyBytes = 7;

__device__ __forceinline__ u64 prefix_key(const int* bytes, int L) {
  u64 k = 0;
#pragma unroll
  for (int i = 0; i < kKeyBytes; ++i)
    if (i < L) k |= static_cast<u64>(bytes[i] + 1) << (64 - 9 * (i + 1));
  if (L > kKeyBytes && bytes[kKeyBytes] >= 0) k |= 1ull;
  return k;
}

// The lex rank that a row key holds (pack_row_key's lex + 1 field).
__device__ __forceinline__ int row_key_lex(u64 k) {
  constexpr int kBits = yabpe::kRowCountShift - yabpe::kRowSlotBits;
  return static_cast<int>((k >> yabpe::kRowSlotBits) & ((1ull << kBits) - 1)) - 1;
}

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread starts a bulk asynchronous copy (TMA) of `bytes` (a multiple
// of 16, both ends 16-byte aligned) from device memory to this CTA's
// shared memory, to complete on the barrier `bar` (initialised here for
// one phase; bytes 0 completes it at once).
__device__ __forceinline__ void stage_async(void* dst, const void* src,
                                            unsigned bytes, u64* bar) {
  const unsigned b = smem_address(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(bytes) : "memory");
  if (bytes != 0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        ::"r"(smem_address(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
}

// Waits until the copy of stage_async has landed; its bytes are then
// visible to the waiting thread.
__device__ __forceinline__ void wait_staged(u64* bar) {
  const unsigned b = smem_address(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(b), "r"(0u) : "memory");
}

// Lexicographic order of a token row (int4s, its first one `v` already
// loaded) against the merged bytes: -1 below, 0 equal, 1 above. Rows are
// -1 padded, so a prefix sorts first.
__device__ __forceinline__ int compare_token(const int4* row, int4 v,
                                             const int* merged, int L) {
  for (int d = 0;;) {
    const int x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (x[k] != merged[d + k]) return x[k] < merged[d + k] ? -1 : 1;
    d += 4;
    if (d >= L) return 0;
    v = row[d >> 2];
  }
}

// One merge step but its apply, in one cluster (the note at the top).
// With `out` set it runs the select alone and writes kNumOut ints there,
// (a, b, count, rounds, rows verified, CTAs, blocks read) with a = b = -1
// and count 0 for a stop, and leaves scalars, stats and the vocab as they
// are. A step below `replay_until` replays its record (the note at the
// top). `key_cap` is the rows of prefix keys that the dynamic shared
// memory holds past the row keys: a stripe's whole share where the cluster
// has room for it, staged there during the select; 0 where it has not,
// and then the compare reads the keys from device memory.
__global__ void __launch_bounds__(kStepThreads, 1)
    step_kernel(const int* counts, int* row_max, int* block_max, int* lex_rank,
                int* token_bytes, int* token_len, u64* token_key, int* merges,
                int* scalars, int* stats, int* out, int V, int L, int step,
                int min_frequency, int replay_until, int key_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ u64 red[66];
  __shared__ u64 pub_top1, pub_top2, pub_exact;
  __shared__ __align__(8) u64 key_bar;  // the staged keys' barrier
  __shared__ int pub_col, s_nless, s_eq, s_ties;
  __shared__ int all_nless[kMaxCtas], all_eq[kMaxCtas];  // by CTA
  __shared__ VerifyScratch vs;

  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  u64* keys = reinterpret_cast<u64*>(smem);  // this stripe's bound keys
  u64* staged = keys + stripe_rows(V, ctas);  // its prefix keys, key_cap rows
  int* merged = reinterpret_cast<int*>(staged + key_cap);

  wait_prior_grid();
  launch_next_grid();
  // Every CTA reads the same flag: they all leave here, or none does.
  if (scalars[kStopped]) return;
  const int n = scalars[kNextId];
  const int sz = stripe_rows(n, ctas);
  const int lo = min(rank * sz, n), hi = min(lo + sz, n), len = hi - lo;
  // The stripe's prefix keys, whole 16 bytes (token_key has rows to a
  // multiple of 4), land in shared memory while the select runs.
  const bool stage = key_cap > 0;
  if (stage && tid == 0)
    stage_async(staged, token_key + lo, static_cast<unsigned>((len + 1) & ~1) * 8u,
                &key_bar);
  const int thr = max(min_frequency, 1);
  const long long t_step = global_ns();
  long long t_phase = t_step, ns_bound = 0, ns_verify = 0, ns_barrier = 0;

  // Every thread of the cluster takes the same decisions from the same
  // data, so control flow, and every cluster barrier, is uniform.
  u64 best = 0;  // the best exact key verified so far
  int best_row = 0, best_col = 0, rounds = 0, verified = 0;
  int blocks = 0;  // read by this CTA's verifies
  bool stop = false;
  const bool replay = step < replay_until;
  int a = 0, b = 0;
  bool bad_record = false;
  if (replay) {
    a = merges[3 * static_cast<size_t>(step)];
    b = merges[3 * static_cast<size_t>(step) + 1];
    bad_record = a >= 0 && (a >= n || b < 0 || b >= n);
    stop = a < 0 || bad_record;
  } else {
    for (;;) {
      ++rounds;
      // Bound pass: the top two keys of this stripe.
      u64 t1 = 0, t2 = 0;
      if (rounds == 1) {
        const int4* rm = reinterpret_cast<const int4*>(row_max + lo);
        const int4* lx = reinterpret_cast<const int4*>(lex_rank + lo);
        const int n4 = len >> 2;
        for (int j = tid; j < n4; j += T) {
          const int4 m = rm[j], l = lx[j];
          const int s = 4 * j;
          const u64 k0 = pack_row_key(m.x, l.x, s), k1 = pack_row_key(m.y, l.y, s + 1);
          const u64 k2 = pack_row_key(m.z, l.z, s + 2), k3 = pack_row_key(m.w, l.w, s + 3);
          keys[4 * j] = k0;
          keys[4 * j + 1] = k1;
          keys[4 * j + 2] = k2;
          keys[4 * j + 3] = k3;
          top2_add(t1, t2, k0);
          top2_add(t1, t2, k1);
          top2_add(t1, t2, k2);
          top2_add(t1, t2, k3);
        }
        for (int i = 4 * n4 + tid; i < len; i += T) {
          const u64 k = pack_row_key(row_max[lo + i], lex_rank[lo + i], i);
          keys[i] = k;
          top2_add(t1, t2, k);
        }
      } else {
        for (int i = tid; i < len; i += T) top2_add(t1, t2, keys[i]);
      }
      block_top2(t1, t2, red);
      if (tid == 0) {
        pub_top1 = t1;
        pub_top2 = t2;
      }
      const long long t_sync = global_ns();
      cluster.sync();
      if (rounds == 1) ns_barrier = global_ns() - t_sync;
      // Lane c of every warp holds CTA c's top two.
      u64 k1 = 0, k2 = 0;
      if (lane < ctas) {
        k1 = *cluster.map_shared_rank(&pub_top1, lane);
        k2 = *cluster.map_shared_rank(&pub_top2, lane);
      }
      ns_bound += global_ns() - t_phase;
      t_phase = global_ns();
      if (row_key_count(warp_max(k1)) < thr) {  // no bound reaches min_frequency
        stop = true;
        break;
      }
      const bool cand = k1 > best && row_key_count(k1) > 0;
      verified += __popc(__ballot_sync(kFullMask, cand));
      const u64 mine = __shfl_sync(kFullMask, k1, rank);
      if (mine > best && row_key_count(mine) > 0) {
        const int slot = row_key_slot(mine);
        const int r = lo + slot;
        int col, read;
        const int m = verify_row(
            counts + static_cast<size_t>(r) * V,
            block_max + static_cast<size_t>(r) * block_count(V), lex_rank, n,
            row_key_count(mine), red, vs, &col, &read);
        blocks += read;
        if (tid == 0) {
          const u64 exact = row_key_with_count(mine, m);
          row_max[r] = m;
          keys[slot] = exact;
          pub_exact = exact;
          pub_col = col;
        }
      } else if (tid == 0) {
        pub_exact = 0;
      }
      cluster.sync();
      u64 e = 0;
      int col = 0, src = 0;  // src: the CTA, so the stripe, e came from
      if (cand) {
        e = *cluster.map_shared_rank(&pub_exact, lane);
        col = *cluster.map_shared_rank(&pub_col, lane);
        src = lane;
      }
      for (int o = 16; o > 0; o >>= 1) {
        const u64 oe = __shfl_xor_sync(kFullMask, e, o);
        const int oc = __shfl_xor_sync(kFullMask, col, o);
        const int os = __shfl_xor_sync(kFullMask, src, o);
        if (oe > e) {
          e = oe;
          col = oc;
          src = os;
        }
      }
      if (e > best) {
        best = e;
        best_row = src * sz + row_key_slot(e);
        best_col = col;
      }
      ns_verify += global_ns() - t_phase;
      t_phase = global_ns();
      // Accept when best beats the largest bound key of the rows not
      // verified this round.
      if (best >= warp_max(cand ? k2 : k1)) break;
    }
    if (!stop && row_key_count(best) < thr) stop = true;
    a = best_row;
    b = best_col;
    // Each CTA adds its own blocks: no exchange on the rounds' path.
    if (tid == 0 && blocks != 0)
      atomicAdd(out != nullptr ? &out[kOutBlocks] : &stats[kBlocksRead], blocks);
  }

  if (out != nullptr || stop) {
    if (stage && tid == 0) wait_staged(&key_bar);  // no copy outlives the CTA
    if (rank == 0 && tid == 0) {
      if (out != nullptr) {
        out[kOutA] = stop ? -1 : a;
        out[kOutB] = stop ? -1 : b;
        out[kOutCount] = stop ? 0 : row_key_count(best);
        out[kOutRounds] = rounds;
        out[kOutVerified] = verified;
        out[kOutCtas] = ctas;
      } else if (replay) {
        scalars[kStopped] = 1;
        if (bad_record) scalars[kDiverged] = step + 1;
      } else {
        scalars[kStopped] = 1;
        stats[kRounds] += rounds;
        stats[kVerified] += verified;
        stats[kNsBound] += static_cast<int>(ns_bound);
        stats[kNsVerify] += static_cast<int>(ns_verify);
        stats[kNsBarrier] += static_cast<int>(ns_barrier);
        stats[kNsStep] += static_cast<int>(global_ns() - t_step);
      }
    }
    cluster_arrive();
    cluster_wait();
    return;
  }

  // Dedup and lex rank: this stripe's live tokens against the merged
  // bytes, built from rows a and b and their lengths, all loaded at once
  // (L is a multiple of 4, so a token row is whole int4s). A token's
  // prefix key against the merged string's decides where they differ;
  // only where they are equal and both strings are longer than the key is
  // the token's row read and the rest compared.
  t_phase = global_ns();
  // The exchange below writes into other CTAs' shared memory, which is
  // safe once every CTA of the cluster has met at a cluster barrier. A
  // live step's rounds have; a replayed step meets here, its wait behind
  // the compare.
  if (replay) cluster_arrive();
  int* row_a = merged + L;
  int* row_b = row_a + L;
  const int la = token_len[a], lb = token_len[b];
  for (int d = tid; d < L; d += T) {
    row_a[d] = token_bytes[static_cast<size_t>(a) * L + d];
    row_b[d] = token_bytes[static_cast<size_t>(b) * L + d];
  }
  if (tid == 0) {
    s_nless = 0;
    s_eq = -1;
    s_ties = 0;
  }
  __syncthreads();
  for (int d = tid; d < L; d += T)
    merged[d] = d < la ? row_a[d] : d < la + lb ? row_b[d - la] : -1;
  __syncthreads();
  const u64 mkey = prefix_key(merged, L);
  // The stripe's keys, read in batches: all of a batch's loads issued
  // before any is compared, with no branch but on an equal key (a row
  // past the stripe reads as ~0, which no key equals or exceeds). Called
  // on the staged copy, or where the cluster had no room for it on device
  // memory, so that each call reads one known memory space.
  int less = 0, ties = 0;
  auto compare_keys = [&](const u64* tk) {
    for (int base = tid; base < len; base += kBatch * T) {
      u64 k[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = base + u * T;
        k[u] = j < len ? tk[j] : ~0ull;
      }
      unsigned equal = 0;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        less += k[u] < mkey;
        equal |= static_cast<unsigned>(k[u] == mkey) << u;
      }
      for (; equal != 0; equal &= equal - 1) {
        const int t = lo + base + (__ffs(equal) - 1) * T;
        int c = 0;
        if (mkey & 1ull) {  // both longer than the key: compare the rest
          const int4* row =
              reinterpret_cast<const int4*>(token_bytes + static_cast<size_t>(t) * L);
          c = compare_token(row, row[0], merged, L);
          ++ties;
        }
        if (c == 0) atomicMax(&s_eq, t);  // token strings are unique
        less += c < 0;
      }
    }
  };
  if (stage) {
    wait_staged(&key_bar);
    compare_keys(staged);
  } else {
    compare_keys(token_key + lo);
  }
  less = warp_sum(less);
  ties = warp_sum(ties);
  if (lane == 0 && less) atomicAdd(&s_nless, less);
  if (lane == 0 && ties) atomicAdd(&s_ties, ties);
  __syncthreads();
  // Each CTA writes its count and duplicate into its slot of every CTA's
  // arrays, so that after the barrier each reads its own shared memory.
  if (replay) cluster_wait();
  if (tid < ctas) {
    *cluster.map_shared_rank(&all_nless[rank], tid) = s_nless;
    *cluster.map_shared_rank(&all_eq[rank], tid) = s_eq;
  }
  // Each CTA adds its own rows, as its verifies' blocks.
  if (tid == 0 && !replay && s_ties != 0) atomicAdd(&stats[kTieRows], s_ties);
  cluster.sync();
  int ins = lane < ctas ? all_nless[lane] : 0;
  int eq = lane < ctas ? all_eq[lane] : -1;
  ins = warp_sum(ins);
  for (int o = 16; o > 0; o >>= 1) eq = max(eq, __shfl_xor_sync(kFullMask, eq, o));
  cluster_arrive();  // no shared memory of another CTA is touched below
  const long long ns_compare = global_ns() - t_phase;
  t_phase = global_ns();

  // Vocab update: a new token's bytes, length, prefix key and lex rank,
  // and the ranks above it bumped. A live step takes the stripe's ranks
  // from its row keys, which the bound pass packed from lex_rank, so it
  // only stores; a replayed step, which packs no row key, loads them.
  const bool grow = eq < 0;
  if (grow) {
    for (int i = tid; i < len; i += T) {
      const int r = replay ? lex_rank[lo + i] : row_key_lex(keys[i]);
      if (r >= ins) lex_rank[lo + i] = r + 1;
    }
    if (rank == 0 && n < V) {
      for (int d = tid; d < L; d += T)
        token_bytes[static_cast<size_t>(n) * L + d] = merged[d];
      if (tid == 0) {
        token_len[n] = la + lb;
        token_key[n] = mkey;
        lex_rank[n] = ins;
      }
    }
  }
  if (rank == 0 && tid == 0) {
    const int c = grow ? n : eq;
    if (replay && c != merges[3 * static_cast<size_t>(step) + 2]) {
      // The record disagrees with this vocab: stop before the apply.
      scalars[kDiverged] = step + 1;
      scalars[kStopped] = 1;
    }
    merges[3 * static_cast<size_t>(step)] = a;
    merges[3 * static_cast<size_t>(step) + 1] = b;
    merges[3 * static_cast<size_t>(step) + 2] = c;
    scalars[kSelA] = a;
    scalars[kSelB] = b;
    scalars[kSelC] = c;
    scalars[kNextId] = n + (grow ? 1 : 0);
    // Adds whose result is unused: reductions in memory, so the thread
    // waits on no load before the last barrier, nor the kernel's end.
    atomicAdd(&scalars[kNumDone], 1);
    if (replay) {
      atomicAdd(&stats[kReplayed], 1);
    } else {
      atomicAdd(&stats[kRounds], rounds);
      atomicAdd(&stats[kVerified], verified);
      atomicAdd(&stats[kNsBound], static_cast<int>(ns_bound));
      atomicAdd(&stats[kNsVerify], static_cast<int>(ns_verify));
      atomicAdd(&stats[kNsCompare], static_cast<int>(ns_compare));
      atomicAdd(&stats[kNsBarrier], static_cast<int>(ns_barrier));
    }
  }
  cluster_wait();
  if (rank == 0 && tid == 0) {
    const long long now = global_ns();
    if (replay) {
      atomicAdd(&stats[kNsReplay], static_cast<int>(now - t_step));
    } else {
      atomicAdd(&stats[kNsVocab], static_cast<int>(now - t_phase));
      atomicAdd(&stats[kNsStep], static_cast<int>(now - t_step));
    }
  }
}

// Grid over words, one thread each: a word that holds (a, b) gets the
// leftmost non-overlapping merge in place, and the pairs of its changed
// window are folded into the table: old pairs -freq, new pairs +freq.
__global__ void __launch_bounds__(kApplyThreads)
    apply_kernel(int* __restrict__ words, const int* __restrict__ freqs,
                 int* counts, int* row_max, int* block_max, const int* scalars,
                 int N, int W, int V) {
  wait_prior_grid();
  launch_next_grid();
  if (scalars[kStopped]) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int a = scalars[kSelA], b = scalars[kSelB];
  int* w = words + static_cast<size_t>(i) * W;
  if (!yabpe::word_has_pair(w, W, a, b)) return;
  yabpe::TableSink sink{counts, V, row_max, block_max};
  yabpe::merge_word(w, W, freqs[i], a, b, scalars[kSelC], sink);
}

// Dynamic shared memory: the stripe's row keys, `key_cap` rows of staged
// prefix keys, then the merged bytes and token rows a and b.
size_t step_smem_bytes(int V, int L, int ctas, int key_cap) {
  return sizeof(u64) * (static_cast<size_t>(stripe_rows(V, ctas)) + key_cap) +
         3 * sizeof(int) * static_cast<size_t>(L);
}

// The cluster for this problem: 16 CTAs where a cluster of 16 fits on the
// card, else 8; cudaErrorLaunchOutOfResources where neither does. With
// `stage`, each size is tried first with room for the stripe's prefix
// keys (*key_cap_out = the stripe's rows), then without (0), so the
// staging never costs a cluster its 16 CTAs.
cudaError_t pick_cluster(int V, int L, bool stage, int* ctas_out,
                         int* key_cap_out, size_t* smem_out) {
  cudaError_t err = cudaFuncSetAttribute(
      step_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, step_kernel);
  int dev = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int sizes[2] = {kMaxCtas, 8};
  for (int ctas : sizes) {
    for (int staged = stage ? 1 : 0; staged >= 0; --staged) {
      const int key_cap = staged ? stripe_rows(V, ctas) : 0;
      const size_t smem = step_smem_bytes(V, L, ctas, key_cap);
      if (smem + fa.sharedSizeBytes > static_cast<size_t>(optin)) continue;
      err = cudaFuncSetAttribute(step_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(ctas);
      cfg.blockDim = dim3(kStepThreads);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = ctas;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, step_kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (clusters >= 1) {
        *ctas_out = ctas;
        *key_cap_out = key_cap;
        *smem_out = smem;
        return cudaSuccess;
      }
    }
  }
  return cudaErrorLaunchOutOfResources;
}

cudaError_t launch_step(int ctas, int key_cap, size_t smem, cudaStream_t st,
                        const int* counts, int* row_max, int* block_max,
                        int* lex_rank, int* token_bytes, int* token_len,
                        u64* token_key, int* merges, int* scalars, int* stats,
                        int* out, int V, int L, int step, int min_frequency,
                        int replay_until) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kStepThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = ctas;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, step_kernel, counts, row_max, block_max,
                            lex_rank, token_bytes, token_len, token_key, merges,
                            scalars, stats, out, V, L, step, min_frequency,
                            replay_until, key_cap);
}

cudaError_t launch_apply(int n_blocks, cudaStream_t st, int* words,
                         const int* freqs, int* counts, int* row_max,
                         int* block_max, const int* scalars, int N, int W,
                         int V) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(kApplyThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, apply_kernel, words, freqs, counts,
                            row_max, block_max, scalars, N, W, V);
}

}  // namespace

extern "C" int yabpe_hbm_max_width() { return kMaxWidth; }

extern "C" int yabpe_hbm_max_vocab() { return kRowKeyMaxVocab; }

extern "C" int yabpe_hbm_block_cols() { return kBlockCols; }

extern "C" const char* yabpe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// CTAs in the step kernel's cluster for this problem (16 or 8), or minus
// the cudaError_t that says why no cluster fits. Where `staged` is not
// null it gets 1 where the merge steps stage their stripes' prefix keys in
// shared memory, 0 where they read them from device memory.
extern "C" int yabpe_hbm_cluster_ctas(int V, int L, int* staged) {
  int ctas = 0, key_cap = 0;
  size_t smem = 0;
  const cudaError_t err = pick_cluster(V, L, true, &ctas, &key_cap, &smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (staged != nullptr) *staged = key_cap > 0 ? 1 : 0;
  return ctas;
}

// Runs merge steps [step_begin, step_end) on `stream`, without syncing;
// the steps below `replay_until` replay their rows of `merges`. With
// `stage_keys` 1 the steps stage their stripes' prefix keys in shared
// memory where the cluster has room (pick_cluster); 0 makes them read the
// keys from device memory, the path of a card without that room, which
// the tests take on purpose. Returns the first launch error (a
// cudaError_t), 0 when all launched.
extern "C" int yabpe_hbm_merge_chunk(
    int* words, const int* freqs, int* counts, int* row_max, int* block_max,
    int* token_bytes, int* token_len, int* lex_rank, u64* token_key,
    int* merges, int* scalars, int* stats, int N, int W, int V, int L,
    int step_begin, int step_end, int min_frequency, int replay_until,
    int stage_keys, void* stream) {
  if (W > kMaxWidth || W < 2 || V > kRowKeyMaxVocab || V < 1 || L < 4 ||
      L % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int ctas = 0, key_cap = 0;
  size_t smem = 0;
  cudaError_t err = pick_cluster(V, L, stage_keys != 0, &ctas, &key_cap, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (N + kApplyThreads - 1) / kApplyThreads;
  for (int step = step_begin; step < step_end; ++step) {
    err = launch_step(ctas, key_cap, smem, st, counts, row_max, block_max,
                      lex_rank, token_bytes, token_len, token_key, merges,
                      scalars, stats, nullptr, V, L, step, min_frequency,
                      replay_until);
    if (err == cudaSuccess && n_blocks > 0)
      err = launch_apply(n_blocks, st, words, freqs, counts, row_max,
                         block_max, scalars, N, W, V);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// The step kernel's select alone, on `stream`, without syncing: reads
// next_id from scalars (stopped must be 0), tightens row_max and
// block_max as a step does, and writes (a, b, count, rounds, rows
// verified, CTAs, blocks read) to out[7].
extern "C" int yabpe_hbm_select(const int* counts, int* row_max,
                                int* block_max, int* lex_rank, int* scalars,
                                int* out, int V, int min_frequency,
                                void* stream) {
  if (V > kRowKeyMaxVocab || V < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0, key_cap = 0;
  size_t smem = 0;
  cudaError_t err = pick_cluster(V, 4, false, &ctas, &key_cap, &smem);
  if (err == cudaSuccess)
    err = launch_step(ctas, 0, smem, static_cast<cudaStream_t>(stream), counts,
                      row_max, block_max, lex_rank, nullptr, nullptr, nullptr,
                      nullptr, scalars, nullptr, out, V, 4, 0, min_frequency, 0);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
