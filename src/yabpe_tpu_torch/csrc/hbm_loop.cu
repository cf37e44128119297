// Merge-loop kernels for Hopper (sm_90a): the CUDA counterpart of the TPU
// kernel yabpe_tpu/kernels/hbm_loop.py::_hbm_loop_kernel.
//
// What it computes. One call runs merge steps [step_begin, step_end) of
// byte-level BPE training over state that lives in device memory:
//   words       [N, W] int32   symbol ids, -1 padded; updated in place
//   freqs       [N]    int32   word frequencies
//   counts      [V, V] int32   exact pair counts
//   row_max     [V]    int32   an upper bound on each row's max count
//   token_bytes [V, L] int32   token byte strings, -1 padded
//   token_len   [V], lex_rank [V] int32 (dense lex rank, -1 = inactive)
//   merges      [M, 3] int32   (a, b, c) per step, -1 where not taken
//   scalars     [8]    int32   next_id, stopped, num_done, then per-step
//                              temporaries (see the enum below)
// Each step is the JAX kernel's chain: select the pair with the highest
// count (ties to the lexicographically greatest (left, right) byte
// strings), grow the vocab (merged bytes, dedup against live tokens,
// lex-rank insertion), apply the leftmost non-overlapping merge to every
// word that holds the pair, and fold the count deltas into the table. A
// count below min_frequency sets `stopped`, and every later kernel returns
// at once.
//
// What bounds it on this card. Per step: (1) the word scan reads the whole
// word table (N*W*4 bytes, ~22 MB for a 100 MB corpus, inside the 50 MB
// L2) to find the few words that hold the pair; (2) the select kernel
// reads row_max and lex_rank (8V bytes) and one exact count row (4V bytes)
// for each verify, in ONE block; (3) five dependent launches, each a few
// microseconds of launch latency, where the useful work of a late step is
// a few hundred cells. On an H100 at the 100 MB / vocab 32,000 shapes, (2)
// takes most of a step (PERF.md, profile_torch.py).
//
// What the design does about it. The [V, V] table is never scanned: the
// lazy row-max bound (the scheme of hbm_loop.py:518-565) confines
// selection to O(V) reads plus the verified rows, and every positive
// delta raises its row's bound with atomicMax, so no exact refresh is
// needed. Deltas are folded straight into the table with int32 atomics
// (no pending-column buffer, no eviction: Hopper has them, the TPU did
// not), and only the changed window of each affected word is emitted.
// The host loop lives inside this library, so Python makes one call per
// chunk and syncs once per chunk. Left for later work: an inverted index
// in place of the word scan, a multi-block select, warp-aggregated
// atomics for the hot cells of the first merges, and a CUDA graph or a
// persistent kernel over the step chain.
//
// Exactness. The apply step (merge_apply.cuh, shared with fused_loop.cu
// and replay_emit.cu), with its table sink, keeps counts exact while the
// table's total pair mass stays below 2^31, which hbm_driver.py checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_apply.cuh"

namespace {

using yabpe::kMaxWidth;

enum Scalar : int {
  kNextId = 0,   // first free token id
  kStopped = 1,  // 1 once a step found no pair at min_frequency
  kNumDone = 2,  // merge steps taken
  kSelA = 3,     // this step's left id
  kSelB = 4,     // this step's right id
  kSelCnt = 5,   // this step's pair count
  kEqId = 6,     // id of a live token equal to the merged bytes, or -1
  kNLess = 7,    // live tokens below the merged bytes (its lex rank)
};

constexpr int kSelectThreads = 1024;
constexpr int kThreads = 256;

// (count, lex rank, id) as one key: a larger count wins, then a greater
// lex rank. Counts are >= 0; an inactive slot (lex -1) ranks lowest.
__device__ __forceinline__ unsigned long long pack_key(int count, int lex,
                                                       int idx) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(count)) << 32) |
         (static_cast<unsigned long long>((lex + 1) & 0xFFFF) << 16) |
         static_cast<unsigned long long>(idx & 0xFFFF);
}

__device__ __forceinline__ unsigned long long max_u64(unsigned long long x,
                                                      unsigned long long y) {
  return x > y ? x : y;
}

// Max over the block; every thread gets the result. `red` holds 33 slots.
__device__ unsigned long long block_max(unsigned long long v,
                                        unsigned long long* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = max_u64(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? red[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1)
      v = max_u64(v, __shfl_down_sync(0xffffffffu, v, o));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  v = red[32];
  __syncthreads();  // red is reused by the next call
  return v;
}

// One block. Lazy select: take the row whose bound is the global max (lex
// tie-break), read it exactly, and accept it when its exact max equals
// the bound; else tighten the bound and retry.
__global__ void select_kernel(const int* __restrict__ counts,
                              int* __restrict__ row_max,
                              const int* __restrict__ lex_rank,
                              int* __restrict__ scalars, int V,
                              int min_frequency) {
  __shared__ unsigned long long red[33];
  if (scalars[kStopped]) return;
  int a = 0, b = 0, best = 0;
  for (;;) {
    unsigned long long k = 0;
    for (int r = threadIdx.x; r < V; r += blockDim.x)
      k = max_u64(k, pack_key(row_max[r], lex_rank[r], r));
    k = block_max(k, red);
    const int m = static_cast<int>(k >> 32);
    a = static_cast<int>(k & 0xFFFF);
    if (m <= 0) {
      best = 0;
      break;
    }
    const int* row = counts + static_cast<size_t>(a) * V;
    unsigned long long k2 = 0;
    for (int col = threadIdx.x; col < V; col += blockDim.x)
      k2 = max_u64(k2, pack_key(row[col], lex_rank[col], col));
    k2 = block_max(k2, red);
    const int tm = static_cast<int>(k2 >> 32);
    if (threadIdx.x == 0) row_max[a] = tm;
    __syncthreads();
    if (tm == m) {
      best = tm;
      b = static_cast<int>(k2 & 0xFFFF);
      break;
    }
  }
  if (threadIdx.x == 0) {
    if (best < max(min_frequency, 1)) {
      scalars[kStopped] = 1;
    } else {
      scalars[kSelA] = a;
      scalars[kSelB] = b;
      scalars[kSelCnt] = best;
      scalars[kEqId] = -1;
      scalars[kNLess] = 0;
    }
  }
}

__device__ __forceinline__ int merged_byte(const int* __restrict__ tb, int L,
                                           int a, int b, int la, int lb,
                                           int d) {
  if (d < la) return tb[static_cast<size_t>(a) * L + d];
  if (d < la + lb) return tb[static_cast<size_t>(b) * L + (d - la)];
  return -1;
}

// Grid over token ids: compare every live token with the merged bytes.
// Finds the equal token (dedup) and counts the tokens below (lex rank).
__global__ void compare_kernel(const int* __restrict__ token_bytes,
                               const int* __restrict__ token_len,
                               int* __restrict__ scalars, int L) {
  extern __shared__ int merged[];
  if (scalars[kStopped]) return;
  const int a = scalars[kSelA], b = scalars[kSelB];
  const int next_id = scalars[kNextId];
  const int la = token_len[a], lb = token_len[b];
  for (int d = threadIdx.x; d < L; d += blockDim.x)
    merged[d] = merged_byte(token_bytes, L, a, b, la, lb, d);
  __syncthreads();
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int less = 0;
  if (t < next_id) {
    const int* row = token_bytes + static_cast<size_t>(t) * L;
    int d = 0;
    while (d < L && row[d] == merged[d]) ++d;
    if (d == L)
      atomicMax(&scalars[kEqId], t);  // token strings are unique
    else
      less = row[d] < merged[d];
  }
  const int n = __syncthreads_count(less);
  if (threadIdx.x == 0 && n) atomicAdd(&scalars[kNLess], n);
}

// Grid over token ids: record (a, b, c) and, for a new token, insert it
// (bytes, length, lex rank) and bump the ranks above it.
__global__ void vocab_kernel(int* __restrict__ token_bytes,
                             int* __restrict__ token_len,
                             int* __restrict__ lex_rank,
                             int* __restrict__ merges,
                             const int* __restrict__ scalars, int V, int L,
                             int step) {
  if (scalars[kStopped]) return;
  const int a = scalars[kSelA], b = scalars[kSelB];
  const int next_id = scalars[kNextId], eq = scalars[kEqId];
  const int ins = scalars[kNLess];
  const bool grow = eq < 0;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t == 0) {
    merges[3 * static_cast<size_t>(step)] = a;
    merges[3 * static_cast<size_t>(step) + 1] = b;
    merges[3 * static_cast<size_t>(step) + 2] = grow ? next_id : eq;
  }
  if (!grow || t >= V) return;
  if (t < next_id) {
    const int r = lex_rank[t];
    if (r >= ins) lex_rank[t] = r + 1;
  } else if (t == next_id) {
    const int la = token_len[a], lb = token_len[b];
    for (int d = 0; d < L; ++d)
      token_bytes[static_cast<size_t>(t) * L + d] =
          merged_byte(token_bytes, L, a, b, la, lb, d);
    token_len[t] = la + lb;
    lex_rank[t] = ins;
  }
}

// Grid over words, one thread each: a word that holds (a, b) gets the
// leftmost non-overlapping merge in place, and the pairs of its changed
// window are folded into the table: old pairs -freq, new pairs +freq.
__global__ void apply_kernel(int* __restrict__ words,
                             const int* __restrict__ freqs,
                             int* __restrict__ counts,
                             int* __restrict__ row_max,
                             const int* __restrict__ scalars, int N, int W,
                             int V) {
  if (scalars[kStopped]) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int a = scalars[kSelA], b = scalars[kSelB];
  int* w = words + static_cast<size_t>(i) * W;
  if (!yabpe::word_has_pair(w, W, a, b)) return;
  const int eq = scalars[kEqId];
  const int c = eq < 0 ? scalars[kNextId] : eq;
  yabpe::TableSink sink{counts, V, row_max};
  yabpe::merge_word(w, W, freqs[i], a, b, c, sink);
}

__global__ void finish_kernel(int* __restrict__ scalars) {
  if (scalars[kStopped]) return;
  if (scalars[kEqId] < 0) scalars[kNextId] += 1;
  scalars[kNumDone] += 1;
}

}  // namespace

extern "C" int yabpe_hbm_max_width() { return kMaxWidth; }

extern "C" const char* yabpe_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Runs merge steps [step_begin, step_end) on `stream`, without syncing.
// Returns the first launch error (a cudaError_t), 0 when all launched.
extern "C" int yabpe_hbm_merge_chunk(
    int* words, const int* freqs, int* counts, int* row_max,
    int* token_bytes, int* token_len, int* lex_rank, int* merges,
    int* scalars, int N, int W, int V, int L, int step_begin, int step_end,
    int min_frequency, void* stream) {
  if (W > kMaxWidth || W < 2 || V > 0xFFFF || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v_blocks = (V + kThreads - 1) / kThreads;
  const int n_blocks = (N + kThreads - 1) / kThreads;
  const size_t merged_bytes = static_cast<size_t>(L) * sizeof(int);
  for (int step = step_begin; step < step_end; ++step) {
    select_kernel<<<1, kSelectThreads, 0, st>>>(counts, row_max, lex_rank,
                                                scalars, V, min_frequency);
    compare_kernel<<<v_blocks, kThreads, merged_bytes, st>>>(
        token_bytes, token_len, scalars, L);
    vocab_kernel<<<v_blocks, kThreads, 0, st>>>(
        token_bytes, token_len, lex_rank, merges, scalars, V, L, step);
    if (n_blocks > 0)
      apply_kernel<<<n_blocks, kThreads, 0, st>>>(words, freqs, counts,
                                                  row_max, scalars, N, W, V);
    finish_kernel<<<1, 1, 0, st>>>(scalars);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
