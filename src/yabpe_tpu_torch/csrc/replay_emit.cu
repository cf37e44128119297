// Replay of a merge chain over one word shard, logging every step's count
// delta cells, for Hopper (sm_90a): the CUDA counterpart of the TPU kernel
// yabpe_tpu/kernels/replay_emit.py::_replay_emit_kernel.
//
// What it computes. One call replays a K-step chain (a, b, c) over a shard
// of the port's word table and logs, step by step, the cells of the count
// delta that each merge makes:
//   words_in  [N, W] int32   symbol ids, -1 padded; read only
//   freqs     [N]    int32   word frequencies
//   chain     [K, 3] int32   (a, b, c) per step; a row with a < 0 is skipped
//   words_out [N, W] int32   the shard after the chain
//   log_l, log_r, log_w      [cps0 + (K-1)*cps rows of 128] int32 each: the
//                            cells (left, right, weight) of the steps; step
//                            0 owns the first cps0 rows, step j > 0 the cps
//                            rows after cps0 + (j-1)*cps
//   cursor    [K]    int32   the slots each step took: its cells are its
//                            slots [0, min(cursor, capacity)); the slots
//                            past them are not written
//   ok        [K]    int32   0 where a step's cells passed its capacity
// Each active step applies the leftmost non-overlapping (a, b) -> c to
// every word that holds the pair and logs the changed window's cells: old
// pairs -freq, new pairs +freq (merge_apply.cuh, the apply step of K1 and
// K2, with its log sink). A step whose cells pass its capacity gets
// ok = 0; its log is then full, and its words are applied all the same.
// The order of the cells within a step is not fixed (warps take their
// slots with an atomicAdd), so only a step's net delta, summed by cell, is
// a result.
//
// What bounds it on this card. Bytes: the shard read once and written
// once (N*W*4 bytes each, 6.2 MB for a quarter of the 100 MB corpus at
// W = 16), and the few cells logged. A chain of 16 steps changes a few
// thousand of the shard's ~97,000 words, so the useful work is the word
// reads and writes, about 4 us at the card's memory rate.
//
// What the design does about it. One launch per call, word-major: a
// thread owns one word for the whole chain. It loads the word once into
// registers (the width bucket 16, 32 or 64 is a template argument, and
// merge_apply.cuh's plan_regs and merge_regs index the word only
// statically), walks the chain from shared memory, merges at each active
// step whose pair it holds, and writes the word to words_out once at the
// end. No step needs a barrier against another: a word's state after step
// j depends only on that word and the chain. So each step's cells are the
// same multiset as in step-major order, each step's cell count the same,
// and with them the net deltas and the ok flags; only the slot order
// differs, which was never fixed. The slots: the words of a warp that
// hold a step's pair scan their cell counts (plan_regs knows them before
// the merge) and reserve the warp's run with one atomicAdd on cursor[j].
// Those atomics bound the kernel on an H100 (PERF.md): every one lands
// on one of K adjacent counters, so they queue at one L2 slice. One per
// word took 25-46 us a call, growing with the shard's changed words
// (10,000 to 40,000); one per warp takes 30-32 us on every shard, 12 %
// less over an epoch's four. Reserving once per block per step (a block
// scan) measured slower: 40 us with the steps' atomics one after another,
// 81-93 us with a 16-step group's atomics in flight together and the
// group merged twice. A first design made 21 stream operations a call: a
// copy of the shard, three memsets of the logs, an init kernel and one
// launch per chain step, each scanning the whole shard for the few words
// that hold its pair.
//
// Stream operations a call: one memset of 2K ints (cursor and ok, both
// zeroed) and this one launch. The logs are not cleared: a reader masks
// a step's slots at or past min(cursor[j], capacity). ok is written at the
// end of the launch by the last block to finish: each block, after its
// words, adds one to ok[0], used as the count of finished blocks; the
// block that brings it to gridDim.x sees every other block's reservations
// complete (each one's atomicAdd had returned before that block's count),
// and writes ok[j] = (cursor[j] <= capacity of step j)
// for every j, ok[0] included. That is the step-major kernel's rule: a
// step overflows exactly when its cells outnumber its slots.
//
// The input shard is never written (a partial commit replays a prefix
// over it again).

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_apply.cuh"

namespace {

using yabpe::kMaxWidth;

constexpr int kThreads = 256;
constexpr int kLane = 128;      // cells per log row, as in the TPU kernel
constexpr int kMaxSteps = 2048;  // chain rows a call takes (shared memory)

__device__ __forceinline__ int step_capacity(int j, int cps, int cps0) {
  return (j == 0 ? cps0 : cps) * kLane;
}

// One thread per word, the word in registers, padded to WB; W <= WB.
template <int WB>
__global__ void __launch_bounds__(kThreads)
    replay_kernel(const int* __restrict__ words_in,
                  const int* __restrict__ freqs, const int* __restrict__ chain,
                  int* __restrict__ words_out, int* __restrict__ log_l,
                  int* __restrict__ log_r, int* __restrict__ log_w, int* ok,
                  int* cursor, int N, int W, int K, int cps, int cps0) {
  extern __shared__ int s_chain[];  // [3K]
  __shared__ bool s_last;
  for (int t = threadIdx.x; t < 3 * K; t += blockDim.x) s_chain[t] = chain[t];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const unsigned act = __ballot_sync(0xffffffffu, i < N);  // the warp's words
  if (i < N) {
    int w[WB];
    const int* src = words_in + static_cast<size_t>(i) * W;
    int* dst = words_out + static_cast<size_t>(i) * W;
    // 16-byte loads and stores where the rows are whole, aligned int4s
    const bool vec = W == WB && (reinterpret_cast<uintptr_t>(words_in) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(words_out) & 15) == 0;
    if (vec) {
#pragma unroll
      for (int q = 0; q < WB / 4; ++q) {
        const int4 v = reinterpret_cast<const int4*>(src)[q];
        w[4 * q] = v.x;
        w[4 * q + 1] = v.y;
        w[4 * q + 2] = v.z;
        w[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < WB; ++k) w[k] = k < W ? src[k] : -1;
    }
    const int f = freqs[i];
    // The chain, step by step: the words of a warp that hold a step's pair
    // scan their cell counts, the last of the warp's lanes reserves the
    // warp's run with one atomicAdd on the step's cursor, and each word
    // merges, writing its cells into its part of the run.
    for (int j = 0; j < K; ++j) {
      const int a = s_chain[3 * j];
      if (a < 0) continue;
      const yabpe::RegsMerge m = yabpe::plan_regs<WB>(w, a, s_chain[3 * j + 1]);
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
                          run + incl - need};
      yabpe::merge_regs<WB>(w, m, f, s_chain[3 * j + 2], sink);
    }
    if (vec) {
#pragma unroll
      for (int q = 0; q < WB / 4; ++q)
        reinterpret_cast<int4*>(dst)[q] =
            make_int4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < WB; ++k)
        if (k < W) dst[k] = w[k];
    }
  }

  // The ok flags, from the final cursors, by the last block to finish
  // (the note at the top).
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(&ok[0], 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int j = threadIdx.x; j < K; j += blockDim.x)
      ok[j] = atomicAdd(&cursor[j], 0) <= step_capacity(j, cps, cps0) ? 1 : 0;
  }
}

template <int WB>
cudaError_t launch(const int* words_in, const int* freqs, const int* chain,
                   int* words_out, int* log_l, int* log_r, int* log_w,
                   int* ok, int* cursor, int N, int W, int K, int cps,
                   int cps0, cudaStream_t st) {
  const int blocks = max((N + kThreads - 1) / kThreads, 1);
  replay_kernel<WB><<<blocks, kThreads, 3 * K * sizeof(int), st>>>(
      words_in, freqs, chain, words_out, log_l, log_r, log_w, ok, cursor, N,
      W, K, cps, cps0);
  return cudaGetLastError();
}

}  // namespace

extern "C" int yabpe_replay_max_width() { return kMaxWidth; }

extern "C" const char* yabpe_replay_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Replays the K-step chain on `stream`, without syncing: one memset of
// `flags` ([2K] ints: cursor, then ok) and one kernel launch. Returns the
// first error (a cudaError_t), 0 when both were issued.
extern "C" int yabpe_replay_emit_chunk(const int* words_in, const int* freqs,
                                       const int* chain, int* words_out,
                                       int* log_l, int* log_r, int* log_w,
                                       int* flags, int N, int W, int K,
                                       int cps, int cps0, void* stream) {
  if (W > kMaxWidth || W < 2 || N < 0 || K < 1 || K > kMaxSteps || cps < 1 ||
      cps0 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* cursor = flags;
  int* ok = flags + K;
  cudaError_t err = cudaMemsetAsync(flags, 0, 2 * K * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (W <= 16)
    err = launch<16>(words_in, freqs, chain, words_out, log_l, log_r, log_w,
                     ok, cursor, N, W, K, cps, cps0, st);
  else if (W <= 32)
    err = launch<32>(words_in, freqs, chain, words_out, log_l, log_r, log_w,
                     ok, cursor, N, W, K, cps, cps0, st);
  else
    err = launch<64>(words_in, freqs, chain, words_out, log_l, log_r, log_w,
                     ok, cursor, N, W, K, cps, cps0, st);
  return static_cast<int>(err);
}
