// The first CUDA design of the replay kernel, superseded by replay_emit.cu.
// No route of the port calls it: chip_smoke.py builds it only to time
// the redesign against it on the same inputs in the same run (the
// kernels' JSON record's old_ms). Its C entry points carry a _v1_ infix.
//
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
//                            rows after cps0 + (j-1)*cps; an empty slot has
//                            left = right = -1 and weight 0
//   ok        [K]    int32   0 where a step's cells passed its capacity
//   cursor    [K]    int32   scratch: the slots each step has taken
// Each active step applies the leftmost non-overlapping (a, b) -> c to
// every word that holds the pair and logs the changed window's cells: old
// pairs -freq, new pairs +freq (merge_apply.cuh, the apply step of K1 and
// K2, with its log sink). A step whose cells pass its capacity gets
// ok = 0; its log may then be partly written, and its words are applied
// all the same. The order of the cells within a step is not fixed (each
// word takes its slots with an atomicAdd), so only a step's net delta,
// summed by cell, is a result.
//
// What bounds it on this card. Per active step, one pass over the shard's
// words (N*W*4 bytes, 6 MB for a quarter of the 100 MB corpus, inside the
// 50 MB L2) to find the few words that hold the pair; the logs are written
// once (cleared by two memsets). The useful work of a late step is a few
// hundred words, so a step is bound by launch latency and the word scan,
// not by the log's bytes.
//
// What the design does about it. The TPU kernel stages cells in VMEM,
// compacts them in 8-row blocks and drains the stage into the log; here
// each word thread takes its run of slots with one atomicAdd on the step's
// cursor and writes its cells straight to the log in device memory, so a
// step overflows only where the TPU kernel, which spends at least 8 rows
// on a window visit, overflows too. The chain stays on the device: a
// skipped row's launch returns at once, so the host never reads the chain
// and one call issues the whole chain on the stream without a sync. The
// shard the caller passes in is never written (a partial commit replays a
// prefix over it again): the words are copied to words_out first and the
// chain runs there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_apply.cuh"

namespace {

using yabpe::kMaxWidth;

constexpr int kThreads = 256;
constexpr int kLane = 128;  // cells per log row, as in the TPU kernel

__global__ void init_kernel(int* __restrict__ ok, int* __restrict__ cursor,
                            int K) {
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    ok[j] = 1;
    cursor[j] = 0;
  }
}

// Grid over words, one thread each, for chain step j.
__global__ void apply_log_kernel(int* __restrict__ words,
                                 const int* __restrict__ freqs,
                                 const int* __restrict__ chain,
                                 int* __restrict__ log_l,
                                 int* __restrict__ log_r,
                                 int* __restrict__ log_w,
                                 int* __restrict__ ok,
                                 int* __restrict__ cursor, int N, int W,
                                 int j, int cps, int cps0) {
  const int a = chain[3 * j];
  if (a < 0) return;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int b = chain[3 * j + 1];
  int* w = words + static_cast<size_t>(i) * W;
  if (!yabpe::word_has_pair(w, W, a, b)) return;
  const size_t base =
      static_cast<size_t>(j == 0 ? 0 : cps0 + (j - 1) * cps) * kLane;
  const int cap = (j == 0 ? cps0 : cps) * kLane;
  yabpe::LogSink sink{log_l + base, log_r + base, log_w + base, cap,
                      &cursor[j], &ok[j], 0};
  yabpe::merge_word(w, W, freqs[i], a, b, chain[3 * j + 2], sink);
}

}  // namespace

extern "C" int yabpe_replay_v1_max_width() { return kMaxWidth; }

extern "C" const char* yabpe_replay_v1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Replays the K-step chain on `stream`, without syncing. Returns the first
// error (a cudaError_t), 0 when everything was issued.
extern "C" int yabpe_replay_v1_emit_chunk(const int* words_in, const int* freqs,
                                       const int* chain, int* words_out,
                                       int* log_l, int* log_r, int* log_w,
                                       int* ok, int* cursor, int N, int W,
                                       int K, int cps, int cps0,
                                       void* stream) {
  if (W > kMaxWidth || W < 2 || N < 0 || K < 1 || cps < 1 || cps0 < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t log_bytes = static_cast<size_t>(cps0 + (K - 1) * cps) *
                           kLane * sizeof(int);
  cudaError_t err;
  if (N > 0) {
    err = cudaMemcpyAsync(words_out, words_in,
                          static_cast<size_t>(N) * W * sizeof(int),
                          cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if ((err = cudaMemsetAsync(log_l, 0xFF, log_bytes, st)) != cudaSuccess ||
      (err = cudaMemsetAsync(log_r, 0xFF, log_bytes, st)) != cudaSuccess ||
      (err = cudaMemsetAsync(log_w, 0, log_bytes, st)) != cudaSuccess)
    return static_cast<int>(err);
  init_kernel<<<1, kThreads, 0, st>>>(ok, cursor, K);
  const int n_blocks = (N + kThreads - 1) / kThreads;
  for (int j = 0; j < K && n_blocks > 0; ++j) {
    apply_log_kernel<<<n_blocks, kThreads, 0, st>>>(
        words_out, freqs, chain, log_l, log_r, log_w, ok, cursor, N, W, j,
        cps, cps0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
