// The first CUDA design of the small-vocabulary merge-loop kernel, superseded by fused_loop.cu.
// No route of the port calls it: chip_smoke.py builds it only to time
// the redesign against it on the same inputs in the same run (the
// kernels' JSON record's old_ms). Its C entry points carry a _v1_ infix.
//
// Small-vocabulary merge loop for Hopper (sm_90a): the CUDA counterpart of
// the TPU kernel yabpe_tpu/kernels/fused_loop.py::_merge_loop_kernel.
//
// What it computes. One launch runs merge steps [step_begin, step_end) of
// byte-level BPE training over state in device memory:
//   words       [N, W] int32   symbol ids, -1 padded; updated in place
//   freqs       [N]    int32   word frequencies
//   counts      [V, V] int32   exact pair counts
//   token_bytes [V, L] int32   token byte strings, -1 padded
//   token_len   [V], lex_rank [V] int32 (dense lex rank, -1 = inactive)
//   merges      [M, 3] int32   (a, b, c) per step, -1 where not taken
//   scalars     [8]    int32   next_id, stopped, num_done (the rest unused)
// Each step: select the cell with the highest count over the whole table
// (ties to the greatest lex rank of the row, then of the column); stop
// when that count is below max(min_frequency, 1); otherwise grow the
// vocab (merged bytes, dedup against live tokens, lex-rank insertion) and
// apply the leftmost non-overlapping merge to every word that holds the
// pair, folding the count deltas into the table (merge_apply.cuh, the
// apply step shared with hbm_loop.cu and replay_emit.cu, with its table
// sink).
//
// What bounds it on this card. The problems this kernel takes are small
// (the driver admits them by the JAX package's 48 MB plan, V about 1000 or
// less): the whole table is a few MB and sits in the 50 MB L2. A step's
// useful work is one pass over the live corner of the table plus a few
// hundred words, so the step is bound by latency: the grid-wide barriers
// between its phases, not bytes.
//
// What the design does about it. One persistent cooperative launch runs
// the whole chunk, as the TPU kernel's one fori_loop launch does: no
// launch gaps, and three grid barriers per step (after select, after
// compare, after vocab and apply). The TPU kernel's MXU one-hot gathers,
// two-limb f32 frequencies, line histograms and butterfly compaction are
// not carried over: the select is one packed 64-bit max with one atomicMax
// per block, the dedup compare and the lex-rank count are grid-stride
// with atomics, and the apply is one thread per word with int32 atomics.
//
// Grid barriers. Every block reaches every barrier: the stop decision and
// the step range are read from values written before a barrier and read
// after it, identically by every thread, so all blocks leave the loop at
// the same step. The per-step slots (select key, dedup id, rank count)
// come in two, chosen by step parity; a step resets the other parity's
// slots in its last phase, which no barrier-free phase shares with a
// reader or a writer of them.
//
// Build: a plain nvcc -shared compile; the cooperative-groups grid barrier
// needs no relocatable device code (-rdc) in CUDA 11 and later.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_apply.cuh"

namespace cg = cooperative_groups;

namespace {

enum Scalar : int {
  kNextId = 0,   // first free token id
  kStopped = 1,  // 1 once a step found no pair at min_frequency
  kNumDone = 2,  // merge steps taken
};

constexpr int kThreads = 512;

// Per-step slots, two of each, chosen by step parity.
struct Slots {
  unsigned long long key[2];  // packed (count, lex of row, lex of column)
  int eq[2];                  // least live id equal to the merged bytes
  int nless[2];               // live tokens below the merged bytes
};

// (count, lex of row, lex of column) as one key: a larger count wins,
// then a greater row lex rank, then a greater column lex rank. Only cells
// with a positive count take part, and both their tokens are live.
__device__ __forceinline__ unsigned long long pack_key(int count, int lex_row,
                                                       int lex_col) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(count)) << 32) |
         (static_cast<unsigned long long>((lex_row + 1) & 0xFFFF) << 16) |
         static_cast<unsigned long long>((lex_col + 1) & 0xFFFF);
}

// Max over the block; thread 0 gets the result. `red` holds 32 slots.
__device__ unsigned long long block_max(unsigned long long v,
                                        unsigned long long* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_down_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? red[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long u = __shfl_down_sync(0xffffffffu, v, o);
      v = u > v ? u : v;
    }
  }
  __syncthreads();  // red is reused by the next call
  return v;
}

__global__ void __launch_bounds__(kThreads)
    fused_loop_kernel(int* words, const int* __restrict__ freqs, int* counts,
                      int* token_bytes, int* token_len, int* lex_rank,
                      int* merges, int* scalars, Slots* slots, int N, int W,
                      int V, int L, int step_begin, int step_end,
                      int min_frequency) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int smem[];
  int* s_lex = smem;       // [V] lex ranks of this step
  int* s_merged = smem + V;  // [L] merged bytes of this step
  __shared__ unsigned long long red[32];
  __shared__ int s_ab[2];

  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int gsize = gridDim.x * blockDim.x;
  if (gtid == 0) {
    for (int p = 0; p < 2; ++p) {
      slots->key[p] = 0ull;
      slots->eq[p] = INT_MAX;
      slots->nless[p] = 0;
    }
  }
  // Every thread keeps the same copy of the loop's scalars.
  int next_id = scalars[kNextId];
  int stopped = scalars[kStopped];
  int num_done = scalars[kNumDone];
  grid.sync();

  volatile Slots* vs = slots;
  for (int step = step_begin; step < step_end && !stopped; ++step) {
    const int p = (step - step_begin) & 1;

    // ---- select: max packed key over the live corner of the table
    for (int t = threadIdx.x; t < V; t += blockDim.x) s_lex[t] = lex_rank[t];
    __syncthreads();
    unsigned long long k = 0ull;
    for (int row = blockIdx.x; row < next_id; row += gridDim.x) {
      const int lex_row = s_lex[row];
      const int* crow = counts + static_cast<size_t>(row) * V;
      for (int col = threadIdx.x; col < next_id; col += blockDim.x) {
        const int cnt = crow[col];
        if (cnt > 0) {
          const unsigned long long key = pack_key(cnt, lex_row, s_lex[col]);
          k = key > k ? key : k;
        }
      }
    }
    k = block_max(k, red);
    if (threadIdx.x == 0 && k != 0ull) atomicMax(&slots->key[p], k);
    grid.sync();

    // ---- compare: dedup id and insertion rank of the merged bytes
    const unsigned long long key = vs->key[p];
    const int best = static_cast<int>(key >> 32);
    if (best < max(min_frequency, 1)) {  // every block sees the same key
      stopped = 1;
      break;
    }
    const int lex_a = static_cast<int>((key >> 16) & 0xFFFF) - 1;
    const int lex_b = static_cast<int>(key & 0xFFFF) - 1;
    for (int t = threadIdx.x; t < next_id; t += blockDim.x) {
      const int r = s_lex[t];
      if (r == lex_a) s_ab[0] = t;
      if (r == lex_b) s_ab[1] = t;
    }
    __syncthreads();
    const int a = s_ab[0], b = s_ab[1];
    const int la = token_len[a], lb = token_len[b];
    for (int d = threadIdx.x; d < L; d += blockDim.x) {
      int v = -1;
      if (d < la)
        v = token_bytes[static_cast<size_t>(a) * L + d];
      else if (d < la + lb)
        v = token_bytes[static_cast<size_t>(b) * L + (d - la)];
      s_merged[d] = v;
    }
    __syncthreads();
    int less = 0;
    for (int t = gtid; t < next_id; t += gsize) {
      const int* row = token_bytes + static_cast<size_t>(t) * L;
      int d = 0;
      while (d < L && row[d] == s_merged[d]) ++d;
      if (d == L)
        atomicMin(&slots->eq[p], t);
      else
        less += row[d] < s_merged[d];
    }
    less = __reduce_add_sync(0xffffffffu, less);
    if ((threadIdx.x & 31) == 0 && less) atomicAdd(&slots->nless[p], less);
    grid.sync();

    // ---- vocab and apply
    const int eq = vs->eq[p];
    const int ins = vs->nless[p];
    const bool grow = eq == INT_MAX;
    const int c = grow ? next_id : eq;
    if (gtid == 0) {
      merges[3 * static_cast<size_t>(step)] = a;
      merges[3 * static_cast<size_t>(step) + 1] = b;
      merges[3 * static_cast<size_t>(step) + 2] = c;
      const int q = p ^ 1;  // the next step's slots
      slots->key[q] = 0ull;
      slots->eq[q] = INT_MAX;
      slots->nless[q] = 0;
    }
    if (grow) {
      for (int t = gtid; t <= next_id && t < V; t += gsize) {
        if (t < next_id) {
          const int r = s_lex[t];
          if (r >= ins) lex_rank[t] = r + 1;
        } else {
          for (int d = 0; d < L; ++d)
            token_bytes[static_cast<size_t>(t) * L + d] = s_merged[d];
          token_len[t] = la + lb;
          lex_rank[t] = ins;
        }
      }
    }
    yabpe::TableSink sink{counts, V, nullptr};
    for (int i = gtid; i < N; i += gsize) {
      int* w = words + static_cast<size_t>(i) * W;
      if (yabpe::word_has_pair(w, W, a, b))
        yabpe::merge_word(w, W, freqs[i], a, b, c, sink);
    }
    next_id += grow ? 1 : 0;
    num_done += 1;
    grid.sync();
  }

  if (gtid == 0) {
    scalars[kNextId] = next_id;
    scalars[kStopped] = stopped;
    scalars[kNumDone] = num_done;
  }
}

}  // namespace

extern "C" int yabpe_fused_v1_max_width() { return yabpe::kMaxWidth; }

extern "C" const char* yabpe_fused_v1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of the per-step slots the caller allocates on the device.
extern "C" int yabpe_fused_v1_slots_bytes() { return sizeof(Slots); }

// Blocks of the cooperative grid on the current device (occupancy times
// SMs), or the negated cudaError_t when the query fails.
extern "C" int yabpe_fused_v1_grid_blocks(int V, int L) {
  const size_t smem = static_cast<size_t>(V + L) * sizeof(int);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fused_loop_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return -static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_loop_kernel, kThreads, smem)) != cudaSuccess)
    return -static_cast<int>(err);
  return per_sm * sms;
}

// Runs merge steps [step_begin, step_end) in one cooperative launch on
// `stream`, without syncing. `slots` points to yabpe_fused_v1_slots_bytes()
// bytes of device memory. Returns the launch's cudaError_t, 0 on success.
extern "C" int yabpe_fused_v1_merge_chunk(
    int* words, const int* freqs, int* counts, int* token_bytes,
    int* token_len, int* lex_rank, int* merges, int* scalars, void* slots,
    int N, int W, int V, int L, int step_begin, int step_end,
    int min_frequency, void* stream) {
  if (W > yabpe::kMaxWidth || W < 2 || V > 0xFFFF || V < 1 || L < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = yabpe_fused_v1_grid_blocks(V, L);
  if (blocks < 0) return -blocks;
  if (blocks == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Slots* sl = static_cast<Slots*>(slots);
  void* args[] = {&words,   &freqs,  &counts,   &token_bytes, &token_len,
                  &lex_rank, &merges, &scalars, &sl,          &N,
                  &W,        &V,      &L,       &step_begin,  &step_end,
                  &min_frequency};
  const size_t smem = static_cast<size_t>(V + L) * sizeof(int);
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_loop_kernel), dim3(blocks), dim3(kThreads),
      args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
