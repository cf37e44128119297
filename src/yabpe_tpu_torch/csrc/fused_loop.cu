// Small-vocabulary merge loop for Hopper (sm_90a): the CUDA counterpart of
// the TPU kernel yabpe_tpu/kernels/fused_loop.py::_merge_loop_kernel.
//
// What it computes. One launch runs merge steps [step_begin, step_end) of
// byte-level BPE training over state in device memory:
//   words       [N, W] int32   symbol ids, -1 padded; updated in place
//   freqs       [N]    int32   word frequencies
//   counts      [V, V] int32   exact pair counts
//   row_max     [V]    int32   an upper bound on each row's max count
//   token_bytes [V, L] int32   token byte strings, -1 padded
//   token_len   [V], lex_rank [V] int32 (dense lex rank, -1 = inactive)
//   merges      [M, 3] int32   (a, b, c) per step, -1 where not taken
//   scalars     [8]    int32   next_id, stopped, num_done (the rest unused)
// Each step: select the cell with the highest count over the whole table
// (ties to the greatest lex rank of the row, then of the column); stop
// when that count is below max(min_frequency, 1); otherwise grow the
// vocab (merged bytes, dedup against live tokens, lex-rank insertion) and
// apply the leftmost non-overlapping merge to every word that holds the
// pair, folding the count deltas into the table and raising row_max
// (merge_apply.cuh, the apply step shared with hbm_loop.cu and
// replay_emit.cu, with its table sink).
//
// What bounds it on this card. The problems this kernel takes are small
// (the driver admits them by the JAX package's 48 MB plan, V about 1000 or
// less, up to ~10,000 rows at width 16, or ~1,000 rows of 304 symbols):
// the table is a few MB and sits in the 50 MB L2. A step's useful work is
// a few count rows and a few hundred words, so a step is bound by
// latency: the chain of dependent reads, reductions and barriers, not
// bytes.
//
// What the design does about it. One thread-block cluster of 1 to 16
// CTAs of 512 threads runs the whole chunk, persistently: as many CTAs as
// give every word a thread, where a cluster that large fits (the launch
// shape is queried once per process and problem shape, and cached by the
// wrapper). Two barriers a step, no grid barrier:
//   1. CTA 0 alone selects the pair, finds the merged bytes' equal id and
//      insertion rank, updates the vocab and records the merge, and
//      publishes (a, b, c) in its shared memory; the other CTAs wait at
//      the first barrier and read (a, b, c) through distributed shared
//      memory;
//   2. every CTA applies the merge to its words (thread g owns words g,
//      g + threads, ... for the whole chunk, so a word is only ever
//      touched by one thread) and arrives at the second barrier, after
//      which the table and the bounds are whole for the next select.
// The barriers are the cluster's, or __syncthreads where the cluster is
// one CTA (every problem of up to 512 rows, the CS336 snapshot's included).
// On an H100 at V = 1000 a step takes 8.3 us, against 16.4-16.9 us for a
// first design of one cooperative grid of occupancy x 132 blocks, three
// grid barriers a step, a select that rescanned all next_id^2 live cells
// and a dedup walk over every live token; 256- and 1024-thread CTAs took
// 9.0 and 10.5 us (PERF.md). At the top of the admission (26,624 rows at
// V = 500) the cluster of 16 takes 19.9 us a step and that larger grid
// 21.8 us: the apply dominates there, and a larger grid does not pay for
// it.
//
// The select (CTA 0). row_max is an upper bound on each row's max count:
// the apply raises it with atomicMax, a verified row is tightened to its
// exact max, and nothing else writes it. Each of CTA 0's 16 warps owns a
// stripe of the live rows (select_keys.cuh) and finds the top two bound
// keys pack(row_max, lex, row) of its stripe; a round verifies, one warp
// per row in 16-byte loads, the top row of every stripe whose key beats
// the best exact key so far, and accepts that key once it is at least
// every bound key of a row not verified in the round. This is
// hbm_loop.cu's cluster select with warps in place of CTAs, and
// kernels/hbm_loop.py::cluster_select_reference with 16 stripes models it
// round by round (yabpe_fused_select runs it alone). A step reads a few
// 4 KB count rows, not next_id^2 cells: 1.2 rounds and 3.5 us a step.
//
// Dedup and insertion (CTA 0). Its shared memory keeps lex_rank, the
// inverse array rank -> id, the token lengths and the token bytes (u16,
// byte + 1, 0 for the padding; in the global layout below, the bytes stay
// in device memory) for the whole chunk. One warp finds the
// merged bytes' insertion rank (the number of live tokens below them) by a
// binary search over ranks, about log2(V) token compares, each a
// warp-wide compare of two rows in shared memory; the token at that rank
// is the duplicate when it is equal. A grow bumps the ranks at or above
// the insertion rank, rebuilds rank -> id from them in one pass, and
// writes the new token to shared and device memory. lex_rank goes back to
// device memory at the end of the launch.
//
// Memory order. Counts and row_max are raised by every CTA's atomics and
// read by CTA 0's select after the second barrier; the select reads them
// with ld.global.cg (L2, never a stale L1 line). The barriers order
// everything else: barrier.cluster.arrive has release and
// barrier.cluster.wait acquire semantics.
//
// Words of any width, as the TPU kernel takes them. The kernel is built
// four times (template <kTokGlobal, kWide>); the wrapper picks one per
// launch shape:
//   - kWide (W > kMaxWidth): the apply is merge_apply.cuh's
//     merge_word_wide, in place in device memory, with no per-thread
//     array: it reads the word kWalk symbols at a time, finds the pair
//     itself (no word_has_pair first) and hands the table only the
//     pairs that change; otherwise merge_word, as in hbm_loop.cu, so
//     that the narrow kernel runs the code it ran before the wide case
//     existed;
//   - kTokGlobal: where CTA 0's u16 token bytes, (V + 1) * L * 2 bytes,
//     pass the card's opt-in shared memory (609 KB at V = 1000 and L =
//     304, against 227 KB), CTA 0 reads the int32 token_bytes in device
//     memory instead (1.2 MB there, which stays in L2), with
//     ld.global.cg, for the merged bytes and the rank search's compares;
//     only the merged bytes [L] stay in shared memory. The choice is
//     yabpe_fused_token_layout's, once per (V, L); a caller may force the
//     global layout where the shared one fits.
//
// Build: plain nvcc for sm_90a; clusters and distributed shared memory
// need no other flag and no relocatable device code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "merge_apply.cuh"
#include "select_keys.cuh"

namespace cg = cooperative_groups;

namespace {

using yabpe::kFullMask;
using yabpe::key_count;
using yabpe::key_id;
using yabpe::pack_key;
using yabpe::stripe_rows;
using yabpe::top2_add;
using yabpe::u64;
using yabpe::warp_max;
using yabpe::warp_top2;

enum Scalar : int {
  kNextId = 0,   // first free token id
  kStopped = 1,  // 1 once a step found no pair at min_frequency
  kNumDone = 2,  // merge steps taken
};

// yabpe_fused_select's output.
enum Out : int { kOutA = 0, kOutB, kOutCount, kOutRounds, kNumOut };

constexpr int kThreads = 512;
constexpr int kStripes = kThreads / 32;  // the select's stripes, one per warp
constexpr int kMaxCtas = 16;
static_assert(kStripes <= 32, "a lane reads each stripe's keys");

// Dynamic shared memory, CTA 0's: the bound keys [V] (u64), lex ranks
// [V]; then, for a chunk, rank -> id [V], token lengths [V], the token
// bytes [V, L] (the shared layout only) and the merged bytes [L] as u16
// (byte + 1, 0 for the -1 padding, so that the order of the u16 strings
// is the order of the -1 padded rows). L is even.
enum Layout : int { kSelectOnly = 0, kTokShared, kTokGlobal };

size_t smem_bytes(int V, int L, Layout layout) {
  const size_t v = static_cast<size_t>(V);
  if (layout == kSelectOnly) return sizeof(u64) * v + sizeof(int) * v;
  const size_t rows = layout == kTokShared ? v + 1 : 1;
  return sizeof(u64) * v + 3 * sizeof(int) * v +
         sizeof(unsigned short) * rows * static_cast<size_t>(L);
}

// The exact key of count row `row` over the live columns [0, n): pack(max
// count, greatest lex rank among the columns equal to it, that column);
// 0 for a row without a positive count. One warp; every lane gets it.
// 16-byte loads from the row's first 16-byte boundary on (a row of 1,000
// columns is one batch of 8 loads a lane), the head and tail one by one.
__device__ u64 warp_verify_row(const int* row, const int* lex, int n) {
  const int lane = threadIdx.x & 31;
  constexpr int kBatch = 8;  // int4 loads in flight per lane
  // this lane's best (count, lex rank, column); lex read only on a new
  // best or a tie
  int m = 0, col = 0, l = -1;
  const int head = min(
      static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) >> 2), n);
  auto take = [&](int c, int v) {
    if (v > m) {
      m = v;
      col = c;
      l = lex[c];
    } else if (v == m && v > 0) {
      const int x = lex[c];
      if (x > l) {
        col = c;
        l = x;
      }
    }
  };
  if (lane < head) take(lane, __ldcg(row + lane));
  const int4* p = reinterpret_cast<const int4*>(row + head);
  const int n4 = (n - head) >> 2;
  for (int q0 = lane; q0 < n4; q0 += 32 * kBatch) {
    int4 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + 32 * u;
      v[u] = q < n4 ? __ldcg(p + q) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int c = head + 4 * (q0 + 32 * u);
      if (c < n) {
        take(c, v[u].x);
        take(c + 1, v[u].y);
        take(c + 2, v[u].z);
        take(c + 3, v[u].w);
      }
    }
  }
  for (int c = head + 4 * n4 + lane; c < n; c += 32) take(c, __ldcg(row + c));
  return warp_max(m > 0 ? pack_key(m, l, col) : 0ull);
}

// Lexicographic order of a token row against the merged bytes, both u16
// strings of even length L in shared memory (a prefix sorts first): -1
// below, 0 equal, 1 above. One warp, two symbols a lane per pass; a pair
// is compared as one u32 with its first symbol in the high half.
__device__ int warp_compare(const unsigned short* row,
                            const unsigned short* merged, int L) {
  const int lane = threadIdx.x & 31;
  const unsigned* x32 = reinterpret_cast<const unsigned*>(row);
  const unsigned* y32 = reinterpret_cast<const unsigned*>(merged);
  for (int d0 = 0; d0 < L / 2; d0 += 32) {
    const int d = d0 + lane;
    const unsigned x = d < L / 2 ? __funnelshift_l(x32[d], x32[d], 16) : 0u;
    const unsigned y = d < L / 2 ? __funnelshift_l(y32[d], y32[d], 16) : 0u;
    const unsigned diff = __ballot_sync(kFullMask, x != y);
    if (diff != 0) {
      const int src = __ffs(diff) - 1;
      return __shfl_sync(kFullMask, x < y ? -1 : 1, src);
    }
  }
  return 0;
}

// warp_compare for a token row in device memory (the global layout):
// int32 bytes, -1 padded, read through L2 (the row may have been written
// this launch), one symbol a lane per pass, as byte + 1 against the u16
// merged bytes.
__device__ int warp_compare_global(const int* row, const unsigned short* merged,
                                   int L) {
  const int lane = threadIdx.x & 31;
  for (int d0 = 0; d0 < L; d0 += 32) {
    const int d = d0 + lane;
    const unsigned x = d < L ? static_cast<unsigned>(__ldcg(row + d) + 1) : 0u;
    const unsigned y = d < L ? merged[d] : 0u;
    const unsigned diff = __ballot_sync(kFullMask, x != y);
    if (diff != 0) {
      const int src = __ffs(diff) - 1;
      return __shfl_sync(kFullMask, x < y ? -1 : 1, src);
    }
  }
  return 0;
}

// The step's barriers: the cluster's, or the CTA's when the cluster is one
// CTA (__syncthreads also makes the CTA's global writes and atomics
// visible to its threads).
__device__ __forceinline__ void step_barrier(cg::cluster_group& cluster,
                                             int ctas) {
  if (ctas == 1)
    __syncthreads();
  else
    cluster.sync();
}

// Per-round values the select's warps trade, two sets chosen by round
// parity, so that a round writes one set while late warps may still read
// the other.
struct SelectScratch {
  u64 top1[2][kStripes];
  u64 top2[2][kStripes];
  u64 exact[2][kStripes];
  int col[2][kStripes];
};

// The lazy select over the live rows [0, n) (the note at the top). Every
// thread of the CTA takes part and takes the same decisions; returns the
// best exact key (0 or a count below `thr` for a stop) with its column in
// `best_col` and the rounds in `rounds`. Tightens row_max and `keys`.
__device__ u64 select_pair(const int* counts, int* row_max, u64* keys,
                           const int* lex, int n, int V, int thr,
                           SelectScratch& s, int& best_col, int& rounds) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sz = stripe_rows(n, kStripes);
  const int lo = min(warp * sz, n), hi = min(lo + sz, n);
  u64 best = 0;
  best_col = 0;
  rounds = 0;
  for (;;) {
    const int p = rounds & 1;
    ++rounds;
    // Bound pass: the top two keys of this warp's stripe.
    u64 t1 = 0, t2 = 0;
    for (int r = lo + lane; r < hi; r += 32) {
      u64 k;
      if (rounds == 1) {
        k = pack_key(__ldcg(row_max + r), lex[r], r);
        keys[r] = k;
      } else {
        k = keys[r];
      }
      top2_add(t1, t2, k);
    }
    warp_top2(t1, t2);
    if (lane == 0) {
      s.top1[p][warp] = t1;
      s.top2[p][warp] = t2;
    }
    __syncthreads();
    // Lane c of every warp holds stripe c's top two.
    const u64 k1 = lane < kStripes ? s.top1[p][lane] : 0ull;
    const u64 k2 = lane < kStripes ? s.top2[p][lane] : 0ull;
    if (key_count(warp_max(k1)) < thr) return 0ull;  // no bound reaches thr
    const bool cand = k1 > best && key_count(k1) > 0;
    const u64 mine = __shfl_sync(kFullMask, k1, warp);
    if (mine > best && key_count(mine) > 0) {
      const int r = key_id(mine);
      const u64 e = warp_verify_row(counts + static_cast<size_t>(r) * V, lex, n);
      if (lane == 0) {
        const u64 exact =
            (static_cast<u64>(static_cast<unsigned>(key_count(e))) << 32) |
            (mine & 0xFFFFFFFFull);
        row_max[r] = key_count(e);
        keys[r] = exact;
        s.exact[p][warp] = exact;
        s.col[p][warp] = key_id(e);
      }
    } else if (lane == 0) {
      s.exact[p][warp] = 0ull;
    }
    __syncthreads();
    u64 e = cand ? s.exact[p][lane] : 0ull;
    int col = cand ? s.col[p][lane] : 0;
    for (int o = 16; o > 0; o >>= 1) {
      const u64 oe = __shfl_xor_sync(kFullMask, e, o);
      const int oc = __shfl_xor_sync(kFullMask, col, o);
      if (oe > e) {
        e = oe;
        col = oc;
      }
    }
    if (e > best) {
      best = e;
      best_col = col;
    }
    // Accept when best beats the largest bound key of the rows not
    // verified this round.
    if (best >= warp_max(cand ? k2 : k1)) return best;
  }
}

// One chunk (or, with `out` set, one select alone: CTA 0 of a one-CTA
// cluster runs the select over [0, select_n) and writes kNumOut ints to
// `out`, (a, b, count, rounds) with a = b = -1 and count 0 for a stop).
// kTokGlobal: the token bytes stay in device memory; kWide: the apply
// takes words past kMaxWidth symbols (the note at the top).
template <bool kTokGlobal, bool kWide>
__global__ void __launch_bounds__(kThreads, 1)
    fused_kernel(int* words, const int* __restrict__ freqs, int* counts,
                 int* row_max, int* token_bytes, int* token_len,
                 int* lex_rank, int* merges, int* scalars, int* out,
                 int N, int W, int V, int L,
                 int step_begin, int step_end, int min_frequency,
                 int select_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* keys = reinterpret_cast<u64*>(smem);  // [V]
  int* lex = reinterpret_cast<int*>(keys + V);  // [V]
  int* rank_id = lex + V;                       // [V]
  int* len = rank_id + V;                       // [V]
  unsigned short* tok = reinterpret_cast<unsigned short*>(len + V);  // [V, L]
  // [L], after the token bytes in the shared layout
  unsigned short* merged = kTokGlobal ? tok : tok + static_cast<size_t>(V) * L;
  // token id's byte d as u16 (byte + 1, 0 for the padding), either layout
  auto tok_at = [&](int id, int d) -> unsigned short {
    const size_t x = static_cast<size_t>(id) * L + d;
    return kTokGlobal ? static_cast<unsigned short>(__ldcg(token_bytes + x) + 1) : tok[x];
  };
  __shared__ SelectScratch scratch;
  __shared__ int pub[4];     // this step's a, b, c and stop, read by every CTA
  __shared__ int search[2];  // insertion rank, equal id

  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gtid = rank * kThreads + tid, gsize = ctas * kThreads;
  const int thr = max(min_frequency, 1);

  int next_id = out != nullptr ? select_n : scalars[kNextId];
  int stopped = out != nullptr ? 0 : scalars[kStopped];
  int num_done = out != nullptr ? 0 : scalars[kNumDone];
  if (rank == 0) {
    for (int t = tid; t < V; t += kThreads) lex[t] = lex_rank[t];
    if (out == nullptr) {
      for (int t = tid; t < V; t += kThreads) len[t] = token_len[t];
      if constexpr (!kTokGlobal)
        for (size_t x = tid; x < static_cast<size_t>(V) * L; x += kThreads)
          tok[x] = static_cast<unsigned short>(token_bytes[x] + 1);
    }
    __syncthreads();
    if (out == nullptr)
      for (int t = tid; t < next_id; t += kThreads) rank_id[lex[t]] = t;
    __syncthreads();
  }
  if (out != nullptr) {
    int col, rounds;
    const u64 best = select_pair(counts, row_max, keys, lex, next_id, V, thr,
                                 scratch, col, rounds);
    if (tid == 0) {
      const bool stop = key_count(best) < thr;
      out[kOutA] = stop ? -1 : key_id(best);
      out[kOutB] = stop ? -1 : col;
      out[kOutCount] = stop ? 0 : key_count(best);
      out[kOutRounds] = rounds;
    }
    return;
  }

  for (int step = step_begin; step < step_end && !stopped; ++step) {
    if (rank == 0) {
      int b, rounds;
      const u64 best = select_pair(counts, row_max, keys, lex, next_id, V,
                                   thr, scratch, b, rounds);
      const bool stop = key_count(best) < thr;
      const int a = key_id(best);
      if (!stop) {
        // The merged bytes, then the binary search over the lex ranks.
        const int la = len[a], lb = len[b];
        for (int d = tid; d < L; d += kThreads)
          merged[d] = d < la        ? tok_at(a, d)
                      : d < la + lb ? tok_at(b, d - la)
                                    : static_cast<unsigned short>(0);
        __syncthreads();
        if (warp == 0) {
          int lo = 0, hi = next_id, eq = -1;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            const int id = rank_id[mid];
            const int cmp =
                kTokGlobal ? warp_compare_global(token_bytes + static_cast<size_t>(id) * L, merged, L)
                           : warp_compare(tok + static_cast<size_t>(id) * L, merged, L);
            if (cmp == 0) eq = id;  // token strings are unique
            if (cmp < 0)
              lo = mid + 1;
            else
              hi = mid;
          }
          if (lane == 0) {
            search[0] = lo;
            search[1] = eq;
          }
        }
        __syncthreads();
        const int ins = search[0], eq = search[1];
        const int c = eq < 0 ? next_id : eq;
        if (eq < 0) {  // grow: a new token at rank ins
          for (int t = tid; t < next_id; t += kThreads)
            if (lex[t] >= ins) lex[t] += 1;
          if (next_id < V) {
            if (tid == 0) {
              lex[next_id] = ins;
              len[next_id] = la + lb;
              token_len[next_id] = la + lb;
            }
            for (int d = tid; d < L; d += kThreads) {
              if constexpr (!kTokGlobal) tok[static_cast<size_t>(next_id) * L + d] = merged[d];
              token_bytes[static_cast<size_t>(next_id) * L + d] =
                  static_cast<int>(merged[d]) - 1;
            }
          }
          __syncthreads();
          for (int t = tid; t <= next_id && t < V; t += kThreads) rank_id[lex[t]] = t;
        }
        if (tid == 0) {
          merges[3 * static_cast<size_t>(step)] = a;
          merges[3 * static_cast<size_t>(step) + 1] = b;
          merges[3 * static_cast<size_t>(step) + 2] = c;
          pub[0] = a;
          pub[1] = b;
          pub[2] = c;
        }
      }
      if (tid == 0) pub[3] = stop ? 1 : 0;
    }
    step_barrier(cluster, ctas);  // 1: the pair is published, the select done

    const int* p0 = cluster.map_shared_rank(pub, 0);
    if (p0[3]) {  // every thread of the cluster reads the same flag
      stopped = 1;
      break;
    }
    const int a = p0[0], b = p0[1], c = p0[2];
    yabpe::TableSink sink{counts, V, row_max, nullptr};
    for (int i = gtid; i < N; i += gsize) {
      int* w = words + static_cast<size_t>(i) * W;
      if constexpr (kWide)
        yabpe::merge_word_wide(w, W, freqs[i], a, b, c, sink);
      else if (yabpe::word_has_pair(w, W, a, b))
        yabpe::merge_word(w, W, freqs[i], a, b, c, sink);
    }
    next_id += c == next_id ? 1 : 0;
    num_done += 1;
    step_barrier(cluster, ctas);  // 2: the table and the bounds are whole
  }
  // No CTA leaves while another may still read CTA 0's pub.
  step_barrier(cluster, ctas);

  if (rank == 0) {
    for (int t = tid; t < V; t += kThreads) lex_rank[t] = lex[t];
    if (tid == 0) {
      scalars[kNextId] = next_id;
      scalars[kStopped] = stopped;
      scalars[kNumDone] = num_done;
    }
  }
}

using Kernel = void (*)(int*, const int*, int*, int*, int*, int*, int*, int*,
                       int*, int*, int, int, int, int, int, int, int, int);

// The instantiation for a token layout and a word width.
Kernel kernel_for(bool tok_global, int W) {
  const bool wide = W > yabpe::kMaxWidth;
  if (tok_global) return wide ? fused_kernel<true, true> : fused_kernel<true, false>;
  return wide ? fused_kernel<false, true> : fused_kernel<false, false>;
}

const Kernel kKernels[] = {fused_kernel<false, false>, fused_kernel<false, true>,
                          fused_kernel<true, false>, fused_kernel<true, true>};

cudaError_t launch(Kernel kernel, int ctas, size_t smem, cudaStream_t st, int* words,
                   const int* freqs, int* counts, int* row_max,
                   int* token_bytes, int* token_len, int* lex_rank,
                   int* merges, int* scalars, int* out,
                   int N, int W, int V, int L, int step_begin, int step_end,
                   int min_frequency, int select_n) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, words, freqs, counts, row_max,
                            token_bytes, token_len, lex_rank, merges, scalars,
                            out, N, W, V, L, step_begin, step_end,
                            min_frequency, select_n);
}

}  // namespace

// The widest word the narrow apply (merge_word) takes; K1 takes any width
// >= 2, past this one through merge_word_wide.
extern "C" int yabpe_fused_narrow_width() { return yabpe::kMaxWidth; }

extern "C" int yabpe_fused_select_stripes() { return kStripes; }

extern "C" const char* yabpe_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The dynamic shared memory a block of `kernel` may have on the current
// device: the card's opt-in limit less the kernel's static shared memory.
static cudaError_t dynamic_smem_limit(Kernel kernel, int* limit) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attrs;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    dev)) != cudaSuccess ||
      (err = cudaFuncGetAttributes(&attrs, kernel)) != cudaSuccess)
    return err;
  *limit = optin - static_cast<int>(attrs.sharedSizeBytes);
  return cudaSuccess;
}

// Sets the four kernels' function attributes on the current device:
// non-portable cluster sizes, and dynamic shared memory up to the card's
// opt-in limit. Once per process and device (the wrapper caches it).
// Returns a cudaError_t.
extern "C" int yabpe_fused_prepare() {
  for (Kernel kernel : kKernels) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    int limit = 0;
    if (err != cudaSuccess || (err = dynamic_smem_limit(kernel, &limit)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    limit)) != cudaSuccess)
      return static_cast<int>(err);
  }
  return 0;
}

// Where CTA 0 keeps the token bytes at [V, L] vocab tensors on the current
// device: 0 in shared memory where they fit, 1 in device memory where not;
// minus the cudaError_t on a failure. Once per (V, L) (the wrapper caches
// it).
extern "C" int yabpe_fused_token_layout(int V, int L) {
  int limit = 0;
  const cudaError_t err = dynamic_smem_limit(fused_kernel<false, false>, &limit);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return smem_bytes(V, L, kTokShared) <= static_cast<size_t>(limit) ? 0 : 1;
}

// CTAs of the cluster for N words of width W at [V, L] vocab tensors in
// the given token layout on the current device: enough to give every word
// a thread, at most 16, fewer where a cluster that large does not fit;
// minus the cudaError_t on a failure. Once per problem shape (the wrapper
// caches it).
extern "C" int yabpe_fused_cluster_ctas(int N, int W, int V, int L, int tok_global) {
  const Kernel kernel = kernel_for(tok_global != 0, W);
  const size_t smem = smem_bytes(V, L, tok_global ? kTokGlobal : kTokShared);
  for (int ctas = min(max((N + kThreads - 1) / kThreads, 1), kMaxCtas);
       ctas >= 1; --ctas) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = ctas;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (clusters >= 1) return ctas;
  }
  return -static_cast<int>(cudaErrorLaunchOutOfResources);
}

// Runs merge steps [step_begin, step_end) in one launch of one
// `ctas`-CTA cluster on `stream`, without syncing, with the token bytes in
// shared memory (tok_global 0) or in device memory (1). Returns the
// launch's cudaError_t, 0 on success.
extern "C" int yabpe_fused_merge_chunk(
    int* words, const int* freqs, int* counts, int* row_max, int* token_bytes,
    int* token_len, int* lex_rank, int* merges, int* scalars,
    int N, int W, int V, int L, int step_begin,
    int step_end, int min_frequency, int ctas, int tok_global, void* stream) {
  if (W < 2 || V > 0xFFFF || V < 1 || L < 2 || L % 2 || ctas < 1 ||
      ctas > kMaxCtas)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = launch(
      kernel_for(tok_global != 0, W), ctas,
      smem_bytes(V, L, tok_global ? kTokGlobal : kTokShared),
      static_cast<cudaStream_t>(stream), words, freqs,
      counts, row_max, token_bytes, token_len, lex_rank, merges, scalars,
      nullptr, N, W, V, L, step_begin, step_end, min_frequency, 0);
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The select alone, on `stream`, without syncing: over the live ids [0,
// next_id), tightening row_max as a step does; writes (a, b, count,
// rounds) to out[4].
extern "C" int yabpe_fused_select(const int* counts, int* row_max,
                                  int* lex_rank, int* out, int next_id, int V,
                                  int min_frequency, void* stream) {
  if (V > 0xFFFF || V < 1 || next_id < 1 || next_id > V)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      launch(fused_kernel<false, false>, 1, smem_bytes(V, 0, kSelectOnly),
             static_cast<cudaStream_t>(stream), nullptr,
             nullptr, const_cast<int*>(counts), row_max, nullptr, nullptr,
             lex_rank, nullptr, nullptr, out, 0, 2, V, 1, 0, 0,
             min_frequency, next_id);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
