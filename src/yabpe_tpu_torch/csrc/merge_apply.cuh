// Word-parallel apply step of a BPE merge, shared by the merge-loop kernels
// (hbm_loop.cu, fused_loop.cu) and the replay kernel (replay_emit.cu).
//
// One thread owns one word: it takes the leftmost non-overlapping (a, b)
// -> c in place, compacts the word, and hands the pairs of the changed
// window to a sink: old pairs -freq, new pairs +freq. The pairs outside
// the window are the same before and after, so the window's cells carry
// the word's whole net delta. Two forms emit the same cells in the same
// order: merge_word on a word in memory of at most kMaxWidth symbols
// (copied to per-thread arrays), and plan_regs + merge_regs on a word
// held in registers (a fixed width bucket, every index static). A third,
// merge_word_wide, takes a word in memory of any width in place, read
// in batches, and hands TableSink only the window's changed pairs (the
// same net delta).
//
// Sinks. TableSink folds the cells into the [V, V] count table (K1, K2);
// LogSink appends them to one step's cell log (K3). A sink has:
//   reserve(n)       called once, before the cells, with their number;
//   sub(l, r, f)     an old pair, weight -f;
//   fence()          between the old pairs and the new ones;
//   add(l, r, f)     a new pair, weight +f.
//
// Exactness of TableSink. Counts are exact while the table's total pair
// mass (the sum of freq * (len - 1)) stays below 2^31, which the drivers
// check: each word thread emits its negative deltas, fences, then its
// positive ones, so a cell never holds more than the current total mass,
// even in passing.
#pragma once

#include <cuda_runtime.h>

namespace yabpe {

constexpr int kMaxWidth = 64;  // longest word the apply step takes

// Columns of a count row per block of K2's block bounds (hbm_loop.cu):
// 4 KB of a row, one int4 load a thread of a 256-thread CTA.
constexpr int kBlockShift = 10;
constexpr int kBlockCols = 1 << kBlockShift;

// Column blocks of a [V, V] count row: the width of the block bounds.
__host__ __device__ __forceinline__ int block_count(int V) {
  return (V + kBlockCols - 1) >> kBlockShift;
}

// True when the word holds the adjacent pair (a, b).
__device__ __forceinline__ bool word_has_pair(const int* w, int W, int a,
                                              int b) {
  int prev = w[0];
  for (int k = 1; k < W; ++k) {
    const int cur = w[k];
    if (cur < 0) break;
    if (prev == a && cur == b) return true;
    prev = cur;
  }
  return false;
}

// Folds cells into the [V, V] count table. `row_max`, when not null, is an
// upper bound on each row's max count, and `block_max` [V, block_count(V)],
// when not null, one on the max of each block of kBlockCols columns of a
// row; every positive delta raises both.
struct TableSink {
  int* counts;
  int V;
  int* row_max;
  int* block_max;

  __device__ __forceinline__ void reserve(int) {}
  __device__ __forceinline__ void sub(int l, int r, int f) {
    atomicAdd(&counts[static_cast<size_t>(l) * V + r], -f);
  }
  __device__ __forceinline__ void fence() { __threadfence(); }
  __device__ __forceinline__ void add(int l, int r, int f) {
    const int old = atomicAdd(&counts[static_cast<size_t>(l) * V + r], f);
    if (row_max != nullptr) atomicMax(&row_max[l], old + f);
    if (block_max != nullptr)
      atomicMax(&block_max[static_cast<size_t>(l) * block_count(V) + (r >> kBlockShift)],
                old + f);
  }
};

// Appends cells (left, right, weight) to one step's log of `cap` slots,
// writing only the slots below `cap`. reserve() takes a run of slots with
// one atomicAdd on the step's cursor, and a run that passes `cap` clears
// the step's ok flag; with `cursor` null the run was taken beforehand and
// starts at `slot` (replay_emit.cu: a warp's words take one run, and the
// flags come from the cursors).
struct LogSink {
  int* left;
  int* right;
  int* weight;
  int cap;
  int* cursor;
  int* ok;
  int slot;

  __device__ __forceinline__ void reserve(int n) {
    if (cursor == nullptr) return;
    slot = atomicAdd(cursor, n);
    if (slot + n > cap) *ok = 0;
  }
  __device__ __forceinline__ void put(int l, int r, int w) {
    if (slot < cap) {
      left[slot] = l;
      right[slot] = r;
      weight[slot] = w;
    }
    ++slot;
  }
  __device__ __forceinline__ void sub(int l, int r, int f) { put(l, r, -f); }
  __device__ __forceinline__ void fence() {}
  __device__ __forceinline__ void add(int l, int r, int f) { put(l, r, f); }
};

// Merges (a, b) -> c in a word that holds the pair, handing the changed
// window's cells to `sink`.
template <class Sink>
__device__ __forceinline__ void merge_word(int* w, int W, int f, int a, int b,
                                           int c, Sink& sink) {
  int s[kMaxWidth], t[kMaxWidth];
  int n = 0;
  while (n < W && w[n] >= 0) {
    s[n] = w[n];
    ++n;
  }
  int m = 0, first = -1, last = -1, q_last = -1;
  for (int k = 0; k < n;) {
    if (k + 1 < n && s[k] == a && s[k + 1] == b) {
      if (first < 0) first = k;
      last = k;
      q_last = m;
      t[m++] = c;
      k += 2;
    } else {
      t[m++] = s[k++];
    }
  }
  // Old pairs [lo, old_hi] map onto new pairs [lo, new_hi]; the pairs
  // outside both windows are the same on either side.
  const int lo = max(first - 1, 0);
  const int old_hi = min(last + 1, n - 2);
  const int new_hi = min(q_last, m - 2);
  sink.reserve(max(old_hi - lo + 1, 0) + max(new_hi - lo + 1, 0));
  for (int k = lo; k <= old_hi; ++k) sink.sub(s[k], s[k + 1], f);
  sink.fence();
  for (int k = lo; k <= new_hi; ++k) sink.add(t[k], t[k + 1], f);
  for (int k = 0; k < m; ++k) w[k] = t[k];
  for (int k = m; k < n; ++k) w[k] = -1;
}

// Symbols a wide walk reads at once: kWalk + 1 independent loads (the one
// past the batch for the pair that straddles it), then kWalk symbols from
// registers. A thread's word row is 4W bytes from its neighbours', so a
// warp's rows overflow L1 and each load waits on L2; batched, a walk of
// 304 symbols waits 19 times, not 304.
constexpr int kWalk = 16;

// w[base, base + kWalk] into registers, -1 at and past `end`.
__device__ __forceinline__ void load_walk(const int* w, int end, int base,
                                          int (&s)[kWalk + 1]) {
#pragma unroll
  for (int j = 0; j <= kWalk; ++j) s[j] = base + j < end ? w[base + j] : -1;
}

// merge_word on a word of any width, in place, with no per-thread array
// but a batch of kWalk symbols; only K1 takes words past kMaxWidth. It
// hands TableSink only the pairs that change, not the whole window: an
// old pair that touches a take, and a new pair that touches a merged
// symbol. The pairs between two takes that touch neither are the same on
// either side, so the net delta is merge_word's; a wide word whose takes
// lie far apart (a run of a few letters, hundreds long) has a window of
// hundreds of pairs but only about five changed pairs a take. Two walks,
// negatives fenced before positives as merge_word does:
//   1. a read-only walk finds the takes (a match is taken unless the
//      match before it was) and subtracts each old pair (j - 1, j) where
//      a take holds j - 2, j - 1 or j (that is, where j - 1 or j lies in
//      a take);
//   2. the word is compacted from the first take on (the write index
//      never passes the read index, and each batch is read before any of
//      it is written), and each new pair is added as its right symbol is
//      written, where either symbol is a merged one.
// A word without (a, b) costs walk 1 and changes nothing, so the caller
// need not test it first.
__device__ __forceinline__ void merge_word_wide(int* w, int W, int f, int a,
                                                int b, int c, TableSink& sink) {
  int n = 0, first = -1, prev = -1;
  bool t2 = false, t1 = false, end = false;  // takes at j - 2 and j - 1
  for (int base = 0; base < W && !end; base += kWalk) {
    int s[kWalk + 1];
    load_walk(w, W, base, s);
#pragma unroll
    for (int j = 0; j < kWalk; ++j) {
      end = end || s[j] < 0;
      if (end) continue;
      const bool t0 = !t1 && s[j] == a && s[j + 1] == b;
      if (t0 && first < 0) first = n;
      if (n > 0 && (t2 || t1 || t0)) sink.sub(prev, s[j], f);
      t2 = t1;
      t1 = t0;
      prev = s[j];
      ++n;
    }
  }
  if (first < 0) return;
  sink.fence();
  int q = first;
  int left = first > 0 ? w[first - 1] : -1;
  bool left_merged = false, skip = false;  // skip: taken by the last batch
  for (int base = first; base < n; base += kWalk) {
    int s[kWalk + 1];
    load_walk(w, n, base, s);
#pragma unroll
    for (int j = 0; j < kWalk; ++j) {
      if (skip || s[j] < 0) {
        skip = false;
        continue;
      }
      const bool take = s[j] == a && s[j + 1] == b;
      const int sym = take ? c : s[j];
      skip = take;
      if (left >= 0 && (take || left_merged)) sink.add(left, sym, f);
      w[q++] = sym;
      left = sym;
      left_merged = take;
    }
  }
  for (int k = q; k < n; ++k) w[k] = -1;
}

// A merge of (a, b) in a word held in registers, -1 padded to WB, planned
// before it is made: the merges as a bit mask (a match is taken unless
// the match before it was) and the word's length. a and b are ids >= 0,
// so the padding never matches.
struct RegsMerge {
  unsigned long long take;  // 0: the word does not hold the pair
  int n;

  // The cells merge_regs hands its sink: the changed window's old pairs
  // and new pairs (0 without a merge).
  __device__ __forceinline__ int cells() const {
    if (take == 0) return 0;
    const int takes = __popcll(take);
    const int first = __ffsll(static_cast<long long>(take)) - 1;
    const int last = 63 - __clzll(static_cast<long long>(take));
    const int lo = max(first - 1, 0);
    return max(min(last + 1, n - 2) - lo + 1, 0) +
           max(min(last - (takes - 1), n - takes - 2) - lo + 1, 0);
  }
};

template <int WB>
__device__ __forceinline__ RegsMerge plan_regs(const int (&w)[WB], int a,
                                               int b) {
  static_assert(WB <= 64, "the take mask is 64 bits");
  RegsMerge m{0ull, 0};
  bool prev = false;
#pragma unroll
  for (int k = 0; k < WB; ++k) {
    m.n += w[k] >= 0;
    if (k + 1 < WB) {
      const bool t = !prev && w[k] == a && w[k + 1] == b;
      m.take |= static_cast<unsigned long long>(t) << k;
      prev = t;
    }
  }
  return m;
}

// merge_word on a word held in registers, for a planned merge (m.take !=
// 0): the same merge, the same window and the same cells in the same
// order, with every array index static so that the word stays in
// registers. The merges are applied from the right, each one a shift of
// the tail by one.
template <int WB, class Sink>
__device__ __forceinline__ void merge_regs(int (&w)[WB], const RegsMerge& m,
                                           int f, int c, Sink& sink) {
  const int takes = __popcll(m.take);
  const int first = __ffsll(static_cast<long long>(m.take)) - 1;
  const int last = 63 - __clzll(static_cast<long long>(m.take));
  const int lo = max(first - 1, 0);
  const int old_hi = min(last + 1, m.n - 2);
  const int new_hi = min(last - (takes - 1), m.n - takes - 2);  // the last merge's new place
  sink.reserve(m.cells());
#pragma unroll
  for (int k = 0; k + 1 < WB; ++k)
    if (k >= lo && k <= old_hi) sink.sub(w[k], w[k + 1], f);
  sink.fence();
  for (unsigned long long rest = m.take; rest != 0;) {
    const int q = 63 - __clzll(static_cast<long long>(rest));
    rest &= ~(1ull << q);
#pragma unroll
    for (int k = 0; k < WB; ++k) {
      if (k == q)
        w[k] = c;
      else if (k > q)
        w[k] = k + 1 < WB ? w[k + 1] : -1;
    }
  }
#pragma unroll
  for (int k = 0; k + 1 < WB; ++k)
    if (k >= lo && k <= new_hi) sink.add(w[k], w[k + 1], f);
}

}  // namespace yabpe
