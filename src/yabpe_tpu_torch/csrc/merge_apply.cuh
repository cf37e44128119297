// Word-parallel apply step of a BPE merge, shared by the merge-loop kernels
// (hbm_loop.cu, fused_loop.cu).
//
// One thread owns one word: it takes the leftmost non-overlapping (a, b)
// -> c in place, compacts the word, and folds the pairs of the changed
// window into the [V, V] count table: old pairs -freq, new pairs +freq.
//
// Exactness. Counts are exact while the table's total pair mass (the sum
// of freq * (len - 1)) stays below 2^31, which the drivers check: each
// word thread emits its negative deltas, fences, then its positive ones,
// so a cell never holds more than the current total mass, even in
// passing.
#pragma once

#include <cuda_runtime.h>

namespace yabpe {

constexpr int kMaxWidth = 64;  // longest word the apply step takes

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

// Merges (a, b) -> c in a word that holds the pair, with its count deltas.
// `row_max`, when not null, is an upper bound on each row's max count,
// raised by every positive delta.
__device__ __forceinline__ void merge_word(int* w, int W, int f, int a, int b,
                                           int c, int* counts, int V,
                                           int* row_max) {
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
  // Old pairs [first-1, last+1] map onto new pairs [first-1, q_last]; the
  // pairs outside both windows are the same on either side.
  for (int k = max(first - 1, 0); k <= min(last + 1, n - 2); ++k)
    atomicAdd(&counts[static_cast<size_t>(s[k]) * V + s[k + 1]], -f);
  __threadfence();
  for (int k = max(first - 1, 0); k <= min(q_last, m - 2); ++k) {
    const int old =
        atomicAdd(&counts[static_cast<size_t>(t[k]) * V + t[k + 1]], f);
    if (row_max != nullptr) atomicMax(&row_max[t[k]], old + f);
  }
  for (int k = 0; k < m; ++k) w[k] = t[k];
  for (int k = m; k < n; ++k) w[k] = -1;
}

}  // namespace yabpe
