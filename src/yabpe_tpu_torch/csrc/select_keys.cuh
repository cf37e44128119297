// Selection keys and their warp reductions, shared by the merge-loop
// kernels' lazy selects (hbm_loop.cu's cluster select, fused_loop.cu's
// striped select in one CTA).
//
// K1's key packs (count, lex rank, id) into 64 bits: a larger count wins,
// then a greater lex rank, then a greater id. Counts are >= 0; an
// inactive slot (lex -1) ranks lowest; ids travel in 16 bits, so V <=
// 0xFFFF. K2's row key (pack_row_key) holds ids and lex ranks up to 2^17
// in the same order. A select owns the live rows [0, n) in stripes of
// stripe_rows(n, stripes) rows, a multiple of 4, the last stripes short
// or empty (kernels/hbm_loop.py::_stripe_bounds models the same cut).
#pragma once

#include <cuda_runtime.h>

namespace yabpe {

using u64 = unsigned long long;

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ u64 pack_key(int count, int lex, int idx) {
  return (static_cast<u64>(static_cast<unsigned>(count)) << 32) |
         (static_cast<u64>((lex + 1) & 0xFFFF) << 16) |
         static_cast<u64>(idx & 0xFFFF);
}

__device__ __forceinline__ int key_count(u64 k) {
  return static_cast<int>(k >> 32);
}

__device__ __forceinline__ int key_id(u64 k) {
  return static_cast<int>(k & 0xFFFF);
}

// K2's row key: (count in 31 | lex rank + 1 in 18 | slot in 15), the slot
// the row's offset in its stripe, so row = the stripe's first row + slot.
// Counts stay below 2^31 (the table's pair mass does, hbm_driver.py), lex
// ranks below kRowKeyMaxVocab, and a stripe of a cluster of 8 or more CTAs
// holds at most kRowKeyMaxVocab / 8 rows, inside the slot's 15 bits. The
// live rows [0, n) of a select hold distinct lex ranks (dense over the
// live tokens), so the slot never decides between two of them: the order
// is (count, lex rank, id), as in K1's key, with no id in the key.
constexpr int kRowSlotBits = 15;
constexpr int kRowCountShift = 33;  // 18 bits of lex rank + 1 below it
constexpr int kRowKeyMaxVocab = 1 << 17;
static_assert(kRowKeyMaxVocab / 8 + 3 < (1 << kRowSlotBits),
              "a stripe's slot must fit its bits");

__device__ __forceinline__ u64 pack_row_key(int count, int lex, int slot) {
  return (static_cast<u64>(static_cast<unsigned>(count)) << kRowCountShift) |
         (static_cast<u64>(static_cast<unsigned>(lex + 1)) << kRowSlotBits) |
         static_cast<u64>(slot);
}

__device__ __forceinline__ int row_key_count(u64 k) {
  return static_cast<int>(k >> kRowCountShift);
}

__device__ __forceinline__ int row_key_slot(u64 k) {
  return static_cast<int>(k & ((1u << kRowSlotBits) - 1));
}

// The key k with its count replaced by `count` (the row's exact max).
__device__ __forceinline__ u64 row_key_with_count(u64 k, int count) {
  return (static_cast<u64>(static_cast<unsigned>(count)) << kRowCountShift) |
         (k & ((1ull << kRowCountShift) - 1));
}

// Rows a stripe owns: a multiple of 4, so every stripe starts 16-byte
// aligned.
__host__ __device__ __forceinline__ int stripe_rows(int n, int stripes) {
  return (((n + stripes - 1) / stripes) + 3) & ~3;
}

__device__ __forceinline__ u64 max_u64(u64 x, u64 y) { return x > y ? x : y; }

__device__ __forceinline__ u64 warp_max(u64 v) {
  for (int o = 16; o > 0; o >>= 1)
    v = max_u64(v, __shfl_xor_sync(kFullMask, v, o));
  return v;
}

// Inserts k into the top two (t1 > t2; 0 = empty). Keys are distinct.
__device__ __forceinline__ void top2_add(u64& t1, u64& t2, u64 k) {
  if (k > t1) {
    t2 = t1;
    t1 = k;
  } else if (k > t2) {
    t2 = k;
  }
}

__device__ __forceinline__ void top2_merge(u64& t1, u64& t2, u64 o1, u64 o2) {
  if (o1 > t1) {
    t2 = max_u64(t1, o2);
    t1 = o1;
  } else {
    t2 = max_u64(t2, o1);
  }
}

// The top two keys over the warp; every lane gets them.
__device__ __forceinline__ void warp_top2(u64& t1, u64& t2) {
  for (int o = 16; o > 0; o >>= 1) {
    const u64 o1 = __shfl_xor_sync(kFullMask, t1, o);
    const u64 o2 = __shfl_xor_sync(kFullMask, t2, o);
    top2_merge(t1, t2, o1, o2);
  }
}

}  // namespace yabpe
