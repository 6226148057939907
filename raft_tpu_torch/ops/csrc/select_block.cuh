// Block-level top-k selection shared by the topk and pq_scan_topk kernels,
// for Hopper (sm_90a).
//
// A block of THREADS threads keeps the k best of a stream of entries. Each
// entry has an order-preserving uint32 key (larger = better, rank_key) and a
// uint32 column (its position in the stream; equal keys go to the lowest
// column), and optionally a uint32 value carried beside it (the float bits
// a caller cannot read back from its input). Entries that beat the running
// k-th best (key, column) are appended to a shared-memory buffer (append,
// one shared atomic per warp); when the buffer could overflow, and once at
// the end, reduce() keeps exactly its best k by a radix select on the unique
// 64-bit composite (key << 32 | ~column), 8-bit digits counted in per-warp
// histograms, stopping as soon as a digit's bin is taken whole; the kept k
// set the new threshold. sort_kept() orders the k by (key desc, column asc)
// with a bitonic sort. See topk.cu's header for the design's origin (RAFT's
// warp_sort_filtered carried to a block) and its costs.

#pragma once

#include <stdint.h>

namespace select_block {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXK = 256;
constexpr int BINS = 256;               // 8-bit radix digits
constexpr uint32_t SIGN = 0x80000000u;
constexpr uint32_t CLAMP_BITS = 0x7f5a2bf8u;  // 2.9e38f
constexpr uint32_t INF_BITS = 0x7f800000u;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == BINS, "reduce's scan gives each thread one digit");

// Order-preserving key of float32 bits b: larger = better. flip = SIGN
// ranks the smallest first (a sign flip negates); values are clamped to
// ±2.9e38 (so ±inf rank and tie with the clamped extremes), -0 folds into
// +0, and NaN is not clamped: it ranks by its bits.
__device__ __forceinline__ uint32_t rank_key(uint32_t b, uint32_t flip) {
  b ^= flip;
  const uint32_t mag = b & ~SIGN;
  if (mag > CLAMP_BITS && mag <= INF_BITS) b = (b & SIGN) | CLAMP_BITS;  // NaN kept
  if (b == SIGN) b = 0u;
  return (b & SIGN) ? ~b : (b | SIGN);
}

__device__ __forceinline__ bool better(uint32_t k1, uint32_t c1, uint32_t k2, uint32_t c2) {
  return k1 > k2 || (k1 == k2 && c1 < c2);
}

// The selection's shared memory: a candidate buffer of CAP entries, with a
// value array when VAL.
template <int CAP, bool VAL>
struct Smem {
  static constexpr bool kVal = VAL;
  uint32_t key[CAP];
  uint32_t col[CAP];
  uint32_t val[VAL ? CAP : 1];
  int hist[WARPS][BINS];
  uint32_t tkey[MAXK], tcol[MAXK], tval[VAL ? MAXK : 1];
  int wsum[WARPS];
  unsigned long long wmin[WARPS];
  int count, sel, digit, kk, bin;
};

// Append this thread's passing entries (bit e of mask) to the buffer, one
// shared atomic per warp. Returns, on the lane that made the atomic, whether
// the buffer then holds more than lim entries; the last atomic of a step sees
// every append before it, so a block-wide OR of the results is exact. val is
// read only when the buffer keeps values.
template <int N, typename S, typename Col>
__device__ __forceinline__ bool append(S& sm, uint32_t mask, const uint32_t* key, Col col,
                                       const uint32_t* val, int lim) {
  const int lane = threadIdx.x & 31;
  const int np = __popc(mask);
  if (__ballot_sync(FULL, np > 0) == 0u) return false;
  int incl = np;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(FULL, incl, 31);
  int base = 0;
  if (lane == 31) base = atomicAdd(&sm.count, total);
  base = __shfl_sync(FULL, base, 31);
  int p = base + incl - np;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if ((mask >> e) & 1u) {
      sm.key[p] = key[e];
      sm.col[p] = col(e);
      if constexpr (S::kVal) sm.val[p] = val[e];
      ++p;
    }
  }
  return lane == 31 && base + total > lim;
}

// Reduce the buffer to its best k entries (all threads, after a barrier) and
// set the threshold (tk, tc) to the k-th best. A buffer of fewer than k
// entries is left as it is.
template <typename S>
__device__ void reduce(S& sm, int k, uint32_t& tk, uint32_t& tc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();
  const int C = sm.count;
  if (C < k) return;
  if (C > k) {
    // radix select of the k-th largest composite (key << 32 | ~col); the
    // kept entries are those whose masked composite is >= the prefix
    uint32_t phi = 0u, plo = 0u, mhi = 0u, mlo = 0u;
    int kk = k;
    for (int pass = 0; pass < 8; ++pass) {
      const bool hiw = pass < 4;
      const int sh = 24 - 8 * (pass & 3);
      for (int i = tid; i < WARPS * BINS; i += THREADS) (&sm.hist[0][0])[i] = 0;
      __syncthreads();
      for (int i = tid; i < C; i += THREADS) {
        const uint32_t h = sm.key[i], l = ~sm.col[i];
        if ((h & mhi) == phi && (l & mlo) == plo)
          atomicAdd(&sm.hist[warp][((hiw ? h : l) >> sh) & (BINS - 1)], 1);
      }
      __syncthreads();
      // thread t owns digit 255 - t: a scan from the best digit down
      int c = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) c += sm.hist[w][BINS - 1 - tid];
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) sm.wsum[warp] = incl;
      __syncthreads();
      for (int w = 0; w < warp; ++w) incl += sm.wsum[w];
      if (incl >= kk && incl - c < kk) {
        sm.digit = BINS - 1 - tid;
        sm.kk = kk - (incl - c);
        sm.bin = c;
      }
      __syncthreads();
      const uint32_t d = (uint32_t)sm.digit;
      const int bin = sm.bin;
      kk = sm.kk;
      if (hiw) {
        phi |= d << sh;
        mhi |= 0xffu << sh;
      } else {
        plo |= d << sh;
        mlo |= 0xffu << sh;
      }
      if (bin == kk) break;  // the digit's whole bin is kept (block-uniform)
    }
    if (tid == 0) sm.sel = 0;
    __syncthreads();
    for (int i = tid; i < C; i += THREADS) {
      const uint32_t h = sm.key[i] & mhi, l = ~sm.col[i] & mlo;
      if (h > phi || (h == phi && l >= plo)) {
        const int p = atomicAdd(&sm.sel, 1);
        sm.tkey[p] = sm.key[i];
        sm.tcol[p] = sm.col[i];
        if constexpr (S::kVal) sm.tval[p] = sm.val[i];
      }
    }
    __syncthreads();
    for (int i = tid; i < k; i += THREADS) {
      sm.key[i] = sm.tkey[i];
      sm.col[i] = sm.tcol[i];
      if constexpr (S::kVal) sm.val[i] = sm.tval[i];
    }
    if (tid == 0) sm.count = k;
    __syncthreads();
  }
  // the new threshold: the smallest composite of the k kept
  unsigned long long v = ~0ull;
  for (int i = tid; i < k; i += THREADS)
    v = min(v, ((unsigned long long)sm.key[i] << 32) | (unsigned long long)(~sm.col[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) sm.wmin[warp] = v;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) v = min(v, sm.wmin[w]);
  tk = (uint32_t)(v >> 32);
  tc = ~(uint32_t)v;
  __syncthreads();
}

// Bitonic sort of the k kept (the buffer's first k entries, k <= MAXK <=
// CAP), padded to a power of two with the worst, best first. Ends on a
// barrier.
template <typename S>
__device__ void sort_kept(S& sm, int k) {
  const int tid = threadIdx.x;
  int P = 1;
  while (P < k) P <<= 1;
  for (int i = k + tid; i < P; i += THREADS) {
    sm.key[i] = 0u;
    sm.col[i] = 0xffffffffu;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const bool i_better = better(sm.key[i], sm.col[i], sm.key[j], sm.col[j]);
          if (((i & size) == 0) != i_better) {
            const uint32_t tkey = sm.key[i], tcol = sm.col[i];
            sm.key[i] = sm.key[j];
            sm.col[i] = sm.col[j];
            sm.key[j] = tkey;
            sm.col[j] = tcol;
            if constexpr (S::kVal) {
              const uint32_t tv = sm.val[i];
              sm.val[i] = sm.val[j];
              sm.val[j] = tv;
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace select_block
