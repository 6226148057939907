// Per-query sorted top-k lists kept by one warp, and the merge of a query's
// dataset splits, shared by the fused_knn kernels (fused_knn.cu, mode f32's
// row-split route, and fused_knn_tc.cu, the tensor-core routes), for Hopper
// (sm_90a).
//
// A list is k <= 64 (score, row) pairs in shared memory, best first: larger
// score, equal scores to the lower row (beats). It starts from the
// sentinels (-3e38, 2^30), as the TPU kernel's running state does.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_topk {

constexpr int MAXK = 64;
constexpr float NEG = -3.0e38f;
constexpr int BIG = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MERGE_THREADS = 256;

// (v1, i1) ranks before (v2, i2): larger score, or equal score and lower id.
__device__ __forceinline__ bool beats(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Insert (cs, cid) into the sorted list tv/ti of length k (k <= 64). The
// whole warp calls it with the same candidate, which must beat entry k-1.
// Lane l owns slots l and l + 32.
__device__ __forceinline__ void warp_insert(float* tv, int* ti, int k, float cs,
                                            int cid, int lane) {
  const int j0 = lane, j1 = lane + 32;
  const bool in0 = j0 < k, in1 = j1 < k;
  const float v0 = in0 ? tv[j0] : 0.f, v1 = in1 ? tv[j1] : 0.f;
  const int i0 = in0 ? ti[j0] : 0, i1 = in1 ? ti[j1] : 0;
  const int pos = __popc(__ballot_sync(FULL, in0 && beats(v0, i0, cs, cid))) +
                  __popc(__ballot_sync(FULL, in1 && beats(v1, i1, cs, cid)));
  const float p0 = (in0 && j0 > 0) ? tv[j0 - 1] : 0.f, p1 = in1 ? tv[j1 - 1] : 0.f;
  const int q0 = (in0 && j0 > 0) ? ti[j0 - 1] : 0, q1 = in1 ? ti[j1 - 1] : 0;
  __syncwarp();
  if (in0 && j0 > pos) { tv[j0] = p0; ti[j0] = q0; }
  if (in0 && j0 == pos) { tv[j0] = cs; ti[j0] = cid; }
  if (in1 && j1 > pos) { tv[j1] = p1; ti[j1] = q1; }
  if (in1 && j1 == pos) { tv[j1] = cs; ti[j1] = cid; }
  __syncwarp();
}

// Offer one candidate per lane to the row's list; only candidates that beat
// the running k-th best (tau) are inserted, one at a time, best lane first.
__device__ __forceinline__ void warp_offer(float* tv, int* ti, int k, float s,
                                           int id, bool valid, int lane) {
  float tau = tv[k - 1];
  int taui = ti[k - 1];
  unsigned msk = __ballot_sync(FULL, valid && beats(s, id, tau, taui));
  while (msk) {
    const int src = __ffs(msk) - 1;
    msk &= msk - 1;
    const float cs = __shfl_sync(FULL, s, src);
    const int cid = __shfl_sync(FULL, id, src);
    if (!beats(cs, cid, tau, taui)) continue;  // warp-uniform
    warp_insert(tv, ti, k, cs, cid, lane);
    tau = tv[k - 1];
    taui = ti[k - 1];
  }
}

// Offer the sorted list sv/si (k entries, best first) to the list tv/ti;
// the whole warp calls it. A chunk of the source where no entry passes the
// gate ends it: the rest are no better.
__device__ __forceinline__ void warp_merge_list(float* tv, int* ti, int k, const float* sv,
                                                const int* si, int lane) {
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int j = j0 + lane;
    const bool ok = j < k;
    const float v = ok ? sv[j] : NEG;
    const int id = ok ? si[j] : BIG;
    const bool pass = ok && beats(v, id, tv[k - 1], ti[k - 1]);
    if (!__any_sync(FULL, pass)) break;
    warp_offer(tv, ti, k, v, id, ok, lane);
  }
}

// Merge the nsplit sorted lists of each query into its top-k; one warp per
// query.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ pv, const int* __restrict__ pi, int m,
             int nsplit, int k, float* __restrict__ ov, int* __restrict__ oi) {
  __shared__ float tvs[MERGE_THREADS / 32][MAXK];
  __shared__ int tis[MERGE_THREADS / 32][MAXK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (MERGE_THREADS / 32) + warp;
  if (row >= m) return;  // warp-uniform
  float* tv = tvs[warp];
  int* ti = tis[warp];
  for (int j = lane; j < k; j += 32) {
    tv[j] = NEG;
    ti[j] = BIG;
  }
  __syncwarp();
  for (int s = 0; s < nsplit; ++s) {
    const size_t base = ((size_t)row * nsplit + s) * k;
    warp_merge_list(tv, ti, k, pv + base, pi + base, lane);
  }
  for (int j = lane; j < k; j += 32) {
    ov[(size_t)row * k + j] = tv[j];
    oi[(size_t)row * k + j] = ti[j];
  }
}

// The same merge for many splits (the row-split route's, one a block of
// the grid): one block per query, each warp merging every eighth split
// into a list of its own, then the first warp merging the eight. A warp's
// lists come from device memory one after another, so spreading them over
// eight warps hides most of their latency.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_wide_kernel(const float* __restrict__ pv, const int* __restrict__ pi, int nsplit, int k,
                  float* __restrict__ ov, int* __restrict__ oi) {
  constexpr int WARPS = MERGE_THREADS / 32;
  __shared__ float tvs[WARPS][MAXK];
  __shared__ int tis[WARPS][MAXK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x;
  for (int j = lane; j < k; j += 32) {
    tvs[warp][j] = NEG;
    tis[warp][j] = BIG;
  }
  __syncwarp();
  for (int s = warp; s < nsplit; s += WARPS) {
    const size_t base = ((size_t)row * nsplit + s) * k;
    warp_merge_list(tvs[warp], tis[warp], k, pv + base, pi + base, lane);
  }
  __syncthreads();
  if (warp != 0) return;  // warp-uniform
  for (int w = 1; w < WARPS; ++w) warp_merge_list(tvs[0], tis[0], k, tvs[w], tis[w], lane);
  for (int j = lane; j < k; j += 32) {
    ov[(size_t)row * k + j] = tvs[0][j];
    oi[(size_t)row * k + j] = tis[0][j];
  }
}

// Merge m queries' nsplit lists with one kernel or the other: wide, a
// block a query (merge_wide_kernel); else a warp a query (merge_kernel).
inline cudaError_t merge_by(bool wide, const float* pv, const int* pi, int m, int nsplit, int k,
                            float* ov, int* oi, cudaStream_t st) {
  constexpr int ROWS = MERGE_THREADS / 32;
  if (wide)
    merge_wide_kernel<<<m, MERGE_THREADS, 0, st>>>(pv, pi, nsplit, k, ov, oi);
  else
    merge_kernel<<<(m + ROWS - 1) / ROWS, MERGE_THREADS, 0, st>>>(pv, pi, m, nsplit, k, ov, oi);
  return cudaGetLastError();
}

// Merge m queries' nsplit lists: a warp a query for few splits, a block a
// query for many. On the H100 80GB HBM3 at 700 W (k = 10, chip_smoke.py's
// time_merges) the block-a-query kernel took 0.019 ms against 0.051 at 64
// queries x 132 splits (the row-split route's), and 0.064 against 0.028 at
// 10,000 x 5 (the tensor-core route's).
inline cudaError_t merge(const float* pv, const int* pi, int m, int nsplit, int k,
                         float* ov, int* oi, cudaStream_t st) {
  return merge_by(nsplit >= 4 * (MERGE_THREADS / 32), pv, pi, m, nsplit, k, ov, oi, st);
}

}  // namespace warp_topk
