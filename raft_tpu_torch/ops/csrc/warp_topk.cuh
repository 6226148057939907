// Per-query sorted top-k lists kept by one warp, and the merge of a query's
// dataset splits, shared by the fused_knn kernels (fused_knn.cu, the float32
// FFMA kernel, and fused_knn_tc.cu, the tensor-core modes), for Hopper
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

// Merge the nsplit sorted lists of each query into its top-k; one warp per
// query. Lists are sorted, so a chunk where no entry passes the gate ends
// that list.
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
    for (int j0 = 0; j0 < k; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < k;
      const float v = ok ? pv[base + j] : NEG;
      const int id = ok ? pi[base + j] : BIG;
      const bool pass = ok && beats(v, id, tv[k - 1], ti[k - 1]);
      if (!__any_sync(FULL, pass)) break;
      warp_offer(tv, ti, k, v, id, ok, lane);
    }
  }
  for (int j = lane; j < k; j += 32) {
    ov[(size_t)row * k + j] = tv[j];
    oi[(size_t)row * k + j] = ti[j];
  }
}

// Launch merge_kernel over m queries.
inline cudaError_t merge(const float* pv, const int* pi, int m, int nsplit, int k,
                         float* ov, int* oi, cudaStream_t st) {
  constexpr int ROWS = MERGE_THREADS / 32;
  merge_kernel<<<(m + ROWS - 1) / ROWS, MERGE_THREADS, 0, st>>>(pv, pi, m, nsplit, k, ov, oi);
  return cudaGetLastError();
}

}  // namespace warp_topk
