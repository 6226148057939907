// IVF-PQ look-up-table scan, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of raft_tpu/ops/pq_scan.py (_make_kernel, called
// from _pq_scan_impl through pq_lut_scan). For every (query, probe) pair b of
// a search step and every slot j of the list l = probe_lists[b] it computes
//     pq4:        out[b, j] = sum_s lut[b, s, c & 15]
//     split pq8:  out[b, j] = sum_s (lut[b, s, c >> 4] + lut[b, s, 16 + (c & 15)])
// with c = list_codes[l, j, s], summed in float32 in subspace order
// s = 0 .. S-1 (ops/pq_scan.py's pq_scan_plain sums in the same order, so the
// two agree bit for bit). A pq4 index stores codes below 16, so the "& 15"
// changes nothing there; it keeps a stray byte from reading outside the table.
// Slots past a list's size are scored too: the caller masks them by list_ids.
//
// Design. The TPU kernel packs two candidates into one 128-lane row and
// gathers with tpu.dynamic_gather in two 8-entry halves; none of that carries
// over. Here the kernel follows each pair's list id itself, so the
// (pairs, cap, S) code gather the XLA path builds never exists:
//   - one block per (pair, tile of 256 slots); the block stages its pair's
//     LUT into shared memory as float32 [S][K] (4 KB at S=64, K=16; dynamic
//     shared memory, opted in above 48 KB);
//   - each thread owns one slot and reads its S code bytes straight from the
//     list, 16 bytes a load where S is a multiple of 16, one byte a load
//     otherwise;
//   - the threads of a warp step through s together, so their table reads
//     lie in one 16-entry row (or two for split): distinct codes fall in
//     distinct banks and equal codes broadcast, with no bank conflict.
//
// Bound. Each input byte once: the probed lists' codes (pairs x cap x S B,
// 83 MB per 10,000-query batch at the 1M x 128, pq4 x 64, 8-probe
// configuration), the LUTs (pairs x S x K x 2 B in bfloat16, 164 MB) and the
// scores written (pairs x cap x 4 B, 0.41 GB): ~0.65 GB, ~0.2 ms at
// 3.35 TB/s, so bytes bound it. The first design does S table reads and adds
// per slot (6.5e9 per batch there) and rereads a list's codes once for each
// pair that probes it; both, and the score round trip through device memory,
// are for later versions to cut (a fused per-probe top-k, pairs grouped by
// list).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block can use

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool SPLIT>
__device__ __forceinline__ float add_code(float acc, const float* row, uint32_t c) {
  if (SPLIT) return acc + (row[c >> 4] + row[16 + (c & 15)]);
  return acc + row[c & 15];
}

template <typename LutT, bool SPLIT>
__global__ void __launch_bounds__(THREADS)
pq_scan_kernel(const uint8_t* __restrict__ codes, const int* __restrict__ probe_lists,
               const LutT* __restrict__ lut, int n_lists, int cap, int S, int vec16,
               float* __restrict__ out) {
  constexpr int K = SPLIT ? 32 : 16;
  extern __shared__ float slut[];  // [S][K]
  const int b = blockIdx.x;
  const LutT* lb = lut + (size_t)b * S * K;
  for (int i = threadIdx.x; i < S * K; i += THREADS) slut[i] = to_f(lb[i]);
  __syncthreads();

  const int j = blockIdx.y * THREADS + threadIdx.x;
  if (j >= cap) return;
  const int list = probe_lists[b];
  float* o = out + (size_t)b * cap + j;
  if (list < 0 || list >= n_lists) {  // not a list of this index
    *o = __int_as_float(0x7fc00000);
    return;
  }
  const uint8_t* row = codes + ((size_t)list * cap + j) * S;
  float acc = 0.f;
  if (vec16) {
    for (int s = 0; s < S; s += 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + s));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc = add_code<SPLIT>(acc, slut + (s + 4 * q + t) * K, (w[q] >> (8 * t)) & 0xffu);
        }
      }
    }
  } else {
    for (int s = 0; s < S; ++s) acc = add_code<SPLIT>(acc, slut + s * K, __ldg(row + s));
  }
  *o = acc;
}

template <typename LutT, bool SPLIT>
int launch(const void* codes, const void* probe_lists, const void* lut, int n_pairs,
           int n_lists, int cap, int S, float* out, cudaStream_t st) {
  constexpr int K = SPLIT ? 32 : 16;
  const size_t smem = (size_t)S * K * sizeof(float);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = pq_scan_kernel<LutT, SPLIT>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec16 = (S % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const dim3 grid(n_pairs, (cap + THREADS - 1) / THREADS);
  kern<<<grid, THREADS, smem, st>>>(static_cast<const uint8_t*>(codes),
                                     static_cast<const int*>(probe_lists),
                                     static_cast<const LutT*>(lut), n_lists, cap, S, vec16, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Scores (n_pairs, cap) float32 of every slot of the list each pair probes.
// codes: (n_lists, cap, S) uint8; probe_lists: (n_pairs,) int32; lut:
// (n_pairs, S, K) float32 (lut_dtype 0) or bfloat16 (1), K = 32 with split,
// else 16. A pair whose list id is out of range scores NaN. Returns the
// launch's cudaError_t.
extern "C" int pq_scan_launch(int lut_dtype, int split, const void* codes,
                              const void* probe_lists, const void* lut, int n_pairs,
                              int n_lists, int cap, int S, float* out, void* stream) {
  if (n_pairs < 1 || cap < 1 || S < 1 || n_lists < 1 || (cap + THREADS - 1) / THREADS > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lut_dtype == 0) {
    return split ? launch<float, true>(codes, probe_lists, lut, n_pairs, n_lists, cap, S, out, st)
                 : launch<float, false>(codes, probe_lists, lut, n_pairs, n_lists, cap, S, out, st);
  }
  if (lut_dtype == 1) {
    return split ? launch<__nv_bfloat16, true>(codes, probe_lists, lut, n_pairs, n_lists, cap, S,
                                               out, st)
                 : launch<__nv_bfloat16, false>(codes, probe_lists, lut, n_pairs, n_lists, cap, S,
                                                out, st);
  }
  return (int)cudaErrorInvalidValue;
}
