// Fused distance + top-k for exact brute-force kNN in float32, for Hopper
// (sm_90a): mode "f32" of ops/fused_knn.py. The bf16, f32x3 and s8 modes run
// on the tensor cores in fused_knn_tc.cu.
//
// Replaces the Pallas kernel of raft_tpu/ops/fused_knn.py:150 (_make_kernel,
// called from _fused_knn_impl). Per query it returns the k best scores
//     s = 2·q·y − yn   (metric "l2")    or    s = q·y − yn   ("ip")
// over the dataset rows, where yn carries |y|² (l2), an optional row bias and
// the 3e38 mask penalty of filtered rows. The best is the largest score; equal
// scores go to the lowest dataset index. Results are sorted best first and
// start from the sentinels (-3e38, 2^30), as the TPU kernel's running state
// does. The wrapper (ops/fused_knn.py) turns scores into distances.
//
// Design. The TPU kernel walks dataset blocks in order on one core and carries
// its running top-k from one grid step to the next. Here blocks run in no
// order, so one block owns a tile of QT queries and a contiguous split of the
// dataset and loops over that split itself:
//   1. stage a DK-wide feature chunk of the query tile and of an NB-row
//      dataset tile in shared memory, double-buffered: the next chunk's
//      global loads (four elements per thread per load) are in flight
//      while the current chunk is multiplied;
//   2. each thread accumulates a TM x TN register micro-tile of dot products
//      (float32 FFMA, never TF32);
//   3. the score tile goes to shared memory;
//   4. each warp offers its rows' scores to a per-query sorted top-k list in
//      shared memory, only where a score beats the running k-th best (tau).
// The wrapper cuts the dataset into as many splits as make the blocks fill
// the card's resident slots in nearly whole waves (fused_knn_config reports
// the slots); a second kernel merges the splits' sorted lists per query
// (warp_topk.cuh).
//
// Bound. At the main path's shape (10k queries x 1M rows x d=128, k=10) the
// work is 2·m·n·d = 2.56e12 float32 operations on CUDA cores (67 TFLOP/s),
// ~38 ms; the bytes (512 MB of dataset) take ~0.15 ms, so it is bound by
// operations. The gate makes the top-k upkeep small next to the products:
// after the first tiles tau is tight and almost no score passes it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_topk.cuh"

namespace {

using warp_topk::beats;
using warp_topk::BIG;
using warp_topk::MAXK;
using warp_topk::NEG;
using warp_topk::warp_offer;

constexpr int NB = 128;       // dataset rows per tile
constexpr int DK = 16;        // feature chunk staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, each a TM x TN micro-tile
constexpr int TM = 8;         // micro-tile rows: g*64 + ty*4 + (0..3), g < 2
constexpr int TN = 8;         // micro-tile columns: tx*4 + (0..3), 64 + tx*4 + (0..3)
constexpr int QT = 16 * TM;   // queries per block
constexpr int QS = QT + 4;    // shared row strides, kept 16-byte aligned
constexpr int YS = NB + 4;
constexpr int SS = NB + 1;    // score tile stride (conflict-free row reads)
constexpr int QV = QT * DK / 4 / THREADS;  // query loads per thread
constexpr int MIN_BLOCKS = 2;              // registers capped for two blocks per SM
constexpr int STAGE = DK * (QS + YS);      // one buffer, in floats
#define NEG_INF __int_as_float(0xff800000)

// One DK-wide feature chunk held in registers between its global load and
// its store to shared memory: QV 4-element loads of the query tile and two
// of the dataset tile per thread (vector index = tid + t * THREADS; row =
// index / 4, features 4 * (index % 4) ...).
struct Chunk {
  float4 q[QV], y[2];
};

__device__ __forceinline__ float4 load4(const float* src, int row, int limit, int d, int col) {
  if (row < limit && col < d) return *reinterpret_cast<const float4*>(src + (size_t)row * d + col);
  return float4{};
}

__device__ __forceinline__ void load_chunk(Chunk& c, const float* q, const float* y, int q0,
                                           int m, int n0, int n, int d, int d0, int tid) {
#pragma unroll
  for (int t = 0; t < QV; ++t) {
    const int vi = tid + t * THREADS;
    c.q[t] = load4(q, q0 + (vi >> 2), m, d, d0 + 4 * (vi & 3));
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int vi = tid + t * THREADS;
    c.y[t] = load4(y, n0 + (vi >> 2), n, d, d0 + 4 * (vi & 3));
  }
}

// Write four features kk0 .. kk0+3 of row r transposed into s[kk * stride + r].
__device__ __forceinline__ void put4(float* s, float4 v, int r, int kk0, int stride) {
  s[kk0 * stride + r] = v.x;
  s[(kk0 + 1) * stride + r] = v.y;
  s[(kk0 + 2) * stride + r] = v.z;
  s[(kk0 + 3) * stride + r] = v.w;
}

__device__ __forceinline__ void store_chunk(const Chunk& c, float* qs, float* ys, int tid) {
#pragma unroll
  for (int t = 0; t < QV; ++t) {
    const int vi = tid + t * THREADS;
    put4(qs, c.q[t], vi >> 2, 4 * (vi & 3), QS);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int vi = tid + t * THREADS;
    put4(ys, c.y[t], vi >> 2, 4 * (vi & 3), YS);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
fused_knn_kernel(const float* __restrict__ q, const float* __restrict__ y,
                 const float* __restrict__ yn, int m, int n, int d, int k,
                 int l2, int rows_per_split, float* __restrict__ part_v,
                 int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);   // two buffers: [DK][QS], [DK][YS]
  float* sc = stage + 2 * STAGE;                    // [QT][SS]
  float* tv = sc + QT * SS;                         // [QT][k]
  int* ti = reinterpret_cast<int*>(tv + QT * k);    // [QT][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(n, n_begin + rows_per_split);

  for (int idx = tid; idx < QT * k; idx += THREADS) {
    tv[idx] = NEG;
    ti[idx] = BIG;
  }

  // chunks are double-buffered: while one is multiplied out of shared
  // memory, the next one's global loads are in flight in registers
  Chunk regs;
  int buf = 0;
  if (n_begin < n_end) load_chunk(regs, q, y, q0, m, n_begin, n, d, 0, tid);
  for (int n0 = n_begin; n0 < n_end; n0 += NB) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += DK) {
      float* qs = stage + buf * STAGE;
      float* ys = qs + DK * QS;
      store_chunk(regs, qs, ys, tid);
      __syncthreads();
      const bool next_tile = d0 + DK >= d;
      const int nn0 = next_tile ? n0 + NB : n0;
      if (nn0 < n_end)
        load_chunk(regs, q, y, q0, m, nn0, n, d, next_tile ? 0 : d0 + DK, tid);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int g = 0; g < TM / 4; ++g) {
          const float4 av = *reinterpret_cast<const float4*>(&qs[kk * QS + g * 64 + ty * 4]);
          a[4 * g] = av.x; a[4 * g + 1] = av.y; a[4 * g + 2] = av.z; a[4 * g + 3] = av.w;
        }
        const float4 b0 = *reinterpret_cast<const float4*>(&ys[kk * YS + tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&ys[kk * YS + 64 + tx * 4]);
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      buf ^= 1;
    }

    // score tile: s = 2·dot − yn (l2) or dot − yn; rows outside the split
    // score −inf and are never offered
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = (i / 4) * 64 + ty * 4 + (i % 4);
        const int c = (j / 4) * 64 + tx * 4 + (j % 4);
        const int id = n0 + c;
        const float dot = acc[i][j];
        sc[r * SS + c] = id < n_end ? (l2 ? 2.0f * dot : dot) - yn[id] : NEG_INF;
      }
    __syncthreads();

    for (int r = warp * (QT / 8); r < (warp + 1) * (QT / 8); ++r)
      for (int c = lane; c < NB; c += 32) {
        const int id = n0 + c;
        warp_offer(tv + r * k, ti + r * k, k, sc[r * SS + c], id, id < n_end, lane);
      }
  }
  __syncthreads();

  const int nsplit = gridDim.y;
  for (int idx = tid; idx < QT * k; idx += THREADS) {
    const int r = idx / k, j = idx % k;
    if (q0 + r < m) {
      const size_t o = ((size_t)(q0 + r) * nsplit + split) * k + j;
      part_v[o] = tv[idx];
      part_i[o] = ti[idx];
    }
  }
}

// Dynamic shared memory of one block, and the attribute that allows it.
cudaError_t prepare(int k, size_t* smem) {
  *smem = sizeof(float) * 2 * STAGE + sizeof(float) * QT * SS +
          (sizeof(float) + sizeof(int)) * QT * k;
  return cudaFuncSetAttribute(fused_knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

// The query tile of the kernel (queries per block) and how many of its
// blocks with this k the current device holds at once (SMs x resident
// blocks per SM): the wrapper sizes the dataset split from them.
extern "C" int fused_knn_config(int k, int* qt, int* slots) {
  if (k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  size_t smem;
  cudaError_t e = prepare(k, &smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_knn_kernel, THREADS, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *qt = QT;
  *slots = per_sm * sms;
  return (int)e;
}

// Scores and top-k of every query. q (m, d) and y (n, d) are row-major
// float32, d a multiple of 4 and both 16-byte aligned; yn is (n,) float32.
// With nsplit > 1 the splits' lists go to part_v/part_i (m, nsplit, k) and a
// second kernel merges them into out_v/out_i (m, k); with nsplit == 1 the
// parts are not used. Returns the launch's cudaError_t.
extern "C" int fused_knn_launch(const float* q, const float* y, const float* yn, int m, int n,
                                int d, int k, int l2, int nsplit, float* part_v, int* part_i,
                                float* out_v, int* out_i, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (k < 1 || k > MAXK || nsplit < 1 || nsplit > 65535 || m < 1 || n < 1 || d < 1 ||
      d % 4 != 0 || !aligned)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = nsplit == 1 ? out_v : part_v;
  int* pi = nsplit == 1 ? out_i : part_i;
  size_t smem;
  cudaError_t e = prepare(k, &smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n + NB - 1) / NB;
  const int rows_per_split = ((tiles + nsplit - 1) / nsplit) * NB;
  const dim3 grid((m + QT - 1) / QT, nsplit);
  fused_knn_kernel<<<grid, THREADS, smem, st>>>(q, y, yn, m, n, d, k, l2, rows_per_split, pv, pi);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  return (int)warp_topk::merge(part_v, part_i, m, nsplit, k, out_v, out_i, st);
}
