// Fused distance + top-k for exact brute-force kNN, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of raft_tpu/ops/fused_knn.py (_make_kernel,
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
//      (float32 FFMA, never TF32; int32 multiply-adds in mode s8);
//   3. the score tile goes to shared memory;
//   4. each warp offers its rows' scores to a per-query sorted top-k list in
//      shared memory, only where a score beats the running k-th best (tau).
// The wrapper cuts the dataset into as many splits as make the blocks fill
// the card's resident slots in nearly whole waves (fused_knn_config reports
// the slots); a second kernel merges the splits' sorted lists per query.
//
// Bound. At the main path's shape (10k queries x 1M rows x d=128, k=10) the
// work is 2·m·n·d = 2.56e12 float32 operations on CUDA cores (67 TFLOP/s),
// ~38 ms; the bytes (512 MB of dataset) take ~0.15 ms, so it is bound by
// operations. The gate makes the top-k upkeep small next to the products:
// after the first tiles tau is tight and almost no score passes it.
//
// Modes (the TPU kernel's _scores):
//   0 f32    float32 operands, float32 products and sums.
//   1 f32x3  float32 operands split into bf16 hi and lo parts; the score is
//            (hi·hi + hi·lo) + lo·hi, each term a float32 sum of exact products.
//   2 bf16   bfloat16 operands (cast by the wrapper), float32 products and sums.
//   3 s8     int8 operands, int32 sums, converted to float32 at the end.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int NB = 128;       // dataset rows per tile
constexpr int DK = 16;        // feature chunk staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, each a TM x TN micro-tile
constexpr int TN = 8;         // micro-tile columns: tx*4 + (0..3), 64 + tx*4 + (0..3)
constexpr int YS = NB + 4;    // shared row strides, kept 16-byte aligned
constexpr int SS = NB + 1;    // score tile stride (conflict-free row reads)
constexpr int MAXK = 64;
constexpr float NEG = -3.0e38f;
constexpr int BIG = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;
#define NEG_INF __int_as_float(0xff800000)

enum { F32 = 0, F32X3 = 1, BF16 = 2, S8 = 3 };

template <int MODE> struct Traits {
  using In = float;  // element type in device memory
  using S = float;   // element type in shared memory
  using V = float4;
};
template <> struct Traits<BF16> { using In = __nv_bfloat16; using S = float; using V = float4; };
template <> struct Traits<S8> { using In = int8_t; using S = int; using V = int4; };

// Tile shape per mode. A thread's micro-tile rows are g*64 + ty*4 + (0..3)
// for g < TM/4, so a block owns QT = 16*TM queries. f32x3 keeps three
// accumulators per score and takes the smaller tile to stay in registers;
// the others cap registers for two resident blocks per SM.
template <int MODE> struct Cfg {
  static constexpr int TM = MODE == F32X3 ? 4 : 8;
  static constexpr int QT = 16 * TM;
  static constexpr int QS = QT + 4;
  static constexpr int PL = MODE == F32X3 ? 2 : 1;   // planes: hi (and lo)
  static constexpr int NACC = MODE == F32X3 ? 3 : 1;
  static constexpr int QV = QT * DK / 4 / THREADS;   // query loads per thread
  static constexpr int MIN_BLOCKS = MODE == F32X3 ? 1 : 2;
  static constexpr int STAGE = PL * DK * (QS + YS);  // one buffer, in elements
};

__device__ __forceinline__ float bf16_round(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

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

// Four consecutive elements of a row in device memory, as one load.
template <int MODE> struct Load4 { using L = float4; };
template <> struct Load4<BF16> { using L = uint2; };
template <> struct Load4<S8> { using L = char4; };

__device__ __forceinline__ void unpack(float4 v, float* e) {
  e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
}
__device__ __forceinline__ void unpack(uint2 v, float* e) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  e[0] = __low2float(a); e[1] = __high2float(a);
  e[2] = __low2float(b); e[3] = __high2float(b);
}
__device__ __forceinline__ void unpack(char4 v, int* e) {
  e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
}

// One DK-wide feature chunk held in registers between its global load and
// its store to shared memory: QV 4-element loads of the query tile and two
// of the dataset tile per thread (vector index = tid + t * THREADS; row =
// index / 4, features 4 * (index % 4) ...).
template <int MODE> struct Chunk {
  typename Load4<MODE>::L q[Cfg<MODE>::QV], y[2];
};

template <int MODE>
__device__ __forceinline__ typename Load4<MODE>::L load4(
    const typename Traits<MODE>::In* src, int row, int limit, int d, int col) {
  using L = typename Load4<MODE>::L;
  if (row < limit && col < d) return *reinterpret_cast<const L*>(src + (size_t)row * d + col);
  return L{};
}

template <int MODE>
__device__ __forceinline__ void load_chunk(Chunk<MODE>& c,
                                           const typename Traits<MODE>::In* q,
                                           const typename Traits<MODE>::In* y,
                                           int q0, int m, int n0, int n, int d,
                                           int d0, int tid) {
#pragma unroll
  for (int t = 0; t < Cfg<MODE>::QV; ++t) {
    const int vi = tid + t * THREADS;
    c.q[t] = load4<MODE>(q, q0 + (vi >> 2), m, d, d0 + 4 * (vi & 3));
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int vi = tid + t * THREADS;
    c.y[t] = load4<MODE>(y, n0 + (vi >> 2), n, d, d0 + 4 * (vi & 3));
  }
}

// Write four elements of row r, features kk0 .. kk0+3, transposed into
// hi[kk * stride + r]; mode f32x3 also writes the low bf16 parts into lo.
template <int MODE>
__device__ __forceinline__ void put4(typename Traits<MODE>::S* hi,
                                     typename Traits<MODE>::S* lo,
                                     typename Load4<MODE>::L v, int r, int kk0,
                                     int stride) {
  typename Traits<MODE>::S e[4];
  unpack(v, e);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (MODE == F32X3) {
      const float h = bf16_round(e[i]);
      hi[(kk0 + i) * stride + r] = h;
      lo[(kk0 + i) * stride + r] = bf16_round(e[i] - h);
    } else {
      hi[(kk0 + i) * stride + r] = e[i];
    }
  }
}

template <int MODE>
__device__ __forceinline__ void store_chunk(const Chunk<MODE>& c,
                                            typename Traits<MODE>::S* qs,
                                            typename Traits<MODE>::S* ys, int tid) {
  constexpr int QS = Cfg<MODE>::QS;
#pragma unroll
  for (int t = 0; t < Cfg<MODE>::QV; ++t) {
    const int vi = tid + t * THREADS;
    put4<MODE>(qs, qs + DK * QS, c.q[t], vi >> 2, 4 * (vi & 3), QS);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int vi = tid + t * THREADS;
    put4<MODE>(ys, ys + DK * YS, c.y[t], vi >> 2, 4 * (vi & 3), YS);
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, Cfg<MODE>::MIN_BLOCKS)
fused_knn_kernel(const typename Traits<MODE>::In* __restrict__ q,
                 const typename Traits<MODE>::In* __restrict__ y,
                 const float* __restrict__ yn, int m, int n, int d, int k,
                 int l2, int rows_per_split, float* __restrict__ part_v,
                 int* __restrict__ part_i) {
  using S = typename Traits<MODE>::S;
  using V = typename Traits<MODE>::V;
  using Acc = typename std::conditional<MODE == S8, int, float>::type;
  constexpr int TM = Cfg<MODE>::TM, QT = Cfg<MODE>::QT, QS = Cfg<MODE>::QS;
  constexpr int PL = Cfg<MODE>::PL, NACC = Cfg<MODE>::NACC;
  constexpr int STAGE = Cfg<MODE>::STAGE;  // one buffer: [PL][DK][QS], [PL][DK][YS]

  extern __shared__ __align__(16) unsigned char smem[];
  S* stage = reinterpret_cast<S*>(smem);           // two buffers
  float* sc = reinterpret_cast<float*>(stage + 2 * STAGE);  // [QT][SS]
  float* tv = sc + QT * SS;                        // [QT][k]
  int* ti = reinterpret_cast<int*>(tv + QT * k);   // [QT][k]

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
  Chunk<MODE> regs;
  int buf = 0;
  if (n_begin < n_end) load_chunk<MODE>(regs, q, y, q0, m, n_begin, n, d, 0, tid);
  for (int n0 = n_begin; n0 < n_end; n0 += NB) {
    Acc acc[NACC][TM][TN];
#pragma unroll
    for (int p = 0; p < NACC; ++p)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[p][i][j] = Acc(0);

    for (int d0 = 0; d0 < d; d0 += DK) {
      S* qs = stage + buf * STAGE;
      S* ys = qs + PL * DK * QS;
      store_chunk<MODE>(regs, qs, ys, tid);
      __syncthreads();
      const bool next_tile = d0 + DK >= d;
      const int nn0 = next_tile ? n0 + NB : n0;
      if (nn0 < n_end)
        load_chunk<MODE>(regs, q, y, q0, m, nn0, n, d, next_tile ? 0 : d0 + DK, tid);
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        S a[PL][TM], b[PL][TN];
#pragma unroll
        for (int p = 0; p < PL; ++p) {
#pragma unroll
          for (int g = 0; g < TM / 4; ++g) {
            const V av = *reinterpret_cast<const V*>(&qs[(p * DK + kk) * QS + g * 64 + ty * 4]);
            a[p][4 * g] = av.x; a[p][4 * g + 1] = av.y; a[p][4 * g + 2] = av.z; a[p][4 * g + 3] = av.w;
          }
          const V b0 = *reinterpret_cast<const V*>(&ys[(p * DK + kk) * YS + tx * 4]);
          const V b1 = *reinterpret_cast<const V*>(&ys[(p * DK + kk) * YS + 64 + tx * 4]);
          b[p][0] = b0.x; b[p][1] = b0.y; b[p][2] = b0.z; b[p][3] = b0.w;
          b[p][4] = b1.x; b[p][5] = b1.y; b[p][6] = b1.z; b[p][7] = b1.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            if constexpr (MODE == F32X3) {
              acc[0][i][j] = fmaf(a[0][i], b[0][j], acc[0][i][j]);  // hi·hi
              acc[1][i][j] = fmaf(a[0][i], b[1][j], acc[1][i][j]);  // hi·lo
              acc[2][i][j] = fmaf(a[1][i], b[0][j], acc[2][i][j]);  // lo·hi
            } else if constexpr (MODE == S8) {
              acc[0][i][j] += a[0][i] * b[0][j];
            } else {
              acc[0][i][j] = fmaf(a[0][i], b[0][j], acc[0][i][j]);
            }
          }
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
        float dot;
        if constexpr (MODE == F32X3) dot = (acc[0][i][j] + acc[1][i][j]) + acc[2][i][j];
        else dot = (float)acc[0][i][j];
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

// Merge the nsplit sorted lists of each query into its top-k; one warp per
// query. Lists are sorted, so a chunk where no entry passes the gate ends
// that list.
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ pv, const int* __restrict__ pi, int m,
             int nsplit, int k, float* __restrict__ ov, int* __restrict__ oi) {
  __shared__ float tvs[THREADS / 32][MAXK];
  __shared__ int tis[THREADS / 32][MAXK];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (THREADS / 32) + warp;
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

// Dynamic shared memory of one block, and the attribute that allows it.
template <int MODE>
cudaError_t prepare(int k, size_t* smem) {
  using S = typename Traits<MODE>::S;
  constexpr int QT = Cfg<MODE>::QT;
  *smem = sizeof(S) * 2 * Cfg<MODE>::STAGE + sizeof(float) * QT * SS +
          (sizeof(float) + sizeof(int)) * QT * k;
  return cudaFuncSetAttribute(fused_knn_kernel<MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <int MODE>
cudaError_t config(int k, int* qt, int* slots) {
  size_t smem;
  cudaError_t e = prepare<MODE>(k, &smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_knn_kernel<MODE>,
                                                    THREADS, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *qt = Cfg<MODE>::QT;
  *slots = per_sm * sms;
  return e;
}

template <int MODE>
cudaError_t launch(const void* q, const void* y, const float* yn, int m, int n,
                   int d, int k, int l2, int nsplit, float* pv, int* pi,
                   cudaStream_t st) {
  size_t smem;
  cudaError_t e = prepare<MODE>(k, &smem);
  if (e != cudaSuccess) return e;
  const int tiles = (n + NB - 1) / NB;
  const int rows_per_split = ((tiles + nsplit - 1) / nsplit) * NB;
  const dim3 grid((m + Cfg<MODE>::QT - 1) / Cfg<MODE>::QT, nsplit);
  using In = typename Traits<MODE>::In;
  fused_knn_kernel<MODE><<<grid, THREADS, smem, st>>>(
      static_cast<const In*>(q), static_cast<const In*>(y), yn, m, n, d, k, l2,
      rows_per_split, pv, pi);
  return cudaGetLastError();
}

}  // namespace

// The query tile of mode's kernel (queries per block) and how many of its
// blocks with this k the current device holds at once (SMs x resident
// blocks per SM): the wrapper sizes the dataset split from them.
extern "C" int fused_knn_config(int mode, int k, int* qt, int* slots) {
  if (k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case F32: return (int)config<F32>(k, qt, slots);
    case F32X3: return (int)config<F32X3>(k, qt, slots);
    case BF16: return (int)config<BF16>(k, qt, slots);
    case S8: return (int)config<S8>(k, qt, slots);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Scores and top-k of every query. q (m, d) and y (n, d) are row-major in
// the mode's element type (float32, bfloat16 or int8), d a multiple of 4 and
// both aligned to 4 elements; yn is (n,) float32.
// With nsplit > 1 the splits' lists go to part_v/part_i (m, nsplit, k) and a
// second kernel merges them into out_v/out_i (m, k); with nsplit == 1 the
// parts are not used. Returns the launch's cudaError_t.
extern "C" int fused_knn_launch(int mode, const void* q, const void* y,
                                const float* yn, int m, int n, int d, int k,
                                int l2, int nsplit, float* part_v, int* part_i,
                                float* out_v, int* out_i, void* stream) {
  const size_t elt = mode == BF16 ? 2 : mode == S8 ? 1 : 4;
  const bool aligned = reinterpret_cast<uintptr_t>(q) % (4 * elt) == 0 &&
                       reinterpret_cast<uintptr_t>(y) % (4 * elt) == 0;
  if (k < 1 || k > MAXK || nsplit < 1 || nsplit > 65535 || m < 1 || n < 1 || d < 1 ||
      d % 4 != 0 || !aligned)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = nsplit == 1 ? out_v : part_v;
  int* pi = nsplit == 1 ? out_i : part_i;
  cudaError_t e;
  switch (mode) {
    case F32: e = launch<F32>(q, y, yn, m, n, d, k, l2, nsplit, pv, pi, st); break;
    case F32X3: e = launch<F32X3>(q, y, yn, m, n, d, k, l2, nsplit, pv, pi, st); break;
    case BF16: e = launch<BF16>(q, y, yn, m, n, d, k, l2, nsplit, pv, pi, st); break;
    case S8: e = launch<S8>(q, y, yn, m, n, d, k, l2, nsplit, pv, pi, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  merge_kernel<<<(m + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, st>>>(
      part_v, part_i, m, nsplit, k, out_v, out_i);
  return (int)cudaGetLastError();
}
