// Fused distance + top-k for exact brute-force kNN in float32, for Hopper
// (sm_90a): mode "f32"'s row-split route of ops/fused_knn.py, for m <=
// M_SMALL (256) queries. Beyond M_SMALL, mode f32 runs as 3xTF32 products
// on the tensor cores (fused_knn_tc.cu, "tf32x3"), and so do the bf16,
// f32x3 and s8 modes.
//
// Replaces the Pallas kernel of raft_tpu/ops/fused_knn.py:150 (_make_kernel,
// called from _fused_knn_impl) at those shapes. Per query it returns the k
// best scores
//     s = 2·q·y − yn   (metric "l2")    or    s = q·y − yn   ("ip")
// over the dataset rows, where yn is |y|² (l2) plus an optional row bias and
// the 3e38 mask penalty of filtered rows, clamped at 3e38 under a mask. The
// best is the largest score; equal scores go to the lowest dataset index.
// Results are sorted best first and start from the sentinels (-3e38, 2^30),
// as the TPU kernel's running state does. The wrapper (ops/fused_knn.py)
// turns scores into distances.
//
// Bound. At serving and delta-scan shapes (1 to 64 queries over up to 1M
// rows) the function is bound by bytes: one read of the dataset, 512 MB at
// 1M x 128, is 0.153 ms at 3.35 TB/s, while its float32-accurate products
// as three TF32 tensor-core products take 0.099 ms at m = 64 (495 TFLOP/s).
// The FFMA products this kernel runs take 0.004 ms at m = 1 and 0.245 ms at
// m = 64 (67 TFLOP/s): at m = 64 this design's own floor is 1.6x the
// function's bound. So the grid walks the
// dataset, not the queries: each block owns a contiguous split of whole row
// tiles and holds all of its (up to 64) queries, and the splits are sized so
// that the blocks fill the card's SMs in whole waves. Each row is read from
// device memory once a call, and |y|² is summed in the kernel from the tile
// it has staged, so the wrapper passes only the row bias and mask penalty,
// and only where there are any.
//
// Products on CUDA cores (FFMA), not 3xTF32 wgmma: at m <= 64 FFMA is within
// 1.6x of the bytes bound at the top of the range and far below it at
// m <= 16, so the simpler design reaches the bound where the serving
// buckets and the delta scan mostly are; its sums are float32
// round-to-nearest in feature order, as the plain version's GEMM is up to
// the sum's order. Beyond 64 queries the grid also walks 64-query tiles,
// each reading the dataset again; on the H100 that still beat the 3xTF32
// route at every m of the sweep up to 256 and lost from 384, which sets
// M_SMALL.
//
// Design (one block: two consumer warpgroups, one producer warpgroup whose
// registers go to the consumers by setmaxnreg):
//   * TMA loads 128-byte boxes (32 float32 features) of NB dataset rows and of
//     the MQ queries, 128-byte swizzled, into a ring of `stages` stages, one
//     full and one empty mbarrier each; at large d the queries ride with
//     every box, so no d is too wide for shared memory. At MQ >= 32 the
//     producer issues a tile's boxes four at a time.
//   * warp w takes query group w % QG (TQ = min(MQ, 8) queries) and row group
//     w / QG (RG = 8 / QG groups of 32·R rows); lane l holds rows l + 32 j
//     (j < R) of its group and a TQ x R micro-tile of sums. A row's 16-byte
//     unit u lies at unit u ^ (row & 7) of its 128 bytes, so eight lanes
//     reading eight rows hit eight distinct bank groups; a query's unit is
//     the same address for the whole warp (a broadcast).
//   * after a tile's last box each warp scores its TQ x 32R candidates,
//     s = c·dot − (|y|² + pen), and offers them to its queries' running
//     top-k lists, gated by each list's k-th best: one vote a query, and
//     the rare passing candidates inserted one at a time. The warp's lists
//     live in registers across its lanes (two slots a lane, the k-th entry
//     in every lane), so an insertion is a few shuffles, not a chain of
//     shared-memory round trips: with two warps a scheduler, those round
//     trips were the route's largest cost at m >= 16.
//   * at the end the RG lists of each query are merged in the block, and
//     each block writes one (query, split) list; warp_topk::merge joins the
//     splits (a block a query for 32 splits or more, a warp a query below:
//     each kernel is the faster on its own side, chip_smoke.py's
//     time_merges). Split s takes tiles [s·T/S, (s+1)·T/S) of T, so S <= T
//     splits are never empty and differ by at most a tile.
// MQ is the least power of two up to 64 that holds m (blockIdx.x walks query
// tiles of 64 beyond that); NB = 256 rows (128 at MQ = 64) and R = 1 (MQ <=
// 8), 2 (16), 4 (32, 64).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "warp_topk.cuh"

using warp_topk::MAXK;

namespace {

constexpr int ROW_WARPS = 8;                      // consumer warps: two warpgroups
constexpr int ROW_THREADS = 384;                  // and a producer warpgroup
// setmaxnreg moves registers within the block's launch allocation (168 x 384):
// the producer warpgroup keeps 24 a thread, the consumers take 240
constexpr int ROW_PRODUCER_REGS = 24, ROW_CONSUMER_REGS = 240;
static_assert(128 * ROW_PRODUCER_REGS + 256 * ROW_CONSUMER_REGS <= 168 * ROW_THREADS,
              "the warpgroups' registers must fit the block's launch allocation");
constexpr int ROW_BOX = 128;                      // bytes of a row per box (32 floats)
constexpr int ROW_SMEM_MAX = 232448;
constexpr int ROW_ALIGN = 1024;                   // the 128-byte swizzle repeats every 8 rows
constexpr int ROW_MAX_STAGES = 8;
constexpr float MASK_PENALTY = 3.0e38f;

template <int MQ> struct RowCfg {
  static constexpr int TQ = MQ < 8 ? MQ : 8;         // queries per warp
  static constexpr int QG = MQ / TQ;                 // query groups
  static constexpr int RG = ROW_WARPS / QG;          // row groups
  static constexpr int NB = MQ == 64 ? 128 : 256;    // dataset rows per tile
  static constexpr int R = NB / (32 * RG);           // rows per lane
  static constexpr int QROWS = MQ < 8 ? 8 : MQ;      // query rows a stage reserves
  static constexpr int GROUP = MQ >= 32 ? 4 : 1;     // boxes the producer issues together
  static_assert(QG * RG == ROW_WARPS && R * 32 * RG == NB, "row-split tiling");
  static_assert(TQ * R <= 32, "the gate's pending bits are one 32-bit word");
};

// Byte offsets of one block's shared memory after its base is aligned:
// [stages x (NB dataset rows, max(MQ, 8) query rows) x 128 B][list scores
// RG x MQ x k][list rows RG x MQ x k][full, empty barriers per stage]. Every
// box starts on a 1,024-byte boundary, where its swizzle pattern starts.
struct RowLayout {
  int stage_bytes, tv_off, ti_off, bar_off, total;
};

__host__ __device__ inline RowLayout row_layout(int mq, int nb, int rg, int k, int stages) {
  RowLayout L;
  L.stage_bytes = (nb + (mq < 8 ? 8 : mq)) * ROW_BOX;
  L.tv_off = stages * L.stage_bytes;
  L.ti_off = L.tv_off + rg * mq * k * 4;
  L.bar_off = L.ti_off + rg * mq * k * 4;
  L.total = L.bar_off + 2 * stages * 8 + ROW_ALIGN;
  return L;
}

// Insert (cs, cid) into a sorted list of k <= 64 held in registers across
// the warp: lane l holds slots l (v0, i0) and l + 32 (v1, i1). The whole
// warp calls it with the same candidate, which must beat slot k-1; entries
// past it shift down one slot (slots past k hold no entry that is read).
__device__ __forceinline__ void reg_insert(float& v0, int& i0, float& v1, int& i1, int k,
                                           float cs, int cid, int lane) {
  using warp_topk::beats;
  using warp_topk::FULL;
  const int pos = __popc(__ballot_sync(FULL, lane < k && beats(v0, i0, cs, cid))) +
                  __popc(__ballot_sync(FULL, lane + 32 < k && beats(v1, i1, cs, cid)));
  const float p0 = __shfl_up_sync(FULL, v0, 1), p1 = __shfl_up_sync(FULL, v1, 1);
  const int q0 = __shfl_up_sync(FULL, i0, 1), q1 = __shfl_up_sync(FULL, i1, 1);
  const float c = __shfl_sync(FULL, v0, 31);   // slot 31 moves to slot 32
  const int ci = __shfl_sync(FULL, i0, 31);
  if (lane > pos) {
    v0 = p0;
    i0 = q0;
  } else if (lane == pos) {
    v0 = cs;
    i0 = cid;
  }
  if (lane + 32 > pos) {
    v1 = lane == 0 ? c : p1;
    i1 = lane == 0 ? ci : q1;
  } else if (lane + 32 == pos) {
    v1 = cs;
    i1 = cid;
  }
}

template <int MQ>
__global__ void __launch_bounds__(ROW_THREADS, 1)
fused_knn_rows_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap ymap, const float* __restrict__ pen,
                      int clamp, int m, int n, int d, int k, int l2, int stages,
                      float* __restrict__ part_v, int* __restrict__ part_i) {
  using C = RowCfg<MQ>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ROW_ALIGN - 1) & ~uintptr_t(ROW_ALIGN - 1));
  const RowLayout L = row_layout(MQ, C::NB, C::RG, k, stages);
  float* tv = reinterpret_cast<float*>(smem + L.tv_off);
  int* ti = reinterpret_cast<int*>(smem + L.ti_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + stages;

  // split s takes tiles [s·T/S, (s+1)·T/S) of the T tiles: runs that differ
  // by at most one tile, none empty while S <= T
  const int q0 = blockIdx.x * MQ;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const long long all_tiles = (n + C::NB - 1) / C::NB;
  const int t_begin = (int)(split * all_tiles / nsplit);
  const int tiles = (int)((split + 1) * all_tiles / nsplit) - t_begin;
  const int n_begin = t_begin * C::NB;
  const int n_end = min(n, n_begin + tiles * C::NB);
  const int kc = (d + 31) / 32;
  const int warp = __shfl_sync(warp_topk::FULL, threadIdx.x / 32, 0), lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], ROW_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= ROW_WARPS) {
    // ---- producer: one thread issues every copy, GROUP boxes at a time ----
    regs_release<ROW_PRODUCER_REGS>();
    if (warp == ROW_WARPS && lane == 0) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&ymap);
      const int total = tiles * kc, G = min(C::GROUP, stages);
      for (int g0 = 0; g0 < total; g0 += G) {
        const int g1 = min(g0 + G, total);
        for (int gi = g0; gi < g1; ++gi)
          mbar_wait(&empty[gi % stages], ((gi / stages) & 1) ^ 1);
        for (int gi = g0; gi < g1; ++gi) {
          const int s = gi % stages, t = gi / kc, c = gi % kc;
          unsigned char* st = smem + s * L.stage_bytes;
          mbar_expect_tx(&full[s], (C::NB + MQ) * ROW_BOX);
          tma_load_2d(st, &ymap, &full[s], c * 32, n_begin + t * C::NB);
          tma_load_2d(st + C::NB * ROW_BOX, &qmap, &full[s], c * 32, q0);
        }
      }
    }
    return;
  }
  regs_acquire<ROW_CONSUMER_REGS>();

  // ---- consumers ----
  const int qg = warp % C::QG, rg = warp / C::QG;
  const int rbase = rg * 32 * C::R;                 // this warp's first row in a tile
  // the warp's TQ lists in registers: lane l holds slots l and l + 32 of
  // each, and every lane the list's k-th entry (tau)
  float v0[C::TQ], v1[C::TQ], tau[C::TQ];
  int i0[C::TQ], i1[C::TQ], taui[C::TQ];
#pragma unroll
  for (int i = 0; i < C::TQ; ++i) {
    v0[i] = v1[i] = tau[i] = warp_topk::NEG;
    i0[i] = i1[i] = taui[i] = warp_topk::BIG;
  }
  const float cf = l2 ? 2.0f : 1.0f;

  for (int t = 0; t < tiles; ++t) {
    float acc[C::TQ][C::R], yy[C::R];
#pragma unroll
    for (int j = 0; j < C::R; ++j) {
      yy[j] = 0.f;
#pragma unroll
      for (int i = 0; i < C::TQ; ++i) acc[i][j] = 0.f;
    }
    for (int c = 0; c < kc; ++c) {
      const int gi = t * kc + c, s = gi % stages;
      mbar_wait(&full[s], (gi / stages) & 1);
      const unsigned char* yb = smem + s * L.stage_bytes;
      const unsigned char* qb = yb + C::NB * ROW_BOX;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        float4 yv[C::R];
#pragma unroll
        for (int j = 0; j < C::R; ++j) {
          yv[j] = *reinterpret_cast<const float4*>(yb + sw128_unit(rbase + lane + 32 * j, u));
          if (l2) {
            yy[j] = fmaf(yv[j].x, yv[j].x, yy[j]);
            yy[j] = fmaf(yv[j].y, yv[j].y, yy[j]);
            yy[j] = fmaf(yv[j].z, yv[j].z, yy[j]);
            yy[j] = fmaf(yv[j].w, yv[j].w, yy[j]);
          }
        }
#pragma unroll
        for (int i = 0; i < C::TQ; ++i) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qb + sw128_unit(qg * C::TQ + i, u));
#pragma unroll
          for (int j = 0; j < C::R; ++j) {
            acc[i][j] = fmaf(qv.x, yv[j].x, acc[i][j]);
            acc[i][j] = fmaf(qv.y, yv[j].y, acc[i][j]);
            acc[i][j] = fmaf(qv.z, yv[j].z, acc[i][j]);
            acc[i][j] = fmaf(qv.w, yv[j].w, acc[i][j]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);   // after every read of the stage
    }

    // scores s = c·dot − (|y|² + pen), gated by each query's k-th entry:
    // one vote a query finds whether some lane's candidate reaches it, and
    // only then are its candidates inserted, one at a time, each checked
    // against the list as it stands. Rows outside the split are never
    // offered.
    const int n0 = n_begin + t * C::NB + rbase + lane;
#pragma unroll
    for (int j = 0; j < C::R; ++j) {
      if (pen != nullptr && n0 + 32 * j < n_end) {
        yy[j] += pen[n0 + 32 * j];
        if (clamp) yy[j] = fminf(yy[j], MASK_PENALTY);
      }
    }
#pragma unroll
    for (int i = 0; i < C::TQ; ++i) {
      bool any = false;
#pragma unroll
      for (int j = 0; j < C::R; ++j)
        any |= n0 + 32 * j < n_end &&
               warp_topk::beats(fmaf(cf, acc[i][j], -yy[j]), n0 + 32 * j, tau[i], taui[i]);
      if (!__any_sync(warp_topk::FULL, any)) continue;   // warp-uniform
#pragma unroll 1
      for (int j = 0; j < C::R; ++j) {
        float a = 0.f, y = 0.f;
#pragma unroll
        for (int jj = 0; jj < C::R; ++jj)
          if (jj == j) {
            a = acc[i][jj];
            y = yy[jj];
          }
        const float sc = fmaf(cf, a, -y);
        const int id = n0 + 32 * j;
        unsigned msk = __ballot_sync(warp_topk::FULL,
                                     id < n_end && warp_topk::beats(sc, id, tau[i], taui[i]));
        while (msk) {
          const int src = __ffs(msk) - 1;
          msk &= msk - 1;
          const float cs = __shfl_sync(warp_topk::FULL, sc, src);
          const int cid = __shfl_sync(warp_topk::FULL, id, src);
          if (!warp_topk::beats(cs, cid, tau[i], taui[i])) continue;   // warp-uniform
          reg_insert(v0[i], i0[i], v1[i], i1[i], k, cs, cid, lane);
          const bool hi = k > 32;
          tau[i] = __shfl_sync(warp_topk::FULL, hi ? v1[i] : v0[i], (k - 1) & 31);
          taui[i] = __shfl_sync(warp_topk::FULL, hi ? i1[i] : i0[i], (k - 1) & 31);
        }
      }
    }
  }

  // the lists to shared memory (slots past k are never read)
  float* lv = tv + (rg * MQ + qg * C::TQ) * k;      // this warp's TQ lists, query-major
  int* li = ti + (rg * MQ + qg * C::TQ) * k;
#pragma unroll
  for (int i = 0; i < C::TQ; ++i) {
    if (lane < k) {
      lv[i * k + lane] = v0[i];
      li[i * k + lane] = i0[i];
    }
    if (lane + 32 < k) {
      lv[i * k + lane + 32] = v1[i];
      li[i * k + lane + 32] = i1[i];
    }
  }

  // the RG lists of each query into the first, then one list per (query,
  // split) out; the named barrier holds the consumer warps only
  asm volatile("bar.sync 1, %0;\n" ::"n"(ROW_WARPS * 32) : "memory");
  for (int q = warp; q < MQ; q += ROW_WARPS) {
    float* mv = tv + q * k;
    int* mi = ti + q * k;
    for (int g = 1; g < C::RG; ++g)
      warp_topk::warp_merge_list(mv, mi, k, tv + (g * MQ + q) * k, ti + (g * MQ + q) * k, lane);
    if (q0 + q < m)
      for (int j = lane; j < k; j += 32) {
        const size_t o = ((size_t)(q0 + q) * nsplit + split) * k + j;
        part_v[o] = mv[j];
        part_i[o] = mi[j];
      }
  }
}

// Queries a block holds (MQ) for m queries: the least power of two up to 64
// that holds them, and 64 beyond (blockIdx.x then walks query tiles).
int row_mq(int m) {
  int mq = 1;
  while (mq < m && mq < 64) mq *= 2;
  return mq;
}

template <int MQ>
cudaError_t rows_prepare(int k, int stages, int* smem) {
  using C = RowCfg<MQ>;
  if (stages < 2 || stages > ROW_MAX_STAGES) return cudaErrorInvalidValue;
  const RowLayout L = row_layout(MQ, C::NB, C::RG, k, stages);
  if (L.total > ROW_SMEM_MAX) return cudaErrorInvalidValue;
  *smem = L.total;
  return cudaFuncSetAttribute(fused_knn_rows_kernel<MQ>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
}

template <int MQ>
cudaError_t rows_config(int k, int stages, int* nb, int* slots, int* smem) {
  cudaError_t e = rows_prepare<MQ>(k, stages, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_knn_rows_kernel<MQ>,
                                                    ROW_THREADS, *smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *nb = RowCfg<MQ>::NB;
  *slots = per_sm * sms;
  return e;
}

template <int MQ>
cudaError_t rows_launch(const float* q, const float* y, const float* pen, int clamp, int m,
                        int n, int d, int k, int l2, int nsplit, int stages, float* pv, int* pi,
                        cudaStream_t st) {
  using C = RowCfg<MQ>;
  int smem;
  cudaError_t e = rows_prepare<MQ>(k, stages, &smem);
  if (e != cudaSuccess) return e;
  CUtensorMap qm, ym;
  if (!hopper::make_map(&qm, q, m, d, 4, MQ) || !hopper::make_map(&ym, y, n, d, 4, C::NB))
    return cudaErrorInvalidValue;
  const dim3 grid((m + MQ - 1) / MQ, nsplit);
  fused_knn_rows_kernel<MQ><<<grid, ROW_THREADS, smem, st>>>(qm, ym, pen, clamp, m, n, d, k, l2,
                                                             stages, pv, pi);
  return cudaGetLastError();
}

}  // namespace

// The row-split route's plan as the device sees it, for m queries and k:
// queries a block holds (mq), dataset rows per tile (nb), and, for the
// wrapper's choice of ring stages, resident blocks on the current device
// (SMs x blocks per SM) and the block's dynamic shared memory in bytes.
// Returns cudaErrorInvalidValue for a layout over the card's 227 KB.
extern "C" int fused_knn_rows_config(int m, int k, int stages, int* mq, int* nb, int* slots,
                                     int* smem) {
  if (m < 1 || k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  *mq = row_mq(m);
  switch (*mq) {
    case 1: return (int)rows_config<1>(k, stages, nb, slots, smem);
    case 2: return (int)rows_config<2>(k, stages, nb, slots, smem);
    case 4: return (int)rows_config<4>(k, stages, nb, slots, smem);
    case 8: return (int)rows_config<8>(k, stages, nb, slots, smem);
    case 16: return (int)rows_config<16>(k, stages, nb, slots, smem);
    case 32: return (int)rows_config<32>(k, stages, nb, slots, smem);
    default: return (int)rows_config<64>(k, stages, nb, slots, smem);
  }
}

// Scores and top-k of every query on the row-split route. q (m, d) and y
// (n, d) are row-major float32, d a multiple of 4 and both 16-byte aligned;
// nsplit is at most the dataset's tiles; pen is (n,) float32 (row bias plus
// mask penalty, clamped at 3e38 when clamp is set) or null. |y|² (l2) is
// summed in the kernel. With nsplit > 1 the splits' lists go to
// part_v/part_i (m, nsplit, k) and a merge kernel joins them into
// out_v/out_i (m, k); with nsplit == 1 the parts are not used. Returns the
// launch's cudaError_t.
extern "C" int fused_knn_rows_launch(const float* q, const float* y, const float* pen,
                                     int clamp, int m, int n, int d, int k,
                                     int l2, int nsplit, int stages, float* part_v, int* part_i,
                                     float* out_v, int* out_i, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int nb = row_mq(m) == 64 ? RowCfg<64>::NB : RowCfg<1>::NB;
  if (k < 1 || k > MAXK || nsplit < 1 || nsplit > 65535 || nsplit > (n + nb - 1) / nb || m < 1 ||
      n < 1 || d < 1 || d % 4 != 0 || !aligned)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = nsplit == 1 ? out_v : part_v;
  int* pi = nsplit == 1 ? out_i : part_i;
  cudaError_t e;
  switch (row_mq(m)) {
    case 1: e = rows_launch<1>(q, y, pen, clamp, m, n, d, k, l2, nsplit, stages, pv, pi, st); break;
    case 2: e = rows_launch<2>(q, y, pen, clamp, m, n, d, k, l2, nsplit, stages, pv, pi, st); break;
    case 4: e = rows_launch<4>(q, y, pen, clamp, m, n, d, k, l2, nsplit, stages, pv, pi, st); break;
    case 8: e = rows_launch<8>(q, y, pen, clamp, m, n, d, k, l2, nsplit, stages, pv, pi, st); break;
    case 16: e = rows_launch<16>(q, y, pen, clamp, m, n, d, k, l2, nsplit, stages, pv, pi, st); break;
    case 32: e = rows_launch<32>(q, y, pen, clamp, m, n, d, k, l2, nsplit, stages, pv, pi, st); break;
    default: e = rows_launch<64>(q, y, pen, clamp, m, n, d, k, l2, nsplit, stages, pv, pi, st); break;
  }
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  return (int)warp_topk::merge(part_v, part_i, m, nsplit, k, out_v, out_i, st);
}

// One of warp_topk's two merge kernels (wide: the block-a-query one) over
// m queries' nsplit sorted lists (m, nsplit, k), whatever nsplit is: for
// timing each kernel on the other's shapes. Returns the launch's
// cudaError_t.
extern "C" int fused_knn_merge_launch(int wide, const float* part_v, const int* part_i, int m,
                                      int nsplit, int k, float* out_v, int* out_i,
                                      void* stream) {
  if (m < 1 || nsplit < 1 || k < 1 || k > MAXK) return (int)cudaErrorInvalidValue;
  return (int)warp_topk::merge_by(wide != 0, part_v, part_i, m, nsplit, k, out_v, out_i,
                                  static_cast<cudaStream_t>(stream));
}
