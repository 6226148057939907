// Fused distance + top-k for exact brute-force kNN on Hopper's tensor cores
// (sm_90a): modes "bf16", "f32x3" and "s8" of ops/fused_knn.py, and mode
// "f32"'s batch route (m > M_SMALL queries) as 3xTF32 products ("tf32x3").
// Mode f32 at m <= M_SMALL runs the row-split kernel of fused_knn.cu.
//
// Replaces the Pallas kernel of raft_tpu/ops/fused_knn.py:150 (_make_kernel,
// called from _fused_knn_impl) in those modes. Per query it returns the k
// best scores s = 2·dot − yn ("l2") or dot − yn ("ip"), best first, ties to
// the lowest dataset row, from the sentinels (-3e38, 2^30), where
//   bf16   dot = Σ q·y over bf16 operands, float32 sums;
//   f32x3  dot = (hi_q·hi_y + hi_q·lo_y) + lo_q·hi_y, each a float32 sum over
//          the round-to-nearest bf16 split of the float32 operands, which the
//          wrapper makes as two bf16 planes per operand (JAX's _scores);
//   s8     dot = Σ q·y over int8 operands, exact int32 sums, then float32;
//   tf32x3 dot = (hh_even + hh_odd) + (hi_q·lo_y + lo_q·hi_y), float32 sums
//          of tf32 products (hi·hi over even and odd k-steps in two chains,
//          the two small terms in a third) over the round-to-nearest-even
//          tf32 split of the
//          float32 operands (tf32_split: hi = tf32(x), lo = tf32(x − hi),
//          float32 planes whose low 13 bits are zero). hi + lo holds x to
//          about 2^-22 of |x|, so the dot is float32-accurate up to the sums'
//          rounding: the TPU kernel's Precision.HIGHEST is a multi-pass split
//          of the same kind. One TF32 product alone keeps 11 bits and is not
//          mode f32.
// yn carries |y|² (l2), the row bias and the mask penalty, padded by the
// wrapper to whole dataset tiles with +inf (those rows score −inf and never
// enter a list).
//
// Bound, at the main path's shape (10,000 queries x 1M rows x d=128, k=10):
// 2·m·n·d = 2.56e12 operations a product, so bf16 2.59 ms (989 TFLOP/s),
// f32x3 7.77 ms (three bf16 products) and s8 1.29 ms (1,979 TOP/s), all
// bound by operations (the dataset is 256 / 512 / 128 MB of device memory,
// 0.04–0.15 ms). tf32x3 is three TF32 products, 3 x 2.56e12 / 495e12 =
// 15.5 ms. The next limit is L2: every query tile streams the whole
// dataset from L2 once. At QT = 256 (bf16, s8) that is 40 tiles x 256 MB =
// 10 GB of L2 reads in bf16 and 5 GB in s8; at QT = 128 (f32x3) 79 tiles x
// 512 MB (hi + lo) = 40 GB, the same order as its operations bound, and
// tf32x3's float32 planes double it (79 GB).
//
// Design (one block: two consumer warpgroups and one producer warpgroup):
//   * operands by TMA into 128-byte-swizzled, K-major shared memory, in
//     chunks of 128 bytes of each row (64 bf16 or 128 int8 features); the
//     producer thread keeps a ring of `stages` dataset chunks in flight,
//     each stage with a full and an empty mbarrier, and beside it a ring of
//     as many tiles' yn (bulk copies). The query tile is loaded once per block
//     when it fits beside the lists (`resident`); at large d or k it rides
//     in every stage with the dataset chunk instead.
//   * products by wgmma with both operands from shared memory and the
//     accumulators in registers: m64n128k16 bf16 (two m64 tiles per
//     warpgroup, QT = 256), m64n128k32 s8 (same tiling), and for f32x3 three
//     m64n64k16 chains (hi·hi, hi·lo, lo·hi) into separate accumulators
//     (one m64 tile per warpgroup, QT = 128, NB = 64: 96 registers of sums,
//     where NB = 128 would need 192); tf32x3 the same tiling with three
//     m64n64k8 tf32 chains (a 128-byte chunk is 32 float32 features, and a
//     k-step reads 32 bytes of a row as bf16's does): hi·hi on even k-steps,
//     hi·hi on odd ones, and hi·lo + lo·hi, so no sum runs over more than
//     d/16 truncating steps. A stage is released as soon as the
//     wgmma group that reads it has retired (wgmma.wait_group 1), so the
//     next chunk's copy overlaps the current products. d is never padded to
//     the MMA depth in memory: the TMA zero-fills the box past d, and the
//     last chunk's k-steps over those zeros change no sum.
//   * the gate runs in registers. A thread holds two rows of each m64 tile
//     (the wgmma accumulator layout) and keeps each row's running k-th entry
//     (tau). Each 8-column group of a tile scores its 4 values and compares
//     them with their rows' tau; only groups where some lane's score reaches
//     its tau go on, one code copy for all of them, to the exact test
//     (`beats`, ties to the lower row) against the row's current k-th entry
//     and the warp insertion (warp_topk.cuh) into its list in shared memory;
//     the thread's taus are refreshed after each such group. On a split's
//     first tile, where tau is still the sentinel, each row's tau is held at
//     or above a threshold that k of the tile's scores reach (a bisection),
//     also after every refresh while the row's list is not yet full, so its
//     first tile inserts about k entries, not 128. While one warpgroup gates
//     its tile, the other's wgmma run.
// Splits and merge: blockIdx.y walks a contiguous split of the dataset, and
// merge_kernel (warp_topk.cuh) joins the splits' lists per query. The
// wrapper takes few, long splits (ops/fused_knn.py _nsplit's warm-up term): each split pays k·(1 + ln(rows / k)) insertions
// per query, which here cost more than a tile's products.
//
// Rounding. wgmma sums float32 with truncation, not round-to-nearest, so
// bf16 and f32x3 scores differ from a float32 FFMA sum by up to about
// (d/16 + 3)·2^-23·Σ|q·y| per dot (ops/fused_knn.py tc_rounding_bound):
// within 1e-5 relative for d <= 256 on the checks' data, 1.2e-5 at d = 1024
// (PERF.md). tf32x3 takes a k-step per 8 features, but each hi·hi chain
// only every other one, and its split drops lo·lo and rounds lo: about
// (d/16 + 10)·2^-23·Σ|q·y|. s8 sums are exact.

#include <cuda.h>          // CUtensorMap and its enums (types only: no -lcuda)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "hopper.cuh"
#include "warp_topk.cuh"

namespace {

using namespace hopper;
using warp_topk::beats;
using warp_topk::BIG;
using warp_topk::FULL;
using warp_topk::MAXK;
using warp_topk::NEG;
using warp_topk::warp_insert;

enum { F32X3 = 1, BF16 = 2, S8 = 3, TF32X3 = 4 };

constexpr int CH = 128;            // bytes of a row in one chunk (TMA box, swizzle span)
constexpr int KSTEP = 32;          // bytes of a row one wgmma k-step reads
constexpr int THREADS = 384;       // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int CONSUMER_WARPS = 8;
constexpr int SMEM_MAX = 232448;   // dynamic shared memory a block may have
constexpr int ALIGN = 1024;        // the 128-byte swizzle repeats every 8 rows
constexpr int MAX_STAGES = 8;
// setmaxnreg moves registers within the block's launch allocation (168 x 384 =
// 64,512): 128 x 24 + 256 x 240 fills it; asking for more never returns
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 65536 / THREADS / 8 * 8 * THREADS,
              "the warpgroups' registers must fit the block's launch allocation");

template <int MODE> struct Tc {
  static constexpr bool X3 = MODE == F32X3 || MODE == TF32X3;  // three chains over hi/lo planes
  static constexpr int MT = X3 ? 1 : 2;                // m64 tiles per consumer warpgroup
  static constexpr int NB = X3 ? 64 : 128;             // dataset rows per tile (wgmma N)
  static constexpr int QT = 2 * 64 * MT;               // queries per block
  static constexpr int PL = X3 ? 2 : 1;                // operand planes (hi, lo)
  static constexpr int NACC = X3 ? 3 : 1;              // accumulator chains
  static constexpr int ELT = MODE == S8 ? 1 : MODE == TF32X3 ? 4 : 2;  // bytes per element
  static constexpr int NREG = NB / 2;                  // accumulator registers per chain
  static constexpr int G = NB / 8;                     // 8-column groups per tile
  static constexpr int A_CHUNK = PL * QT * CH;         // one chunk of the query tile
  static constexpr int B_CHUNK = PL * NB * CH;         // one chunk of a dataset tile
  using Acc = typename std::conditional<MODE == S8, int, float>::type;
  using Tile = Acc[NACC][NREG];                        // one m64 tile's accumulators
};

// Byte offsets of one block's shared memory (after aligning its base to
// ALIGN): [resident query chunks][stages x (dataset chunk, query chunk if
// not resident)][list scores QT x k][list rows QT x k][yn slots x NB floats]
// [barriers: full, empty per stage; the query tile's; full, empty per yn
// slot]. The yn ring holds as many tiles as the chunk ring (at least two),
// so it never holds the producer back.
struct Layout {
  int kc, stage_bytes, yn_slots, stage_off, tv_off, ti_off, yn_off, bar_off, total;
};

template <int MODE>
__host__ __device__ inline Layout layout(int d, int k, int resident, int stages) {
  using C = Tc<MODE>;
  Layout L;
  L.kc = (d * C::ELT + CH - 1) / CH;
  L.stage_bytes = C::B_CHUNK + (resident ? 0 : C::A_CHUNK);
  L.stage_off = resident ? L.kc * C::A_CHUNK : 0;
  L.tv_off = L.stage_off + stages * L.stage_bytes;
  L.ti_off = L.tv_off + C::QT * k * 4;
  L.yn_slots = max(2, stages / L.kc);
  L.yn_off = L.ti_off + C::QT * k * 4;
  L.bar_off = L.yn_off + L.yn_slots * C::NB * 4;
  L.total = L.bar_off + (2 * stages + 1 + 2 * L.yn_slots) * 8 + ALIGN;
  return L;
}

// An accumulator as float32. s8's int32 sums are converted in place once per
// tile, so here they are float bits already.
template <typename Acc>
__device__ __forceinline__ float to_float(Acc v) {
  if constexpr (std::is_same<Acc, int>::value) return __int_as_float(v);
  else return v;
}

template <int MODE>
__device__ __forceinline__ float dot_of(const typename Tc<MODE>::Tile& a, int r) {
  if constexpr (MODE == F32X3) return (a[0][r] + a[1][r]) + a[2][r];
  else if constexpr (MODE == TF32X3) return (a[0][r] + a[1][r]) + a[2][r];
  else return to_float(a[0][r]);
}

// The four scores a thread holds in 8-column group g of an m64 tile:
// s[2i + j] for row +8i, column +j (the wgmma accumulator layout), each
// c·dot − yn rounded once (c·dot is exact for c = 2 (l2) or 1 (ip)).
template <int MODE>
__device__ __forceinline__ void scores(const typename Tc<MODE>::Tile& a, int g, float2 y2,
                                       float cf, float (&s)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    s[e] = fmaf(cf, dot_of<MODE>(a, g * 4 + e), -((e & 1) ? y2.y : y2.x));
}

// scores() of a group g known only at run time: each register is picked by
// a compile-time index, so the accumulators stay in registers.
template <int MODE>
__device__ __forceinline__ void scores_at(const typename Tc<MODE>::Tile& a, int g, float2 y2,
                                          float cf, float (&s)[4]) {
  float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int gg = 0; gg < Tc<MODE>::G; ++gg)
    if (g == gg) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dot[e] = dot_of<MODE>(a, gg * 4 + e);
    }
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = fmaf(cf, dot[e], -((e & 1) ? y2.y : y2.x));
}

// A threshold that at least k of a tile's scores of row +8i reach, as high
// as a bisection over [min, max] of the row's scores finds (each lane of the
// quad holds NB/4 of them); -inf when fewer than k scores reach the sentinel.
// Used on a split's first tile, where every score would otherwise pass the
// sentinel tau and be offered one by one.
template <int MODE>
__device__ __forceinline__ float tile_threshold(const typename Tc<MODE>::Tile& a, int i,
                                                const float* ynt, float cf, int k, int lane) {
  using C = Tc<MODE>;
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int g = 0; g < C::G; ++g) {
    float s[4];
    scores<MODE>(a, g, *reinterpret_cast<const float2*>(ynt + 8 * g + 2 * (lane & 3)), cf, s);
    lo = fminf(lo, fminf(s[2 * i], s[2 * i + 1]));
    hi = fmaxf(hi, fmaxf(s[2 * i], s[2 * i + 1]));
  }
  lo = fmaxf(lo, NEG);
  auto count = [&](float th) {
    int c = 0;
#pragma unroll
    for (int g = 0; g < C::G; ++g) {
      float s[4];
      scores<MODE>(a, g, *reinterpret_cast<const float2*>(ynt + 8 * g + 2 * (lane & 3)), cf, s);
      c += (s[2 * i] >= th) + (s[2 * i + 1] >= th);
    }
    c += __shfl_xor_sync(FULL, c, 1);
    return c + __shfl_xor_sync(FULL, c, 2);
  };
  lo = fminf(lo, __shfl_xor_sync(FULL, lo, 1));
  lo = fminf(lo, __shfl_xor_sync(FULL, lo, 2));
  hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, 1));
  hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, 2));
  if (count(lo) < k) return -INFINITY;
  for (int it = 0; it < 12; ++it) {  // invariant: count(lo) >= k
    const float mid = 0.5f * lo + 0.5f * hi;
    if (count(mid) >= k) lo = mid;
    else hi = mid;
  }
  return lo;
}

// Offer lane candidates (s, id) for one row slot: the 8 rows of this
// register slot are rowbase + lane/4. A lane's candidate that reaches its
// thread's tau (possibly stale, so never too strict) is tested against its
// row's current k-th entry; the winners are inserted by the whole warp, one
// at a time, each re-checked first (an earlier one may have raised its row's
// k-th entry).
__device__ __forceinline__ void offer(float* tv, int* ti, int k, int rowbase, float s, int id,
                                      float tau_v, int tau_i, int lane) {
  bool pass = beats(s, id, tau_v, tau_i);
  if (pass) {
    const int my = (rowbase + (lane >> 2)) * k + k - 1;
    pass = beats(s, id, tv[my], ti[my]);
  }
  unsigned msk = __ballot_sync(FULL, pass);
  while (msk) {
    const int src = __ffs(msk) - 1;
    msk &= msk - 1;
    const float cs = __shfl_sync(FULL, s, src);
    const int cid = __shfl_sync(FULL, id, src);
    const int row = rowbase + (src >> 2);
    float* rv = tv + row * k;
    int* ri = ti + row * k;
    if (!beats(cs, cid, rv[k - 1], ri[k - 1])) continue;  // warp-uniform
    warp_insert(rv, ri, k, cs, cid, lane);
  }
}

// Offer a group's four candidates (rows rowbase + lane/4 + 8i, columns
// col + j) and refresh the thread's two taus from the lists, each at least
// its row's floor (fl, with row BIG): on a split's first tile the tile's
// threshold, which k of its scores reach, so no score below it can enter
// the row's top-k; -inf on later tiles.
__device__ __forceinline__ void offer_group(float* tv, int* ti, int k, int rowbase, int col,
                                            const float (&s)[4], float (&tau_v)[2],
                                            int (&tau_i)[2], const float (&fl)[2], int lane) {
#pragma unroll 1
  for (int e = 0; e < 4; ++e) {
    const int i = e >> 1;
    const float se = e == 0 ? s[0] : e == 1 ? s[1] : e == 2 ? s[2] : s[3];
    offer(tv, ti, k, rowbase + 8 * i, se, col + (e & 1), i ? tau_v[1] : tau_v[0],
          i ? tau_i[1] : tau_i[0], lane);
  }
  const int my = (rowbase + (lane >> 2)) * k + k - 1;
  tau_v[0] = tv[my];
  tau_i[0] = ti[my];
  tau_v[1] = tv[my + 8 * k];
  tau_i[1] = ti[my + 8 * k];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    if (!beats(tau_v[i], tau_i[i], fl[i], BIG)) {
      tau_v[i] = fl[i];
      tau_i[i] = BIG;
    }
}

// The gate of one m64 tile's scores: a pass bit per 8-column group where
// some score reaches its row's tau, then the rare slow path (one copy of its
// code for all groups: per-group copies would crowd the instruction cache)
// over the groups where some lane passed.
template <int MODE>
__device__ __forceinline__ void gate(const typename Tc<MODE>::Tile& a, float (&tau_v)[2],
                                     int (&tau_i)[2], const float (&fl)[2], float* tv, int* ti,
                                     int k, int rowbase, int n0, const float* ynt, float cf,
                                     int lane) {
  using C = Tc<MODE>;
  unsigned pend = 0;
#pragma unroll
  for (int g = 0; g < C::G; ++g) {
    float s[4];
    scores<MODE>(a, g, *reinterpret_cast<const float2*>(ynt + 8 * g + 2 * (lane & 3)), cf, s);
    const bool pass = s[0] >= tau_v[0] || s[1] >= tau_v[0] || s[2] >= tau_v[1] ||
                      s[3] >= tau_v[1];
    pend |= (unsigned)pass << g;
  }
  unsigned todo = __reduce_or_sync(FULL, pend);
  while (todo) {
    const int g = __ffs(todo) - 1;
    todo &= todo - 1;
    const int c8 = 8 * g + 2 * (lane & 3);
    float s[4];
    scores_at<MODE>(a, g, *reinterpret_cast<const float2*>(ynt + c8), cf, s);
    offer_group(tv, ti, k, rowbase, n0 + c8, s, tau_v, tau_i, fl, lane);
  }
}

// Issue the k-steps of one chunk for this warpgroup's m64 tiles: a is the
// chunk of the query tile, b of the dataset tile; first = 0 overwrites the
// accumulators.
template <int MODE>
__device__ __forceinline__ void issue_chunk(typename Tc<MODE>::Tile (&acc)[Tc<MODE>::MT],
                                            const unsigned char* a, const unsigned char* b,
                                            int wg, int first) {
  using C = Tc<MODE>;
#pragma unroll
  for (int s = 0; s < CH / KSTEP; ++s) {
    const int scale = (first && s == 0) ? 0 : 1;
    const uint64_t db = desc_sw128(b + s * KSTEP);
#pragma unroll
    for (int u = 0; u < C::MT; ++u) {
      const unsigned char* at = a + (wg * C::MT + u) * 64 * CH + s * KSTEP;
      const uint64_t da = desc_sw128(at);
      if constexpr (MODE == S8) {
        wgmma_s8_n128(acc[u][0], da, db, scale);
      } else if constexpr (MODE == BF16) {
        wgmma_bf16_n128(acc[u][0], da, db, scale);
      } else {
        const uint64_t dbl = desc_sw128(b + C::NB * CH + s * KSTEP);   // dataset lo plane
        const uint64_t dal = desc_sw128(at + C::QT * CH);              // query lo plane
        if constexpr (MODE == F32X3) {
          wgmma_bf16_n64(acc[u][0], da, db, scale);    // hi·hi
          wgmma_bf16_n64(acc[u][1], da, dbl, scale);   // hi·lo
          wgmma_bf16_n64(acc[u][2], dal, db, scale);   // lo·hi
        } else {
          // hi·hi alternates between two chains by k-step, so each
          // truncating sum takes half the steps over half the terms; the
          // small hi·lo and lo·hi terms share the third
          wgmma_tf32_n64(acc[u][s & 1], da, db, (first && s < 2) ? 0 : 1);
          wgmma_tf32_n64(acc[u][2], da, dbl, scale);
          wgmma_tf32_n64(acc[u][2], dal, db, 1);
        }
      }
    }
  }
}

template <int MODE>
__device__ __forceinline__ void fence_acc(typename Tc<MODE>::Tile (&acc)[Tc<MODE>::MT]) {
#pragma unroll
  for (int u = 0; u < Tc<MODE>::MT; ++u)
#pragma unroll
    for (int p = 0; p < Tc<MODE>::NACC; ++p) fence_regs(acc[u][p]);
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
fused_knn_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap qlmap,
                    const __grid_constant__ CUtensorMap ymap,
                    const __grid_constant__ CUtensorMap ylmap,
                    const float* __restrict__ yn, int m, int n, int d, int k, int l2,
                    int rows_per_split, int resident, int stages,
                    float* __restrict__ part_v, int* __restrict__ part_i) {
  using C = Tc<MODE>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) & ~uintptr_t(ALIGN - 1));
  const Layout L = layout<MODE>(d, k, resident, stages);
  unsigned char* a_res = smem;  // the resident query chunks
  unsigned char* ring = smem + L.stage_off;
  float* tv = reinterpret_cast<float*>(smem + L.tv_off);
  int* ti = reinterpret_cast<int*>(smem + L.ti_off);
  float* yns = reinterpret_cast<float*>(smem + L.yn_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + stages;
  uint64_t* qbar = empty + stages;
  uint64_t* ynfull = qbar + 1;
  uint64_t* ynempty = ynfull + L.yn_slots;
  const int ys = L.yn_slots;

  const int q0 = blockIdx.x * C::QT;
  const int split = blockIdx.y;
  const int n_begin = split * rows_per_split;
  const int n_end = min(n, n_begin + rows_per_split);
  const int tiles = n_end > n_begin ? (n_end - n_begin + C::NB - 1) / C::NB : 0;
  const int kc = L.kc;
  // warp-uniform by construction, so the compiler sees the role branches as
  // uniform (a divergent path around wgmma serialises it)
  const int wg = __shfl_sync(FULL, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init(qbar, 1);
    for (int s = 0; s < L.yn_slots; ++s) {
      mbar_init(&ynfull[s], 1);
      mbar_init(&ynempty[s], CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    regs_release<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&qmap);
      tma_prefetch_map(&ymap);
      constexpr int EL = CH / C::ELT;  // features per chunk
      if (resident) {
        mbar_expect_tx(qbar, kc * C::A_CHUNK);
        for (int c = 0; c < kc; ++c) {
          unsigned char* dst = a_res + c * C::A_CHUNK;
          tma_load_2d(dst, &qmap, qbar, c * EL, q0);
          if constexpr (C::PL == 2) tma_load_2d(dst + C::QT * CH, &qlmap, qbar, c * EL, q0);
        }
      }
      for (int t = 0; t < tiles; ++t) {
        const int n0 = n_begin + t * C::NB;
        mbar_wait(&ynempty[t % ys], ((t / ys) & 1) ^ 1);
        mbar_expect_tx(&ynfull[t % ys], C::NB * 4);
        bulk_load(yns + (t % ys) * C::NB, yn + n0, C::NB * 4, &ynfull[t % ys]);
        for (int c = 0; c < kc; ++c) {
          const int gi = t * kc + c, s = gi % stages;
          mbar_wait(&empty[s], ((gi / stages) & 1) ^ 1);
          unsigned char* st = ring + s * L.stage_bytes;
          mbar_expect_tx(&full[s], L.stage_bytes);
          tma_load_2d(st, &ymap, &full[s], c * EL, n0);
          if constexpr (C::PL == 2) tma_load_2d(st + C::NB * CH, &ylmap, &full[s], c * EL, n0);
          if (!resident) {
            unsigned char* sa = st + C::B_CHUNK;
            tma_load_2d(sa, &qmap, &full[s], c * EL, q0);
            if constexpr (C::PL == 2) tma_load_2d(sa + C::QT * CH, &qlmap, &full[s], c * EL, q0);
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows [wg*MT*64, (wg+1)*MT*64) ----
    regs_acquire<CONSUMER_REGS>();
    const int wt = threadIdx.x & 127;
    const int wiw = wt >> 5, lane = wt & 31;
    // this warp's 16 rows of m64 tile u start at rbase(u); a thread holds
    // rows rbase(u) + lane/4 (+ 8)
    auto rbase = [&](int u) { return (wg * C::MT + u) * 64 + wiw * 16; };
#pragma unroll
    for (int u = 0; u < C::MT; ++u)
      for (int idx = lane; idx < 16 * k; idx += 32) {
        tv[rbase(u) * k + idx] = NEG;
        ti[rbase(u) * k + idx] = BIG;
      }
    __syncwarp();
    float tau_v[C::MT][2];
    int tau_i[C::MT][2];
#pragma unroll
    for (int u = 0; u < C::MT; ++u)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tau_v[u][i] = NEG;
        tau_i[u][i] = BIG;
      }
    if (resident) mbar_wait(qbar, 0);
    const float cf = l2 ? 2.0f : 1.0f;

    typename C::Tile acc[C::MT];
    // a tile's chunks stream through the ring: each chunk's products are
    // one wgmma group, and a stage goes back to the producer as soon as the
    // group that reads it has retired; the gate follows the last group
    for (int t = 0; t < tiles; ++t) {
      for (int c = 0; c < kc; ++c) {
        const int gi = t * kc + c;
        mbar_wait(&full[gi % stages], (gi / stages) & 1);
        const unsigned char* st = ring + (gi % stages) * L.stage_bytes;
        fence_acc<MODE>(acc);
        wgmma_fence();
        issue_chunk<MODE>(acc, resident ? a_res + c * C::A_CHUNK : st + C::B_CHUNK, st, wg,
                          c == 0);
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();  // the previous chunk's group has retired
          if (lane == 0) mbar_arrive(&empty[(gi - 1) % stages]);
        }
      }
      wgmma_wait<0>();
      fence_acc<MODE>(acc);
      if (lane == 0) mbar_arrive(&empty[(t * kc + kc - 1) % stages]);
      mbar_wait(&ynfull[t % ys], (t / ys) & 1);
      const float* ynt = yns + (t % ys) * C::NB;
      // each m64 tile: s8 sums to float, the split's first tile's
      // thresholds, the gate
#pragma unroll
      for (int u = 0; u < C::MT; ++u) {
        if constexpr (MODE == S8) {
#pragma unroll
          for (int r = 0; r < C::NREG; ++r)
            acc[u][0][r] = __float_as_int(__int2float_rn(acc[u][0][r]));
        }
        float fl[2] = {-INFINITY, -INFINITY};
        if (t == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            fl[i] = tile_threshold<MODE>(acc[u], i, ynt, cf, k, lane);
            if (fl[i] > tau_v[u][i]) {
              tau_v[u][i] = fl[i];
              tau_i[u][i] = BIG;
            }
          }
        }
        gate<MODE>(acc[u], tau_v[u], tau_i[u], fl, tv, ti, k, rbase(u), n_begin + t * C::NB,
                   ynt, cf, lane);
      }
      if (lane == 0) mbar_arrive(&ynempty[t % ys]);  // after every read of this warp's yn
    }

    __syncwarp();
    const int nsplit = gridDim.y;
#pragma unroll
    for (int u = 0; u < C::MT; ++u)
      for (int idx = lane; idx < 16 * k; idx += 32) {
        const int r = rbase(u) + idx / k, j = idx % k;
        if (q0 + r < m) {
          const size_t o = ((size_t)(q0 + r) * nsplit + split) * k + j;
          part_v[o] = tv[r * k + j];
          part_i[o] = ti[r * k + j];
        }
      }
  }
}

// ---- f32x3's operand planes ----------------------------------------------

__device__ __forceinline__ float flush(float v) { return fabsf(v) < FLT_MIN ? copysignf(0.f, v) : v; }

// hi = bf16(x) and lo = bf16(x − hi), round to nearest even, with the
// subtraction's operands and result flushed to zeros of their sign: the
// split of JAX's _scores (raft_tpu/ops/fused_knn.py:139-142), which runs in
// the TPU kernel under flushed subnormals. Four elements a thread a step.
__device__ __forceinline__ void split1(float x, __nv_bfloat16& h, __nv_bfloat16& l) {
  h = __float2bfloat16_rn(x);
  l = __float2bfloat16_rn(flush(flush(x) - flush(__bfloat162float(h))));
}

// hi = tf32(x) and lo = tf32(x − hi), each rounded to nearest even onto the
// top 19 bits (as cvt.rn.tf32.f32) and stored as float32 with its low 13
// bits zero, so the tensor core reads both exactly; x − hi is exact, and
// hi + lo rebuilds x to about 2^-22 of |x|. Mode f32's planes for the
// 3xTF32 products (ops/fused_knn.py tf32_split_plain is its plain twin).
__device__ __forceinline__ float tf32_rn(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0xfffu + ((u >> 13) & 1u);  // inf / NaN kept
  return __uint_as_float(u & 0xffffe000u);
}

__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ x, float* __restrict__ hi, float* __restrict__ lo,
                  long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n / 4; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    float4 h, l;
    h.x = tf32_rn(v.x); l.x = tf32_rn(v.x - h.x);
    h.y = tf32_rn(v.y); l.y = tf32_rn(v.y - h.y);
    h.z = tf32_rn(v.z); l.z = tf32_rn(v.z - h.z);
    h.w = tf32_rn(v.w); l.w = tf32_rn(v.w - h.w);
    reinterpret_cast<float4*>(hi)[i] = h;
    reinterpret_cast<float4*>(lo)[i] = l;
  }
  if (blockIdx.x == 0 && threadIdx.x < n % 4) {
    const long long j = n - n % 4 + threadIdx.x;
    hi[j] = tf32_rn(x[j]);
    lo[j] = tf32_rn(x[j] - hi[j]);
  }
}

__global__ void __launch_bounds__(256)
bf16_split_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ hi,
                  __nv_bfloat16* __restrict__ lo, long long n) {
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const float4 v = reinterpret_cast<const float4*>(x)[i];
    __align__(8) __nv_bfloat16 h[4], l[4];
    split1(v.x, h[0], l[0]);
    split1(v.y, h[1], l[1]);
    split1(v.z, h[2], l[2]);
    split1(v.w, h[3], l[3]);
    reinterpret_cast<uint2*>(hi)[i] = *reinterpret_cast<const uint2*>(h);
    reinterpret_cast<uint2*>(lo)[i] = *reinterpret_cast<const uint2*>(l);
  }
  if (blockIdx.x == 0 && threadIdx.x < n - 4 * n4) {
    const long long j = 4 * n4 + threadIdx.x;
    split1(x[j], hi[j], lo[j]);
  }
}

// ---- host side ----------------------------------------------------------------

template <int MODE>
cudaError_t prepare(int d, int k, int resident, int stages, int* smem) {
  if (stages < 2 || stages > MAX_STAGES) return cudaErrorInvalidValue;
  const Layout L = layout<MODE>(d, k, resident, stages);
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;  // the layout does not fit
  *smem = L.total;
  return cudaFuncSetAttribute(fused_knn_tc_kernel<MODE>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
}

template <int MODE>
cudaError_t config(int d, int k, int resident, int stages, int* qt, int* nb, int* slots,
                   int* smem) {
  cudaError_t e = prepare<MODE>(d, k, resident, stages, smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_knn_tc_kernel<MODE>, THREADS,
                                                    *smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *qt = Tc<MODE>::QT;
  *nb = Tc<MODE>::NB;
  *slots = per_sm * sms;
  return e;
}

template <int MODE>
cudaError_t launch(const void* q, const void* ql, const void* y, const void* yl, const float* yn,
                   int m, int n, int d, int k, int l2, int nsplit, int resident, int stages,
                   float* pv, int* pi, cudaStream_t st) {
  using C = Tc<MODE>;
  int smem;
  cudaError_t e = prepare<MODE>(d, k, resident, stages, &smem);
  if (e != cudaSuccess) return e;
  CUtensorMap qm, qlm, ym, ylm;
  if (!make_map(&qm, q, m, d, C::ELT, C::QT) || !make_map(&ym, y, n, d, C::ELT, C::NB))
    return cudaErrorInvalidValue;
  if (C::PL == 2) {
    if (!make_map(&qlm, ql, m, d, C::ELT, C::QT) || !make_map(&ylm, yl, n, d, C::ELT, C::NB))
      return cudaErrorInvalidValue;
  } else {
    qlm = qm;
    ylm = ym;
  }
  const int tiles = (n + C::NB - 1) / C::NB;
  const int rows_per_split = ((tiles + nsplit - 1) / nsplit) * C::NB;
  const dim3 grid((m + C::QT - 1) / C::QT, nsplit);
  fused_knn_tc_kernel<MODE><<<grid, THREADS, smem, st>>>(qm, qlm, ym, ylm, yn, m, n, d, k, l2,
                                                         rows_per_split, resident, stages, pv, pi);
  return cudaGetLastError();
}

}  // namespace

// The tile plan's numbers as the device sees them: queries per block (qt),
// dataset rows per tile (nb), resident blocks on the current device (SMs x
// blocks per SM) and the block's dynamic shared memory in bytes, for mode
// (1 f32x3, 2 bf16, 3 s8, 4 tf32x3) at feature dim d (the operands' padded row
// length), k, and the wrapper's choice of a resident query tile and ring
// stages. Returns cudaErrorInvalidValue for a layout over the card's 227 KB.
extern "C" int fused_knn_tc_config(int mode, int d, int k, int resident, int stages, int* qt,
                                   int* nb, int* slots, int* smem) {
  if (k < 1 || k > MAXK || d < 1) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case F32X3: return (int)config<F32X3>(d, k, resident, stages, qt, nb, slots, smem);
    case BF16: return (int)config<BF16>(d, k, resident, stages, qt, nb, slots, smem);
    case S8: return (int)config<S8>(d, k, resident, stages, qt, nb, slots, smem);
    case TF32X3: return (int)config<TF32X3>(d, k, resident, stages, qt, nb, slots, smem);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Scores and top-k of every query in mode 1 (f32x3: q/ql and y/yl the bf16
// hi and lo planes), 2 (bf16: q, y), 3 (s8: q, y int8) or 4 (tf32x3, mode
// f32's batch route: q/ql and y/yl the float32 tf32 hi and lo planes).
// Operands are row-major (rows, d) with 16-byte rows (d a multiple of 4
// float32, 8 bf16 or 16 int8)
// and 16-byte aligned bases; yn is float32 padded to whole tiles of the
// mode's nb rows. With nsplit > 1 the splits' lists go to part_v/part_i
// (m, nsplit, k) and merge_kernel joins them into out_v/out_i (m, k); with
// nsplit == 1 the parts are not used. Returns the launch's cudaError_t.
extern "C" int fused_knn_tc_launch(int mode, const void* q, const void* ql, const void* y,
                                   const void* yl, const float* yn, int m, int n, int d, int k,
                                   int l2, int nsplit, int resident, int stages, float* part_v,
                                   int* part_i, float* out_v, int* out_i, void* stream) {
  const int elt = mode == S8 ? 1 : mode == TF32X3 ? 4 : 2;
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool planes_ok = (mode != F32X3 && mode != TF32X3) || (a16(ql) && a16(yl));
  if (k < 1 || k > MAXK || nsplit < 1 || nsplit > 65535 || m < 1 || n < 1 || d < 1 ||
      (d * elt) % 16 != 0 || !a16(q) || !a16(y) || !planes_ok)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pv = nsplit == 1 ? out_v : part_v;
  int* pi = nsplit == 1 ? out_i : part_i;
  cudaError_t e;
  switch (mode) {
    case F32X3:
      e = launch<F32X3>(q, ql, y, yl, yn, m, n, d, k, l2, nsplit, resident, stages, pv, pi, st);
      break;
    case BF16:
      e = launch<BF16>(q, ql, y, yl, yn, m, n, d, k, l2, nsplit, resident, stages, pv, pi, st);
      break;
    case S8:
      e = launch<S8>(q, ql, y, yl, yn, m, n, d, k, l2, nsplit, resident, stages, pv, pi, st);
      break;
    case TF32X3:
      e = launch<TF32X3>(q, ql, y, yl, yn, m, n, d, k, l2, nsplit, resident, stages, pv, pi, st);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  return (int)warp_topk::merge(part_v, part_i, m, nsplit, k, out_v, out_i, st);
}

// Mode f32's 3xTF32 operand planes: hi and lo (n float32 each, low 13 bits
// zero) of x (n float32), as tf32_split_kernel computes them; x, hi and lo
// 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int tf32_split_launch(const float* x, float* hi, float* lo, long long n, void* stream) {
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (n < 1 || !a16(x) || !a16(hi) || !a16(lo)) return (int)cudaErrorInvalidValue;
  const long long blocks = (n / 4 + 255) / 256;
  tf32_split_kernel<<<(int)(blocks < 1 ? 1 : blocks > 4096 ? 4096 : blocks), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, hi, lo, n);
  return (int)cudaGetLastError();
}

// f32x3's operand planes: hi and lo (n bf16 each) of x (n float32), as
// bf16_split_kernel computes them; x, hi and lo 16-byte aligned. Returns the
// launch's cudaError_t.
extern "C" int bf16_split_launch(const float* x, void* hi, void* lo, long long n, void* stream) {
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (n < 1 || !a16(x) || !a16(hi) || !a16(lo)) return (int)cudaErrorInvalidValue;
  const long long blocks = (n / 4 + 255) / 256;
  bf16_split_kernel<<<(int)(blocks < 1 ? 1 : blocks > 4096 ? 4096 : blocks), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<__nv_bfloat16*>(hi), static_cast<__nv_bfloat16*>(lo), n);
  return (int)cudaGetLastError();
}
