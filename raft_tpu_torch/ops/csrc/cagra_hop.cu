// CAGRA beam hop, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of raft_tpu/ops/cagra_hop.py (_make_hop_kernel,
// called from cagra_hop). One launch updates the beam of every query row of
// a search batch by one hop:
//   1. score each of the row's cw candidates by the direct ||v - q||^2 in
//      float32 (int8 rows are upcast first; 8-bit values are exact), and
//      score +inf where the id is negative or valid == 0;
//   2. merge the candidates into the 128-lane beam (lanes >= itopk are
//      padding), either
//      extract: drop candidates whose id is among beam lanes < itopk, then
//        itopk passes of minimum extraction over [beam | candidates | pad],
//        ties to the lowest id, every copy of the chosen id masked; or
//      arena: while the best remaining candidate beats the arena's worst
//        entry (lanes < itopk), put it over that entry (the highest lane
//        among equal worst), lowest id among equal best, a candidate whose
//        id is already in the arena consumed without insertion;
//   3. take `width` picks: the best unvisited lane < itopk, lowest id on
//      ties, marked visited; pick clipped to [0, 2^30], no_cand when none.
//
// Profiles (the template parameter PROF; the JAX kernel's carve-outs for an
// in-kernel profile, each one compiled apart so that FULL's code carries
// none of them): NOSCORE scores a valid candidate as (float)|id| and reads
// no row; NODEDUP skips the beam-membership masks of the extract merge;
// NOMERGE passes the beam through and takes the picks from it; NOGATE runs
// every step of the arena's insertion loop, where FULL stops a row's loop
// once its best candidate no longer beats the arena's worst (the answers
// are FULL's). An arena merge runs as one only under FULL and NOGATE; the
// launcher sends NOSCORE and NODEDUP to the extract merge.
//
// Summation order, kept bit for bit by ops/cagra_hop.py's cagra_hop_plain:
// lane l of the row's warp owns dims c*128 + 4l .. c*128 + 4l + 3 for
// c = 0, 1, ...; it sums (v - q)^2 over its dims in increasing order, with
// __fsub_rn / __fmul_rn / __fadd_rn so that nvcc contracts nothing into an
// FMA; the 32 lane sums are then added as a halving tree (lane i + lane
// i+16, then i + i+8, ... i + i+1), the value lane 0 holds after an xor
// butterfly.
//
// Design. The TPU kernel takes the candidate rows pre-gathered, (m, cw, d),
// because its gather belongs to XLA; on the card that array is 164 MB
// written and read back every hop at 10,000 queries, cw = 32, d = 128. Here
// the kernel takes the dataset and reads each candidate's row by id:
//   - one warp per query row, 4 warps a block; the query row sits in shared
//     memory (zero-padded to a multiple of 128), the row's candidate ids
//     and scores in 128-entry shared arrays;
//   - the warp reads a candidate row with 16-byte loads (4-byte for int8), a
//     coalesced 512 B for d = 128 float32, 8 rows in flight at a time;
//   - the beam lives in registers, 4 lanes a thread (lane p is held by
//     thread p % 32 as slot p / 32); minima, maxima and the lowest-id ties
//     are warp shuffles, membership tests are warp votes.
// Limit: the query rows take 4 * round_up(d, 128) * 4 bytes of dynamic
// shared memory beside 4 KB of static arrays; a block may hold 232,448
// bytes, so d <= 14,208 (MAX_D in ops/cagra_hop.py).
//
// Bound. One hop must read each distinct candidate row once (at the main
// path's shape ~200k of the m * cw = 320k pairs' rows, ~103 MB: queries of
// one cluster share neighbour lists), the query rows, the beam state in and
// out (3 x m x 128 x 4 bytes each way), nbrs, valid and the picks: ~0.14 GB,
// ~0.04 ms at 3.35 TB/s; its 3 * m * cw * d flops take ~0.002 ms at
// 67 TFLOP/s. So bytes bound it, and the rows are random 512 B reads, so
// latency more than bandwidth: the design keeps 8 rows in flight a warp and
// many warps a multiprocessor. A persistent multi-hop kernel (beam kept on
// chip across hops, no host round trip between them) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                 // query rows per block, one warp each
constexpr int POOL = 128;                // beam lanes
constexpr int SLOTS = POOL / 32;         // beam lanes per thread
constexpr int G = 8;                     // candidate rows in flight per warp
constexpr int BIG = 1 << 30;
constexpr float NEG = -3.0e38f;
constexpr int MAX_SMEM = 232448;         // shared memory a block can use
constexpr unsigned FULL = 0xffffffffu;
// profiles, the codes of ops/cagra_hop.py's PROFILES
constexpr int PROF_FULL = 0, PROF_NOSCORE = 1, PROF_NODEDUP = 2, PROF_NOMERGE = 3,
              PROF_NOGATE = 4;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool lex_lt(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// (distance, id) minimum over the warp, ties to the lowest id; every lane
// ends with the same pair
__device__ __forceinline__ void warp_lexmin(float& d, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(FULL, d, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (lex_lt(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_min_f(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(FULL, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ float warp_max_f(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(FULL, v, off);
    v = o > v ? o : v;
  }
  return v;
}

// the 4 values of dims base .. base+3 of a row (0 past d)
template <bool VEC>
__device__ __forceinline__ void load4(const float* row, int base, int d, float v[4]) {
  if (VEC) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row + base));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = base + t < d ? __ldg(row + base + t) : 0.f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load4(const int8_t* row, int base, int d, float v[4]) {
  if (VEC) {
    const char4 t = __ldg(reinterpret_cast<const char4*>(row + base));
    v[0] = (float)(signed char)t.x; v[1] = (float)(signed char)t.y;
    v[2] = (float)(signed char)t.z; v[3] = (float)(signed char)t.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      v[t] = base + t < d ? (float)__ldg(reinterpret_cast<const signed char*>(row) + base + t)
                          : 0.f;
  }
}

__device__ __forceinline__ float sq_add(float acc, float v, float q) {
  const float df = __fsub_rn(v, q);
  return __fadd_rn(acc, __fmul_rn(df, df));
}

template <typename T, bool VEC, int PROF>
__global__ void __launch_bounds__(WARPS * 32)
cagra_hop_kernel(const float* __restrict__ queries, const T* __restrict__ data,
                 const float* __restrict__ beam_d, const int* __restrict__ beam_i,
                 const int* __restrict__ beam_v, const int* __restrict__ nbrs,
                 const int* __restrict__ valid, int m, int n, int d, int dp, int cw,
                 int itopk, int width, int arena, float* __restrict__ out_d,
                 int* __restrict__ out_i, int* __restrict__ out_v, int* __restrict__ pick,
                 int* __restrict__ no_cand) {
  extern __shared__ __align__(16) float s_query[];   // [WARPS][dp]
  __shared__ float s_cd[WARPS][POOL];    // candidate scores (0 = to score)
  __shared__ int s_id[WARPS][POOL];      // candidate ids
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= m) return;                  // whole warps leave together
  const float INF = inf_f();

  float* sq = s_query + (size_t)warp * dp;
  const float* qr = queries + (size_t)row * d;
  if constexpr (PROF != PROF_NOSCORE) {
    for (int j = lane; j < dp; j += 32) sq[j] = j < d ? qr[j] : 0.f;
  }
  float* cd = s_cd[warp];
  int* cid = s_id[warp];
  for (int j = lane; j < cw; j += 32) {
    const int id = nbrs[(size_t)row * cw + j];
    const bool ok = id >= 0 && id < n && valid[(size_t)row * cw + j] > 0;
    cid[j] = id;
    if constexpr (PROF == PROF_NOSCORE) {
      cd[j] = ok ? __int2float_rn(id) : INF;
    } else {
      cd[j] = ok ? 0.f : INF;
    }
  }
  __syncwarp();

  // ---- 1. scores, G candidate rows at a time
  for (int j0 = 0; PROF != PROF_NOSCORE && j0 < cw; j0 += G) {
    const T* rp[G];
    bool ok[G];
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = j0 + g;
      ok[g] = j < cw && cd[j] == 0.f;
      rp[g] = data + (ok[g] ? (size_t)cid[j] * d : 0);
      acc[g] = 0.f;
    }
    for (int base = 4 * lane; base < dp; base += 128) {
      if (base < d) {
        const float4 q4 = *reinterpret_cast<const float4*>(sq + base);
        float v[G][4];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (ok[g]) {
            load4<VEC>(rp[g], base, d, v[g]);
          } else {
            v[g][0] = v[g][1] = v[g][2] = v[g][3] = 0.f;
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g] = sq_add(acc[g], v[g][0], q4.x);
          acc[g] = sq_add(acc[g], v[g][1], q4.y);
          acc[g] = sq_add(acc[g], v[g][2], q4.z);
          acc[g] = sq_add(acc[g], v[g][3], q4.w);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = acc[g];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(FULL, s, off));
      if (lane == 0 && ok[g]) cd[j0 + g] = s;
    }
  }
  __syncwarp();

  // ---- 2. merge
  float pd[SLOTS];
  int pi[SLOTS], pv[SLOTS];
  const size_t rb = (size_t)row * POOL;
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int p = s * 32 + lane;
    pd[s] = beam_d[rb + p];
    pi[s] = beam_i[rb + p];
    pv[s] = beam_v[rb + p];
  }

  if constexpr (PROF == PROF_NOMERGE) {
    // the beam passes through as it came
  } else if (!arena) {
    // candidates already in the beam carry the beam's own score: drop them
    for (int j = 0; PROF != PROF_NODEDUP && j < cw; ++j) {
      const int id = cid[j];
      bool hit = false;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) hit |= (s * 32 + lane < itopk) && pi[s] == id;
      if (__any_sync(FULL, hit) && lane == 0) cd[j] = INF;
    }
    __syncwarp();
    // the pool: [beam lanes < itopk | candidates | +inf pad]
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int p = s * 32 + lane;
      if (p >= itopk) {
        if (p < itopk + cw) {
          pd[s] = cd[p - itopk];
          pi[s] = cid[p - itopk];
          pv[s] = 0;
        } else {
          pd[s] = INF;
          pi[s] = -1;
          pv[s] = 1;
        }
      }
    }
    float od[SLOTS];
    int oi[SLOTS], ov[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      od[s] = INF;
      oi[s] = -1;
      ov[s] = 1;
    }
    for (int t = 0; t < itopk; ++t) {
      float mn = pd[0];
      int am = pi[0];
#pragma unroll
      for (int s = 1; s < SLOTS; ++s) {
        if (lex_lt(pd[s], pi[s], mn, am)) {
          mn = pd[s];
          am = pi[s];
        }
      }
      warp_lexmin(mn, am);
      int wv = BIG;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (pi[s] == am && pd[s] <= mn) wv = min(wv, pv[s]);
      wv = warp_min_i(wv);
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if (s * 32 + lane == t) {
          od[s] = mn;
          oi[s] = mn < INF ? am : -1;
          ov[s] = min(wv, 1);
        }
        if (pi[s] == am) pd[s] = INF;     // every copy of the chosen id
      }
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      pd[s] = od[s];
      pi[s] = oi[s];
      pv[s] = ov[s];
    }
  } else {
    float kd[SLOTS];
    int kn[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int j = s * 32 + lane;
      kd[s] = j < cw ? cd[j] : INF;
      kn[s] = j < cw ? cid[j] : -1;
    }
    for (int t = 0; t < cw; ++t) {
      float worst = NEG, best = INF;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        const float a = s * 32 + lane < itopk ? pd[s] : NEG;
        worst = a > worst ? a : worst;
        best = kd[s] < best ? kd[s] : best;
      }
      worst = warp_max_f(worst);
      best = warp_min_f(best);
      if constexpr (PROF != PROF_NOGATE) {
        if (!(best < worst)) break;      // the gate closes for the row
      }
      // under NOGATE a step whose best does not beat the worst writes nothing
      const bool improve = PROF != PROF_NOGATE || best < worst;
      int bid = BIG;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (kd[s] <= best) bid = min(bid, kn[s]);
      bid = warp_min_i(bid);
      bool dup = false;
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) dup |= (s * 32 + lane < itopk) && pi[s] == bid;
      if (!__any_sync(FULL, dup) && improve) {
        int wl = -1;
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          const int p = s * 32 + lane;
          const float a = p < itopk ? pd[s] : NEG;
          if (a >= worst) wl = max(wl, p);
        }
        wl = warp_max_i(wl);
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          if (s * 32 + lane == wl) {
            pd[s] = best;
            pi[s] = bid;
            pv[s] = 0;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (improve && kn[s] == bid) kd[s] = INF;  // consume every copy of the id
    }
  }

  // ---- 3. the next picks
  for (int w = 0; w < width; ++w) {
    float mn = INF;
    int pid = 0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const float c = (pv[s] > 0 || s * 32 + lane >= itopk) ? INF : pd[s];
      if (s == 0 || lex_lt(c, pi[s], mn, pid)) {
        mn = c;
        pid = pi[s];
      }
    }
    warp_lexmin(mn, pid);
    const bool nc = mn >= INF;
    if (!nc) {
#pragma unroll
      for (int s = 0; s < SLOTS; ++s)
        if (pi[s] == pid) pv[s] = 1;
    }
    if (lane == 0) {
      pick[(size_t)row * width + w] = min(max(pid, 0), BIG);
      no_cand[(size_t)row * width + w] = nc ? 1 : 0;
    }
  }
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int p = s * 32 + lane;
    out_d[rb + p] = pd[s];
    out_i[rb + p] = pi[s];
    out_v[rb + p] = pv[s];
  }
}

// one launch's arguments, as cagra_hop_launch takes them
struct Args {
  const void *queries, *data;
  int m, n, d;
  const void *bd, *bi, *bv, *nbrs, *valid;
  int cw, itopk, width, arena;
  void *od, *oi, *ov, *pick, *no_cand;
  cudaStream_t st;
};

template <typename T, bool VEC, int PROF>
int launch(const Args& a) {
  const int dp = (a.d + 127) / 128 * 128;
  const size_t smem = (size_t)WARPS * dp * sizeof(float);
  const size_t static_smem = (size_t)WARPS * POOL * (sizeof(float) + sizeof(int));
  if (smem + static_smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = cagra_hop_kernel<T, VEC, PROF>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a.m + WARPS - 1) / WARPS;
  kern<<<blocks, WARPS * 32, smem, a.st>>>(
      static_cast<const float*>(a.queries), static_cast<const T*>(a.data),
      static_cast<const float*>(a.bd), static_cast<const int*>(a.bi),
      static_cast<const int*>(a.bv), static_cast<const int*>(a.nbrs),
      static_cast<const int*>(a.valid), a.m, a.n, a.d, dp, a.cw, a.itopk, a.width, a.arena,
      static_cast<float*>(a.od), static_cast<int*>(a.oi), static_cast<int*>(a.ov),
      static_cast<int*>(a.pick), static_cast<int*>(a.no_cand));
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_profile(const Args& a, int profile) {
  switch (profile) {
    case PROF_FULL: return launch<T, VEC, PROF_FULL>(a);
    case PROF_NOSCORE: return launch<T, VEC, PROF_NOSCORE>(a);
    case PROF_NODEDUP: return launch<T, VEC, PROF_NODEDUP>(a);
    case PROF_NOMERGE: return launch<T, VEC, PROF_NOMERGE>(a);
    case PROF_NOGATE: return launch<T, VEC, PROF_NOGATE>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One hop for every query row. queries (m, d) float32; data (n, d) float32
// (data_dtype 0) or int8 (1); beam_d / beam_i / beam_v (m, 128) float32 /
// int32 / int32; nbrs and valid (m, cw) int32; outputs: the new beam
// (m, 128) x 3, pick and no_cand (m, width) int32. merge 0 is extract, 1 is
// arena; profile 0 .. 4 is FULL, NOSCORE, NODEDUP, NOMERGE, NOGATE. Needs
// 1 <= itopk, 1 <= cw, itopk + cw <= 128, width >= 1. Returns the launch's
// cudaError_t.
extern "C" int cagra_hop_launch(int data_dtype, const void* queries, const void* data, int m,
                                int n, int d, const void* beam_d, const void* beam_i,
                                const void* beam_v, const void* nbrs, const void* valid, int cw,
                                int itopk, int width, int merge, int profile, void* out_d,
                                void* out_i, void* out_v, void* pick, void* no_cand,
                                void* stream) {
  if (m < 1 || n < 1 || d < 1 || cw < 1 || itopk < 1 || itopk + cw > POOL || width < 1 ||
      (merge != 0 && merge != 1) || profile < PROF_FULL || profile > PROF_NOGATE)
    return (int)cudaErrorInvalidValue;
  const int arena = merge == 1 && (profile == PROF_FULL || profile == PROF_NOGATE);
  const Args a{queries, data, m, n, d, beam_d, beam_i, beam_v, nbrs, valid, cw, itopk, width,
               arena, out_d, out_i, out_v, pick, no_cand, static_cast<cudaStream_t>(stream)};
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
  if (data_dtype == 0) {
    const bool vec = d % 4 == 0 && addr % 16 == 0;
    return vec ? launch_profile<float, true>(a, profile) : launch_profile<float, false>(a, profile);
  }
  if (data_dtype == 1) {
    const bool vec = d % 4 == 0 && addr % 4 == 0;
    return vec ? launch_profile<int8_t, true>(a, profile)
               : launch_profile<int8_t, false>(a, profile);
  }
  return (int)cudaErrorInvalidValue;
}
