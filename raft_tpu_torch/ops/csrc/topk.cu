// Row-wise top-k selection in one read of each row, for Hopper (sm_90a).
//
// Replaces the Pallas kernel of raft_tpu/ops/topk.py (_select_kernel, called
// from topk_pallas). For each row of x (m, n) it writes the k best entries,
// best first: the smallest (select_min) or the largest. Entries rank by the
// TPU kernel's preparation of the value: the float32 cast, negated for
// select_min (a sign-bit flip), clamped to ±2.9e38 (so ±inf still rank and tie
// with the clamped extremes), -0 folded into +0. NaN is not clamped: it ranks
// by its bits, +NaN above +inf and -NaN below -inf, as lax.top_k and the plain
// version do. Equal ranks go to the lowest column. One launch writes the whole
// answer: the values, read from x at the chosen columns (exact, infinities and
// NaN bits included), and int32 columns or, when a payload (m, n) of int32 or
// int64 ids is given, the payload's ids at those columns.
//
// Design: a threshold-filtered selection, RAFT's warp_sort_filtered
// (matrix/detail/select_warpsort.cuh) carried to a block. One block of 256
// threads owns one row and streams it from device memory once, 16-byte loads
// (__ldcs: the row is not read again), each thread holding its next two
// steps' 64 bytes in flight while it ranks the current 32. Every entry maps to an
// order-preserving uint32 key (larger = better) and is compared with the
// running k-th best (key, column) of the row; only the entries that beat it
// are appended to a candidate buffer in shared memory (warp-aggregated: one
// shared atomic per warp per step). Before the first k entries are kept,
// everything passes. When the buffer could overflow on the next step (more
// than CAP - STEP entries), and once at the end, the block reduces it to the
// best k: a radix select on the 64-bit composite (key, ~column) in shared
// memory, 8-bit digits counted in per-warp histograms (no __match_any_sync),
// which stops as soon as the digit's bin is taken whole; the composite is
// unique, so ties at the boundary need no extra pass over the row. The kept k
// set the new threshold. At the end a bitonic sort orders the k by (key desc,
// column asc). On random rows the buffer takes the first ~4k entries, then
// only the few that beat the threshold; the slow cases are rows whose entries
// keep improving in column order (a sorted row), which reduce every ~2k
// entries, all in shared memory. The key, the buffer, the reduce and the
// sort live in select_block.cuh, which pq_scan.cu's fused scan-and-select
// shares.
//
// Bound. The function reads x once and writes (m, k) values and ids: at the
// main path's shape (10,000 x 100,003 float32) that is 4.0 GB, ~1.19 ms at
// 3.35 TB/s, so it is bound by bytes. The per-entry work is a 16-byte load
// share, a key (about 9 integer operations) and one compare; 4 blocks share
// an SM (45 KB of static shared memory each), 64 KB of loads in flight per SM.
// Rows that fit in shared memory and rows that do not take the same path.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "select_block.cuh"

namespace {

using namespace select_block;

constexpr int E = 8;                    // entries a thread ranks per step
constexpr int STEP = THREADS * E;       // entries a block ranks per step
constexpr int CAP = 2 * STEP + MAXK;    // candidate buffer entries
using Sel = select_block::Smem<CAP, false>;

// float32 bits of one element
__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return __float_as_uint(__bfloat162float(v));
}
__device__ __forceinline__ uint32_t bits_of(__half v) { return __float_as_uint(__half2float(v)); }

__device__ __forceinline__ uint32_t half_bits(uint32_t h) {
  return __float_as_uint(__half2float(__ushort_as_half((unsigned short)h)));
}

// PER_VEC elements in one 16-byte vector, VECS vectors a thread a step
template <typename T> struct Load;
template <> struct Load<float> {
  static constexpr int PER_VEC = 4, VECS = E / 4;
  __device__ static void unpack(uint4 v, uint32_t* b) {
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
  }
};
template <> struct Load<__nv_bfloat16> {
  static constexpr int PER_VEC = 8, VECS = E / 8;
  __device__ static void unpack(uint4 v, uint32_t* b) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[2 * i] = w[i] << 16;
      b[2 * i + 1] = w[i] & 0xffff0000u;
    }
  }
};
template <> struct Load<__half> {
  static constexpr int PER_VEC = 8, VECS = E / 8;
  __device__ static void unpack(uint4 v, uint32_t* b) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[2 * i] = half_bits(w[i] & 0xffffu);
      b[2 * i + 1] = half_bits(w[i] >> 16);
    }
  }
};

// One step's vectors of this thread (zeros past the row's end).
template <typename T>
__device__ __forceinline__ void load_step(const uint4* vrow, int nvec, int s, uint4* buf) {
  constexpr int VECS = Load<T>::VECS;
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int v = (s * VECS + j) * THREADS + (int)threadIdx.x;
    buf[j] = v < nvec ? __ldcs(vrow + v) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Rank one step's entries, append those that beat the threshold (tk, tc),
// and reduce the buffer when the next step could overflow it.
template <typename T>
__device__ __forceinline__ void rank_step(Sel& S, const uint4* buf, int s, int nvec, int head,
                                          uint32_t flip, int k, uint32_t& tk, uint32_t& tc) {
  using L = Load<T>;
  constexpr int PV = L::PER_VEC, VECS = L::VECS;
  const int v0 = s * VECS * THREADS + (int)threadIdx.x;
  uint32_t key[E];
  uint32_t mask = 0u;
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const int v = v0 + j * THREADS;
    uint32_t b[PV];
    L::unpack(buf[j], b);
#pragma unroll
    for (int i = 0; i < PV; ++i) {
      const int e = j * PV + i;
      key[e] = rank_key(b[i], flip);
      const uint32_t c = (uint32_t)(head + v * PV + i);
      const bool p = v < nvec && (key[e] > tk || (key[e] == tk && c < tc));
      mask |= (uint32_t)p << e;
    }
  }
  const bool over = append<E>(
      S, mask, key,
      [=](int e) { return (uint32_t)(head + (v0 + (e / PV) * THREADS) * PV + e % PV); },
      nullptr, CAP - STEP);
  if (__syncthreads_or(over)) reduce(S, k, tk, tc);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
topk_kernel(const T* __restrict__ x, int n, int k, uint32_t flip,
            const void* __restrict__ payload, int pkind, T* __restrict__ out_v,
            int* __restrict__ out_i) {
  using L = Load<T>;
  constexpr int PV = L::PER_VEC, VECS = L::VECS, VPS = THREADS * VECS;
  __shared__ Sel S;
  const int tid = threadIdx.x;
  const size_t r = blockIdx.x;
  const T* row = x + r * (size_t)n;
  if (tid == 0) S.count = 0;
  __syncthreads();
  // threshold (key, column): an entry passes if it beats it; nothing is
  // kept yet, so every entry passes (every column is below 0x7fffffff)
  uint32_t tk = 0u, tc = 0x7fffffffu;

  // unaligned ends of the row (at most 2 * PV - 2 entries), by warp 0
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  const int head = min(n, (int)(((16u - addr % 16u) % 16u) / sizeof(T)));
  const int nvec = (n - head) / PV;
  const int body_end = head + nvec * PV;
  const int nextra = head + (n - body_end);
  if (tid < 32) {
    uint32_t key[1] = {0u};
    uint32_t mask = 0u;
    const int c = tid < head ? tid : body_end + (tid - head);
    if (tid < nextra) {
      key[0] = rank_key(bits_of(row[c]), flip);
      mask = 1u;
    }
    append<1>(S, mask, key, [=](int) { return (uint32_t)c; }, nullptr, CAP);
  }

  // the body: three steps' loads in flight per thread (a ring of three
  // register buffers), ranked in column order
  const uint4* vrow = reinterpret_cast<const uint4*>(row + head);
  const int nsteps = (nvec + VPS - 1) / VPS;
  uint4 b0[VECS], b1[VECS], b2[VECS];
  load_step<T>(vrow, nvec, 0, b0);
  load_step<T>(vrow, nvec, 1, b1);
  for (int s = 0; s < nsteps; s += 3) {
    load_step<T>(vrow, nvec, s + 2, b2);
    rank_step<T>(S, b0, s, nvec, head, flip, k, tk, tc);
    if (s + 1 >= nsteps) break;
    load_step<T>(vrow, nvec, s + 3, b0);
    rank_step<T>(S, b1, s + 1, nvec, head, flip, k, tk, tc);
    if (s + 2 >= nsteps) break;
    load_step<T>(vrow, nvec, s + 4, b1);
    rank_step<T>(S, b2, s + 2, nvec, head, flip, k, tk, tc);
  }
  __syncthreads();
  if (S.count > k) reduce(S, k, tk, tc);

  sort_kept(S, k);   // best first
  for (int j = tid; j < k; j += THREADS) {
    const size_t c = S.col[j];
    const size_t o = r * (size_t)k + j;
    out_v[o] = row[c];
    if (pkind == 1)
      out_i[o] = static_cast<const int*>(payload)[r * (size_t)n + c];
    else if (pkind == 2)
      out_i[o] = (int)static_cast<const long long*>(payload)[r * (size_t)n + c];
    else
      out_i[o] = (int)c;
  }
}

template <typename T>
int launch(const void* x, int m, int n, int k, int select_min, const void* payload,
           int pkind, void* out_v, int* out_i, cudaStream_t st) {
  topk_kernel<T><<<m, THREADS, 0, st>>>(static_cast<const T*>(x), n, k,
                                        select_min ? SIGN : 0u, payload, pkind,
                                        static_cast<T*>(out_v), out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// The k best entries of every row of x (m, n), row-major, best first.
// dtype: 0 float32, 1 bfloat16, 2 float16. out_v is (m, k) in x's dtype,
// out_i (m, k) int32: the columns, or with pkind 1 (int32) / 2 (int64) the
// payload (m, n)'s ids at those columns. Returns the launch's cudaError_t.
extern "C" int topk_launch(int dtype, const void* x, int m, int n, int k, int select_min,
                           const void* payload, int pkind, void* out_v, int* out_i,
                           void* stream) {
  if (k < 1 || k > MAXK || k > n || m < 1 || n >= 0x7fffffff || pkind < 0 || pkind > 2 ||
      (pkind != 0 && payload == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, m, n, k, select_min, payload, pkind, out_v, out_i, st);
    case 1:
      return launch<__nv_bfloat16>(x, m, n, k, select_min, payload, pkind, out_v, out_i, st);
    case 2: return launch<__half>(x, m, n, k, select_min, payload, pkind, out_v, out_i, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
