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
// entries, all in shared memory.
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

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXK = 256;
constexpr int E = 8;                    // entries a thread ranks per step
constexpr int STEP = THREADS * E;       // entries a block ranks per step
constexpr int CAP = 2 * STEP + MAXK;    // candidate buffer entries
constexpr int BINS = 256;               // 8-bit radix digits
constexpr uint32_t SIGN = 0x80000000u;
constexpr uint32_t CLAMP_BITS = 0x7f5a2bf8u;  // 2.9e38f
constexpr uint32_t INF_BITS = 0x7f800000u;
constexpr unsigned FULL = 0xffffffffu;
static_assert(THREADS == BINS, "reduce's scan gives each thread one digit");

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

// Order-preserving key of float32 bits b: larger = better.
__device__ __forceinline__ uint32_t rank_key(uint32_t b, uint32_t flip) {
  b ^= flip;                                   // select_min: negate
  const uint32_t mag = b & ~SIGN;
  if (mag > CLAMP_BITS && mag <= INF_BITS) b = (b & SIGN) | CLAMP_BITS;  // NaN kept
  if (b == SIGN) b = 0u;                       // -0 ranks with +0
  return (b & SIGN) ? ~b : (b | SIGN);
}

struct Smem {
  uint32_t key[CAP];
  uint32_t col[CAP];
  int hist[WARPS][BINS];
  uint32_t tkey[MAXK], tcol[MAXK];
  int wsum[WARPS];
  unsigned long long wmin[WARPS];
  int count, sel, digit, kk, bin;
};

// Append this thread's passing entries (bit e of mask) to the buffer, one
// shared atomic per warp. Returns, on the lane that made the atomic, whether
// the buffer then holds more than lim entries; the last atomic of a step sees
// every append before it, so a block-wide OR of the results is exact.
template <int N, typename Col>
__device__ __forceinline__ bool append(Smem& S, uint32_t mask, const uint32_t* key,
                                       Col col, int lim) {
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
  if (lane == 31) base = atomicAdd(&S.count, total);
  base = __shfl_sync(FULL, base, 31);
  int p = base + incl - np;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if ((mask >> e) & 1u) {
      S.key[p] = key[e];
      S.col[p] = col(e);
      ++p;
    }
  }
  return lane == 31 && base + total > lim;
}

// Reduce the buffer to its best k entries (all threads, after a barrier) and
// set the threshold (tk, tc) to the k-th best. A buffer of fewer than k
// entries is left as it is.
__device__ void reduce(Smem& S, int k, uint32_t& tk, uint32_t& tc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();
  const int C = S.count;
  if (C < k) return;
  if (C > k) {
    // radix select of the k-th largest composite (key << 32 | ~col); the
    // kept entries are those whose masked composite is >= the prefix
    uint32_t phi = 0u, plo = 0u, mhi = 0u, mlo = 0u;
    int kk = k;
    for (int pass = 0; pass < 8; ++pass) {
      const bool hiw = pass < 4;
      const int sh = 24 - 8 * (pass & 3);
      for (int i = tid; i < WARPS * BINS; i += THREADS) (&S.hist[0][0])[i] = 0;
      __syncthreads();
      for (int i = tid; i < C; i += THREADS) {
        const uint32_t h = S.key[i], l = ~S.col[i];
        if ((h & mhi) == phi && (l & mlo) == plo)
          atomicAdd(&S.hist[warp][((hiw ? h : l) >> sh) & (BINS - 1)], 1);
      }
      __syncthreads();
      // thread t owns digit 255 - t: a scan from the best digit down
      int c = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) c += S.hist[w][BINS - 1 - tid];
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      if (lane == 31) S.wsum[warp] = incl;
      __syncthreads();
      for (int w = 0; w < warp; ++w) incl += S.wsum[w];
      if (incl >= kk && incl - c < kk) {
        S.digit = BINS - 1 - tid;
        S.kk = kk - (incl - c);
        S.bin = c;
      }
      __syncthreads();
      const uint32_t d = (uint32_t)S.digit;
      const int bin = S.bin;
      kk = S.kk;
      if (hiw) {
        phi |= d << sh;
        mhi |= 0xffu << sh;
      } else {
        plo |= d << sh;
        mlo |= 0xffu << sh;
      }
      if (bin == kk) break;  // the digit's whole bin is kept (block-uniform)
    }
    if (tid == 0) S.sel = 0;
    __syncthreads();
    for (int i = tid; i < C; i += THREADS) {
      const uint32_t h = S.key[i] & mhi, l = ~S.col[i] & mlo;
      if (h > phi || (h == phi && l >= plo)) {
        const int p = atomicAdd(&S.sel, 1);
        S.tkey[p] = S.key[i];
        S.tcol[p] = S.col[i];
      }
    }
    __syncthreads();
    for (int i = tid; i < k; i += THREADS) {
      S.key[i] = S.tkey[i];
      S.col[i] = S.tcol[i];
    }
    if (tid == 0) S.count = k;
    __syncthreads();
  }
  // the new threshold: the smallest composite of the k kept
  unsigned long long v = ~0ull;
  for (int i = tid; i < k; i += THREADS)
    v = min(v, ((unsigned long long)S.key[i] << 32) | (unsigned long long)(~S.col[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
  if (lane == 0) S.wmin[warp] = v;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) v = min(v, S.wmin[w]);
  tk = (uint32_t)(v >> 32);
  tc = ~(uint32_t)v;
  __syncthreads();
}

__device__ __forceinline__ bool better(uint32_t k1, uint32_t c1, uint32_t k2, uint32_t c2) {
  return k1 > k2 || (k1 == k2 && c1 < c2);
}

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
__device__ __forceinline__ void rank_step(Smem& S, const uint4* buf, int s, int nvec, int head,
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
      CAP - STEP);
  if (__syncthreads_or(over)) reduce(S, k, tk, tc);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4)
topk_kernel(const T* __restrict__ x, int n, int k, uint32_t flip,
            const void* __restrict__ payload, int pkind, T* __restrict__ out_v,
            int* __restrict__ out_i) {
  using L = Load<T>;
  constexpr int PV = L::PER_VEC, VECS = L::VECS, VPS = THREADS * VECS;
  __shared__ Smem S;
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
    append<1>(S, mask, key, [=](int) { return (uint32_t)c; }, CAP);
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

  // bitonic sort of the k kept, padded to a power of two with the worst
  int P = 1;
  while (P < k) P <<= 1;
  for (int i = k + tid; i < P; i += THREADS) {
    S.key[i] = 0u;
    S.col[i] = 0xffffffffu;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const bool i_better = better(S.key[i], S.col[i], S.key[j], S.col[j]);
          if (((i & size) == 0) != i_better) {
            const uint32_t tkey = S.key[i], tcol = S.col[i];
            S.key[i] = S.key[j];
            S.col[i] = S.col[j];
            S.key[j] = tkey;
            S.col[j] = tcol;
          }
        }
      }
      __syncthreads();
    }
  }
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
