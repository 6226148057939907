// Row-wise top-k selection (radix select), for Hopper (sm_90a).
//
// Replaces the Pallas kernel of raft_tpu/ops/topk.py (_select_kernel, called
// from topk_pallas). For each row of x (m, n) it returns the columns of the k
// best entries, best first: the smallest (select_min) or the largest. Values
// are ranked after the TPU kernel's preparation: cast to float32, negated for
// select_min, clamped to ±2.9e38 (so ±inf still rank, and tie with the
// clamped extremes), -0 folded into +0. Equal values go to the lowest column.
// The wrapper (ops/topk.py) gathers the exact values from x.
//
// Design. The TPU kernel streams column blocks through one core and keeps a
// running top-k in VMEM. Here one block owns one row and runs the radix select
// of the CUDA original (matrix/detail/select_radix.cuh):
//   1. each value maps to an order-preserving uint32 key (larger = better);
//   2. a histogram pass over the row's top 11 key bits (shared-memory atomics,
//      aggregated per warp) finds the bin b that holds the k-th best key;
//   3. fast path, when the keys above b and the keys in b number at most
//      SORT_MAX (the usual case: b holds a handful of keys): one more pass
//      collects them all into shared memory;
//      slow path (heavy ties or clustered values): two more histogram passes
//      (11 and 10 bits) fix the k-th best key K and how many keys equal to K
//      the top-k takes (kk); a last pass collects the keys above K and, in
//      column order, the first kk columns whose key is K;
//   4. a bitonic sort in shared memory orders the survivors by (key desc,
//      column asc); the first k are the answer.
// Rows are read four values per thread per load. No thread holds a buffer of
// size k.
//
// Bound. The function reads x once and writes (m, k) int32: at the main path's
// shape (10,000 x 100,003 float32) that is 4.0 GB, ~1.2 ms at 3.35 TB/s, so
// it is bound by bytes. The fast path reads each row twice, the slow path
// four times; rows are read from device memory, since the rows in flight
// (~0.4 MB each) exceed the 50 MB L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAXK = 256;
constexpr int SORT_MAX = 2048;  // survivors the fast path sorts in shared memory
constexpr int HBITS = 11;       // widest digit
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// four consecutive elements, loaded as one vector
template <typename T> struct Vec4 { using V = uint2; };  // 4 x 16-bit
template <> struct Vec4<float> { using V = float4; };

__device__ __forceinline__ void unpack(float4 v, float* e) {
  e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
}
template <typename T>
__device__ __forceinline__ void unpack(uint2 v, float* e);
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint2 v, float* e) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  e[0] = __low2float(a); e[1] = __high2float(a);
  e[2] = __low2float(b); e[3] = __high2float(b);
}
template <>
__device__ __forceinline__ void unpack<__half>(uint2 v, float* e) {
  const __half2 a = *reinterpret_cast<const __half2*>(&v.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&v.y);
  e[0] = __low2float(a); e[1] = __high2float(a);
  e[2] = __low2float(b); e[3] = __high2float(b);
}

__device__ __forceinline__ uint32_t rank_key(float v, bool select_min) {
  float s = select_min ? -v : v;
  s = fminf(fmaxf(s, -2.9e38f), 2.9e38f);
  if (s == 0.f) s = 0.f;  // -0 ranks with +0
  const uint32_t b = __float_as_uint(s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ bool better(uint32_t k1, int c1, uint32_t k2, int c2) {
  return k1 > k2 || (k1 == k2 && c1 < c2);
}

// Call f(column, valid, key) for every entry of the row, in no particular
// order. Every thread of the block makes the same number of calls (valid is
// false past the end), so f may use warp-wide intrinsics.
template <typename T, typename F>
__device__ __forceinline__ void scan_row(const T* row, int n, bool smin, F&& f) {
  using V = typename Vec4<T>::V;
  constexpr int VB = 4 * sizeof(T);
  const int tid = threadIdx.x;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  const int head = min(n, (int)(((VB - addr % VB) % VB) / sizeof(T)));
  const int nvec = (n - head) / 4;
  const int body_end = head + 4 * nvec;
  const int nextra = head + (n - body_end);  // at most 6: unaligned ends
  {
    const bool ok = tid < nextra;
    const int c = tid < head ? tid : body_end + (tid - head);
    f(c, ok, ok ? rank_key(to_f(row[c]), smin) : 0u);
  }
  const V* vrow = reinterpret_cast<const V*>(row + head);
  for (int base = 0; base < nvec; base += THREADS) {
    const int v = base + tid;
    const bool ok = v < nvec;
    float e[4] = {0.f, 0.f, 0.f, 0.f};
    if (ok) {
      if constexpr (sizeof(T) == 4) unpack(vrow[v], e);
      else unpack<T>(vrow[v], e);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) f(head + 4 * v + i, ok, ok ? rank_key(e[i], smin) : 0u);
  }
}

// Histogram of digit (key >> shift) & (nb - 1) over the keys matching prefix
// under mask; warps aggregate equal bins before the shared atomic.
template <typename T>
__device__ __forceinline__ void histogram(const T* row, int n, bool smin, int* hist,
                                          int shift, int nb, uint32_t prefix,
                                          uint32_t mask) {
  const int lane = threadIdx.x & 31;
  for (int b = threadIdx.x; b < nb; b += THREADS) hist[b] = 0;
  __syncthreads();
  scan_row(row, n, smin, [=](int, bool ok, uint32_t key) {
    const bool act = ok && (key & mask) == prefix;
    if (!__any_sync(FULL, act)) return;
    const int bin = act ? (int)((key >> shift) & (nb - 1)) : -1;
    const unsigned peers = __match_any_sync(FULL, bin);
    if (act && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
  });
  __syncthreads();
}

// Warp 0: the bin holding the kk-th best key (bins read from the top), and
// the rank left inside it. Lane l owns bins [nb-1 - l*per, nb - (l+1)*per].
__device__ __forceinline__ void find_digit(const int* hist, int nb, int kk,
                                           int* s_digit, int* s_kk) {
  const int lane = threadIdx.x & 31;
  const int per = nb / 32;
  const int top = nb - 1 - lane * per;
  int local = 0;
  for (int i = 0; i < per; ++i) local += hist[top - i];
  int incl = local;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int excl = incl - local;
  if (excl < kk && kk <= incl) {
    int cum = excl;
    for (int i = 0; i < per; ++i) {
      const int h = hist[top - i];
      if (cum + h >= kk) {
        *s_digit = top - i;
        *s_kk = kk - cum;
        break;
      }
      cum += h;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_kernel(const T* __restrict__ x, int n, int k, int select_min,
            int* __restrict__ out_i) {
  __shared__ int hist[1 << HBITS];
  __shared__ uint32_t ckey[SORT_MAX];
  __shared__ int ccol[SORT_MAX];
  __shared__ int warp_cnt[WARPS];
  __shared__ int s_digit, s_kk, s_n, s_taken;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* row = x + (size_t)blockIdx.x * n;
  const bool smin = select_min != 0;
  if (tid == 0) {
    s_n = 0;
    s_taken = 0;
  }

  histogram(row, n, smin, hist, 21, 1 << 11, 0u, 0u);
  if (warp == 0) find_digit(hist, 1 << 11, k, &s_digit, &s_kk);
  __syncthreads();
  const uint32_t b0 = (uint32_t)s_digit;
  const int above0 = k - s_kk;  // keys in bins above b0
  const bool fast = above0 + hist[b0] <= SORT_MAX;
  __syncthreads();

  int cnt;
  if (fast) {
    scan_row(row, n, smin, [=](int c, bool ok, uint32_t key) {
      if (ok && (key >> 21) >= b0) {
        const int p = atomicAdd(&s_n, 1);
        ckey[p] = key;
        ccol[p] = c;
      }
    });
    __syncthreads();
    cnt = s_n;
  } else {
    uint32_t prefix = b0 << 21, mask = 0x7ffu << 21;
    int kk = s_kk;
    const int shifts[2] = {10, 0};
    const int bits[2] = {11, 10};
    for (int pass = 0; pass < 2; ++pass) {
      const int nb = 1 << bits[pass];
      histogram(row, n, smin, hist, shifts[pass], nb, prefix, mask);
      if (warp == 0) find_digit(hist, nb, kk, &s_digit, &s_kk);
      __syncthreads();
      prefix |= (uint32_t)s_digit << shifts[pass];
      mask |= (uint32_t)(nb - 1) << shifts[pass];
      kk = s_kk;
      __syncthreads();
    }
    // prefix is the k-th best key K: take every key above it and, in column
    // order, the first kk keys equal to it
    const uint32_t K = prefix;
    const int n_above = k - kk;
    for (int base = 0; base < n; base += THREADS) {
      const int c = base + tid;
      const uint32_t key = c < n ? rank_key(to_f(row[c]), smin) : 0u;
      const bool eq = c < n && key == K;
      if (c < n && key > K) {
        const int p = atomicAdd(&s_n, 1);
        ckey[p] = key;
        ccol[p] = c;
      }
      const unsigned bal = __ballot_sync(FULL, eq);
      if (lane == 0) warp_cnt[warp] = __popc(bal);
      __syncthreads();
      int off = s_taken;
      for (int w = 0; w < warp; ++w) off += warp_cnt[w];
      const int r = off + __popc(bal & ((1u << lane) - 1u));
      if (eq && r < kk) {
        ckey[n_above + r] = key;
        ccol[n_above + r] = c;
      }
      __syncthreads();
      if (tid == 0) {
        int tot = 0;
        for (int w = 0; w < WARPS; ++w) tot += warp_cnt[w];
        s_taken += tot;
      }
      __syncthreads();
      if (s_taken >= kk && s_n == n_above) break;  // block-uniform
    }
    cnt = k;
  }

  // bitonic sort of the survivors, padded to a power of two
  int P = 1;
  while (P < cnt) P <<= 1;
  for (int i = cnt + tid; i < P; i += THREADS) {
    ckey[i] = 0u;
    ccol[i] = 0x7fffffff;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const bool i_better = better(ckey[i], ccol[i], ckey[j], ccol[j]);
          const bool best_first = (i & size) == 0;
          if (best_first != i_better) {
            const uint32_t tk = ckey[i];
            const int tc = ccol[i];
            ckey[i] = ckey[j];
            ccol[i] = ccol[j];
            ckey[j] = tk;
            ccol[j] = tc;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int j = tid; j < k; j += THREADS) out_i[(size_t)blockIdx.x * k + j] = ccol[j];
}

}  // namespace

// Columns of the k best entries of every row of x (m, n), row-major, best
// first. dtype: 0 float32, 1 bfloat16, 2 float16. out_i is (m, k) int32.
// Returns the launch's cudaError_t.
extern "C" int topk_launch(int dtype, const void* x, int m, int n, int k,
                           int select_min, int* out_i, void* stream) {
  if (k < 1 || k > MAXK || k > n || m < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      topk_kernel<float><<<m, THREADS, 0, st>>>(static_cast<const float*>(x), n, k,
                                                 select_min, out_i);
      break;
    case 1:
      topk_kernel<__nv_bfloat16><<<m, THREADS, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), n, k, select_min, out_i);
      break;
    case 2:
      topk_kernel<__half><<<m, THREADS, 0, st>>>(static_cast<const __half*>(x), n,
                                                  k, select_min, out_i);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
