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
// pair that probes it. The search's kernel route now takes pq_scan_topk
// below, which keeps the scores out of device memory; this unfused kernel
// serves the plain-select route (select_impl="xla") and k above 256.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "select_block.cuh"

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// pq_scan_topk: the scan fused with the chunk's top-k, for Hopper (sm_90a).
//
// Replaces the same Pallas kernel (raft_tpu/ops/pq_scan.py:61) together with
// the per-chunk select that the JAX package's _pq_search
// (raft_tpu/neighbors/ivf_pq.py:1622) runs on its scores in XLA. For each
// query t of a tile and each slot j of each list l = probe_lists[t, p] it
// probes in the chunk (p = 0 .. pc-1, flat position p * cap + j):
//     score = (scan + bias[t, p]) + list_consts[l, j]   (consts: split L2)
//     score = list_ids[l, j] < 0 ? bad : score          (bad = ±inf)
//     score = keep bit of list_ids[l, j] clear ? bad : score   (a filter)
// with scan summed as pq_scan's above, every add rounded alone (__fadd_rn),
// and writes only the k best scores and their list_ids, best first. Ranking
// is the topk kernel's: the key of select_block.cuh (clamp to ±2.9e38, -0
// with +0, NaN by its bits), equal keys to the lowest flat position. Values
// are the scores' exact bits. ops/pq_scan.py's pq_scan_topk_plain is the same
// composition in PyTorch (pq_scan_plain, the two adds, torch.where,
// topk_plain), so the two agree bit for bit. A probed list id outside the
// index makes all its slots bad, with id -1. A sample filter comes as keep,
// a packed bitset of n_words words (bit i & 31 of word i >> 5 set when id i
// is kept; an id past the last word is not kept; null keeps every id), and
// is the JAX package's apply_id_filter on the chunk's
// scores: a slot whose id's bit is clear scores bad exactly as an empty slot
// does, and keeps its id (the search reports -1 wherever a returned value is
// ±inf). The filter is a template flag, so the unfiltered kernel carries no
// test; the filtered one loads a slot's keep word as soon as the tile's ids
// (prefetched a tile ahead) come up and tests it after the tile's sums, so
// the load's latency hides behind them.
//
// Design: the CUDA original's compute_similarity (IVF-PQ, LUT in shared
// memory, a block-level top-k fused behind it) carried to Hopper.
//   - A thread-block cluster of 2 blocks of 256 threads per query: block r
//     scans probes r, r + 2, ... in order, 512 slots a tile (two a thread,
//     their sums interleaved so two add chains are in flight); a probe's LUT
//     is staged once (not once per tile). At T = 128 the 256 blocks fill the
//     card two to an SM (113 KB of shared memory each at S=64, bf16) where
//     one block a query left an SM to one block's latency chain.
//   - A 2-stage ring of tiles in dynamic shared memory, filled with
//     cp.async: a tile's codes are one contiguous run of 512 x S bytes in the
//     list, copied in 16-byte pieces by consecutive threads (coalesced) and
//     stored unpadded with each row's pieces XOR-swizzled, so the 8 threads
//     of a quarter warp reading their rows' next 16 bytes hit 8 distinct
//     bank groups; a probe's first tile also brings the probe's raw LUT,
//     converted to float32 into one shared buffer when that tile comes up.
//     The slots' list_ids and consts are loaded a tile ahead into registers.
//     S that is not 16 x 2^i bytes (or an unaligned code array) reads codes
//     from device memory byte by byte instead.
//   - The threads of a warp step through s together, so their LUT reads lie
//     in one 16-entry row (two for split): no bank conflicts.
//   - Selection: select_block.cuh, shared with the topk kernel. Each scored
//     slot is held against the block's running k-th best (key, flat
//     position) and appended with its value to a 2,304-entry shared buffer
//     when it beats it; a radix select keeps exactly k when the buffer could
//     overflow and at the end, and a bitonic sort orders them. Block 0 then
//     reads block 1's sorted k through distributed shared memory and writes
//     each entry of the two lists at its rank in their union (a binary
//     search in the other list), the first k. Only (T, k) values and ids are
//     written; the (T, pc, cap) scores never reach device memory.
//   - Tensor cores do not fit: a one-hot product would do S x K
//     multiply-adds per slot where the gather does S lookups, and grouping
//     the pairs of a tile by list gives only ~3.4 pairs a list at the main
//     shape. Pairing pq4 subspaces into 256-entry tables would halve the
//     lookups but changes the summation order (and so the bits): left for
//     later, as is reading a list once for all queries that probe it.
//
// Bound at the main shape (128 queries x 8 probes of the 1M-row, 1,024-list
// index, cap 1,272, S=64, bf16 LUT, k=40): the distinct probed lists' codes
// (~298 lists, 24.3 MB) and their list_ids (1.5 MB), the LUTs (2.1 MB), bias
// and output: ~28 MB, ~8.3 us at 3.35 TB/s (a filter over 1M ids adds its
// 125 KB bitset), so bytes bound it (the 83.4M
// adds take ~1.2 us at 67 TFLOP/s). The shared-memory lookups set a floor the
// bytes bound does not show: 83.4M lookups at one 32-lane shared load per SM
// per clock is ~10 us on 132 SMs.

namespace fused {

using select_block::append;
using select_block::rank_key;
using select_block::reduce;
using select_block::sort_kept;
constexpr int THREADS = select_block::THREADS;
constexpr int NSTAGE = 2;                         // tiles in the ring
constexpr int CL = 2;                             // blocks a query: one cluster
static_assert(CL == 2, "the kernel merges two blocks' lists");
constexpr int SPT = 2;                            // slots a thread scores a tile
constexpr int TILE = SPT * THREADS;               // slots a tile
constexpr int STEP = TILE;                        // entries a tile may append
constexpr int CAP = 4 * STEP + select_block::MAXK;  // candidate buffer entries
using Sel = select_block::Smem<CAP, true>;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Byte offsets of a ring stage's parts and of the dynamic shared memory's.
// ops/pq_scan.py's pq_scan_topk_smem mirrors the total.
struct Layout {
  int lut_raw, stage, lutf, plist, bias, total;
  __host__ __device__ Layout(int S, int K, int lut_bytes, bool staged, int pc) {
    lut_raw = staged ? TILE * S : 0;           // the tile's code rows come first
    stage = lut_raw + S * K * lut_bytes;       // a multiple of 16
    lutf = NSTAGE * stage;                     // rounded up to 128 bytes in the kernel
    plist = lutf + S * K * 4 + 128;
    bias = plist + pc * 4;
    total = bias + pc * 4;
  }
};

// Where 16-byte piece c of a tile's row jj lies in its stage: rows are
// S = 16 << lcps bytes, stored without padding, and the piece index is XORed
// with a function of the row, so the 8 threads of a quarter warp reading
// piece c of 8 consecutive rows hit 8 distinct 16-byte bank groups.
__device__ __forceinline__ int piece_at(int jj, int c, int lcps) {
  const int swz = lcps >= 3 ? (jj & 7) : ((jj >> (3 - lcps)) & ((1 << lcps) - 1));
  return (jj << (lcps + 4)) + ((c ^ swz) << 4);
}

template <bool SPLIT>
__device__ __forceinline__ float add_code(float acc, const float* row, uint32_t c) {
  if (SPLIT) return __fadd_rn(acc, __fadd_rn(row[c >> 4], row[16 + (c & 15)]));
  return __fadd_rn(acc, row[c & 15]);
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

// add_code for the code in the low byte of x and the LUT row at shared
// address base + off (base aligned to 128 bytes, off a multiple of them):
// the entry lies at (base | nibble << 2) + off, a shift and one logic
// operation, with off left to the load's immediate.
template <bool SPLIT>
__device__ __forceinline__ float add_code_at(float acc, uint32_t base, uint32_t off, uint32_t x) {
  if (SPLIT)
    return __fadd_rn(acc, __fadd_rn(lds_f32((base | ((x >> 2) & 0x3cu)) + off),
                                    lds_f32((base | ((x << 2) & 0x3cu)) + off + 64u)));
  return __fadd_rn(acc, lds_f32((base | ((x << 2) & 0x3cu)) + off));
}

// The position of a block's tiles: probe p (of the chunk), first slot j0.
struct Cursor {
  int p, j0;
  __device__ __forceinline__ void next(int cap) {
    j0 += TILE;
    if (j0 >= cap) {
      j0 = 0;
      p += CL;
    }
  }
};

template <typename LutT, bool SPLIT, bool STAGED, bool FILTER>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(THREADS, 2)
pq_scan_topk_kernel(const uint8_t* __restrict__ codes, const int* __restrict__ list_ids,
                    const float* __restrict__ consts, const uint32_t* __restrict__ keep,
                    int n_words, const int* __restrict__ probe_lists,
                    const LutT* __restrict__ lut, const float* __restrict__ bias, int n_lists,
                    int cap, int S, int lcps, int pc, int k, int select_min,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int K = SPLIT ? 32 : 16;
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ Sel sel;
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int t = blockIdx.x / CL;                   // the query
  const int rank = (int)cluster.block_rank();     // scans probes rank, rank + CL, ...
  const Layout L(S, K, (int)sizeof(LutT), STAGED, pc);
  const uint32_t dsm_s = (uint32_t)__cvta_generic_to_shared(dsm);
  const uint32_t lutf_s = (dsm_s + (uint32_t)L.lutf + 127u) & ~127u;   // the LUT's rows
  float* lutf = reinterpret_cast<float*>(dsm + (lutf_s - dsm_s));
  int* plist = reinterpret_cast<int*>(dsm + L.plist);
  float* pbias = reinterpret_cast<float*>(dsm + L.bias);
  for (int i = tid; i < pc; i += THREADS) {
    plist[i] = probe_lists[(size_t)t * pc + i];
    pbias[i] = bias[(size_t)t * pc + i];
  }
  if (tid == 0) sel.count = 0;
  __syncthreads();
  const uint32_t flip = select_min ? select_block::SIGN : 0u;
  const float bad = __int_as_float(select_min ? 0x7f800000 : (int)0xff800000);
  const int U = (pc - rank + CL - 1) / CL * ((cap + TILE - 1) / TILE);   // this block's tiles
  const int cps = S >> 4;                          // 16-byte pieces a row (STAGED)

  // start the copies of the tile at cursor x (its codes, and on a probe's
  // first tile the probe's raw LUT) into stage u % NSTAGE, as one commit
  // group (empty past the last tile)
  auto fetch = [&](int u, const Cursor& x) {
    if (u < U) {
      const int l = plist[x.p];
      unsigned char* st = dsm + (u % NSTAGE) * L.stage;
      if (STAGED && l >= 0 && l < n_lists) {
        const uint8_t* src = codes + ((size_t)l * cap + x.j0) * S;
        const int n = min(TILE, cap - x.j0) << lcps;
        for (int q = tid; q < n; q += THREADS)
          cp_async16(st + piece_at(q >> lcps, q & (cps - 1), lcps), src + (size_t)q * 16);
      }
      if (x.j0 == 0) {
        const uint8_t* src =
            reinterpret_cast<const uint8_t*>(lut + ((size_t)t * pc + x.p) * S * K);
        for (int q = tid; q < S * K * (int)sizeof(LutT) / 16; q += THREADS)
          cp_async16(st + L.lut_raw + q * 16, src + q * 16);
      }
    }
    cp_async_commit();
  };
  // this thread's slots of the tile at cursor x: their ids (-1 past the
  // list's end, or for a list outside the index) and constants, loaded a
  // tile ahead into registers
  auto slots = [&](int u, const Cursor& x, int* id, float* cst) {
#pragma unroll
    for (int e = 0; e < SPT; ++e) {
      id[e] = -1;
      cst[e] = 0.f;
      const int j = x.j0 + e * THREADS + tid;
      const int l = u < U ? plist[x.p] : -1;
      if (j < cap && l >= 0 && l < n_lists) {
        id[e] = __ldg(list_ids + (size_t)l * cap + j);
        if (consts != nullptr) cst[e] = __ldg(consts + (size_t)l * cap + j);
      }
    }
  };

  Cursor at = {rank, 0}, ahead = {rank, 0};     // the tile scored; the next to fetch
  for (int u = 0; u < NSTAGE - 1; ++u) {
    fetch(u, ahead);
    ahead.next(cap);
  }
  int id_next[SPT];
  float cst_next[SPT];
  slots(0, at, id_next, cst_next);
  // threshold (key, position): nothing is kept yet, so every slot passes
  const int lim = CAP - STEP;
  uint32_t tk = 0u, tc = 0x7fffffffu;
  for (int u = 0; u < U; ++u) {
    int id[SPT];
    float cst[SPT];
    uint32_t kw[SPT];   // the slots' keep words (FILTER), tested after the sums
#pragma unroll
    for (int e = 0; e < SPT; ++e) {
      id[e] = id_next[e];
      cst[e] = cst_next[e];
      kw[e] = (FILTER && id[e] >= 0 && (id[e] >> 5) < n_words) ? __ldg(keep + (id[e] >> 5))
                                                                : 0u;
    }
    Cursor nx = at;
    nx.next(cap);
    slots(u + 1, nx, id_next, cst_next);
    fetch(u + NSTAGE - 1, ahead);   // its stage was last read before the previous barrier
    ahead.next(cap);
    cp_async_wait<NSTAGE - 1>();
    __syncthreads();
    const unsigned char* st = dsm + (u % NSTAGE) * L.stage;
    const int p = at.p;
    if (at.j0 == 0) {
      const LutT* raw = reinterpret_cast<const LutT*>(st + L.lut_raw);
      for (int i = tid; i < S * K; i += THREADS) lutf[i] = to_f(raw[i]);
      __syncthreads();
    }
    float acc[SPT];
#pragma unroll
    for (int e = 0; e < SPT; ++e) acc[e] = 0.f;
    if (STAGED) {
      // both slots' sums interleaved, each in subspace order
      for (int c = 0; c < cps; ++c) {
        const uint32_t lrow = lutf_s + (uint32_t)(c * 16 * K * 4);   // subspace 16c
        uint32_t w[SPT][4];
#pragma unroll
        for (int e = 0; e < SPT; ++e) {
          const uint4 w4 = *reinterpret_cast<const uint4*>(
              st + piece_at(e * THREADS + tid, c, lcps));
          w[e][0] = w4.x;
          w[e][1] = w4.y;
          w[e][2] = w4.z;
          w[e][3] = w4.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
#pragma unroll
            for (int e = 0; e < SPT; ++e)
              acc[e] = add_code_at<SPLIT>(acc[e], lrow, (uint32_t)((4 * q + b) * K * 4),
                                          w[e][q] >> (8 * b));
          }
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < SPT; ++e) {
        const int j = at.j0 + e * THREADS + tid;
        if (id[e] >= 0) {
          const uint8_t* row = codes + ((size_t)plist[p] * cap + j) * S;
          for (int s = 0; s < S; ++s)
            acc[e] = add_code<SPLIT>(acc[e], lutf + s * K, __ldg(row + s));
        }
      }
    }
    uint32_t key[SPT], val[SPT];
    uint32_t mask = 0u;
#pragma unroll
    for (int e = 0; e < SPT; ++e) {
      const int j = at.j0 + e * THREADS + tid;
      float v = bad;
      if (id[e] >= 0 && (!FILTER || ((kw[e] >> (id[e] & 31)) & 1u))) {
        v = __fadd_rn(acc[e], pbias[p]);
        if (consts != nullptr) v = __fadd_rn(v, cst[e]);
      }
      val[e] = __float_as_uint(v);
      key[e] = rank_key(val[e], flip);
      const uint32_t c = (uint32_t)(p * cap + j);
      if (j < cap && (key[e] > tk || (key[e] == tk && c < tc))) mask |= 1u << e;
    }
    const uint32_t c0 = (uint32_t)(p * cap + at.j0 + tid);
    const bool over = append<SPT>(
        sel, mask, key, [=](int e) { return c0 + (uint32_t)(e * THREADS); }, val, lim);
    if (__syncthreads_or(over)) reduce(sel, k, tk, tc);
    at = nx;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (sel.count > k) reduce(sel, k, tk, tc);

  // each block sorts its (at most) k best; block 0 reads block 1's through
  // distributed shared memory and places every entry of the two sorted
  // lists at its rank in the union (its index plus the entries of the other
  // list that beat it), writing the first k
  const int na = sel.count;           // <= k after the reduce
  sort_kept(sel, na);
  cluster.sync();
  if (rank == 0) {
    const Sel* o = cluster.map_shared_rank(&sel, 1);
    const int nb = o->count;
    for (int i = tid; i < nb; i += THREADS) {
      sel.tkey[i] = o->key[i];
      sel.tcol[i] = o->col[i];
      sel.tval[i] = o->val[i];
    }
    if (tid == 0) sel.sel = nb;
  }
  cluster.sync();   // block 1's list is read; block 0's copy is visible
  if (rank != 0) return;
  const int nb = sel.sel;
  for (int i = tid; i < na + nb; i += THREADS) {
    const bool in_a = i < na;
    const int x = in_a ? i : i - na;
    const uint32_t key = in_a ? sel.key[x] : sel.tkey[x];
    const uint32_t col = in_a ? sel.col[x] : sel.tcol[x];
    const uint32_t* okey = in_a ? sel.tkey : sel.key;
    const uint32_t* ocol = in_a ? sel.tcol : sel.col;
    int lo = 0, hi = in_a ? nb : na;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (select_block::better(okey[mid], ocol[mid], key, col)) lo = mid + 1;
      else hi = mid;
    }
    const int r = x + lo;
    if (r < k) {
      const int p = (int)col / cap, j = (int)col - p * cap;
      const int l = plist[p];
      const size_t o = (size_t)t * k + r;
      out_v[o] = __uint_as_float(in_a ? sel.val[x] : sel.tval[x]);
      out_i[o] = (l >= 0 && l < n_lists) ? list_ids[(size_t)l * cap + j] : -1;
    }
  }
}

template <typename LutT, bool SPLIT, bool STAGED, bool FILTER>
int launch(const void* codes, const void* list_ids, const void* consts, const void* keep,
           int n_words, const void* probe_lists, const void* lut, const void* bias, int T, int pc,
           int n_lists, int cap, int S, int k, int select_min, float* out_v, int* out_i,
           cudaStream_t st) {
  constexpr int K = SPLIT ? 32 : 16;
  int lcps = 0;
  while ((16 << lcps) < S) ++lcps;
  const Layout L(S, K, (int)sizeof(LutT), STAGED, pc);
  if ((size_t)L.total + sizeof(Sel) > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = pq_scan_topk_kernel<LutT, SPLIT, STAGED, FILTER>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return (int)e;
  kern<<<T * CL, THREADS, L.total, st>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(list_ids),
      static_cast<const float*>(consts), static_cast<const uint32_t*>(keep), n_words,
      static_cast<const int*>(probe_lists),
      static_cast<const LutT*>(lut), static_cast<const float*>(bias), n_lists, cap, S, lcps, pc,
      k, select_min, out_v, out_i);
  return (int)cudaGetLastError();
}

template <typename LutT, bool SPLIT>
int launch_staged(bool staged, const void* codes, const void* list_ids, const void* consts,
                  const void* keep, int n_words, const void* probe_lists, const void* lut,
                  const void* bias, int T, int pc, int n_lists, int cap, int S, int k,
                  int select_min, float* out_v, int* out_i, cudaStream_t st) {
  auto go = staged ? (keep != nullptr ? &launch<LutT, SPLIT, true, true>
                                      : &launch<LutT, SPLIT, true, false>)
                   : (keep != nullptr ? &launch<LutT, SPLIT, false, true>
                                      : &launch<LutT, SPLIT, false, false>);
  return go(codes, list_ids, consts, keep, n_words, probe_lists, lut, bias, T, pc, n_lists, cap,
            S, k, select_min, out_v, out_i, st);
}

}  // namespace fused

// The k best (T, k) float32 scores and their int32 list_ids of every slot of
// the pc lists each query probes, best first (see the note above). codes:
// (n_lists, cap, S) uint8; list_ids: (n_lists, cap) int32; consts: (n_lists,
// cap) float32 or null; keep: the filter's packed bitset of n_words words
// (ids past its end are not kept), or null; probe_lists: (T, pc) int32; lut: (T, pc, S, K)
// float32 (lut_dtype 0) or bfloat16 (1), 16-byte aligned, K = 32 with split,
// else 16; bias: (T, pc) float32. 1 <= k <= min(256, pc * cap). Returns the
// launch's cudaError_t.
extern "C" int pq_scan_topk_launch(int lut_dtype, int split, const void* codes,
                                   const void* list_ids, const void* consts, const void* keep,
                                   int n_words, const void* probe_lists, const void* lut,
                                   const void* bias, int T, int pc, int n_lists, int cap, int S,
                                   int k, int select_min, float* out_v, int* out_i,
                                   void* stream) {
  if (T < 1 || pc < 1 || cap < 1 || S < 1 || n_lists < 1 || k < 1 || k > select_block::MAXK ||
      (keep != nullptr && n_words < 0) ||
      (long long)pc * cap > 0x7ffffffe || k > pc * cap ||
      reinterpret_cast<uintptr_t>(lut) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rows of 16 x 2^i bytes at a 16-byte aligned address go through shared memory
  const bool staged = S % 16 == 0 && ((S / 16) & (S / 16 - 1)) == 0 &&
                      reinterpret_cast<uintptr_t>(codes) % 16 == 0;
  if (lut_dtype == 0) {
    auto go = split ? &fused::launch_staged<float, true> : &fused::launch_staged<float, false>;
    return go(staged, codes, list_ids, consts, keep, n_words, probe_lists, lut, bias, T, pc,
              n_lists, cap, S, k, select_min, out_v, out_i, st);
  }
  if (lut_dtype == 1) {
    auto go = split ? &fused::launch_staged<__nv_bfloat16, true>
                    : &fused::launch_staged<__nv_bfloat16, false>;
    return go(staged, codes, list_ids, consts, keep, n_words, probe_lists, lut, bias, T, pc,
              n_lists, cap, S, k, select_min, out_v, out_i, st);
  }
  return (int)cudaErrorInvalidValue;
}
