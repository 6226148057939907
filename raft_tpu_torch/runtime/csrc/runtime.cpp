// raft_tpu_torch native host runtime.
//
// The port's own copy of the JAX package's host runtime (the two packages
// build and load their libraries apart; the functions and the files they
// write are the same):
//  - big-ANN binary dataset IO (reference: cpp/bench/ann/src/common/dataset.h
//    BinFile — 8-byte header: uint32 n_rows, uint32 dim; suffixes
//    .fbin/.u8bin/.i8bin), with pread-based chunked access so Python can
//    stream datasets larger than host memory into device memory a chunk at
//    a time;
//  - exact host-side candidate refinement (reference: refine_host,
//    cpp/include/raft/neighbors/detail/refine.cuh:169 — OpenMP loop over
//    queries), used to re-rank ANN candidates against original vectors while
//    the device works on the next batch;
//  - host top-k merge of per-shard results (reference: knn_merge_parts,
//    cpp/include/raft/neighbors/detail/knn_merge_parts.cuh), for multi-host
//    result aggregation outside the device mesh.
//
// Exposed as a plain C ABI for ctypes. Threading uses std::thread — no
// OpenMP runtime dependency. Built by raft_tpu_torch/runtime/native.py with
//   g++ -O3 -std=c++17 -fPIC -shared -pthread

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

int num_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Run fn(i) for i in [0, n) over a thread pool (strided like the reference's
// `for (i = omp_get_thread_num(); i < n; i += omp_get_num_threads())`).
template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
  int nt = std::min<int64_t>(num_threads(), n);
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    pool.emplace_back([=] {
      for (int64_t i = t; i < n; i += nt) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

int64_t rt_num_threads() { return num_threads(); }

// ---------------------------------------------------------------------------
// Big-ANN binary file IO (header: uint32 n, uint32 dim — dataset.h:35-41)
// ---------------------------------------------------------------------------

// Returns 0 on success; fills n_rows/dim.
int rt_bin_info(const char* path, int64_t* n_rows, int64_t* dim) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  uint32_t hdr[2];
  size_t got = std::fread(hdr, sizeof(uint32_t), 2, fp);
  std::fclose(fp);
  if (got != 2) return -2;
  *n_rows = hdr[0];
  *dim = hdr[1];
  return 0;
}

// Read rows [row_start, row_start + n_rows) of an (n, dim) record file with
// elem_size-byte scalars into out. Parallel pread chunks saturate the page
// cache / NVMe queue the way the reference's mmap+first-touch does.
int rt_bin_read_chunk(const char* path, int64_t row_start, int64_t n_rows,
                      int64_t dim, int64_t elem_size, void* out) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -1;
  const int64_t row_bytes = dim * elem_size;
  const int64_t base = 8 + row_start * row_bytes;  // 8-byte header
  const int64_t total = n_rows * row_bytes;
  std::atomic<int> err{0};
  // split into ~32MB stripes for parallel pread
  const int64_t stripe = 32ll << 20;
  const int64_t n_stripes = (total + stripe - 1) / stripe;
  parallel_for(n_stripes, [&](int64_t s) {
    int64_t off = s * stripe;
    int64_t len = std::min(stripe, total - off);
    char* dst = static_cast<char*>(out) + off;
    int64_t done = 0;
    while (done < len) {
      ssize_t got = ::pread(fd, dst + done, len - done, base + off + done);
      if (got <= 0) {
        err.store(-2);
        return;
      }
      done += got;
    }
  });
  ::close(fd);
  return err.load();
}

// Write an (n, dim) float32 record file with the big-ANN 8-byte header.
int rt_bin_write(const char* path, const void* data, int64_t n_rows,
                 int64_t dim, int64_t elem_size) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return -1;
  uint32_t hdr[2] = {static_cast<uint32_t>(n_rows), static_cast<uint32_t>(dim)};
  if (std::fwrite(hdr, sizeof(uint32_t), 2, fp) != 2) {
    std::fclose(fp);
    return -2;
  }
  size_t total = static_cast<size_t>(n_rows) * dim;
  size_t got = std::fwrite(data, elem_size, total, fp);
  std::fclose(fp);
  return got == total ? 0 : -3;
}

// ---------------------------------------------------------------------------
// Host refine (reference: refine_host, detail/refine.cuh:169)
// metric: 0 = L2 (squared), 1 = inner product (negated for ascending sort)
// ---------------------------------------------------------------------------

int rt_refine_host_f32(const float* dataset, int64_t n, int64_t d,
                       const float* queries, int64_t m,
                       const int32_t* candidates, int64_t k_in,
                       int32_t* out_idx, float* out_dist, int64_t k_out,
                       int metric) {
  if (k_out > k_in) return -1;
  std::atomic<int> err{0};
  parallel_for(m, [&](int64_t i) {
    const float* q = queries + i * d;
    std::vector<std::pair<float, int32_t>> scored(k_in);
    for (int64_t j = 0; j < k_in; ++j) {
      int32_t id = candidates[i * k_in + j];
      if (id < 0 || id >= n) {
        scored[j] = {HUGE_VALF, -1};
        continue;
      }
      const float* v = dataset + static_cast<int64_t>(id) * d;
      float acc = 0.f;
      if (metric == 1) {
        for (int64_t c = 0; c < d; ++c) acc -= q[c] * v[c];
      } else {
        for (int64_t c = 0; c < d; ++c) {
          float diff = q[c] - v[c];
          acc += diff * diff;
        }
      }
      scored[j] = {acc, id};
    }
    std::partial_sort(scored.begin(), scored.begin() + k_out, scored.end());
    for (int64_t j = 0; j < k_out; ++j) {
      out_dist[i * k_out + j] =
          (metric == 1 && scored[j].second >= 0) ? -scored[j].first : scored[j].first;
      out_idx[i * k_out + j] = scored[j].second;
    }
  });
  return err.load();
}

// ---------------------------------------------------------------------------
// Host merge of per-shard top-k lists (reference: knn_merge_parts)
// part_dists: (n_parts, m, k); ids already global. select_min: 1 = ascending.
// ---------------------------------------------------------------------------

int rt_knn_merge_parts_f32(const float* part_dists, const int32_t* part_ids,
                           int64_t n_parts, int64_t m, int64_t k_in,
                           float* out_dist, int32_t* out_idx, int64_t k_out,
                           int select_min) {
  if (k_out > n_parts * k_in) return -1;
  parallel_for(m, [&](int64_t i) {
    std::vector<std::pair<float, int32_t>> all(n_parts * k_in);
    for (int64_t p = 0; p < n_parts; ++p) {
      const float* dsrc = part_dists + (p * m + i) * k_in;
      const int32_t* isrc = part_ids + (p * m + i) * k_in;
      for (int64_t j = 0; j < k_in; ++j) {
        float v = dsrc[j];
        all[p * k_in + j] = {select_min ? v : -v, isrc[j]};
      }
    }
    std::partial_sort(all.begin(), all.begin() + k_out, all.end());
    for (int64_t j = 0; j < k_out; ++j) {
      out_dist[i * k_out + j] = select_min ? all[j].first : -all[j].first;
      out_idx[i * k_out + j] = all[j].second;
    }
  });
  return 0;
}

}  // extern "C"
