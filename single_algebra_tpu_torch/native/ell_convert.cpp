// Native host-side sparse format conversion for single-algebra-tpu.
//
// Role-equivalent of the compiled storage layer the reference gets from
// nalgebra-sparse (CSR/CSC construction and transposition, reference
// src/sparse/csr.rs:27-29): the O(nnz) relayout passes that sit between
// disk/scipy CSR arrays and the TPU's padded-ELL / tiled-ELL device
// layouts. These are bandwidth-bound pointer loops - the one part of the
// pipeline where native code beats numpy (no boolean-mask temporaries, one
// pass, cache-friendly write patterns).
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Row loops with disjoint writes are OpenMP-parallel (the host build
// was the measured cold-path bottleneck at wide shapes); pragmas are
// no-ops when compiled without -fopenmp.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <memory>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// CSR -> padded ELL. ell_data/ell_ids must be zero-initialized by the
// caller with shape [rows_padded, width].
void csr_to_ell_f32(const int64_t* indptr, const int32_t* indices,
                    const float* data, int64_t n_rows, int64_t width,
                    float* ell_data, int32_t* ell_ids, int32_t* row_nnz) {
#pragma omp parallel for schedule(guided)
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t lo = indptr[r], hi = indptr[r + 1];
    row_nnz[r] = static_cast<int32_t>(hi - lo);
    float* dst_d = ell_data + r * width;
    int32_t* dst_i = ell_ids + r * width;
    const int64_t cnt = hi - lo;
    std::memcpy(dst_d, data + lo, cnt * sizeof(float));
    std::memcpy(dst_i, indices + lo, cnt * sizeof(int32_t));
  }
}

// CSR -> CSC (counting sort). out_indptr must be zero-initialized
// [n_cols + 1]; out_indices/out_data sized [nnz].
void csr_transpose_f32(const int64_t* indptr, const int32_t* indices,
                       const float* data, int64_t n_rows, int64_t n_cols,
                       int64_t* out_indptr, int32_t* out_indices,
                       float* out_data, int64_t* work /* [n_cols] */) {
  const int64_t nnz = indptr[n_rows];
  for (int64_t i = 0; i < nnz; ++i) out_indptr[indices[i] + 1]++;
  for (int64_t c = 0; c < n_cols; ++c) out_indptr[c + 1] += out_indptr[c];
  std::memcpy(work, out_indptr, n_cols * sizeof(int64_t));
  for (int64_t r = 0; r < n_rows; ++r) {
    for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
      const int64_t dst = work[indices[i]]++;
      out_indices[dst] = static_cast<int32_t>(r);
      out_data[dst] = data[i];
    }
  }
}

// CSR -> column-tiled padded ELL (the Pallas SpMM kernel layout),
// TRANSPOSED orientation: outputs are [n_payload_rows, rows_padded]
// with n_payload_rows = ntiles * wt. tdata_t/tlocal_t must be
// zero-initialized by the caller.
// The caller pre-computes wt with csr_tile_width and passes it back here;
// entries whose within-(row, tile) rank reaches wt are NOT written (they
// would index past the slot array) and are counted in the return value —
// callers must treat a nonzero return as a caller bug (stale width plan).
//
// The transposed layout makes the naive fill one scattered float write
// per entry with a rows_padded*4-byte stride — TLB/cache-hostile (15 s
// for a 48M-nnz wide-shape payload measured). Instead: fill a
// cache-resident [n_payload_rows, BR] block-local buffer for BR source
// rows at a time (tracking which payload rows the block touched), then
// stream the touched rows out with memcpy. Work is proportional to the
// touched payload bytes; blocks parallelize over threads.
int64_t csr_to_tiled_ell_t_f32(const int64_t* indptr, const int32_t* indices,
                               const float* data, int64_t n_rows,
                               int64_t col_tile, int64_t wt,
                               int64_t rows_padded, int64_t n_payload_rows,
                               float* tdata_t, int32_t* tlocal_t) {
  // block width: keep the local buffers (8 bytes/slot) around 8 MB
  int64_t BR = 512;
  while (BR > 64 && n_payload_rows * BR * 8 > (8 << 20)) BR /= 2;
  if (n_payload_rows * BR * 8 > (64LL << 20)) {
    // extreme payload heights would make the per-thread scratch (and
    // the per-block touched-row sweep) dominate: fall back to the
    // direct streaming writer (zero extra memory, nnz-proportional)
    int64_t dropped = 0;
#pragma omp parallel for schedule(guided) reduction(+ : dropped)
    for (int64_t r = 0; r < n_rows; ++r) {
      int64_t cur_tile = -1, rank = 0;
      for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
        const int64_t c = indices[i];
        const int64_t t = c / col_tile;
        rank = (t == cur_tile) ? rank + 1 : 0;
        cur_tile = t;
        if (rank >= wt) {
          ++dropped;
          continue;
        }
        const int64_t slot = (t * wt + rank) * rows_padded + r;
        tdata_t[slot] = data[i];
        tlocal_t[slot] = static_cast<int32_t>(c - t * col_tile);
      }
    }
    return dropped;
  }
  int64_t dropped = 0;
#pragma omp parallel reduction(+ : dropped)
  {
    std::vector<float> ld(static_cast<size_t>(n_payload_rows) * BR, 0.0f);
    std::vector<int32_t> ll(static_cast<size_t>(n_payload_rows) * BR, 0);
    std::vector<uint8_t> touched(n_payload_rows, 0);
#pragma omp for schedule(dynamic, 1)
    for (int64_t b0 = 0; b0 < n_rows; b0 += BR) {
      const int64_t b1 = std::min(b0 + BR, n_rows);
      std::memset(touched.data(), 0, n_payload_rows);
      for (int64_t r = b0; r < b1; ++r) {
        int64_t cur_tile = -1;
        int64_t rank = 0;
        const int64_t rcol = r - b0;
        for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
          const int64_t c = indices[i];
          const int64_t t = c / col_tile;
          rank = (t == cur_tile) ? rank + 1 : 0;
          cur_tile = t;
          if (rank >= wt) {
            ++dropped;
            continue;
          }
          const int64_t pr = t * wt + rank;
          touched[pr] = 1;
          ld[pr * BR + rcol] = data[i];
          ll[pr * BR + rcol] = static_cast<int32_t>(c - t * col_tile);
        }
      }
      const int64_t width = b1 - b0;
      for (int64_t pr = 0; pr < n_payload_rows; ++pr) {
        if (!touched[pr]) continue;
        std::memcpy(tdata_t + pr * rows_padded + b0, ld.data() + pr * BR,
                    width * sizeof(float));
        std::memcpy(tlocal_t + pr * rows_padded + b0, ll.data() + pr * BR,
                    width * sizeof(int32_t));
        std::memset(ld.data() + pr * BR, 0, width * sizeof(float));
        std::memset(ll.data() + pr * BR, 0, width * sizeof(int32_t));
      }
    }
  }
  return dropped;
}

// max per-(row, tile) group size, needed to size wt before conversion
int64_t csr_tile_width(const int64_t* indptr, const int32_t* indices,
                       int64_t n_rows, int64_t col_tile) {
  int64_t max_cnt = 0;
#pragma omp parallel for schedule(guided) reduction(max : max_cnt)
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t cur_tile = -1, cnt = 0;
    for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
      const int64_t t = indices[i] / col_tile;
      cnt = (t == cur_tile) ? cnt + 1 : 1;
      cur_tile = t;
      max_cnt = std::max(max_cnt, cnt);
    }
  }
  return max_cnt;
}

// fused scatter of nnz values into a zero-initialized dense bf16 matrix
// (row-major [n_rows, n_cols], uint16 bit patterns), with on-the-fly
// f32 -> bf16 round-to-nearest-even. Returns 1 if the conversion was exact
// (no value lost precision), else 0. Feeds DensifiedOperator.
int32_t csr_densify_bf16(const int64_t* indptr, const int32_t* indices,
                         const float* data, int64_t n_rows, int64_t n_cols,
                         uint16_t* dense_hi, uint16_t* dense_lo /* or null */) {
  int32_t exact = 1;
#pragma omp parallel for schedule(guided) reduction(&& : exact)
  for (int64_t r = 0; r < n_rows; ++r) {
    uint16_t* row_hi = dense_hi + r * n_cols;
    uint16_t* row_lo = dense_lo ? dense_lo + r * n_cols : nullptr;
    for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
      const float v = data[i];
      uint32_t u;
      std::memcpy(&u, &v, 4);
      const uint32_t r16 = (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
      row_hi[indices[i]] = static_cast<uint16_t>(r16);
      const uint32_t back = r16 << 16;
      float hi_f;
      std::memcpy(&hi_f, &back, 4);
      const float lo_f = v - hi_f;
      if (lo_f != 0.0f) {
        exact = 0;
        if (row_lo) {
          uint32_t ul;
          std::memcpy(&ul, &lo_f, 4);
          const uint32_t l16 = (ul + 0x7FFFu + ((ul >> 16) & 1u)) >> 16;
          row_lo[indices[i]] = static_cast<uint16_t>(l16);
        }
      }
    }
  }
  return exact;
}

}  // extern "C"

extern "C" {

// histogram of (row, tile) group sizes; hist must be zeroed [hist_len]
void csr_tile_group_hist(const int64_t* indptr, const int32_t* indices,
                         int64_t n_rows, int64_t col_tile, int64_t* hist,
                         int64_t hist_len) {
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t cur_tile = -1, cnt = 0;
    for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
      const int64_t t = indices[i] / col_tile;
      if (t == cur_tile) {
        ++cnt;
      } else {
        if (cnt > 0) hist[std::min(cnt, hist_len - 1)]++;
        cur_tile = t;
        cnt = 1;
      }
    }
    if (cnt > 0) hist[std::min(cnt, hist_len - 1)]++;
  }
}

// max per-row overflow count for a given main width wt
int64_t csr_overflow_width(const int64_t* indptr, const int32_t* indices,
                           int64_t n_rows, int64_t col_tile, int64_t wt) {
  int64_t max_over = 0;
#pragma omp parallel for schedule(guided) reduction(max : max_over)
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t cur_tile = -1, rank = 0, over = 0;
    for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
      const int64_t t = indices[i] / col_tile;
      rank = (t == cur_tile) ? rank + 1 : 0;
      cur_tile = t;
      if (rank >= wt) ++over;
    }
    max_over = std::max(max_over, over);
  }
  return max_over;
}

// two-level split fill: main level (transposed tiled ELL, rank < wt,
// [n_payload_rows = ntiles * wt, rows_padded]) + overflow side array
// [rows_padded, ov_w] with GLOBAL column ids. All outputs must be
// zero-initialized by the caller. Same block-local buffering as
// csr_to_tiled_ell_t_f32 for the transposed main level; the overflow
// side array is row-major (already cache-friendly) and written direct.
void csr_to_tiled_ell_split_t_f32(const int64_t* indptr,
                                  const int32_t* indices, const float* data,
                                  int64_t n_rows, int64_t col_tile,
                                  int64_t wt, int64_t rows_padded,
                                  int64_t n_payload_rows,
                                  float* tdata_t, int32_t* tlocal_t,
                                  float* ov_data, int32_t* ov_ids,
                                  int64_t ov_w) {
  int64_t BR = 512;
  while (BR > 64 && n_payload_rows * BR * 8 > (8 << 20)) BR /= 2;
  if (n_payload_rows * BR * 8 > (64LL << 20)) {
    // same scratch bound as csr_to_tiled_ell_t_f32: direct writer
#pragma omp parallel for schedule(guided)
    for (int64_t r = 0; r < n_rows; ++r) {
      int64_t cur_tile = -1, rank = 0, over = 0;
      for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
        const int64_t c = indices[i];
        const int64_t t = c / col_tile;
        rank = (t == cur_tile) ? rank + 1 : 0;
        cur_tile = t;
        if (rank < wt) {
          const int64_t slot = (t * wt + rank) * rows_padded + r;
          tdata_t[slot] = data[i];
          tlocal_t[slot] = static_cast<int32_t>(c - t * col_tile);
        } else {
          const int64_t slot = r * ov_w + over;
          ov_data[slot] = data[i];
          ov_ids[slot] = static_cast<int32_t>(c);
          ++over;
        }
      }
    }
    return;
  }
#pragma omp parallel
  {
    std::vector<float> ld(static_cast<size_t>(n_payload_rows) * BR, 0.0f);
    std::vector<int32_t> ll(static_cast<size_t>(n_payload_rows) * BR, 0);
    std::vector<uint8_t> touched(n_payload_rows, 0);
#pragma omp for schedule(dynamic, 1)
    for (int64_t b0 = 0; b0 < n_rows; b0 += BR) {
      const int64_t b1 = std::min(b0 + BR, n_rows);
      std::memset(touched.data(), 0, n_payload_rows);
      for (int64_t r = b0; r < b1; ++r) {
        int64_t cur_tile = -1, rank = 0, over = 0;
        const int64_t rcol = r - b0;
        for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
          const int64_t c = indices[i];
          const int64_t t = c / col_tile;
          rank = (t == cur_tile) ? rank + 1 : 0;
          cur_tile = t;
          if (rank < wt) {
            const int64_t pr = t * wt + rank;
            touched[pr] = 1;
            ld[pr * BR + rcol] = data[i];
            ll[pr * BR + rcol] = static_cast<int32_t>(c - t * col_tile);
          } else {
            const int64_t slot = r * ov_w + over;
            ov_data[slot] = data[i];
            ov_ids[slot] = static_cast<int32_t>(c);
            ++over;
          }
        }
      }
      const int64_t width = b1 - b0;
      for (int64_t pr = 0; pr < n_payload_rows; ++pr) {
        if (!touched[pr]) continue;
        std::memcpy(tdata_t + pr * rows_padded + b0, ld.data() + pr * BR,
                    width * sizeof(float));
        std::memcpy(tlocal_t + pr * rows_padded + b0, ll.data() + pr * BR,
                    width * sizeof(int32_t));
        std::memset(ld.data() + pr * BR, 0, width * sizeof(float));
        std::memset(ll.data() + pr * BR, 0, width * sizeof(int32_t));
      }
    }
  }
}

}  // extern "C"

extern "C" {

// per-row maximum (row, tile)-group size (row bucketing input):
// out[r] = widest column-tile run of row r. One O(nnz) pass.
void csr_row_tile_widths(const int64_t* indptr, const int32_t* indices,
                         int64_t n_rows, int64_t col_tile, int64_t* out) {
#pragma omp parallel for schedule(guided)
  for (int64_t r = 0; r < n_rows; ++r) {
    int64_t cur_tile = -1, cnt = 0, best = 0;
    for (int64_t i = indptr[r]; i < indptr[r + 1]; ++i) {
      const int64_t t = indices[i] / col_tile;
      cnt = (t == cur_tile) ? cnt + 1 : 1;
      cur_tile = t;
      if (cnt > best) best = cnt;
    }
    out[r] = best;
  }
}

// sub-CSR extraction for a row subset (bucket payload build):
// out_indptr must be precomputed (cumsum of selected row lengths).
void csr_extract_rows_f32(const int64_t* indptr, const int32_t* indices,
                          const float* data, const int64_t* rows,
                          int64_t n_sel, const int64_t* out_indptr,
                          int32_t* out_indices, float* out_data) {
#pragma omp parallel for schedule(guided)
  for (int64_t j = 0; j < n_sel; ++j) {
    const int64_t src = indptr[rows[j]];
    const int64_t len = indptr[rows[j] + 1] - src;
    const int64_t dst = out_indptr[j];
    std::memcpy(out_indices + dst, indices + src, len * sizeof(int32_t));
    std::memcpy(out_data + dst, data + src, len * sizeof(float));
  }
}

}  // extern "C"

extern "C" {

// 1 if every value survives f32 -> bf16 -> f32 round-tripping (early-exit)
int32_t f32_bf16_exact(const float* data, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    const float v = data[i];
    uint32_t u;
    std::memcpy(&u, &v, 4);
    const uint32_t r16 = (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
    const uint32_t back = r16 << 16;
    float hv;
    std::memcpy(&hv, &back, 4);
    if (hv != v) return 0;
  }
  return 1;
}

}  // extern "C"

extern "C" {

// Column sums and sums of squares of CSR values, widened to double before
// the product: s[c] += v, sq[c] += v * v for every entry (the fit's column
// statistics). The entries are cut into nb contiguous blocks, nb fixed by
// nnz and p alone (at most 64, partials under ~64 MB); each block adds in
// CSR order into partials of its own, and the partials are summed per
// column in block order. So the result is the same bit for bit whatever
// the thread count, and on integer-valued data (exact in double) it is
// what one sequential pass gives. n_threads 0 is OpenMP's default.
void csr_col_stats_f64(const float* data, const int32_t* indices,
                       int64_t nnz, int64_t p, double* s, double* sq,
                       int32_t n_threads) {
  if (p <= 0) return;
  int64_t nb = std::min<int64_t>(64, std::max<int64_t>(1, nnz / p));
  nb = std::max<int64_t>(1, std::min<int64_t>(nb, (64LL << 20) / (16 * p)));
  // each block zeroes its own partials, on the thread that fills them
  std::unique_ptr<double[]> part(new double[nb * 2 * p]);
  double* parts = part.get();
#ifdef _OPENMP
  const int nt = n_threads > 0 ? n_threads : omp_get_max_threads();
#else
  (void)n_threads;
#endif
#pragma omp parallel for schedule(static) num_threads(nt)
  for (int64_t b = 0; b < nb; ++b) {
    double* ps = parts + b * 2 * p;
    double* pq = ps + p;
    std::memset(ps, 0, 2 * p * sizeof(double));
    const int64_t lo = nnz * b / nb, hi = nnz * (b + 1) / nb;
    for (int64_t i = lo; i < hi; ++i) {
      const double v = data[i];
      ps[indices[i]] += v;
      pq[indices[i]] += v * v;
    }
  }
  const int64_t CH = 2048;
#pragma omp parallel for schedule(static) num_threads(nt)
  for (int64_t c0 = 0; c0 < p; c0 += CH) {
    const int64_t c1 = std::min(c0 + CH, p);
    for (int64_t c = c0; c < c1; ++c) s[c] = sq[c] = 0.0;
    for (int64_t b = 0; b < nb; ++b) {
      const double* ps = parts + b * 2 * p;
      const double* pq = ps + p;
      for (int64_t c = c0; c < c1; ++c) {
        s[c] += ps[c];
        sq[c] += pq[c];
      }
    }
  }
}

}  // extern "C"
