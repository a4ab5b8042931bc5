// Native host-side graph builder: COO -> CSR construction and Matrix
// Market body parsing. Counterpart of the reference's
// OpenMP-parallel host CSR build (gunrock/csr.cuh:534-697, sort at
// util/sort_omp.cuh) and .mtx reader (gunrock/graphio/market.cuh:192).
//
// Exposed as a C ABI consumed via ctypes (gunrock_jax/graph/native.py);
// the Python layer falls back to numpy when this library is unavailable.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC \
//            -o libgunrock_host.so graph_builder.cpp

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// COO -> CSR.
//
// Input: e edges (src, dst[, vals]) over n vertices. Behavior mirrors
// gunrock's Csr::FromCoo: optional self-loop removal; output CSR is
// fully sorted by (src, dst) with ties broken by input order, so a
// subsequent gr_csr_dedup keeps the first-listed duplicate's value
// (matching the numpy fallback's stable lexsort semantics). Returns the
// post-filter edge count, or -1 on error.
//
// row_offsets: n+1 int64 (caller-allocated)
// col_out:     e int32   (caller-allocated; only first <return> valid)
// val_out:     e float   (may be null iff vals is null)
int64_t gr_coo_to_csr(int64_t n, int64_t e,
                      const int32_t* src, const int32_t* dst,
                      const float* vals,
                      int remove_self_loops,
                      int64_t* row_offsets, int32_t* col_out,
                      float* val_out) {
  if (n < 0 || e < 0) return -1;

  // Pass 1: per-row counts (parallel histogram with per-thread bins).
  std::vector<int64_t> counts(static_cast<size_t>(n) + 1, 0);
#pragma omp parallel
  {
    std::vector<int64_t> local(static_cast<size_t>(n) + 1, 0);
#pragma omp for nowait
    for (int64_t i = 0; i < e; ++i) {
      int32_t s = src[i], d = dst[i];
      if (s < 0 || s >= n || d < 0 || d >= n) continue;
      if (remove_self_loops && s == d) continue;
      ++local[s];
    }
#pragma omp critical
    for (int64_t v = 0; v <= n; ++v) counts[v] += local[v];
  }

  row_offsets[0] = 0;
  for (int64_t v = 0; v < n; ++v) row_offsets[v + 1] = row_offsets[v] + counts[v];

  // Pass 2: scatter into rows (atomic per-row cursor).
  std::vector<std::atomic<int64_t>> cursor(static_cast<size_t>(n));
  for (int64_t v = 0; v < n; ++v)
    cursor[v].store(row_offsets[v], std::memory_order_relaxed);

  // Temporary per-edge (dst, original index) pairs so values follow the sort.
  std::vector<int64_t> order(static_cast<size_t>(row_offsets[n]));
#pragma omp parallel for
  for (int64_t i = 0; i < e; ++i) {
    int32_t s = src[i], d = dst[i];
    if (s < 0 || s >= n || d < 0 || d >= n) continue;
    if (remove_self_loops && s == d) continue;
    int64_t pos = cursor[s].fetch_add(1, std::memory_order_relaxed);
    col_out[pos] = d;
    order[pos] = i;
  }

  // Pass 3: sort each row by (dst, original index) — stable w.r.t. input
  // order so "first duplicate wins" matches the numpy/lexsort fallback.
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t v = 0; v < n; ++v) {
    int64_t lo = row_offsets[v], hi = row_offsets[v + 1];
    if (hi - lo < 2) continue;
    // indirect sort of [lo, hi) on (col, order)
    std::vector<int64_t> idx(hi - lo);
    for (int64_t k = 0; k < hi - lo; ++k) idx[k] = k;
    std::sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
      if (col_out[lo + a] != col_out[lo + b])
        return col_out[lo + a] < col_out[lo + b];
      return order[lo + a] < order[lo + b];
    });
    std::vector<int32_t> ctmp(hi - lo);
    std::vector<int64_t> otmp(hi - lo);
    for (int64_t k = 0; k < hi - lo; ++k) {
      ctmp[k] = col_out[lo + idx[k]];
      otmp[k] = order[lo + idx[k]];
    }
    std::memcpy(col_out + lo, ctmp.data(), ctmp.size() * sizeof(int32_t));
    std::memcpy(order.data() + lo, otmp.data(), otmp.size() * sizeof(int64_t));
  }

  // Pass 4: gather values into sorted order.
  int64_t out = row_offsets[n];
  if (val_out && vals) {
#pragma omp parallel for
    for (int64_t k = 0; k < out; ++k) val_out[k] = vals[order[k]];
  }
  return out;
}

// Duplicate-edge removal over a sorted CSR (first duplicate's value
// wins, matching Csr::FromCoo). Returns new edge count;
// row_offsets/col/val updated in place.
int64_t gr_csr_dedup(int64_t n, int64_t* row_offsets, int32_t* col,
                     float* val) {
  // Forward compaction: reads always stay ahead of writes.
  int64_t out = 0;
  int64_t read_lo = row_offsets[0];
  for (int64_t v = 0; v < n; ++v) {
    int64_t lo = read_lo, hi = row_offsets[v + 1];
    read_lo = hi;
    int64_t start = out;
    int32_t last = -1;
    for (int64_t k = lo; k < hi; ++k) {
      if (k > lo && col[k] == last) continue;
      last = col[k];
      col[out] = col[k];
      if (val) val[out] = val[k];
      ++out;
    }
    row_offsets[v] = start;
  }
  row_offsets[n] = out;
  return out;
}

// ---------------------------------------------------------------------------
// Matrix Market body parser: integer triples "r c [w]" per line, 1-based.
// buf/len is the body after the size line. Fills src/dst (0-based) and
// vals (1.0 when the file has no weight column). Returns parsed edge
// count, or -1 on malformed input. Parallel: the buffer is split into
// chunks aligned to line breaks; each thread counts then fills its slice.
int64_t gr_parse_market_body(const char* buf, int64_t len, int64_t nnz_max,
                             int has_values, int32_t* src, int32_t* dst,
                             float* vals) {
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  std::vector<int64_t> chunk_start(nthreads + 1, 0);
  for (int t = 1; t < nthreads; ++t) {
    int64_t p = len * t / nthreads;
    while (p < len && buf[p] != '\n') ++p;
    chunk_start[t] = (p < len) ? p + 1 : len;
  }
  chunk_start[nthreads] = len;

  std::vector<int64_t> counts(nthreads, 0);
#pragma omp parallel num_threads(nthreads)
  {
#ifdef _OPENMP
    int t = omp_get_thread_num();
#else
    int t = 0;
#endif
    int64_t c = 0;
    for (int64_t p = chunk_start[t]; p < chunk_start[t + 1]; ++p)
      if (buf[p] == '\n') ++c;
    if (chunk_start[t + 1] == len && len > 0 && buf[len - 1] != '\n') ++c;
    counts[t] = c;
  }
  std::vector<int64_t> offs(nthreads + 1, 0);
  for (int t = 0; t < nthreads; ++t) offs[t + 1] = offs[t] + counts[t];
  if (offs[nthreads] > nnz_max) return -1;

  std::atomic<int64_t> bad{0};
#pragma omp parallel num_threads(nthreads)
  {
#ifdef _OPENMP
    int t = omp_get_thread_num();
#else
    int t = 0;
#endif
    int64_t w = offs[t];
    const char* p = buf + chunk_start[t];
    const char* end = buf + chunk_start[t + 1];
    while (p < end) {
      // skip whitespace/newlines
      while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
        ++p;
      if (p >= end) break;
      if (*p == '%') {  // comment line
        while (p < end && *p != '\n') ++p;
        continue;
      }
      auto parse_int = [&](int64_t& v) -> bool {
        bool neg = false;
        if (p < end && (*p == '-' || *p == '+')) neg = (*p++ == '-');
        if (p >= end || !isdigit((unsigned char)*p)) return false;
        int64_t x = 0;
        while (p < end && isdigit((unsigned char)*p)) x = x * 10 + (*p++ - '0');
        v = neg ? -x : x;
        return true;
      };
      int64_t r, c;
      if (!parse_int(r)) { bad.store(1); break; }
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
      if (!parse_int(c)) { bad.store(1); break; }
      double wgt = 1.0;
      if (has_values) {
        while (p < end && (*p == ' ' || *p == '\t')) ++p;
        char* endp = nullptr;
        wgt = strtod(p, &endp);
        if (endp == p) wgt = 1.0;
        else p = endp;
      }
      // skip to end of line
      while (p < end && *p != '\n') ++p;
      src[w] = static_cast<int32_t>(r - 1);
      dst[w] = static_cast<int32_t>(c - 1);
      if (vals) vals[w] = static_cast<float>(wgt);
      ++w;
    }
    counts[t] = w - offs[t];
  }
  if (bad.load()) return -1;

  // Compact per-thread slices (threads may parse fewer lines than counted
  // if trailing blanks/comments). Serial memmove, usually no-op.
  int64_t out = counts[0] + offs[0] - offs[0];
  out = counts[0];
  for (int t = 1; t < nthreads; ++t) {
    if (counts[t] == 0) continue;
    if (offs[t] != out) {
      std::memmove(src + out, src + offs[t], counts[t] * sizeof(int32_t));
      std::memmove(dst + out, dst + offs[t], counts[t] * sizeof(int32_t));
      if (vals)
        std::memmove(vals + out, vals + offs[t], counts[t] * sizeof(float));
    }
    out += counts[t];
  }
  return out;
}

int gr_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
