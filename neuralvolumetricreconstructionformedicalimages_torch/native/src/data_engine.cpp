// Host data engine: beam masks and valid-pixel pools in C++.
//
// The port's own copy of the JAX package's native/src/data_engine.cpp,
// with the same C ABI.  It keeps dataset ingestion (per-view valid-pixel
// pool construction, ptycho beam masks) off the Python interpreter for
// large real-detector scans (e.g. 187 views x 1024^2).  The training
// step itself runs on the card; this library runs once, at load.
//
// Exposed as a plain C ABI consumed via ctypes.
// Build: see ../build.py (g++ -O3 -shared -fPIC [-fopenmp]).

#include <cstdint>
#include <cstring>
#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// Ptycho beam mask (metrics.get_ptycho_mask, per view).
//
// mask = |hr| < thr; then mask[i][j] &= mask[i-1][j] (row pass, computed
// from the pre-pass values), then mask[i][j] &= mask[i][j-1] (column pass
// on the row-updated values); returned INVERTED (1 = keep).  The boolean
// identity a & (a == b) == a & b collapses the equality-AND of the original mask code.
//
// abs_hr: [h*w] float32 magnitudes (caller takes |.| for complex input)
// out:    [h*w] uint8 (1 = keep)
// ---------------------------------------------------------------------
void nvr_ptycho_mask(const float* abs_hr, int64_t h, int64_t w,
                     float thr, uint8_t* out) {
  // pass 0: threshold
  for (int64_t i = 0; i < h * w; ++i) out[i] = abs_hr[i] < thr ? 1 : 0;
  // row pass: bottom-up so each row reads its predecessor's ORIGINAL value
  for (int64_t i = h - 1; i >= 1; --i) {
    uint8_t* row = out + i * w;
    const uint8_t* prev = out + (i - 1) * w;
    for (int64_t j = 0; j < w; ++j) row[j] &= prev[j];
  }
  // column pass: right-to-left within each row (reads row-updated values)
  for (int64_t i = 0; i < h; ++i) {
    uint8_t* row = out + i * w;
    for (int64_t j = w - 1; j >= 1; --j) row[j] &= row[j - 1];
  }
  // invert
  for (int64_t i = 0; i < h * w; ++i) out[i] ^= 1;
}

// Batched masks over n views (independent; parallel over views).
void nvr_ptycho_mask_batch(const float* abs_hr, int64_t n, int64_t h,
                           int64_t w, float thr, uint8_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t v = 0; v < n; ++v) {
    nvr_ptycho_mask(abs_hr + v * h * w, h, w, thr, out + v * h * w);
  }
}

// ---------------------------------------------------------------------
// Valid-pixel pools (static-shaped: padded to a common length).
//
// Pass 1: per-view count of pixels with |proj| > 0.
// ---------------------------------------------------------------------
void nvr_pool_counts(const float* projs, int64_t n, int64_t hw,
                     int32_t* counts) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t v = 0; v < n; ++v) {
    const float* p = projs + v * hw;
    int32_t c = 0;
    for (int64_t i = 0; i < hw; ++i) c += (std::fabs(p[i]) > 0.0f) ? 1 : 0;
    counts[v] = c;
  }
}

// Pass 2: fill pools [n, pool_len] with valid flat indices, padded by
// cyclic repetition; views with zero valid pixels fall back to the full
// pixel set (matching the NumPy path in ../__init__.py).
// counts is updated in-place for the fallback views.
void nvr_fill_pools(const float* projs, int64_t n, int64_t hw,
                    int64_t pool_len, int32_t* pools, int32_t* counts) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t v = 0; v < n; ++v) {
    const float* p = projs + v * hw;
    int32_t* pool = pools + v * pool_len;
    int64_t c = 0;
    for (int64_t i = 0; i < hw && c < pool_len; ++i) {
      if (std::fabs(p[i]) > 0.0f) pool[c++] = static_cast<int32_t>(i);
    }
    if (c == 0) {  // all-invalid view: full pixel set
      int64_t m = hw < pool_len ? hw : pool_len;
      for (int64_t i = 0; i < m; ++i) pool[i] = static_cast<int32_t>(i);
      c = m;
      counts[v] = static_cast<int32_t>(m);
    }
    // cyclic repetition pad
    for (int64_t i = c; i < pool_len; ++i) pool[i] = pool[i - c];
  }
}

// ---------------------------------------------------------------------
// Fused ingest helper: |proj|>0 counts + maximum, in one pass (lets the
// Python side allocate pools of exactly max(counts) without a second
// scan).  Returns the max count.
// ---------------------------------------------------------------------
int32_t nvr_pool_counts_max(const float* projs, int64_t n, int64_t hw,
                            int32_t* counts) {
  nvr_pool_counts(projs, n, hw, counts);
  int32_t mx = 0;
  for (int64_t v = 0; v < n; ++v) mx = counts[v] > mx ? counts[v] : mx;
  return mx;
}

int32_t nvr_version() { return 1; }

}  // extern "C"
