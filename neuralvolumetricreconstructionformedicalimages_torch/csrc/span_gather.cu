// Sorted span gather: trilinear hash-grid features over a per-level
// ascending key stream.
//
// Replaces the Pallas `_kernel` of the JAX package
// (ops/span_gather.py::span_gather_sorted):
//
//   out[l, c, i] = sum_k w_k(frac_i) * R[l, k*C + c, key_i]
//
// with R the feature-major rolled table [L, K*C, S] (f32 or bf16), keys
// [L, B] int32 ascending per level, and fracs either [L, D, B] f32 or
// [L, 1, B] int32 packed 11/11/10-bit (D = 3).  Output [L, C, B] f32.
//
// What bounds it on the card: bytes.  At the main-path shape (L=16, K=8,
// C=2, B=196608, S=2^19, bf16 table, packed fracs) it reads 12.6 MB of
// keys, 12.6 MB of fracs and at most 100.7 MB of distinct table rows, and
// writes 25.2 MB: at most ~151 MB, ~0.045 ms at 3.35 TB/s.
//
// Design: one thread per (level, sorted point).  The TPU kernel streamed
// table spans through VMEM and selected rows with one-hot MXU products
// because the TPU has no gather unit; the GPU gathers directly.  Because
// the stream is sorted, the 32 points of a warp hold nearby keys, so each
// of the K*C row reads (stride S apart in this layout) touches few
// sectors and neighbouring warps hit the same lines in L2.  Weights are
// formed in the order of the TPU kernel (w_k = prod_d (bit ? f : 1-f)) and
// the corners are summed in k order in f32, with __fmul_rn/__fadd_rn so
// that the compiler does not fuse them into multiply-adds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TabT, int D, bool PACKED>
__global__ void span_gather_kernel(const int* __restrict__ keys,
                                   const void* __restrict__ frac_raw,
                                   const TabT* __restrict__ tab,
                                   float* __restrict__ out, int L, int C,
                                   long long B, long long S) {
  constexpr int K = 1 << D;
  const long long n = (long long)L * B;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int l = (int)(idx / B);
    const long long i = idx - (long long)l * B;
    const long long key = keys[idx];

    float f[D > 0 ? D : 1];
    if constexpr (PACKED) {
      const uint32_t pk = ((const uint32_t*)frac_raw)[idx];
      f[0] = (float)(pk & 2047u) * (float)(1.0 / 2047.0);
      f[1] = (float)((pk >> 11) & 2047u) * (float)(1.0 / 2047.0);
      f[2] = (float)((pk >> 22) & 1023u) * (float)(1.0 / 1023.0);
    } else {
      const float* fr = (const float*)frac_raw;
#pragma unroll
      for (int d = 0; d < D; ++d) f[d] = fr[((long long)l * D + d) * B + i];
    }

    float w[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float wk = 1.f;
#pragma unroll
      for (int d = 0; d < D; ++d)
        wk = __fmul_rn(wk, ((k >> d) & 1) ? f[d] : __fsub_rn(1.f, f[d]));
      w[k] = wk;
    }

    const TabT* col = tab + (long long)l * K * C * S + key;
    for (int c = 0; c < C; ++c) {
      float acc = __fmul_rn(w[0], to_f32(col[(long long)c * S]));
#pragma unroll
      for (int k = 1; k < K; ++k)
        acc = __fadd_rn(acc,
                        __fmul_rn(w[k], to_f32(col[(long long)(k * C + c) * S])));
      out[((long long)l * C + c) * B + i] = acc;
    }
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;
  if (blocks > cap) blocks = cap;
  return (int)(blocks > 0 ? blocks : 1);
}

template <typename TabT, int D, bool PACKED>
void launch(const void* keys, const void* frac, const void* tab, void* out,
            int L, int C, long long B, long long S, cudaStream_t st) {
  span_gather_kernel<TabT, D, PACKED>
      <<<grid_for((long long)L * B), kThreads, 0, st>>>(
          (const int*)keys, frac, (const TabT*)tab, (float*)out, L, C, B, S);
}

}  // namespace

extern "C" {

const char* nvr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// keys [L, B] int32 in [0, S); frac [L, D, B] f32 or, with packed != 0,
// [L, B] int32 (D must be 3); tab [L, K*C, S] f32 or bf16 (tab_bf16 != 0);
// out [L, C, B] f32.  D in {1, 2, 3}.
int nvr_span_gather_sorted(const void* keys, const void* frac, const void* tab,
                           void* out, int packed, int tab_bf16, int L, int D,
                           int C, long long B, long long S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)L * B == 0) return (int)cudaGetLastError();
#define NVR_SPAN(T)                                                         \
  if (packed) {                                                             \
    if (D != 3) return (int)cudaErrorInvalidValue;                          \
    launch<T, 3, true>(keys, frac, tab, out, L, C, B, S, st);               \
  } else if (D == 3) {                                                      \
    launch<T, 3, false>(keys, frac, tab, out, L, C, B, S, st);              \
  } else if (D == 2) {                                                      \
    launch<T, 2, false>(keys, frac, tab, out, L, C, B, S, st);              \
  } else if (D == 1) {                                                      \
    launch<T, 1, false>(keys, frac, tab, out, L, C, B, S, st);              \
  } else {                                                                  \
    return (int)cudaErrorInvalidValue;                                      \
  }
  if (tab_bf16) {
    NVR_SPAN(__nv_bfloat16)
  } else {
    NVR_SPAN(float)
  }
#undef NVR_SPAN
  return (int)cudaGetLastError();
}

}  // extern "C"
