// Deterministic sorted segment sum: hash-grid table gradients in the
// rolled feature-major layout.
//
// Replaces the Pallas `_kernel` of the JAX package
// (ops/bucket_matmul.py::bucket_grad_matmul):
//
//   g[l, k*C + c, s] = sum_{m : key_m = s} w_k(frac_m) * grad[l, c, m]
//
// keys [L, B] int32 ascending per level, fracs [L, D, B] f32 (D = 0 means
// no fracs and weight 1, the XOR backward's use), grads [L, C, B] f32.
// Output [L, K*C, S + E] f32 or bf16, where the E columns after S repeat
// columns 0.. cyclically (the wrap-extension the unroll reduce reads).
//
// What bounds it on the card: bytes.  At the main-path shape (L=16, K=8,
// C=2, B=196608, S=2^19, E=4224) it reads 75.5 MB (keys, fracs, grads)
// and writes the 541.2 MB table-shaped gradient: ~0.184 ms at 3.35 TB/s.
//
// Design: one thread per (level, output column s).  Because the keys are
// sorted, column s owns the contiguous run [lower_bound(s),
// lower_bound(s+1)) of the stream; the thread finds it by binary search
// (the keys of one level, 786 KB, stay in L2), sums it in stream order in
// f32 and writes all K*C rows of column s, plus the wrapped copies at
// S + s, S + s + S, ... below S + E.  No atomics: every output element
// has one writer and a fixed summation order, so the result is bitwise
// reproducible (the TPU kernel's per-bucket one-hot MXU products were its
// way to a deterministic scatter).  Neighbouring threads write
// neighbouring columns, so the stores -- most of the bytes -- coalesce.
// A duplicate-heavy stream, where one column owns a long run, makes that
// one thread loop serially over the run; it stays exact.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// First index in keys[0, n) whose key is >= target.
__device__ __forceinline__ long long lower_bound(const int* __restrict__ keys,
                                                 long long n, long long target) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)keys[mid] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int D, int C, typename OutT>
__global__ void bucket_kernel(const int* __restrict__ keys,
                              const float* __restrict__ frac,
                              const float* __restrict__ grads,
                              OutT* __restrict__ out, int L, long long B,
                              long long S, long long E) {
  constexpr int K = 1 << D;
  constexpr int F = K * C;
  const long long Se = S + E;
  const long long n = (long long)L * S;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int l = (int)(idx / S);
    const long long s = idx - (long long)l * S;
    const int* kl = keys + (long long)l * B;
    const long long lo = lower_bound(kl, B, s);
    const long long hi = lo + lower_bound(kl + lo, B - lo, s + 1);

    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;

    for (long long m = lo; m < hi; ++m) {
      float w[K];
      if constexpr (D == 0) {
        w[0] = 1.f;
      } else {
        float t[D];
#pragma unroll
        for (int d = 0; d < D; ++d) t[d] = frac[((long long)l * D + d) * B + m];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float wk = 1.f;
#pragma unroll
          for (int d = 0; d < D; ++d)
            wk = __fmul_rn(wk, ((k >> d) & 1) ? t[d] : __fsub_rn(1.f, t[d]));
          w[k] = wk;
        }
      }
      float g[C];
#pragma unroll
      for (int c = 0; c < C; ++c) g[c] = grads[((long long)l * C + c) * B + m];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[k * C + c] = __fadd_rn(acc[k * C + c], __fmul_rn(w[k], g[c]));
    }

    OutT* o = out + (long long)l * F * Se;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const OutT v = cast_out<OutT>(acc[f]);
      o[(long long)f * Se + s] = v;
      for (long long col = S + s; col < Se; col += S) o[(long long)f * Se + col] = v;
    }
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;
  if (blocks > cap) blocks = cap;
  return (int)(blocks > 0 ? blocks : 1);
}

template <int D, int C>
void launch(const void* keys, const void* frac, const void* grads, void* out,
            int out_bf16, int L, long long B, long long S, long long E,
            cudaStream_t st) {
  const int grid = grid_for((long long)L * S);
  if (out_bf16)
    bucket_kernel<D, C, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const int*)keys, (const float*)frac, (const float*)grads,
        (__nv_bfloat16*)out, L, B, S, E);
  else
    bucket_kernel<D, C, float><<<grid, kThreads, 0, st>>>(
        (const int*)keys, (const float*)frac, (const float*)grads, (float*)out,
        L, B, S, E);
}

template <int D>
int launch_c(int C, const void* keys, const void* frac, const void* grads,
             void* out, int out_bf16, int L, long long B, long long S,
             long long E, cudaStream_t st) {
  switch (C) {
    case 1: launch<D, 1>(keys, frac, grads, out, out_bf16, L, B, S, E, st); break;
    case 2: launch<D, 2>(keys, frac, grads, out, out_bf16, L, B, S, E, st); break;
    case 4: launch<D, 4>(keys, frac, grads, out, out_bf16, L, B, S, E, st); break;
    case 8: launch<D, 8>(keys, frac, grads, out, out_bf16, L, B, S, E, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

const char* nvr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// keys [L, B] int32 ascending per level; frac [L, D, B] f32 (unused when
// D == 0); grads [L, C, B] f32; out [L, K*C, S + E] f32 or bf16
// (out_bf16 != 0).  D in {0, 2, 3}, C in {1, 2, 4, 8}.
int nvr_bucket_grad_matmul(const void* keys, const void* frac,
                           const void* grads, void* out, int out_bf16, int L,
                           int D, int C, long long B, long long S, long long E,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)L * S == 0) return (int)cudaGetLastError();
  int rc;
  switch (D) {
    case 0: rc = launch_c<0>(C, keys, frac, grads, out, out_bf16, L, B, S, E, st); break;
    case 2: rc = launch_c<2>(C, keys, frac, grads, out, out_bf16, L, B, S, E, st); break;
    case 3: rc = launch_c<3>(C, keys, frac, grads, out, out_bf16, L, B, S, E, st); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
