// Corner-roll kernels: canonical <-> feature-major rolled hash tables.
//
// Replaces the Pallas `_roll_kernel` of the JAX package
// (ops/roll_kernels.py::roll_broadcast_fm, reduce=False, and
// ops/roll_kernels.py::unroll_reduce_fm, reduce=True).
//
//   roll_broadcast_fm:  R[l, k*C+c, s] = T[l, (s + off[l,k]) % S, c]
//                       (cast to the table dtype, bf16 on the main path)
//   unroll_reduce_fm:   out[l, j, c] = sum_k G[l, k*C+c, (j - off[l,k]) % S]
//                       (f32, summed in k order 0..K-1)
//
// What bounds them on the card: bytes.  Both are pure data movement with
// no reuse beyond the K-fold read of the canonical side.  At the main-path
// shape (L=16, K=8, C=2, S=2^19) the build reads 67.1 MB and writes
// 268.4 MB of bf16 (~0.100 ms at 3.35 TB/s); the reduce reads the 541.2 MB
// wrap-extended f32 gradient and writes 67.1 MB (~0.182 ms).
//
// Design: one thread per (level, corner, column) for the build and one per
// (level, column) for the reduce, in a grid-stride loop.  Neighbouring
// threads take neighbouring columns, so every store (build) and every load
// (reduce) of a warp is one contiguous run; the shifted side is contiguous
// too except where the roll wraps.  The TPU kernel's 128-aligned windows
// and wrap-extension (_PAD) exist for DMA alignment and are not carried
// over: the modulo is taken per element, so any S works.  The build rounds
// with __float2bfloat16_rn (round to nearest even), as a PyTorch cast does.

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

template <typename OutT>
__global__ void roll_broadcast_kernel(const float* __restrict__ table,
                                      const int* __restrict__ offs,
                                      OutT* __restrict__ out, int L, int K,
                                      int C, long long S) {
  const long long n = (long long)L * K * S;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long s = idx % S;
    const long long lk = idx / S;  // l * K + k
    const int l = (int)(lk / K);
    long long src = s + offs[lk];
    if (src >= S) src -= S;
    const float* row = table + ((long long)l * S + src) * C;
    OutT* o = out + lk * C * S + s;  // row (l, k*C + 0), column s
    for (int c = 0; c < C; ++c) o[c * S] = cast_out<OutT>(row[c]);
  }
}

__global__ void unroll_reduce_kernel(const float* __restrict__ grad,
                                     const int* __restrict__ offs,
                                     float* __restrict__ out, int L, int K,
                                     int C, long long S, long long Se) {
  const long long n = (long long)L * S;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const long long j = idx % S;
    const int l = (int)(idx / S);
    for (int c = 0; c < C; ++c) {
      float acc = 0.f;
      for (int k = 0; k < K; ++k) {
        long long col = j - offs[l * K + k];
        if (col < 0) col += S;
        const float v = grad[((long long)l * K * C + k * C + c) * Se + col];
        acc = (k == 0) ? v : __fadd_rn(acc, v);
      }
      out[((long long)l * S + j) * C + c] = acc;
    }
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;  // grid-stride beyond ~64 blocks per SM
  if (blocks > cap) blocks = cap;
  return (int)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" {

const char* nvr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// table [L, S, C] f32; offs [L, K] int32 in [0, S); out [L, K*C, S] f32 or
// bf16 (out_bf16 != 0).
int nvr_roll_broadcast_fm(const void* table, const void* offs, void* out,
                          int out_bf16, int L, int K, int C, long long S,
                          void* stream) {
  const long long n = (long long)L * K * S;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) return (int)cudaGetLastError();
  if (out_bf16)
    roll_broadcast_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, st>>>(
        (const float*)table, (const int*)offs, (__nv_bfloat16*)out, L, K, C, S);
  else
    roll_broadcast_kernel<float><<<grid_for(n), kThreads, 0, st>>>(
        (const float*)table, (const int*)offs, (float*)out, L, K, C, S);
  return (int)cudaGetLastError();
}

// grad [L, K*C, Se] f32 with Se >= S (columns >= S are never read);
// offs [L, K] int32 in [0, S); out [L, S, C] f32.
int nvr_unroll_reduce_fm(const void* grad, const void* offs, void* out, int L,
                         int K, int C, long long S, long long Se,
                         void* stream) {
  const long long n = (long long)L * S;
  if (n == 0) return (int)cudaGetLastError();
  unroll_reduce_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)grad, (const int*)offs, (float*)out, L, K, C, S, Se);
  return (int)cudaGetLastError();
}

}  // extern "C"
