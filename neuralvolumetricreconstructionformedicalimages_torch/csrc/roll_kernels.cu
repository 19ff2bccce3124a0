// Corner-roll kernels: canonical <-> feature-major rolled hash tables.
//
// Replaces the Pallas `_roll_kernel` of the JAX package
// (ops/roll_kernels.py::roll_broadcast_fm, reduce=False, and
// ops/roll_kernels.py::unroll_reduce_fm, reduce=True).
//
//   roll_broadcast_fm:  R[l, k*C+c, s] = T[l, (s + off[l,k]) % S, c]
//                       (cast to the table dtype, bf16 on the main path)
//   unroll_reduce_fm:   out[l, j, c] = sum_k G[l, k*C+c, (j - off[l,k]) % S]
//                       (G f32 or bf16, each value widened to f32, summed
//                       in k order 0..K-1 with __fadd_rn; f32 out)
//
// What bounds them on the card: bytes.  Both are pure data movement with
// no reuse beyond the K-fold read of the canonical side.  At the main-path
// shape (L=16, K=8, C=2, S=2^19) the build reads 67.1 MB and writes
// 268.4 MB of bf16 (~0.100 ms at 3.35 TB/s); the reduce reads the S
// columns of the f32 gradient, 536.9 MB (268.4 MB in bf16, the rolled
// backward's case), and writes 67.1 MB (~0.180 ms, ~0.100 ms in bf16).
//
// Build design: one block row per (level, corner), blockIdx.y = l*K + k,
// so the offset is read once per thread and no index is divided per
// element; the K corners of a level run back to back, and the level's
// 4 MB canonical rows stay in L2 for all K of them.  C = 2, the width of
// every configuration, has its own kernel: a thread takes 4 column pairs
// (2q, 2q + 1), each 512 columns from the last, reads a pair's two
// canonical rows as one float4 (two float2 when the offset is odd) and
// stores each channel's pair as one 4-byte bf16x2 (8-byte float2 in
// f32).  A warp then reads 512 contiguous bytes and stores 128 (bf16)
// contiguous bytes per row, where one thread per element read with
// a stride of C and took a 64-bit % and two / per element.  Only the one
// pair whose second column passes S wraps per element.  Other C, odd S
// and unaligned pointers take the scalar kernel, one thread per column.
// Both round with __float2bfloat16_rn (round to nearest even), as a
// PyTorch cast does, so the build is bit-equal to the plain version.
//
// Reduce design: one thread per (level, column) in a grid-stride loop.
// Neighbouring threads take neighbouring columns, so every load of a warp
// is one contiguous run except where the roll wraps.  The TPU kernel's
// 128-aligned windows and wrap-extension (_PAD) exist for DMA alignment
// and are not carried over: the modulo is taken per element, so any S
// works.

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

constexpr int kPairs = 4;                      // column pairs per thread
constexpr int kPairCols = 2 * kPairs * kThreads;  // columns per block

// Two columns' values of one channel row, stored as one vector.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __halves2bfloat162(__float2bfloat16_rn(a), __float2bfloat16_rn(b));
}

// C = 2, S even, table 16-byte and out 2-element aligned.  blockIdx.y is
// l*K + k; the thread's pairs are q = blockIdx.x*kPairs*kThreads +
// r*kThreads + threadIdx.x, columns 2q and 2q + 1.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    roll_broadcast_kernel_c2(const float* __restrict__ table,
                             const int* __restrict__ offs,
                             OutT* __restrict__ out, int K, long long S) {
  const int lk = blockIdx.y;
  const long long off = offs[lk];
  const float2* __restrict__ tl =
      reinterpret_cast<const float2*>(table) + (long long)(lk / K) * S;
  OutT* __restrict__ o0 = out + (long long)lk * 2 * S;  // row (l, 2k)
  OutT* __restrict__ o1 = o0 + S;                       // row (l, 2k + 1)
  const long long q0 = (long long)blockIdx.x * kPairs * kThreads + threadIdx.x;
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    const long long s = 2 * (q0 + (long long)r * kThreads);
    if (s >= S) break;
    long long src = s + off;
    if (src >= S) src -= S;
    float2 a, b;  // columns s and s + 1: (channel 0, channel 1)
    if (src + 1 == S) {  // the pair that crosses the wrap
      a = tl[src];
      b = tl[0];
    } else if ((src & 1) == 0) {  // the same parity for the whole block
      const float4 v = *reinterpret_cast<const float4*>(tl + src);
      a = make_float2(v.x, v.y);
      b = make_float2(v.z, v.w);
    } else {
      a = tl[src];
      b = tl[src + 1];
    }
    store_pair(o0 + s, a.x, b.x);
    store_pair(o1 + s, a.y, b.y);
  }
}

// Any C and S: one thread per column of one (level, corner) row block.
template <typename OutT>
__global__ void roll_broadcast_kernel(const float* __restrict__ table,
                                      const int* __restrict__ offs,
                                      OutT* __restrict__ out, int K, int C,
                                      long long S) {
  const int lk = blockIdx.y;
  const long long off = offs[lk];
  const float* __restrict__ tl = table + (long long)(lk / K) * S * C;
  OutT* __restrict__ o = out + (long long)lk * C * S;
  for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < S;
       s += (long long)gridDim.x * blockDim.x) {
    long long src = s + off;
    if (src >= S) src -= S;
    for (int c = 0; c < C; ++c)
      o[(long long)c * S + s] = cast_out<OutT>(tl[src * C + c]);
  }
}

template <typename OutT>
void launch_roll(const void* table, const void* offs, void* out, int L, int K,
                 int C, long long S, cudaStream_t st) {
  const bool pairs = C == 2 && S % 2 == 0 && (uintptr_t)table % 16 == 0 &&
                     (uintptr_t)out % (2 * sizeof(OutT)) == 0;
  if (pairs) {
    const dim3 grid((unsigned)((S + kPairCols - 1) / kPairCols), (unsigned)(L * K));
    roll_broadcast_kernel_c2<OutT><<<grid, kThreads, 0, st>>>(
        (const float*)table, (const int*)offs, (OutT*)out, K, S);
  } else {
    long long bx = (S + kThreads - 1) / kThreads;
    if (bx > 4096) bx = 4096;  // grid-stride beyond
    const dim3 grid((unsigned)bx, (unsigned)(L * K));
    roll_broadcast_kernel<OutT><<<grid, kThreads, 0, st>>>(
        (const float*)table, (const int*)offs, (OutT*)out, K, C, S);
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// InT is float or __nv_bfloat16 (the rolled backward's bf16 gradient);
// every value is widened to f32 before the sum, so the result is f32.
template <typename InT>
__global__ void unroll_reduce_kernel(const InT* __restrict__ grad,
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
        const float v =
            to_f32(grad[((long long)l * K * C + k * C + c) * Se + col]);
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
// bf16 (out_bf16 != 0).  L*K below 2^16.
int nvr_roll_broadcast_fm(const void* table, const void* offs, void* out,
                          int out_bf16, int L, int K, int C, long long S,
                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)L * K * S == 0) return (int)cudaGetLastError();
  if ((long long)L * K > 65535) return (int)cudaErrorInvalidValue;
  if (out_bf16)
    launch_roll<__nv_bfloat16>(table, offs, out, L, K, C, S, st);
  else
    launch_roll<float>(table, offs, out, L, K, C, S, st);
  return (int)cudaGetLastError();
}

// grad [L, K*C, Se] f32 or bf16 (grad_bf16 != 0) with Se >= S (columns
// >= S are never read); offs [L, K] int32 in [0, S); out [L, S, C] f32.
int nvr_unroll_reduce_fm(const void* grad, const void* offs, void* out,
                         int grad_bf16, int L, int K, int C, long long S,
                         long long Se, void* stream) {
  const long long n = (long long)L * S;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 0) return (int)cudaGetLastError();
  if (grad_bf16)
    unroll_reduce_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, st>>>(
        (const __nv_bfloat16*)grad, (const int*)offs, (float*)out, L, K, C, S,
        Se);
  else
    unroll_reduce_kernel<float><<<grid_for(n), kThreads, 0, st>>>(
        (const float*)grad, (const int*)offs, (float*)out, L, K, C, S, Se);
  return (int)cudaGetLastError();
}

}  // extern "C"
