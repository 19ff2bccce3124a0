// Direct scatter-add of one hash-grid level's updates into its table.
//
// Replaces the Pallas `pallas_scatter_level` kernel of the encoder
// microbenchmark (scripts/microbench_encoder.py::pallas_scatter_level):
//
//   out[j, :] = sum_{i : idx[i] = j} pay[i, :]
//
// idx [N] int32 in [0, S), pay [N, C] f32 with C in {1, 2, 4}, out [S, C]
// f32.  An index outside [0, S) is skipped (never written out of bounds).
//
// What bounds it on the card: bytes.  At the microbenchmark's shape
// (N = 1,572,864, S = 2^19, C = 2) it reads N * (4 + 4C) = 18.9 MB and
// writes the 4.2 MB table: ~0.0069 ms at 3.35 TB/s.  The real limit is the
// rate of atomics on L2, where the whole 4 MB table stays.
//
// Design: a zero fill (cudaMemsetAsync), then one thread per update, which
// adds its C values into row idx[i] with one vector atomicAdd (float2 /
// float4 atomics exist for global memory on sm_90; C = 1 uses the scalar
// one).  Four updates a thread (an int4 of indices, float4 payload loads,
// four atomics in flight) takes the same ~0.020 ms on the device for the
// 1.57M float2 updates on an H100 (700 W): the L2's rate of atomics on
// random rows sets the time, not the loads.  The TPU kernel walked 32,768-update chunks in a serial loop over
// a whole-table VMEM block; both are artefacts of that machine and are
// not carried over.
//
// Order of the sums: the atomics land in no fixed order, so a column's
// sum is not bitwise reproducible in general.  With about three updates
// per column at these shapes, the kernel agrees with the plain version
// (index_add_) to rtol/atol 1e-5 on normal payloads, and is bit-equal on
// integer-valued payloads, whose sums are exact in any order (including a
// 700-update column of integers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int C>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

template <int C>
__global__ void scatter_kernel(const int* __restrict__ idx,
                               const float* __restrict__ pay,
                               float* __restrict__ out, long long N,
                               long long S) {
  using V = typename Vec<C>::T;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < N;
       i += (long long)gridDim.x * blockDim.x) {
    const int j = idx[i];
    if (j < 0 || (long long)j >= S) continue;
    const V v = reinterpret_cast<const V*>(pay)[i];
    atomicAdd(reinterpret_cast<V*>(out) + j, v);
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;
  if (blocks > cap) blocks = cap;
  return (int)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" {

const char* nvr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// idx [N] int32; pay [N, C] f32 (16-byte aligned rows for C = 4, 8-byte
// for C = 2); out [S, C] f32, zero-filled here.  C in {1, 2, 4}.
int nvr_scatter_level(const void* idx, const void* pay, void* out, int C,
                      long long N, long long S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C != 1 && C != 2 && C != 4) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)S * C * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return (int)cudaGetLastError();
  const int grid = grid_for(N);
  switch (C) {
    case 1:
      scatter_kernel<1><<<grid, kThreads, 0, st>>>(
          (const int*)idx, (const float*)pay, (float*)out, N, S);
      break;
    case 2:
      scatter_kernel<2><<<grid, kThreads, 0, st>>>(
          (const int*)idx, (const float*)pay, (float*)out, N, S);
      break;
    default:
      scatter_kernel<4><<<grid, kThreads, 0, st>>>(
          (const int*)idx, (const float*)pay, (float*)out, N, S);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
