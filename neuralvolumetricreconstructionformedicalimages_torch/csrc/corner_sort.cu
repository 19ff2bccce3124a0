// The XOR backward's corner stream, sorted once (ops/hash_encoding.py::
// sorted_corner_stream): the keys and the payload the bucket kernel sums
// at D = 0.
//
// They replace torch.sort (16 stable per-level sorts with int64 stream
// positions) and the payload gather through those positions.  The JAX
// package has no Pallas kernel for this work: it sorts with XLA's sort
// and gathers with XLA ops.
//
//   corner_keys_kernel: idx [B, L, 8] int32 (as xor_index_kernel writes
//     it), w [B, L, 8] and g [B, L, 2] f32 -> slot l*N + n, n = b*8 + k,
//     N = B*8, gets the key (l << sbits) | idx[b, l, k] (sbits = log2 S),
//     the value n and the payload pay[l, n] = (w[b, l, k] * g[b, l, 0],
//     w[b, l, k] * g[b, l, 1]) (one f32 multiply each, the plain
//     version's, so the payload is bit-equal).
//   cub::DeviceRadixSort::SortPairs over bits [0, ceil(log2 L) + sbits)
//     (23 at L = 16, S = 2^19: three passes of 8, 8 and 7 bits), uint32
//     keys, int32 values, in a pair of double buffers.  Every level has
//     exactly N entries, so level l's run is [l*N, (l+1)*N), ascending by
//     row; the passes are stable, so ties keep stream order, as
//     torch.sort(stable=True) keeps them.
//   corner_payload_kernel: sorted slot j of level l, i = j - l*N, with
//     value n -> sk[j] = key & (S - 1) (over the key, in place) and
//     sg[l, c, i] = pay[l, n].c, written over the two buffers the sort
//     left free (the other keys and values), so the four sort buffers end
//     as sk and sg and the payload is the only other array.
//
// What bounds them: bytes.  At B = 196,608, L = 16 (25,165,824 slots):
// the key kernel reads idx, w and g (226.5 MB) and writes keys, values and
// payload (402.7 MB); each of the sort's three passes reads and writes 8
// bytes a slot (402.7 MB), plus one read of the keys for its histograms;
// the payload kernel reads the sorted keys and values (201.3 MB) and the
// payload (201.3 MB), and writes sk (100.7 MB) and sg (201.3 MB).  About
// 2.75 GB, 0.82 ms at 3.35 TB/s; the least traffic for the function (idx,
// w, g read once, sk and sg written once) is 529 MB, 0.16 ms.
//
// The key kernel transposes [B, L] to [L, B] through shared memory, a
// tile of 16 points at a time, so that both its loads and its stores are
// contiguous runs.  One thread a (point, level) in output order made every
// load a 32-byte sector 32 * L bytes from the next (0.16 ms for the keys
// and values alone, 0.44 ms with the payload); in input order it made
// every store one (0.40 ms with the payload; NVIDIA H100 80GB HBM3).
//
// Why the payload kernel walks level-major: it reads the payload out of
// order (by stream position within a level).  One thread a sorted slot,
// in slot order, so the blocks in flight lie within one level, whose
// slice of the payload (8 bytes a slot, 12.6 MB, dense) stays in the 50
// MB L2 while the level's run is read: each of its sectors comes from
// device memory about once.  Gathering w and g themselves there (4 and 8
// bytes at random, their level's slices spread over the whole [B, L, *]
// arrays) took 0.54 ms; from level-major copies of w and g 0.31 ms; from
// the payload 0.27 ms (NVIDIA H100 80GB HBM3).

#include <cub/device/device_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Bits of the composite key: the level's ceil(log2 L) above sbits.
int key_bits(int L, int sbits) {
  int lb = 0;
  while ((1 << lb) < L) ++lb;
  return lb + sbits;
}

// A block a tile of kTile points x L levels: the tile's idx, w and g are
// one contiguous run each, loaded with 16-byte loads into shared memory;
// then each level's keys, values (kTile * 32 bytes) and payload (kTile *
// 64 bytes) are stored as contiguous rows, a warp's 16-byte stores one
// run.  Rows of idx and w in shared memory are padded by 32 bytes, so a
// quarter warp's 16-byte reads of eight (point, half) pairs hit distinct
// banks.
constexpr int kTile = 16;
constexpr int kMaxLevels = 32;
constexpr int kRow = kMaxLevels * 8 + 8;   // ints a point's row, padded

__global__ void corner_keys_kernel(const int4* __restrict__ idx,
                                   const float4* __restrict__ w,
                                   const float2* __restrict__ g,
                                   uint4* __restrict__ keys,
                                   int4* __restrict__ vals,
                                   float4* __restrict__ pay, int L, uint32_t B,
                                   int sbits) {
  __shared__ __align__(16) int s_idx[kTile * kRow];
  __shared__ __align__(16) float s_w[kTile * kRow];
  __shared__ float2 s_g[kTile * kMaxLevels];
  const uint32_t b0 = blockIdx.x * kTile;
  const int P = (int)min((uint32_t)kTile, B - b0);
  const int q2 = 2 * L;                      // 16-byte pieces a point's row
  for (int q = threadIdx.x; q < P * q2; q += blockDim.x) {
    const int p = q / q2, r = q - p * q2;
    const size_t src = (size_t)b0 * q2 + q;
    *(int4*)(s_idx + p * kRow + r * 4) = __ldg(idx + src);
    *(float4*)(s_w + p * kRow + r * 4) = __ldg(w + src);
  }
  for (int q = threadIdx.x; q < P * L; q += blockDim.x)
    s_g[q] = __ldg(g + (size_t)b0 * L + q);
  __syncthreads();
  const uint32_t N = B * 8;
  // keys and values: 2 * kTile pieces a level's row
  for (int u = threadIdx.x; u < L * 2 * kTile; u += blockDim.x) {
    const int l = u / (2 * kTile), r = u - l * 2 * kTile, p = r >> 1, h = r & 1;
    if (p >= P) continue;
    const int4 a = *(const int4*)(s_idx + p * kRow + l * 8 + h * 4);
    const uint32_t hi = (uint32_t)l << sbits;
    const size_t dst = ((size_t)l * N + (size_t)(b0 + p) * 8 + h * 4) / 4;
    keys[dst] = make_uint4(hi | (uint32_t)a.x, hi | (uint32_t)a.y,
                           hi | (uint32_t)a.z, hi | (uint32_t)a.w);
    const int m = (int)((b0 + p) * 8 + h * 4);
    vals[dst] = make_int4(m, m + 1, m + 2, m + 3);
  }
  // payload: 4 * kTile pieces (two corners each) a level's row
  for (int u = threadIdx.x; u < L * 4 * kTile; u += blockDim.x) {
    const int l = u / (4 * kTile), r = u - l * 4 * kTile, p = r >> 2, k = (r & 3) * 2;
    if (p >= P) continue;
    const float w0 = s_w[p * kRow + l * 8 + k], w1 = s_w[p * kRow + l * 8 + k + 1];
    const float2 gv = s_g[p * L + l];
    pay[((size_t)l * N + (size_t)(b0 + p) * 8 + k) / 2] =
        make_float4(__fmul_rn(w0, gv.x), __fmul_rn(w0, gv.y), __fmul_rn(w1, gv.x),
                    __fmul_rn(w1, gv.y));
  }
}

// One thread a sorted slot (fewer than 2^31 of them, so 32-bit index
// math).  keys and sk are one buffer (no __restrict__ on either): each
// slot is read and then written by its own thread.
__global__ void corner_payload_kernel(const uint32_t* keys,
                                      const int* __restrict__ vals,
                                      const float2* __restrict__ pay, int* sk,
                                      float* __restrict__ sg, int L, uint32_t N,
                                      uint32_t mask) {
  const uint32_t n = (uint32_t)L * N;
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const uint32_t l = j / N, i = j - l * N;
    const float2 v = __ldg(pay + (size_t)l * N + (uint32_t)vals[j]);
    sk[j] = (int)(keys[j] & mask);
    sg[(size_t)l * 2 * N + i] = v.x;
    sg[((size_t)l * 2 + 1) * N + i] = v.y;
  }
}

// One thread an item: at most 2^31 / 256 blocks.
int blocks_for(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* nvr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The sort's scratch bytes for n slots of L levels at sbits = log2 S,
// written as int64 to the host address `bytes`.
int nvr_corner_sort_scratch(long long n, int L, int sbits, void* bytes,
                            void* stream) {
  if (n < 0 || n > 0x7fffffffLL || L <= 0 || sbits <= 0 || key_bits(L, sbits) > 31)
    return (int)cudaErrorInvalidValue;
  size_t temp = 0;
  cub::DoubleBuffer<uint32_t> dk(nullptr, nullptr);
  cub::DoubleBuffer<int> dv(nullptr, nullptr);
  cudaError_t e = cub::DeviceRadixSort::SortPairs(
      nullptr, temp, dk, dv, (int)n, 0, key_bits(L, sbits), (cudaStream_t)stream);
  *(long long*)bytes = (long long)temp;
  return (int)e;
}

// idx [B, L, 8] int32, w [B, L, 8] f32 and g [B, L, 2] f32, contiguous
// and 16-byte aligned (g 8-byte), L <= 32; buf [4, L * B * 8] int32, the
// sort's keys, values, other keys and other values in that order; pay [L,
// B*8, 2] f32 scratch; temp of temp_bytes (nvr_corner_sort_scratch).  Each
// idx in [0, 2^sbits); ceil(log2 L) + sbits <= 31; L * B * 8 < 2^31.
// Writes to the host int at `selector` which pair of buf holds the result:
// 0 -> sk [L, B*8] int32 in buf[0] and sg [L, 2, B*8] f32 in buf[2:4]; 1 ->
// sk in buf[2] and sg in buf[0:2].
int nvr_corner_sort(const void* idx, const void* w, const void* g, void* buf,
                    void* pay, void* temp, long long temp_bytes, void* selector,
                    int L, long long B, int sbits, void* stream) {
  const long long N = B * 8, n = (long long)L * N;
  if (L <= 0 || L > kMaxLevels || B < 0 || n > 0x7fffffffLL || sbits <= 0 ||
      key_bits(L, sbits) > 31 ||
      ((uintptr_t)idx | (uintptr_t)w | (uintptr_t)buf | (uintptr_t)pay) % 16 != 0 ||
      (uintptr_t)g % 8 != 0)
    return (int)cudaErrorInvalidValue;
  *(int*)selector = 0;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  uint32_t* k0 = (uint32_t*)buf;
  int* v0 = (int*)buf + n;
  corner_keys_kernel<<<(int)((B + kTile - 1) / kTile), kThreads, 0, s>>>(
      (const int4*)idx, (const float4*)w, (const float2*)g, (uint4*)k0, (int4*)v0,
      (float4*)pay, L, (uint32_t)B, sbits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cub::DoubleBuffer<uint32_t> dk(k0, k0 + 2 * n);
  cub::DoubleBuffer<int> dv(v0, v0 + 2 * n);
  size_t tb = (size_t)temp_bytes;
  e = cub::DeviceRadixSort::SortPairs(temp, tb, dk, dv, (int)n, 0,
                                      key_bits(L, sbits), s);
  if (e != cudaSuccess) return (int)e;
  if (dk.selector != dv.selector) return (int)cudaErrorUnknown;
  *(int*)selector = dk.selector;
  corner_payload_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      dk.Current(), dv.Current(), (const float2*)pay, (int*)dk.Current(),
      (float*)dk.Alternate(), L, (uint32_t)N, (1u << sbits) - 1u);
  return (int)cudaGetLastError();
}

}  // extern "C"
