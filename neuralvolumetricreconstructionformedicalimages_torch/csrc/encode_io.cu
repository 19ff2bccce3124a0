// The sorted encoder's index, feature-unpack, gradient-transpose and
// gradient-permute kernels: the work around the per-level sort and the
// span gather of ops/span_gather.py::sorted_encode, with packed positions
// (D = 3, C = 2); and the XOR path's index kernel (xor_index_kernel, last).
//
// They replace no TPU kernel.  The JAX package does this work with XLA
// element-wise ops (ops/coherent_hash.py::base_and_frac_t, ops/span_gather.py
// pack_frac_t, the features' unpack, unpack_frac_t and a gather of the
// output gradient); the port first did it with PyTorch ops, which
// materialise int64 and f32 [L, D, B] intermediates (226 MB for one int64
// pass at B = 589,824) where the values to produce are [L, B] int32
// arrays.  The kernels are bound by bytes; each reads its inputs once and
// writes its outputs once.
//
// encode_index_kernel: x [B, 3] f32 in [0, 1] -> base [L, B] int32 (the
// linear hash of the cell's corner 0, masked to S - 1) and pos [L, B]
// int32 (the in-cell position, 11/11/10-bit fixed point).  One thread a
// point, looping over the levels: x is read once (12 bytes a point), and
// each level's two stores are coalesced.  Bit-equal to base_and_frac_t
// followed by pack_frac_t:
// - pos = x * scale, then + 0.5, as two roundings (__fmul_rn/__fadd_rn):
//   a fused multiply-add would move floor(pos) at cell edges;
// - frac = pos - floor(pos), exact;
// - the products of the grid coordinates and the multipliers are taken in
//   uint32 with wraparound: the PyTorch code takes them in int64 and masks
//   with S - 1, and since 2^S divides 2^32 the low bits are the same;
// - q = trunc(min(max(frac * hi + 0.5, 0), hi)), again two roundings.
// Bytes at B = 589,824, L = 16: 7 MB read, 75.5 MB written, ~0.025 ms.
//
// unpack_feats_kernel: feats [L, B] int32, each a bf16 pair in point order
// (c0 high, as the span gather's point-order mode writes them) -> out
// [B, L*2] f32, the pair widened.  A block stages a tile of 64 points x L
// levels in shared memory, read along the points and written along the
// levels, so both sides are coalesced.  Bytes at B = 589,824: 37.7 MB
// read, 75.5 MB written, ~0.034 ms.
//
// transpose_grad_kernel: the output gradient g [B, L*2] f32 -> gT [L, B]
// float2, the inverse layout change of unpack_feats_kernel and the same
// tiling.  75.5 MB read and written at B = 589,824, ~0.045 ms.
//
// encode_grad_permute_kernel: for sorted slot (l, i) with p = perm[l, i],
// sg[l, c, i] = gT[l, p, c] and sf[l, :, i] = unpack(spf[l, i]): the
// output gradient in sorted order and the positions the bucket kernel
// takes, unpacked by the span gather's own chain.  One thread a slot; the
// reads of perm and spf and the five stores are coalesced; the 8-byte
// read of gT at p is random within one level's 8 B-byte row (4.7 MB at B
// = 589,824), which stays in L2 while the level's stream sweeps it.
// Bytes at B = 589,824: perm 75.5 MB, spf 37.7 MB, gT 75.5 MB, sg 75.5
// MB, sf 113 MB.  Reading g at p in place of gT, 8 bytes at a random
// place of a 128-byte row, measured 0.074 / 0.311 ms at B = 196,608 /
// 589,824, against 0.021 / 0.058 ms for the transpose and 0.048 / 0.152
// ms for this read (NVIDIA H100 80GB HBM3; all with the capped grid, see
// grid_for); ordering the slots so that the four levels of one 32-byte
// sector run together did not help (0.074 / 0.313 ms).
//
// xor_index_kernel: the XOR path's index math, the work of
// ops/hash_encoding.py::_indices_weights_frac_plain.  It replaces no TPU
// kernel: the JAX package does it with XLA element-wise ops.  x [B, 3]
// f32 in [0, 1] -> idx [B, L, 8] int32 (each corner's row: dense row-major on the levels
// whose (res+1)^3 fits the table, else the XOR-prime hash c0 ^ c1 *
// 19349663 ^ c2 * 83492791, masked to S - 1), w [B, L, 8] f32 (the
// trilinear weights) and frac [B, L, 3] f32 (the in-cell positions).  The
// PyTorch ops go through int64 [B, L, 8, 3] corners and int64 products;
// the kernel writes each output once.  Bit-equal to the PyTorch ops on
// the card:
// - pos = x * scale, then + 0.5, as two roundings, as encode_index_kernel;
//   frac = pos - floor(pos) and 1 - frac are single f32 roundings;
// - corner k adds bit d of k to axis d (coherent_hash.corner_bits) and
//   takes frac or 1 - frac on that axis;
// - its weight is (t0 * t2) * t1, the grouping of torch.prod over a
//   contiguous axis of 3 on the card: two lanes reduce it, lane 0 folding
//   elements 0 and 2 into its accumulators, lane 1 element 1, and the
//   warp shuffle combines the two;
// - the dense rows (sum_d c_d * stride_d) and the hashed rows are taken in
//   uint32 with wraparound and masked with S - 1: the PyTorch code takes
//   them in int64, whose low 32 bits are the same, and 2^S divides 2^32.
// One thread a (point, level): its 8 rows and 8 weights are two 16-byte
// stores each, adjacent threads own adjacent 32-byte chunks, so every
// store is coalesced; x is read once a point, and the L threads of a
// point share it through L1.  Bytes at B = 196,608, L = 16: 2.4 MB read,
// idx 100.7 MB, w 100.7 MB and frac 37.7 MB written, ~241 MB, ~0.072 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;

__global__ void encode_index_kernel(const float* __restrict__ x,
                                    const float* __restrict__ scales,
                                    const long long* __restrict__ mult,
                                    int* __restrict__ base, int* __restrict__ pos,
                                    int L, long long B, uint32_t mask) {
  __shared__ float s_scale[kMaxLevels];
  __shared__ uint32_t s_mult[kMaxLevels * 3];
  for (int t = threadIdx.x; t < L * 3; t += blockDim.x) {
    s_mult[t] = (uint32_t)mult[t];
    if (t < L) s_scale[t] = scales[t];
  }
  __syncthreads();
  const float hi[3] = {2047.f, 2047.f, 1023.f};
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += (long long)gridDim.x * blockDim.x) {
    float xd[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) xd[d] = x[b * 3 + d];
    for (int l = 0; l < L; ++l) {
      const float s = s_scale[l];
      uint32_t raw = 0, pk = 0;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float p = __fadd_rn(__fmul_rn(xd[d], s), 0.5f);
        const float g = floorf(p);
        const float f = __fsub_rn(p, g);
        raw += (uint32_t)(long long)g * s_mult[l * 3 + d];
        float q = __fadd_rn(__fmul_rn(f, hi[d]), 0.5f);
        q = fminf(fmaxf(q, 0.f), hi[d]);
        pk |= (uint32_t)(int)q << (11 * d);
      }
      base[(long long)l * B + b] = (int)(raw & mask);
      pos[(long long)l * B + b] = (int)pk;
    }
  }
}

constexpr int kTile = 64;   // points a block of unpack_feats_kernel

__global__ void unpack_feats_kernel(const uint32_t* __restrict__ feats,
                                    float2* __restrict__ out, int L,
                                    long long B) {
  __shared__ uint32_t tile[kMaxLevels][kTile + 1];
  const long long b0 = (long long)blockIdx.x * kTile;
  for (int t = threadIdx.x; t < L * kTile; t += blockDim.x) {
    const int l = t / kTile, j = t % kTile;
    if (b0 + j < B) tile[l][j] = feats[(long long)l * B + b0 + j];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L * kTile; t += blockDim.x) {
    const int j = t / L, l = t % L;
    if (b0 + j < B) {
      const uint32_t u = tile[l][j];
      out[(b0 + j) * L + l] =
          make_float2(__uint_as_float(u & 0xFFFF0000u), __uint_as_float(u << 16));
    }
  }
}

__global__ void transpose_grad_kernel(const float2* __restrict__ g,
                                      float2* __restrict__ gT, int L,
                                      long long B) {
  __shared__ float2 tile[kMaxLevels][kTile + 1];
  const long long b0 = (long long)blockIdx.x * kTile;
  for (int t = threadIdx.x; t < L * kTile; t += blockDim.x) {
    const int j = t / L, l = t % L;
    if (b0 + j < B) tile[l][j] = g[(b0 + j) * L + l];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L * kTile; t += blockDim.x) {
    const int l = t / kTile, j = t % kTile;
    if (b0 + j < B) gT[(long long)l * B + b0 + j] = tile[l][j];
  }
}

__global__ void encode_grad_permute_kernel(const long long* __restrict__ perm,
                                           const int* __restrict__ spf,
                                           const float2* __restrict__ gT,
                                           float* __restrict__ sg,
                                           float* __restrict__ sf, int L,
                                           long long B) {
  const long long n = (long long)L * B;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int l = (int)(idx / B);
    const long long i = idx - (long long)l * B;
    const float2 v = __ldg(gT + (long long)l * B + perm[idx]);
    sg[(long long)l * 2 * B + i] = v.x;
    sg[((long long)l * 2 + 1) * B + i] = v.y;
    const uint32_t pk = (uint32_t)spf[idx];
    sf[(long long)l * 3 * B + i] = (float)(pk & 2047u) * (float)(1.0 / 2047.0);
    sf[((long long)l * 3 + 1) * B + i] =
        (float)((pk >> 11) & 2047u) * (float)(1.0 / 2047.0);
    sf[((long long)l * 3 + 2) * B + i] =
        (float)((pk >> 22) & 1023u) * (float)(1.0 / 1023.0);
  }
}

__global__ void xor_index_kernel(const float* __restrict__ x,
                                 const float* __restrict__ scales,
                                 const long long* __restrict__ strides,
                                 const bool* __restrict__ dense,
                                 int4* __restrict__ idx, float4* __restrict__ w,
                                 float* __restrict__ frac, int L, long long B,
                                 uint32_t mask) {
  __shared__ float s_scale[kMaxLevels];
  __shared__ uint32_t s_stride[kMaxLevels * 3];
  __shared__ bool s_dense[kMaxLevels];
  for (int t = threadIdx.x; t < L * 3; t += blockDim.x) {
    s_stride[t] = (uint32_t)strides[t];
    if (t < L) {
      s_scale[t] = scales[t];
      s_dense[t] = dense[t];
    }
  }
  __syncthreads();
  const long long n = (long long)L * B;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += (long long)gridDim.x * blockDim.x) {
    const long long b = t / L;
    const int l = (int)(t - b * L);
    const float s = s_scale[l];
    float f[3], o[3];
    uint32_t g[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float p = __fadd_rn(__fmul_rn(__ldg(x + b * 3 + d), s), 0.5f);
      const float gf = floorf(p);
      f[d] = __fsub_rn(p, gf);
      o[d] = __fsub_rn(1.f, f[d]);
      g[d] = (uint32_t)(long long)gf;
      frac[t * 3 + d] = f[d];
    }
    const bool dn = s_dense[l];
    const uint32_t m0 = dn ? s_stride[l * 3] : 1u;
    const uint32_t m1 = dn ? s_stride[l * 3 + 1] : 19349663u;
    const uint32_t m2 = dn ? s_stride[l * 3 + 2] : 83492791u;
    int r[8];
    float wk[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t a = (g[0] + (k & 1)) * m0;
      const uint32_t c = (g[1] + ((k >> 1) & 1)) * m1;
      const uint32_t e = (g[2] + ((k >> 2) & 1)) * m2;
      r[k] = (int)((dn ? a + c + e : a ^ c ^ e) & mask);
      const float t0 = (k & 1) ? f[0] : o[0];
      const float t1 = (k & 2) ? f[1] : o[1];
      const float t2 = (k & 4) ? f[2] : o[2];
      wk[k] = __fmul_rn(__fmul_rn(t0, t2), t1);
    }
    idx[t * 2] = make_int4(r[0], r[1], r[2], r[3]);
    idx[t * 2 + 1] = make_int4(r[4], r[5], r[6], r[7]);
    w[t * 2] = make_float4(wk[0], wk[1], wk[2], wk[3]);
    w[t * 2 + 1] = make_float4(wk[4], wk[5], wk[6], wk[7]);
  }
}

// Blocks for n slots: at most 132 x 64 (a grid-stride loop takes the
// rest) or, uncapped, one thread a slot.  The gradient permute runs
// uncapped, as the span gather's point-order mode does (csrc/span_gather.cu):
// the slots in flight then lie within about one level of gT.  Measured
// (NVIDIA H100 80GB HBM3) at B = 196,608 / 589,824 / 786,432 / 1,572,864:
// capped 0.048 / 0.151 / 0.233 / 0.601 ms, uncapped 0.048 / 0.135 / 0.182
// / 0.370 ms.
int grid_for(long long n, bool capped = true) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = capped ? 132LL * 64 : 0x7fffffffLL;
  if (blocks > cap) blocks = cap;
  return (int)(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" {

const char* nvr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x [B, 3] f32; scales [L] f32; mult [L, 3] int64 holding uint32 values;
// base and pos [L, B] int32 out.  S a power of two, L <= 32.
int nvr_encode_index(const void* x, const void* scales, const void* mult,
                     void* base, void* pos, int L, long long B, long long S,
                     void* stream) {
  if (L <= 0 || L > kMaxLevels || S <= 0 || S > (1LL << 32) || (S & (S - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  encode_index_kernel<<<grid_for(B), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scales, (const long long*)mult, (int*)base,
      (int*)pos, L, B, (uint32_t)(S - 1));
  return (int)cudaGetLastError();
}

// x [B, 3] f32; scales [L] f32; strides [L, 3] int64 holding uint32
// values; dense [L] bool; idx [B, L, 8] int32, w [B, L, 8] f32 and frac
// [B, L, 3] f32 out, 16-byte aligned.  S a power of two, L <= 32.
int nvr_xor_index(const void* x, const void* scales, const void* strides,
                  const void* dense, void* idx, void* w, void* frac, int L,
                  long long B, long long S, void* stream) {
  if (L <= 0 || L > kMaxLevels || S <= 0 || S > (1LL << 32) || (S & (S - 1)) != 0 ||
      ((uintptr_t)idx | (uintptr_t)w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  xor_index_kernel<<<grid_for((long long)L * B), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scales, (const long long*)strides,
      (const bool*)dense, (int4*)idx, (float4*)w, (float*)frac, L, B,
      (uint32_t)(S - 1));
  return (int)cudaGetLastError();
}

// feats [L, B] int32 bf16 pairs (c0 high); out [B, L*2] f32.  L <= 32.
int nvr_unpack_feats(const void* feats, void* out, int L, long long B,
                     void* stream) {
  if (L <= 0 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  unpack_feats_kernel<<<(int)((B + kTile - 1) / kTile), kThreads, 0,
                        (cudaStream_t)stream>>>((const uint32_t*)feats,
                                                (float2*)out, L, B);
  return (int)cudaGetLastError();
}

// g [B, L*2] f32; gT [L, B, 2] f32 out.  L <= 32.
int nvr_transpose_grad(const void* g, void* gT, int L, long long B,
                       void* stream) {
  if (L <= 0 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaGetLastError();
  transpose_grad_kernel<<<(int)((B + kTile - 1) / kTile), kThreads, 0,
                          (cudaStream_t)stream>>>((const float2*)g, (float2*)gT,
                                                  L, B);
  return (int)cudaGetLastError();
}

// perm [L, B] int64 (each row a permutation of [0, B)); spf [L, B] int32
// packed positions in sorted order; gT [L, B, 2] f32; sg [L, 2, B] and sf
// [L, 3, B] f32 out.
int nvr_encode_grad_permute(const void* perm, const void* spf, const void* gT,
                            void* sg, void* sf, int L, long long B,
                            void* stream) {
  if ((long long)L * B == 0) return (int)cudaGetLastError();
  encode_grad_permute_kernel<<<grid_for((long long)L * B, false), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const long long*)perm, (const int*)spf, (const float2*)gT, (float*)sg,
      (float*)sf, L, B);
  return (int)cudaGetLastError();
}

}  // extern "C"
