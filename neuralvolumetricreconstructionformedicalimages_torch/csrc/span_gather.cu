// Sorted span gather: trilinear hash-grid features over a per-level
// ascending key stream.
//
// Replaces the Pallas `_kernel` of the JAX package
// (neuralvolumetricreconstructionformedicalimages_tpu/ops/span_gather.py:222
// span_gather_sorted, pallas_call at :282):
//
//   out[l, c, i] = sum_k w_k(frac_i) * V(l, k, c, key_i)
//
// with keys [L, B] int32 ascending per level, fracs either [L, D, B] f32 or
// [L, 1, B] int32 packed 11/11/10-bit (D = 3), output [L, C, B] f32, and
// the corner value V read in one of two addressing modes of one kernel:
//
//   ROLLED  V = R[l, k*C + c, key], R the feature-major rolled table
//           [L, K*C, S] (f32 or bf16), as the TPU kernel reads it;
//   TABLE   V = round(T[l, (key + off[l, k]) & (S - 1), c]), T the
//           canonical [L, S, C] f32 table, off the [L, K] int32 corner
//           offsets, round() the cast to the table dtype (bf16: rounded
//           with __float2bfloat16_rn and widened back, as the roll build
//           rounds).  S is a power of two.
//
// By definition R[l, k*C + c, s] = round(T[l, (s + off[l, k]) % S, c]), so
// the two modes read the same values; the weights, the k order and the
// __fmul_rn/__fadd_rn chain are shared, so they are bit-equal.
//
// POINT_ORDER, a variant of TABLE_PAIR with packed fracs (D = 3, C = 2),
// reads and writes through the sort's permutation perm [L, B] int64: for
// sorted slot (l, i) with p = perm[l, i] it reads the packed position at
// pos[l, p] (point order), writes it to spf[l, i] (the sorted positions
// the backward keeps), interpolates as TABLE_PAIR does, and writes the
// pair rounded to bf16 (c0 in the high half) to out[l, p] of an [L, B]
// int32 output.  That is the gather of the positions into sorted order,
// the gather itself, and the bf16 pack and scatter of the features back
// to point order, in one pass; csrc/encode_io.cu's unpack_feats_kernel
// then transposes and widens out to the [B, L*2] f32 features.  The read
// of pos and the store to out at p are random within one level's 4
// B-byte row (2.4 MB at B = 589,824), which stays in L2 while the level's
// stream sweeps it.  A store of the widened pair straight to the [B, L*2]
// features, 8 bytes at a random place of a 128-byte row, measured 0.146 /
// 0.724 ms at B = 196,608 / 589,824 against 0.068 / 0.185 ms for this
// store and 0.017 / 0.052 ms for the transpose (NVIDIA H100 80GB HBM3;
// both stores with the capped grid, see grid_for).
//
// Why the rolled table exists only for the TPU: the TPU has no gather unit,
// so its kernel streams spans of R through VMEM and picks rows with one-hot
// MXU products, and R puts every corner of a key in one row.  The card
// gathers directly, and R is a 268 MB bf16 copy of a 67 MB f32 table at the
// main-path shape, written by the roll build only to be read back here.
//
// What bounds it on the card: bytes.  Main-path shape: L = 16, K = 8,
// C = 2, B = 196,608, S = 2^19, bf16 table dtype, packed fracs.
// - ROLLED: keys 12.6 MB, fracs 12.6 MB, output 25.2 MB, and the K*C = 16
//   rows of R.  At the 13 hashed levels the sorted stream puts ~6 points on
//   each 32-byte sector of a 1 MiB bf16 row, so nearly every sector of all
//   16 rows is fetched: ~218 MB, ~0.08 ms at 3.35 TB/s.  The layout, not
//   the kernel, sets that time.
// - TABLE: the same keys, fracs and output, and the canonical table read
//   at most once, 67.1 MB: ~117 MB, ~0.035 ms.  Each level's 4 MB table
//   stays in the 50 MB L2 while that level's stream sweeps it (the grid
//   stride runs the stream level by level and ~1.4 levels are in flight);
//   a warp's 32 sorted keys span ~85 columns at a hashed level, so each
//   corner's 32 float2 loads fall on ~22 sectors of L2.
//
// Design: one thread per (level, sorted point), in a grid-stride loop.
// Weights are formed in the order of the TPU kernel (w_k = prod_d (bit ?
// f : 1-f)) and the corners are summed in k order in f32, with
// __fmul_rn/__fadd_rn so that the compiler does not fuse them into
// multiply-adds.  TABLE mode with C = 2 and an 8-byte aligned table loads
// each corner's channel pair as one float2; other C take scalar loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// How a corner's value is addressed: ROLLED reads R[l, k*C + c, key];
// TABLE_PAIR and TABLE read T[l, (key + off) & (S - 1), c] (C = 2 as one
// float2, or any C by scalar loads).
enum Mode { ROLLED, TABLE_PAIR, TABLE };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A canonical f32 value rounded to the table dtype T and widened back.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// TabT is the table dtype: ROLLED reads TabT values; the TABLE modes read
// f32 and round to TabT.  POINT_ORDER (TABLE_PAIR with packed fracs only)
// reads the fracs at perm and writes spf and the point-order output.
template <typename TabT, int D, bool PACKED, int MODE, bool POINT_ORDER>
__global__ void span_gather_kernel(const int* __restrict__ keys,
                                   const void* __restrict__ frac_raw,
                                   const void* __restrict__ tab_raw,
                                   const int* __restrict__ offs,
                                   float* __restrict__ out, int L, int C,
                                   long long B, long long S,
                                   const long long* __restrict__ perm,
                                   int* __restrict__ spf) {
  static_assert(!POINT_ORDER || (PACKED && MODE == TABLE_PAIR),
                "the point-order mode takes packed fracs and channel pairs");
  constexpr int K = 1 << D;
  const long long n = (long long)L * B;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n; idx += (long long)gridDim.x * blockDim.x) {
    const int l = (int)(idx / B);
    const long long i = idx - (long long)l * B;
    const long long key = keys[idx];
    long long p = i;  // the point of sorted slot (l, i)
    if constexpr (POINT_ORDER) p = perm[idx];

    float f[D > 0 ? D : 1];
    if constexpr (PACKED) {
      uint32_t pk;
      if constexpr (POINT_ORDER) {
        pk = ((const uint32_t*)frac_raw)[(long long)l * B + p];
        spf[idx] = (int)pk;
      } else {
        pk = ((const uint32_t*)frac_raw)[idx];
      }
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

    if constexpr (MODE == ROLLED) {
      const TabT* col = (const TabT*)tab_raw + (long long)l * K * C * S + key;
      for (int c = 0; c < C; ++c) {
        float acc = __fmul_rn(w[0], to_f32(col[(long long)c * S]));
#pragma unroll
        for (int k = 1; k < K; ++k)
          acc = __fadd_rn(
              acc, __fmul_rn(w[k], to_f32(col[(long long)(k * C + c) * S])));
        out[((long long)l * C + c) * B + i] = acc;
      }
    } else {
      const int* ol = offs + l * K;
      long long row[K];  // the corners' columns of the canonical table
#pragma unroll
      for (int k = 0; k < K; ++k)
        row[k] = (long long)l * S + ((key + __ldg(ol + k)) & (S - 1));
      if constexpr (MODE == TABLE_PAIR) {
        const float2* tp = (const float2*)tab_raw;
        float2 v = __ldg(tp + row[0]);
        float a0 = __fmul_rn(w[0], round_to<TabT>(v.x));
        float a1 = __fmul_rn(w[0], round_to<TabT>(v.y));
#pragma unroll
        for (int k = 1; k < K; ++k) {
          v = __ldg(tp + row[k]);
          a0 = __fadd_rn(a0, __fmul_rn(w[k], round_to<TabT>(v.x)));
          a1 = __fadd_rn(a1, __fmul_rn(w[k], round_to<TabT>(v.y)));
        }
        if constexpr (POINT_ORDER) {
          const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(a0));
          const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a1));
          ((uint32_t*)out)[(long long)l * B + p] = (hi << 16) | lo;
        } else {
          out[(long long)l * 2 * B + i] = a0;
          out[((long long)l * 2 + 1) * B + i] = a1;
        }
      } else {
        const float* tp = (const float*)tab_raw;
        for (int c = 0; c < C; ++c) {
          float acc = __fmul_rn(w[0], round_to<TabT>(__ldg(tp + row[0] * C + c)));
#pragma unroll
          for (int k = 1; k < K; ++k)
            acc = __fadd_rn(
                acc, __fmul_rn(w[k], round_to<TabT>(__ldg(tp + row[k] * C + c))));
          out[((long long)l * C + c) * B + i] = acc;
        }
      }
    }
  }
}

// Blocks for n slots: at most 132 x 64 (a grid-stride loop takes the
// rest) or, uncapped, one thread a slot.  The point-order mode runs
// uncapped: blocks start roughly in slot order, so the slots in flight lie
// within about one level and its random reads and stores through perm
// stay in that level's L2-resident rows; a capped grid's resident blocks
// stride across every level at once.  Measured (NVIDIA H100 80GB HBM3) at
// B = 196,608 / 589,824 / 786,432 / 1,572,864: capped 0.067 / 0.184 /
// 0.382 / 1.302 ms, uncapped 0.075 / 0.166 / 0.236 / 0.494 ms.
int grid_for(long long n, bool capped = true) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = capped ? 132LL * 64 : 0x7fffffffLL;
  if (blocks > cap) blocks = cap;
  return (int)(blocks > 0 ? blocks : 1);
}

template <typename TabT, int D, bool PACKED, int MODE, bool POINT_ORDER = false>
void launch(const void* keys, const void* frac, const void* tab,
            const void* offs, void* out, int L, int C, long long B,
            long long S, cudaStream_t st, const void* perm = nullptr,
            void* spf = nullptr) {
  span_gather_kernel<TabT, D, PACKED, MODE, POINT_ORDER>
      <<<grid_for((long long)L * B, !POINT_ORDER), kThreads, 0, st>>>(
          (const int*)keys, frac, tab, (const int*)offs, (float*)out, L, C, B,
          S, (const long long*)perm, (int*)spf);
}

// The fracs' form and D, for one table dtype and mode.
template <typename TabT, int MODE>
int dispatch(const void* keys, const void* frac, const void* tab,
             const void* offs, void* out, int packed, int L, int D, int C,
             long long B, long long S, cudaStream_t st) {
  if (packed) {
    if (D != 3) return (int)cudaErrorInvalidValue;
    launch<TabT, 3, true, MODE>(keys, frac, tab, offs, out, L, C, B, S, st);
  } else if (D == 3) {
    launch<TabT, 3, false, MODE>(keys, frac, tab, offs, out, L, C, B, S, st);
  } else if (D == 2) {
    launch<TabT, 2, false, MODE>(keys, frac, tab, offs, out, L, C, B, S, st);
  } else if (D == 1) {
    launch<TabT, 1, false, MODE>(keys, frac, tab, offs, out, L, C, B, S, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
  if (tab_bf16)
    return dispatch<__nv_bfloat16, ROLLED>(keys, frac, tab, nullptr, out,
                                           packed, L, D, C, B, S, st);
  return dispatch<float, ROLLED>(keys, frac, tab, nullptr, out, packed, L, D,
                                 C, B, S, st);
}

// keys and frac as above; table [L, S, C] f32 with S a power of two; offs
// [L, 2^D] int32 in [0, S); out [L, C, B] f32.  Each table value is
// rounded to bf16 first when round_bf16 != 0.  D in {1, 2, 3}.
int nvr_span_gather_table(const void* keys, const void* frac,
                          const void* table, const void* offs, void* out,
                          int packed, int round_bf16, int L, int D, int C,
                          long long B, long long S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 0 || (S & (S - 1)) != 0) return (int)cudaErrorInvalidValue;
  if ((long long)L * B == 0) return (int)cudaGetLastError();
  const bool pair = C == 2 && (uintptr_t)table % sizeof(float2) == 0;
  if (round_bf16)
    return pair ? dispatch<__nv_bfloat16, TABLE_PAIR>(
                      keys, frac, table, offs, out, packed, L, D, C, B, S, st)
                : dispatch<__nv_bfloat16, TABLE>(keys, frac, table, offs, out,
                                                 packed, L, D, C, B, S, st);
  return pair ? dispatch<float, TABLE_PAIR>(keys, frac, table, offs, out,
                                            packed, L, D, C, B, S, st)
              : dispatch<float, TABLE>(keys, frac, table, offs, out, packed, L,
                                       D, C, B, S, st);
}

// keys [L, B] int32 sorted per level, perm [L, B] int64 the sort's
// permutation, pos [L, B] int32 packed positions in point order, table
// [L, S, 2] f32 (8-byte aligned, S a power of two), offs [L, 8] int32;
// out: spf [L, B] int32 (pos in sorted order) and feats [L, B] int32,
// each a bf16 pair in point order (c0 high).  Each table value is rounded
// to bf16 first when round_bf16 != 0.
int nvr_span_gather_point_order(const void* keys, const void* pos,
                                const void* perm, const void* table,
                                const void* offs, void* spf, void* feats,
                                int round_bf16, int L, long long B,
                                long long S, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 0 || (S & (S - 1)) != 0 || (uintptr_t)table % sizeof(float2) != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)L * B == 0) return (int)cudaGetLastError();
  if (round_bf16)
    launch<__nv_bfloat16, 3, true, TABLE_PAIR, true>(keys, pos, table, offs,
                                                      feats, L, 2, B, S, st,
                                                      perm, spf);
  else
    launch<float, 3, true, TABLE_PAIR, true>(keys, pos, table, offs, feats, L,
                                             2, B, S, st, perm, spf);
  return (int)cudaGetLastError();
}

}  // extern "C"
