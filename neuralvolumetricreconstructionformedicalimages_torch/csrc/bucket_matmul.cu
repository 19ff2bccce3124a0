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
// What bounds it on the card: bytes, and the longest run.
// - Bytes: at the main-path shape (L=16, K=8, C=2, B=196608, S=2^19,
//   E=4224) it reads 75.5 MB (keys, fracs, grads) and writes the 541.2 MB
//   table-shaped gradient, ~0.184 ms at 3.35 TB/s; the XOR backward (D=0,
//   16 x 1,572,864 keys) reads 302 MB and writes 67 MB.  Nearly every
//   column is empty on the main path (196,608 points for 524,288 columns a
//   level), so the work that is not a store must cost next to nothing.
// - The longest run: a sum in stream order is a chain of dependent adds.
//   The coarse levels hold runs of ~8,000 updates in one column on the main
//   path and ~57,000 on the XOR stream, with one 1024-column tile holding
//   93-97 % of its level's stream.  A first design (a thread per column,
//   two binary searches each, one lane forming all K*C products of a run
//   with its loads waiting on each other) spent 0.1-0.25 us per element
//   of such a run: 1.99 ms on the main path, 5.95 ms on the XOR stream.
//
// Design: one block of 256 threads per (tile of 1024 columns, level),
// plus slice blocks, first in the grid, for the longest runs.
// 1. Two warps find the tile's segment [a, b) of the level's sorted stream
//    (lower_bound of its first column and of the one past its last) with
//    a 32-way search: four or five rounds of one load per lane.
// 2. The run starts start[j] = lower_bound(ts + j), j = 0..1024, go to
//    shared memory, searched in the segment's keys staged there when it
//    holds at most 4096 (with its fracs and grads when they fit), else in
//    the stream itself.
// 3. Runs of at most 32: thread t takes the columns t, t + 256, ... one at
//    a time, sums the run in stream order in f32 and stores all K*C rows,
//    zeros for an empty column, plus the wrapped copies at S + s,
//    S + s + S, ... below S + E.  A warp's stores of one row are 32
//    neighbouring columns, and every output element is written once, so
//    there is no separate zero fill.
// 4. Runs of 33-2047 are queued, longest first, and taken by warps a few
//    at a time; runs of 2048 or more go to slice blocks, one warp each, so
//    that a dense tile's chains spread over many SMs.  A warp stages 32
//    elements of its runs a round with coalesced loads (issued rounds
//    ahead), forms all K*C products of each element into shared memory,
//    and one lane per sum adds them in stream order.
//
// Summation order: unchanged.  Every sum is taken over its run in stream
// order, from 0, with the products w_k * g_c formed by __fmul_rn (w_k
// multiplied in d order) and added by __fadd_rn (no fused multiply-add),
// as the plain version does, so the two agree bit for bit and the result
// is the same run to run (no atomics).  Step 4 splits a run's K*C sums
// over lanes, never a sum over its elements: that would change the order.
// The XOR stream's longest run is therefore a chain of ~57,000 dependent
// adds in one lane, which sets that mode's time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;   // output columns per block
constexpr int kStage = 4096;  // longest segment searched in shared memory
constexpr int kHeavy = 32;    // longest run summed by one thread
constexpr int kBig = 2048;    // shortest run taken by a slice block
constexpr int kSlice = 8 * kBig;  // stream elements per slice block

template <typename T>
__device__ __forceinline__ T cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// First index in keys[0, n) whose key is >= target, found by one warp:
// each round, lane i probes the end of the i-th of 32 equal parts of the
// range and the ballot's count picks the part that holds the answer.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ keys,
                                                int n, long long target,
                                                int lane) {
  long long lo = 0, hi = n;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) >> 5;
    const long long p = lo + (lane + 1) * step - 1;
    const bool below = p < hi && (long long)keys[p] < target;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    hi = min(hi, lo + (c + 1) * step);
    lo += c * step;
  }
  const long long p = lo + lane;
  const bool below = p < hi && (long long)keys[p] < target;
  return (int)lo + __popc(__ballot_sync(0xffffffffu, below));
}

// w_k = prod_d (bit d of k ? t_d : 1 - t_d), multiplied in d order.
template <int D>
__device__ __forceinline__ float corner_weight(const float* t, int k) {
  float w = 1.f;
#pragma unroll
  for (int d = 0; d < D; ++d)
    w = __fmul_rn(w, ((k >> d) & 1) ? t[d] : __fsub_rn(1.f, t[d]));
  return w;
}

// First index in keys[lo, hi) whose key is >= target (one thread).
__device__ __forceinline__ int lower_bound(const int* keys, int lo, int hi,
                                          long long target) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if ((long long)keys[mid] < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Column s's K*C values into rows f of the output, and its wrapped copies
// at S + s, S + s + S, ... below S + E.
template <typename OutT>
__device__ __forceinline__ void store_column(OutT* o, int f, long long s,
                                             long long S, long long Se,
                                             float v) {
  const OutT x = cast_out<OutT>(v);
  o[(long long)f * Se + s] = x;
  for (long long col = S + s; col < Se; col += S) o[(long long)f * Se + col] = x;
}

// Geometry of a warp's pass over long runs, for F = K*C sums over R =
// D + C stream rows: groups of G lanes sum one run each, CPW runs a warp
// at a time; a round stages EL stream elements of each of those runs, and
// every lane keeps P rounds of its loads in flight.
template <int F, int R, int CPW_MAX>
struct LongRuns {
  static constexpr int G = F < 32 ? F : 32;                        // lanes per run
  static constexpr int FPL = F / G;                                // sums per lane
  static constexpr int CPW = 32 / G < CPW_MAX ? 32 / G : CPW_MAX;  // runs per warp
  // elements per round (8 at K*C = 64, so that the products fit in 48 KB)
  static constexpr int EL = CPW * F > 32 ? 8 : 32;
  static constexpr int PAIRS = CPW * EL;                           // (run, element)
  static constexpr int NP = PAIRS > 32 ? PAIRS / 32 : 1;           // pairs per lane
  // rounds ahead: at most 24 registers of loads in flight, so that the
  // kernel fits in 80 registers without spills
  static constexpr int P = 24 / (NP * R) > 1 ? 24 / (NP * R) : 1;
  static constexpr int ROW = EL + 4;  // a product row: 16-byte aligned
  static constexpr int WARP_FLOATS = CPW * F * ROW;                // products
};

// This lane's pairs of round r: stream elements pm[i] + r*EL, i < NP.
template <int D, int C, typename LR>
__device__ __forceinline__ void load_round(float (&b)[LR::NP][D + C], int r,
                                           const int* pm, const int* pend,
                                           const float* __restrict__ fl,
                                           const float* __restrict__ gl, int B) {
#pragma unroll
  for (int i = 0; i < LR::NP; ++i) {
    const int m = pm[i] + r * LR::EL;
    const bool ok = m < pend[i];
#pragma unroll
    for (int d = 0; d < D; ++d) b[i][d] = ok ? fl[(long long)d * B + m] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) b[i][D + c] = ok ? gl[(long long)c * B + m] : 0.f;
  }
}

// The K*C products of this lane's elements of round r (registers b) into
// the product rows dst[run][k*C + c][element].
template <int D, int C, typename LR>
__device__ __forceinline__ void make_products(const float (&b)[LR::NP][D + C],
                                              int r, const int* pm,
                                              const int* pend, const int* pq,
                                              const int* pe, float* dst) {
  constexpr int K = 1 << D;
#pragma unroll
  for (int i = 0; i < LR::NP; ++i) {
    if (pm[i] + r * LR::EL < pend[i]) {
      float* pp = dst + (pq[i] * K * C) * LR::ROW + pe[i];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float w = corner_weight<D>(b[i], k);
#pragma unroll
        for (int c = 0; c < C; ++c)
          pp[(k * C + c) * LR::ROW] = __fmul_rn(w, b[i][D + c]);
      }
    }
  }
}

// acc += row[0] + row[1] + ... + row[cnt - 1], one add at a time; a full
// round is read as 16-byte vectors, 16 values ahead of the adds.
template <typename LR>
__device__ __forceinline__ float add_row(float acc, const float* row, int cnt) {
  if (LR::EL % 16 == 0 && cnt == LR::EL) {
#pragma unroll
    for (int h = 0; h < LR::EL / 16; ++h) {
      float4 v[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) v[x] = reinterpret_cast<const float4*>(row)[4 * h + x];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        acc = __fadd_rn(acc, v[x].x);
        acc = __fadd_rn(acc, v[x].y);
        acc = __fadd_rn(acc, v[x].z);
        acc = __fadd_rn(acc, v[x].w);
      }
    }
  } else {
    for (int x = 0; x < cnt; ++x) acc = __fadd_rn(acc, row[x]);
  }
  return acc;
}

// One warp sums the runs [lo[p], hi[p]) of the columns col[p], p < CPW
// (a table in shared memory; col < 0 marks an empty slot), and stores
// them.  Each round its lanes load EL stream elements of every run with
// coalesced loads (P rounds ahead), form all K*C products of each element
// into `prod`, and then lane gi of run q's group adds the products of rows
// gi, gi + G, ... in stream order.  The K*C sums of a run proceed side by
// side; each is taken in the order of the plain version.
template <int D, int C, int CPW_MAX, typename OutT>
__device__ __forceinline__ void warp_runs(const int* lo, const int* hi,
                                          const int* col, float* prod,
                                          const float* __restrict__ fl,
                                          const float* __restrict__ gl, int B,
                                          OutT* __restrict__ o, long long S,
                                          long long Se, int lane) {
  constexpr int F = (1 << D) * C;
  using LR = LongRuns<F, D + C, CPW_MAX>;
  const int q = lane / LR::G, gi = lane % LR::G;  // q < CPW: a summing lane
  int rounds = 0;
#pragma unroll
  for (int p = 0; p < LR::CPW; ++p)
    rounds = max(rounds, (hi[p] - lo[p] + LR::EL - 1) / LR::EL);
  // Pair lane + 32 i is element pe[i] of each round of run pq[i], at stream
  // index pm[i] + r * EL in round r.
  int pq[LR::NP], pe[LR::NP], pm[LR::NP], pend[LR::NP];
#pragma unroll
  for (int i = 0; i < LR::NP; ++i) {
    const int pair = lane + 32 * i;
    pq[i] = pair / LR::EL;
    pe[i] = pair % LR::EL;
    const bool live = pair < LR::PAIRS;
    pm[i] = live ? lo[pq[i]] + pe[i] : 0;
    pend[i] = live ? hi[pq[i]] : 0;
  }
  const bool sums = q < LR::CPW;
  const int mlo = sums ? lo[q] : 0, mhi = sums ? hi[q] : 0;
  const int row0 = (q * F + gi) * LR::ROW;  // this lane's first product row

  // buf[r % P] holds round r's loads until its products are formed.
  float buf[LR::P][LR::NP][D + C];
#pragma unroll
  for (int u = 0; u < LR::P; ++u) load_round<D, C, LR>(buf[u], u, pm, pend, fl, gl, B);

  float acc[LR::FPL];
#pragma unroll
  for (int i = 0; i < LR::FPL; ++i) acc[i] = 0.f;
  for (int r0 = 0; r0 < rounds; r0 += LR::P) {
#pragma unroll
    for (int u = 0; u < LR::P; ++u) {
      const int r = r0 + u;
      if (r >= rounds) break;
      make_products<D, C, LR>(buf[u], r, pm, pend, pq, pe, prod);
      __syncwarp();
      // round r + P's loads go out before round r's adds
      load_round<D, C, LR>(buf[u], r + LR::P, pm, pend, fl, gl, B);
      const int cnt = min(LR::EL, max(0, mhi - (mlo + r * LR::EL)));
#pragma unroll
      for (int i = 0; i < LR::FPL; ++i)
        acc[i] = add_row<LR>(acc[i], prod + row0 + i * LR::G * LR::ROW, cnt);
      __syncwarp();
    }
  }
  if (sums && col[q] >= 0) {
#pragma unroll
    for (int i = 0; i < LR::FPL; ++i)
      store_column(o, gi + i * LR::G, (long long)col[q], S, Se, acc[i]);
  }
}

// At least 3 blocks an SM (at most 85 registers a thread): the tile
// blocks' searches and loads wait on memory, and more blocks in flight
// hide it; a cap of 64 spills the long-run path's registers.
template <int D, int C, typename OutT>
__global__ void __launch_bounds__(kThreads, 3)
    bucket_kernel(const int* __restrict__ keys, const float* __restrict__ frac,
                  const float* __restrict__ grads, OutT* __restrict__ out,
                  int B, long long S, long long E, int n_slices) {
  constexpr int K = 1 << D;
  constexpr int F = K * C;
  constexpr int R = D + C;
  constexpr int TD = D > 0 ? D : 1;
  constexpr int kWarps = kThreads / 32;
  using TileLR = LongRuns<F, R, 4>;
  using SliceLR = LongRuns<F, R, 1>;
  constexpr int kProd = kWarps * (TileLR::WARP_FLOATS > SliceLR::WARP_FLOATS
                                      ? TileLR::WARP_FLOATS
                                      : SliceLR::WARP_FLOATS);
  constexpr int kScratch = kStage > kProd ? kStage : kProd;
  // start[j], start[j + 1]: column ts + j's run of the stream.
  __shared__ int start[kTile + 1];
  __shared__ int heavy[kTile];  // long columns, longest first
  // Step 2's staged keys, then step 3's list of long columns, then the
  // products of the long runs.
  __shared__ __align__(16) float scratch[kScratch];
  __shared__ int slot_lo[kWarps][4], slot_hi[kWarps][4], slot_col[kWarps][4];
  __shared__ int seg[2], n_heavy, next_heavy;

  const int l = blockIdx.y;
  const int* __restrict__ kl = keys + (long long)l * B;
  const float* __restrict__ fl = frac + (long long)l * D * B;
  const float* __restrict__ gl = grads + (long long)l * C * B;
  OutT* __restrict__ o = out + (long long)l * F * (S + E);
  const long long Se = S + E;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if ((int)blockIdx.x < n_slices) {
    // A slice block: the runs of at least kBig updates whose first sample
    // (stream index a multiple of kBig / 2) lies in its kSlice stream
    // elements; sample p finds one when key[p] == key[p + kBig / 2].  At
    // most kSlice / kBig = kWarps runs qualify: one warp each.
    constexpr int kHalf = kBig / 2;
    const int s0 = blockIdx.x * kSlice;
    if (tid == 0) n_heavy = 0;
    __syncthreads();
    const int p = s0 + tid * kHalf;
    if (tid < kSlice / kHalf && p + kHalf < B) {
      const int key = kl[p];
      if (key == kl[p + kHalf] && key >= 0 && (long long)key < S) {
        // The run's start when it lies after the previous sample; that
        // sample itself when the run reaches back to it.
        const int lo = lower_bound(kl, max(0, p - kHalf), p + 1, key);
        if (lo > p - kHalf) {  // p is the run's first sample
          const int hi = lower_bound(kl, p + kHalf, B, (long long)key + 1);
          if (hi - lo >= kBig) {
            const int e = atomicAdd(&n_heavy, 1);
            slot_lo[e][0] = lo;
            slot_hi[e][0] = hi;
            slot_col[e][0] = key;
          }
        }
      }
    }
    __syncthreads();
    if (warp < n_heavy)
      warp_runs<D, C, 1>(slot_lo[warp], slot_hi[warp], slot_col[warp],
                         scratch + warp * SliceLR::WARP_FLOATS, fl, gl, B, o, S,
                         Se, lane);
    return;
  }

  const long long ts = (long long)(blockIdx.x - n_slices) * kTile;
  const int width = (int)min((long long)kTile, S - ts);

  // 1. The tile's segment [a, b) of the sorted stream.
  if (warp < 2) {
    const int pos = warp_lower_bound(kl, B, warp == 0 ? ts : ts + width, lane);
    if (lane == 0) seg[warp] = pos;
  }
  if (tid == 0) n_heavy = next_heavy = 0;
  __syncthreads();
  const int a = seg[0], b = seg[1], n = b - a;

  // 2. Run starts: start[j] = lower_bound(ts + j) for j in [0, width],
  //    searched in shared memory when the segment is short, else in the
  //    stream (dense coarse levels: tens of thousands of updates a tile).
  //    A short segment's fracs and grads come along when they fit, so
  //    that step 3 reads them from shared memory.
  const bool staged_data = n <= kStage && n * (1 + R) <= kScratch;
  const float* sdata = scratch + n;  // [R][n] when staged_data
  if (n <= kStage) {
    int* staged = reinterpret_cast<int*>(scratch);
#pragma unroll 4
    for (int i = tid; i < n; i += kThreads) {
      staged[i] = kl[a + i];
      if (staged_data) {
#pragma unroll
        for (int d = 0; d < D; ++d) scratch[n + d * n + i] = fl[(long long)d * B + a + i];
#pragma unroll
        for (int c = 0; c < C; ++c) scratch[n + (D + c) * n + i] = gl[(long long)c * B + a + i];
      }
    }
    __syncthreads();
    for (int j = tid; j <= width; j += kThreads)
      start[j] = a + lower_bound(staged, 0, n, ts + j);
  } else {
    for (int j = tid; j <= width; j += kThreads)
      start[j] = lower_bound(kl, a, b, ts + j);
  }
  __syncthreads();

  // 3. Short runs: one thread per column, neighbouring threads on
  //    neighbouring columns, all K*C rows stored (zeros when empty).  Runs
  //    of kBig or more are the slice blocks'; the others above kHeavy are
  //    queued for step 4.
  int* queued = reinterpret_cast<int*>(scratch);
  for (int j = tid; j < width; j += kThreads) {
    const int lo = start[j], hi = start[j + 1];
    if (hi - lo > kHeavy) {
      if (hi - lo < kBig) queued[atomicAdd(&n_heavy, 1)] = j;
      continue;
    }
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.f;
#pragma unroll 2
    for (int m = lo; m < hi; ++m) {
      float t[TD], g[C];
      if (staged_data) {
#pragma unroll
        for (int d = 0; d < D; ++d) t[d] = sdata[d * n + m - a];
#pragma unroll
        for (int c = 0; c < C; ++c) g[c] = sdata[(D + c) * n + m - a];
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) t[d] = fl[(long long)d * B + m];
#pragma unroll
        for (int c = 0; c < C; ++c) g[c] = gl[(long long)c * B + m];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float w = corner_weight<D>(t, k);
#pragma unroll
        for (int c = 0; c < C; ++c)
          acc[k * C + c] = __fadd_rn(acc[k * C + c], __fmul_rn(w, g[c]));
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) store_column(o, f, ts + j, S, Se, acc[f]);
  }
  __syncthreads();
  const int nh = n_heavy;
  if (nh == 0) return;

  // 4. Queued columns, longest first (ties by column), so that the runs a
  //    warp takes together are of like length; warps take CPW at a time.
  for (int e = tid; e < nh; e += kThreads) {
    const int j = queued[e], len = start[j + 1] - start[j];
    int rank = 0;
    for (int e2 = 0; e2 < nh; ++e2) {
      const int j2 = queued[e2], len2 = start[j2 + 1] - start[j2];
      rank += len2 > len || (len2 == len && j2 < j);
    }
    heavy[rank] = j;
  }
  __syncthreads();
  for (;;) {
    int e0 = 0;
    if (lane == 0) e0 = atomicAdd(&next_heavy, TileLR::CPW);
    e0 = __shfl_sync(0xffffffffu, e0, 0);
    if (e0 >= nh) break;
    if (lane < TileLR::CPW) {
      const bool live = e0 + lane < nh;
      const int j = live ? heavy[e0 + lane] : 0;
      slot_lo[warp][lane] = live ? start[j] : 0;
      slot_hi[warp][lane] = live ? start[j + 1] : 0;
      slot_col[warp][lane] = live ? (int)ts + j : -1;
    }
    __syncwarp();
    warp_runs<D, C, 4>(slot_lo[warp], slot_hi[warp], slot_col[warp],
                       scratch + warp * TileLR::WARP_FLOATS, fl, gl, B, o, S, Se,
                       lane);
    __syncwarp();
  }
}

template <int D, int C>
void launch(const void* keys, const void* frac, const void* grads, void* out,
            int out_bf16, int L, int B, long long S, long long E,
            cudaStream_t st) {
  const int n_slices = (B + kSlice - 1) / kSlice;
  const dim3 grid((unsigned)(n_slices + (S + kTile - 1) / kTile), (unsigned)L);
  if (out_bf16)
    bucket_kernel<D, C, __nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const int*)keys, (const float*)frac, (const float*)grads,
        (__nv_bfloat16*)out, B, S, E, n_slices);
  else
    bucket_kernel<D, C, float><<<grid, kThreads, 0, st>>>(
        (const int*)keys, (const float*)frac, (const float*)grads, (float*)out,
        B, S, E, n_slices);
}

template <int D>
int launch_c(int C, const void* keys, const void* frac, const void* grads,
             void* out, int out_bf16, int L, int B, long long S, long long E,
             cudaStream_t st) {
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
// (out_bf16 != 0).  D in {0, 2, 3}, C in {1, 2, 4, 8}; B and S below 2^31,
// L below 2^16.
int nvr_bucket_grad_matmul(const void* keys, const void* frac,
                           const void* grads, void* out, int out_bf16, int L,
                           int D, int C, long long B, long long S, long long E,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)L * S == 0) return (int)cudaGetLastError();
  if (B > INT_MAX || S > INT_MAX || L > 65535) return (int)cudaErrorInvalidValue;
  const int b = (int)B;
  int rc;
  switch (D) {
    case 0: rc = launch_c<0>(C, keys, frac, grads, out, out_bf16, L, b, S, E, st); break;
    case 2: rc = launch_c<2>(C, keys, frac, grads, out, out_bf16, L, b, S, E, st); break;
    case 3: rc = launch_c<3>(C, keys, frac, grads, out, out_bf16, L, b, S, E, st); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // extern "C"
