// In-order scatter-add of one hash-grid level's updates into its table.
//
// Replaces the Pallas `pallas_scatter_level` kernel of the encoder
// microbenchmark (scripts/microbench_encoder.py::pallas_scatter_level):
//
//   out[j, :] = 0 + pay[i0, :] + pay[i1, :] + ...,  i0 < i1 < ... the
//               updates with idx[i] = j, added one at a time in that order
//
// idx [N] int32, pay [N, C] f32 with C in {1, 2, 4} (rows aligned to their
// width), out [S, C] f32, any N >= 0 and S > 0.  An index outside [0, S) is
// skipped.  The TPU kernel adds in exactly this order (a serial loop over
// each chunk of updates, the chunks in order into one VMEM block), as do
// np.add.at and the CPU's index_add_, so this kernel equals all three bit
// for bit on any payload and is the same from run to run.
//
// An in-order sum rules out atomics on device memory (they land in no fixed
// order), and blocks run in no order on 132 SMs, so the order of every sum
// comes from the updates' positions, never from scheduling.
//
// Two kernels, no atomics, no zero fill:
// 1. Partition (scatter_partition_kernel, one block of 8 warps per tile of
//    kTile = 4096 updates).  Rows are cut into slabs of kSlabFloats / C
//    rows (16 KB of f32; times `windows` when S needs more than kMaxSlabs
//    slabs).  Each warp ranks its 512 updates within their slabs, 32 at a
//    time in order (a ballot a bit of the slab number groups equal lanes),
//    against its own counters in shared memory; a scan of the counters in
//    slab-major, warp-minor order places each update in the tile sorted
//    stably by slab.  The block writes that sorted tile, one word an update
//    (its row within its slab and its place in the tile, 16 bits each, or
//    32 when a slab has more than 2^16 rows), into the tile's own part of
//    the workspace, and where each slab starts in it (offs [n_tiles,
//    n_slabs + 1]).  It reads no payload.
// 2. Accumulate (scatter_kernel, one block of 16 warps per slab window,
//    launched as a programmatic dependent of the partition so that its
//    prologue overlaps the partition's end).  Each warp owns a sixteenth of
//    the block's rows.  The block zeroes its accumulators in shared memory
//    and walks its slab's runs tile after tile, so in update order, a chunk
//    of kPer * 512 positions at a time (a search over the runs' offsets
//    finds the tile of the first of each 32 positions, and each lane steps
//    on from there to its own; its payload is read from the input at its
//    place in the tile).  The chunk is put in order by owner, stably:
//    each warp counts its own contiguous part by owner with ballots, and a
//    scan of the [owner, warp] counts places every update.  Then each warp
//    adds its owner's updates 32 at a time: lanes on one row group by
//    ballots, and the group's lowest lane adds their payloads in lane order.
//    No barrier orders the adds: a row is only ever added by its owner.
//    Last, the block writes its rows, coalesced and vectorised: every
//    output row is written.
//
// Order of the sums: each row's accumulator starts at 0 and takes its
// updates one at a time (__fadd_rn) in ascending i: tiles in order, the
// slab's part of a tile in order (stable partition), chunks in order, the
// owner's part of a chunk in order (stable), lanes in order within 32.  Skew
// is right but not fast: a row's sum is one chain of dependent adds, as on
// the TPU, and one slab's updates take one block.
//
// Where the time goes, phase by phase: scripts/scatter_phases_torch.py
// builds this file with one phase of the accumulate cut at a time and
// times each kernel alone (PERF.md has its numbers).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 4096;             // updates a partition block takes
constexpr int kPartThreads = 256;       // partition block: 8 warps
constexpr int kPartWarps = kPartThreads / 32;
constexpr int kPasses = kTile / kPartThreads;   // rounds of 32 a warp
constexpr int kSlabFloats = 4096;       // f32 accumulators a block holds
constexpr int kMaxSlabs = 2048;         // partition counters: 72 KB at most
constexpr int kLabelBits = 12;          // bits of a slab label (< 2 * kMaxSlabs)
constexpr int kCntStride = kPartWarps + 1;
constexpr int kAccThreads = 512;        // accumulate block: 16 warps
constexpr int kOwnersLog2 = 4;          // a warp owns 1/16 of the rows
constexpr int kAccWarps = 1 << kOwnersLog2;
constexpr int kCounts = kAccWarps * kAccWarps;  // [owner, warp]
constexpr int kWinTiles = 1024;         // tiles whose runs are mapped at once
constexpr int kPer = 4;                 // updates a thread holds in a chunk
constexpr int kChunk = kPer * kAccThreads;

static_assert(kAccThreads == kAccWarps * 32, "one owner a warp");
static_assert(kCounts <= kAccThreads, "one count a thread");

__device__ __forceinline__ int bit_width(int n) { return 32 - __clz(n); }

template <int C>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  static __device__ T zero() { return 0.f; }
};
template <>
struct Vec<2> {
  using T = float2;
  static __device__ T zero() { return make_float2(0.f, 0.f); }
};
template <>
struct Vec<4> {
  using T = float4;
  static __device__ T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

// log2 of the rows a block accumulates: kSlabFloats / C.
template <int C>
__host__ __device__ constexpr int block_rows_log2() {
  return C == 1 ? 12 : C == 2 ? 11 : 10;
}
static_assert(kSlabFloats == 1 << 12, "block_rows_log2 follows kSlabFloats");

// The sizes both kernels and the workspace follow (ops/scatter_level.py::
// scatter_plan mirrors them).
struct Plan {
  int rows_log2;      // log2 of the rows a block accumulates
  int windows_log2;   // log2 of the blocks a slab takes
  bool wide;          // a row within its slab needs more than 16 bits
  long long n_slabs, n_tiles, ws_bytes;
};

Plan make_plan(int C, long long N, long long S) {
  Plan p;
  p.rows_log2 = 31 - __builtin_clz(kSlabFloats / C);
  p.windows_log2 = 0;
  for (;;) {
    const long long slab = 1LL << (p.rows_log2 + p.windows_log2);
    p.n_slabs = (S + slab - 1) / slab;
    if (p.n_slabs <= kMaxSlabs) break;
    ++p.windows_log2;
  }
  p.n_tiles = (N + kTile - 1) / kTile;
  p.wide = p.rows_log2 + p.windows_log2 > 16;
  p.ws_bytes = (p.n_slabs + 1) * p.n_tiles * 4LL + N * (p.wide ? 8LL : 4LL);
  return p;
}

// Dynamic shared memory of each kernel.
template <typename P>
size_t partition_smem(long long n_slabs) {
  return kTile * sizeof(P) + (size_t)n_slabs * kCntStride * 4;
}

template <int C>
size_t accumulate_smem() {
  return ((size_t)C << block_rows_log2<C>()) * 4 +
         kChunk * (sizeof(typename Vec<C>::T) + 2) +
         (2 * kWinTiles + 1 + kCounts) * 4;
}

// Exclusive scan of one int a thread over the block; *total gets the sum.
// warp_sums holds 32 ints.  Ends with a barrier (warp_sums is free again).
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = x - v + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[n_warps - 1];
  __syncthreads();
  return excl;
}

// Shared memory: the sorted tile's staged words [kTile] (P), then the
// counters [n_slabs, kCntStride] (a slab's warps in order, padded so that
// a thread a slab reads them without bank conflicts).  P, an update's row
// within its slab in the low half and its place in the tile in the high
// half: 32 bits unless a slab has more than 2^16 rows.
template <typename P>
__global__ void __launch_bounds__(kPartThreads, 3)
scatter_partition_kernel(const int* __restrict__ idx, P* __restrict__ stage,
                         int* __restrict__ offs, long long N, long long S,
                         int slab_shift, int n_slabs) {
  constexpr int kHalf = sizeof(P) * 4;
  extern __shared__ __align__(16) unsigned char smem[];
  P* tword = reinterpret_cast<P*>(smem);
  int* cnt = reinterpret_cast<int*>(tword + kTile);
  __shared__ int warp_sums[32];

  const long long t = blockIdx.x;
  const long long base = t * kTile;
  const int n = (int)(N - base < kTile ? N - base : kTile);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = threadIdx.x; e < n_slabs * kCntStride; e += kPartThreads)
    cnt[e] = 0;

  // Each warp ranks its kTile / 8 updates within their slabs, in order:
  // its indices loaded first, all in flight together, then the lanes that
  // share a slab in each round of 32 (one ballot a bit of the label: the
  // slab, or n_slabs for an update that is skipped), then the counts.
  const int q0 = warp * (kTile / kPartWarps) + lane;
  const int bits = bit_width(n_slabs);
  int row[kPasses];
  unsigned peers[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p)
    row[p] = q0 + p * 32 < n ? idx[base + q0 + p * 32] : -1;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    if (row[p] < 0 || (long long)row[p] >= S) row[p] = -1;
    const int label = row[p] < 0 ? n_slabs : row[p] >> slab_shift;
    peers[p] = kFull;
#pragma unroll
    for (int b = 0; b < kLabelBits; ++b) {
      if (b < bits) {
        const bool one = (label >> b) & 1;
        const unsigned m = __ballot_sync(kFull, one);
        peers[p] &= one ? m : ~m;
      }
    }
  }
  __syncthreads();   // the counters are zero
  int rank[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int slab = row[p] < 0 ? -1 : row[p] >> slab_shift;
    const int leader = __ffs(peers[p]) - 1;
    int before = 0;
    if (slab >= 0 && lane == leader) before = cnt[slab * kCntStride + warp];
    before = __shfl_sync(kFull, before, leader);
    rank[p] = before + __popc(peers[p] & ((1u << lane) - 1u));
    if (slab >= 0 && lane == leader)
      cnt[slab * kCntStride + warp] = before + __popc(peers[p]);
    __syncwarp();
  }
  __syncthreads();

  // Scan the counters (slab-major, warp-minor): each thread a run of slabs.
  const int per = (n_slabs + kPartThreads - 1) / kPartThreads;
  const int s0 = threadIdx.x * per;
  const int s1 = s0 + per < n_slabs ? s0 + per : n_slabs;
  int sum = 0;
  for (int s = s0; s < s1; ++s)
#pragma unroll
    for (int w = 0; w < kPartWarps; ++w) sum += cnt[s * kCntStride + w];
  int total;
  int run = block_exclusive_scan(sum, warp_sums, &total);
  int* toffs = offs + t * (n_slabs + 1);
  for (int s = s0; s < s1; ++s) {
    toffs[s] = run;
#pragma unroll
    for (int w = 0; w < kPartWarps; ++w) {
      const int c = cnt[s * kCntStride + w];
      cnt[s * kCntStride + w] = run;
      run += c;
    }
  }
  if (threadIdx.x == 0) toffs[n_slabs] = total;
  __syncthreads();

  // The tile sorted stably by slab, in shared memory, then out coalesced.
  // The accumulate may launch now; it waits for this grid's writes.
  asm volatile("griddepcontrol.launch_dependents;");
  const P in_slab = ((P)1 << slab_shift) - 1;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int j = row[p];
    if (j >= 0) {
      const int at = cnt[(j >> slab_shift) * kCntStride + warp] + rank[p];
      tword[at] = ((P)j & in_slab) | ((P)(q0 + p * 32) << kHalf);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += kPartThreads)
    stage[base + i] = tword[i];
}

// Shared memory: accumulators [rows * C] f32, the chunk's payloads [kChunk]
// (V), the window's run offsets woff [kWinTiles + 1] and run starts wbeg
// [kWinTiles], the chunk's counts [owner, warp] [kCounts], the chunk's rows
// [kChunk] (uint16).
template <int C, typename P>
__global__ void __launch_bounds__(kAccThreads, 2)
scatter_kernel(const float* __restrict__ pay, const P* __restrict__ stage,
               const int* __restrict__ offs, float* __restrict__ out,
               long long S, int windows_log2, int n_slabs, long long n_tiles) {
  using V = typename Vec<C>::T;
  constexpr int kRowsLog2 = block_rows_log2<C>();
  constexpr int rows = 1 << kRowsLog2;
  constexpr int own_shift = kRowsLog2 - kOwnersLog2;   // log2 of an owner's rows
  constexpr int kHalf = sizeof(P) * 4;
  constexpr int kTilesPer = kWinTiles / kAccThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);
  V* bpay = reinterpret_cast<V*>(acc + rows * C);
  int* woff = reinterpret_cast<int*>(bpay + kChunk);
  int* wbeg = woff + kWinTiles + 1;
  int* cnt = wbeg + kWinTiles;
  unsigned short* brow = reinterpret_cast<unsigned short*>(cnt + kCounts);
  __shared__ int warp_sums[32];

  const long long s = blockIdx.x;
  const int wrow0 = blockIdx.y << kRowsLog2;   // the window, in its slab
  const long long row0 = (s << (kRowsLog2 + windows_log2)) + wrow0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int i = threadIdx.x; i < rows * C; i += kAccThreads) acc[i] = 0.f;
  // The partition's writes are visible from here (it may still be ending
  // when this prologue runs: programmatic dependent launch).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long stride = n_slabs + 1;
  const V* pv = reinterpret_cast<const V*>(pay);

  // Tiles in windows of kWinTiles: the slab's runs, concatenated.
  for (long long t0 = 0; t0 < n_tiles; t0 += kWinTiles) {
    int c[kTilesPer], a[kTilesPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kTilesPer; ++k) {
      const long long t = t0 + threadIdx.x * kTilesPer + k;
      c[k] = a[k] = 0;
      if (t < n_tiles) {
        a[k] = offs[t * stride + s];
        c[k] = offs[t * stride + s + 1] - a[k];
      }
      sum += c[k];
    }
    int total;
    int run = block_exclusive_scan(sum, warp_sums, &total);
#pragma unroll
    for (int k = 0; k < kTilesPer; ++k) {
      const int j = threadIdx.x * kTilesPer + k;
      woff[j] = run;           // the run's first position
      wbeg[j] = a[k] - run;    // its place in the tile, less that position
      run += c[k];
    }
    if (threadIdx.x == 0) woff[kWinTiles] = total;
    __syncthreads();

    for (int q0 = 0; q0 < total; q0 += kChunk) {
      // Load: warp w holds the chunk's positions [w * 32 * kPer, +32 *
      // kPer), each found in its tile's run: lane k of the warp finds the
      // tile of the first of the k-th 32 (the last tile lo with woff[lo] <=
      // q), and each lane steps on from there to its own.
      int q[kPer], lo[kPer], r[kPer];
      P word[kPer];
      V v[kPer];
      int first = 0;
      {
        const int qf = q0 + (warp * kPer + (lane < kPer ? lane : 0)) * 32;
#pragma unroll
        for (int step = kWinTiles / 2; step > 0; step >>= 1)
          if (woff[first + step] <= qf) first += step;
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        q[k] = q0 + (warp * kPer + k) * 32 + lane;
        lo[k] = __shfl_sync(kFull, first, k);
        while (q[k] < total && woff[lo[k] + 1] <= q[k]) ++lo[k];
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        word[k] = 0;
        if (q[k] < total)
          word[k] = stage[(t0 + lo[k]) * kTile + wbeg[lo[k]] + q[k]];
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int j = (int)(word[k] & (((P)1 << kHalf) - 1)) - wrow0;
        r[k] = -1;
        v[k] = Vec<C>::zero();
        if (q[k] < total && j >= 0 && j < rows) {
          r[k] = j;
          v[k] = pv[(t0 + lo[k]) * kTile + (long long)(word[k] >> kHalf)];
        }
      }
      // Rank each update among this warp's updates of its owner, in order:
      // lane o (< 16) keeps the count of owner o so far.
      unsigned key[kPer];   // owner << 16 | rank
      int mine = 0;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int o = r[k] < 0 ? 0 : r[k] >> own_shift;
        unsigned m = __ballot_sync(kFull, r[k] >= 0);
#pragma unroll
        for (int b = 0; b < kOwnersLog2; ++b) {
          const unsigned bb = __ballot_sync(kFull, (o >> b) & 1);
          m &= ((lane >> b) & 1) ? bb : ~bb;
        }
        // m: in lane o, the lanes that hold owner o (o < 16)
        const unsigned peers = __shfl_sync(kFull, m, o);
        const int before = __shfl_sync(kFull, mine, o);
        key[k] = ((unsigned)o << 16) | (unsigned)(before + __popc(peers & below));
        mine += __popc(m);
      }
      if (lane < kAccWarps) cnt[lane * kAccWarps + warp] = mine;
      // The last chunk's adds are done from here.
      __syncthreads();
      // Exclusive scan of the counts, owner-major and warp-minor.
      int x = 0, c0 = 0;
      if (threadIdx.x < kCounts) {
        c0 = x = cnt[threadIdx.x];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, x, d);
          if (lane >= d) x += y;
        }
        if (lane == 31) warp_sums[warp] = x;
      }
      __syncthreads();
      int kept = 0, before = 0;
#pragma unroll
      for (int w = 0; w < kCounts / 32; ++w) {
        if (w == warp) before = kept;
        kept += warp_sums[w];
      }
      if (threadIdx.x < kCounts) cnt[threadIdx.x] = before + x - c0;
      __syncthreads();
      const int beg = cnt[warp * kAccWarps];
      const int end = warp + 1 < kAccWarps ? cnt[(warp + 1) * kAccWarps] : kept;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (r[k] >= 0) {
          const int at = cnt[(key[k] >> 16) * kAccWarps + warp] + (key[k] & 0xffff);
          brow[at] = (unsigned short)r[k];
          bpay[at] = v[k];
        }
      }
      __syncthreads();
      // This warp's owner: its updates in order, 32 at a time.  Lanes on
      // one row group; the lowest adds the group's payloads in lane order.
      for (int b = beg; b < end; b += 32) {
        const int e = b + lane;
        const int rr = e < end ? brow[e] : -1;
        unsigned peers = __ballot_sync(kFull, rr >= 0);
#pragma unroll
        for (int bit = 0; bit < own_shift; ++bit) {
          const bool one = (rr >> bit) & 1;
          const unsigned bb = __ballot_sync(kFull, one);
          peers &= one ? bb : ~bb;
        }
        if (rr >= 0 && (peers & below) == 0) {
          float sums[C];
#pragma unroll
          for (int i = 0; i < C; ++i) sums[i] = acc[rr * C + i];
          for (unsigned m = peers; m; m &= m - 1) {
            const float* p =
                reinterpret_cast<const float*>(bpay + b + __ffs(m) - 1);
#pragma unroll
            for (int i = 0; i < C; ++i) sums[i] = __fadd_rn(sums[i], p[i]);
          }
#pragma unroll
          for (int i = 0; i < C; ++i) acc[rr * C + i] = sums[i];
        }
        __syncwarp();
      }
    }
    __syncthreads();   // woff and wbeg are rewritten by the next window
  }

  __syncthreads();
  V* ov = reinterpret_cast<V*>(out);
  const V* av = reinterpret_cast<const V*>(acc);
  for (int i = threadIdx.x; i < rows; i += kAccThreads)
    if (row0 + i < S) ov[row0 + i] = av[i];
}

// Allows each kernel the most dynamic shared memory it can take, once per
// device.
template <int C, typename P>
cudaError_t allow_shared_memory() {
  static bool done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(scatter_partition_kernel<P>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)partition_smem<P>(kMaxSlabs));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        scatter_kernel<C, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)accumulate_smem<C>());
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <int C, typename P>
int run(const int* idx, const float* pay, float* out, unsigned char* ws,
        long long N, long long S, const Plan& p, cudaStream_t st) {
  P* stage = reinterpret_cast<P*>(ws);
  int* offs = reinterpret_cast<int*>(stage + N);
  const int slab_shift = p.rows_log2 + p.windows_log2;
  cudaError_t e = allow_shared_memory<C, P>();
  if (e != cudaSuccess) return (int)e;
  if (p.n_tiles > 0) {
    scatter_partition_kernel<P><<<(unsigned)p.n_tiles, kPartThreads,
                                  partition_smem<P>(p.n_slabs), st>>>(
        idx, stage, offs, N, S, slab_shift, (int)p.n_slabs);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // Launched as a programmatic dependent of the partition: its prologue
  // overlaps the partition's end.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.n_slabs, 1u << p.windows_log2);
  cfg.blockDim = dim3(kAccThreads);
  cfg.dynamicSmemBytes = accumulate_smem<C>();
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, scatter_kernel<C, P>, pay,
                         (const P*)stage, (const int*)offs, out, S,
                         p.windows_log2, (int)p.n_slabs, p.n_tiles);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* nvr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// idx [N] int32; pay [N, C] f32 (rows aligned to their width); out [S, C]
// f32, every row written here; ws: ws_bytes of workspace, at least
// N * (4 or 8) + (n_slabs + 1) * n_tiles * 4 (16-byte aligned).
// C in {1, 2, 4}, N >= 0, S > 0.
int nvr_scatter_level(const void* idx, const void* pay, void* out, void* ws,
                      int C, long long N, long long S, long long ws_bytes,
                      void* stream) {
  if ((C != 1 && C != 2 && C != 4) || N < 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(C, N, S);
  if (ws_bytes < p.ws_bytes || p.windows_log2 > 15)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned char* w = (unsigned char*)ws;
  const int* i = (const int*)idx;
  const float* y = (const float*)pay;
  float* o = (float*)out;
  if (p.wide) {
    switch (C) {
      case 1: return run<1, unsigned long long>(i, y, o, w, N, S, p, st);
      case 2: return run<2, unsigned long long>(i, y, o, w, N, S, p, st);
      default: return run<4, unsigned long long>(i, y, o, w, N, S, p, st);
    }
  }
  switch (C) {
    case 1: return run<1, unsigned>(i, y, o, w, N, S, p, st);
    case 2: return run<2, unsigned>(i, y, o, w, N, S, p, st);
    default: return run<4, unsigned>(i, y, o, w, N, S, p, st);
  }
}

}  // extern "C"
