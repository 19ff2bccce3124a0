// Range mark: the device part of a layer range (utils/profiling.py).
//
// One mark is one kernel launched in stream order at a layer boundary of
// the training step.  It reads the device's %globaltimer (ns) and stores
// it, with the id of the range it starts, in the step's slot `slot` of a
// small int64 buffer in device memory.  The step's end mark (`end` != 0)
// stores its own time and then charges every interval of the step, from
// one mark to the next, to the range the first of the two started, and
// the interval from the previous step's end mark to this step's first mark
// to the last range (`step.io`: input copies, the loss copy, and any time
// the device waited for the host between steps).
//
// Buffer (int64), `slots` marks a step and `n_ranges` ranges:
//   [0, slots)                 this step's stamps (ns)
//   [slots, 2 slots)           this step's range ids
//   [2 slots, + n_ranges)      ns charged to each range
//   [.., + n_ranges)           intervals charged to each range (hits)
//   [.., + 2)                  the last end mark's stamp (0: none), steps
//
// What bounds it: launch latency.  A mark stores two words from one
// thread; the end mark charges the step's intervals with one thread each
// (integer atomics, so the sums do not depend on their order).  Stream
// order makes every earlier mark's stores visible to the end mark.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSlots = 64;   // at most one block of threads for the charge

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__global__ void range_mark_kernel(long long* buf, int slot, int id, int slots,
                                  int n_ranges, int end) {
  __shared__ long long now;
  long long* stamp = buf;
  long long* ids = buf + slots;
  if (threadIdx.x == 0) {
    now = global_ns();
    stamp[slot] = now;
    ids[slot] = id;
  }
  if (!end) return;
  __syncthreads();
  unsigned long long* ns = (unsigned long long*)(buf + 2 * slots);
  unsigned long long* hits = ns + n_ranges;
  long long* tail = (long long*)(hits + n_ranges);
  for (int j = threadIdx.x; j < slot; j += blockDim.x) {
    long long next = (j + 1 == slot) ? now : stamp[j + 1];
    int r = (int)ids[j];
    atomicAdd(ns + r, (unsigned long long)(next - stamp[j]));
    atomicAdd(hits + r, 1ULL);
  }
  if (threadIdx.x == 0) {
    if (tail[0] != 0) {
      atomicAdd(ns + n_ranges - 1, (unsigned long long)(stamp[0] - tail[0]));
      atomicAdd(hits + n_ranges - 1, 1ULL);
    }
    tail[0] = now;
    tail[1] += 1;
  }
}

}  // namespace

extern "C" {

const char* nvr_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// buf: int64 [2 * slots + 2 * n_ranges + 2] in device memory; slot in
// [0, slots); id in [0, n_ranges); slots <= 64.  An end mark (end != 0)
// at slot n charges the n marks before it.
int nvr_range_mark(void* buf, int slot, int id, int slots, int n_ranges, int end,
                   void* stream) {
  if (slots > kMaxSlots || slot < 0 || slot >= slots || id < 0 || id >= n_ranges)
    return (int)cudaErrorInvalidValue;
  range_mark_kernel<<<1, end ? kMaxSlots : 1, 0, (cudaStream_t)stream>>>(
      (long long*)buf, slot, id, slots, n_ranges, end);
  return (int)cudaGetLastError();
}

}  // extern "C"
