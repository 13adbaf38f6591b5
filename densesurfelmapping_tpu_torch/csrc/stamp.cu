// Device time stamps for the port's tracer (`utils/timing.py`).
//
// Replaces no TPU kernel: the JAX package has no counterpart (a jitted
// program's phases show in the TPU profiler by their XLA op names, where a
// replayed CUDA graph records no host scope).  One launch of one thread
// takes the next slot of a ring on the card with one atomicAdd on a device
// cursor and writes (tag, %globaltimer) there, so every replay of a graph
// that captured the launch leaves its phases' start times in the ring.  It
// is bound by launch latency (~2 us of device time a stamp on an H100), not
// by bytes (16 written).  Kept in its own source so that the SLIC and SGM
// libraries keep their cached builds.

#include <cuda_runtime.h>

namespace {

__global__ void dsm_stamp_kernel(unsigned long long* cursor, long long* ring,
                                 unsigned long long mask, int tag) {
  const unsigned long long i = atomicAdd(cursor, 1ULL);
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  long long* e = ring + 2 * (i & mask);
  e[0] = tag;
  e[1] = static_cast<long long>(now);
}

}  // namespace

extern "C" {

// cursor: one u64 on the card (the count of stamps ever written); ring:
// `entries` (tag, ns) pairs of i64, entries a power of two.
int dsm_stamp(void* cursor, void* ring, int entries, int tag, void* stream) {
  if (entries < 1 || (entries & (entries - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dsm_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(cursor), static_cast<long long*>(ring),
      static_cast<unsigned long long>(entries - 1), tag);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
