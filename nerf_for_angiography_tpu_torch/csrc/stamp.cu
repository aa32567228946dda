// A device timestamp taken in stream order: one thread writes %globaltimer
// (nanoseconds, the same clock on every SM) into a slot.  A launch recorded
// while a stream is captured into a CUDA graph becomes a kernel node of the
// graph, so every replay writes the slot again: utils/profiling.py's step
// spans read the times of a replayed step from these slots.
//
// Why a kernel and not an event: a timing cudaEvent recorded inside a graph
// (an event-record node) costs the card about 4 us a node on the H100
// against about 0.9 us for this one-thread kernel node, in a chain of small
// kernels as a train step is.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(unsigned long long* __restrict__ slots, int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[i] = t;
}

}  // namespace

extern "C" {

// slots: device uint64 (int64) array; writes slot i on the stream
int stamp(void* slots, int i, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(slots), i);
  return (int)cudaGetLastError();
}

}  // extern "C"
