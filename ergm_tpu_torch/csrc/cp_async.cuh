// Asynchronous 16-byte copies from device memory to shared memory
// (cp.async, sm_80 and later), shared by the kernels K1 and K5.
// A tile's loads are all in flight at once, where a load-then-store loop
// waits one L2 round trip per load; nothing passes through registers.
// Start the copies, then wait_all() and __syncthreads() before reading;
// or close each tile's copies with commit() and wait<N>() until at most N
// later groups are still in flight, so that the next tile's copies overlap
// the work on this one.
#pragma once

#include <cuda_runtime.h>

namespace ergm_async {

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace ergm_async
