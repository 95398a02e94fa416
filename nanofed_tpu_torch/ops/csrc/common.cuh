// Helpers shared by the port's hand-written kernels (included, not compiled alone).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nanofed {

// Every kernel of the port launches 256-thread blocks.
constexpr int kThreads = 256;

// VEC contiguous floats in one load: 16 bytes (float4), 8 (float2) or 4.  The
// caller guarantees `p` is aligned to 4 * VEC bytes.
template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum over a kThreads block in a fixed tree, so the result is the same on every
// run.  Every thread of the block must call it; the sum is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = (threadIdx.x < kThreads / 32) ? warp_sums[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

}  // namespace nanofed

extern "C" const char* nf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
