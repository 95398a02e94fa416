// Helpers shared by the port's hand-written kernels (included, not compiled alone).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace nanofed {

// Every kernel of the port launches 256-thread blocks (the bulk-copy ring adds one
// producer warp).
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

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// ---- the persistent grid and the bulk-copy ring (B1/B2 in reduce.cu, B4 in quantize.cu,
// B3 in dp_reduce.cu over (row, segment) pairs)
//
// The host plans each launch (ops/reduce.py launch_plan): `blocks` slabs of columns,
// at most SMs x k blocks, so one wave.  On 16-byte-aligned rows a block streams its
// slab through a ring of `stages` 16 KB stages in dynamic shared memory, filled by one
// producer thread with bulk copies against full/empty mbarrier pairs; kConsumers
// threads compute from shared memory.

constexpr int kConsumers = kThreads;            // the ring's consumer threads
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kBulkThreads = kConsumers + 32;   // + one producer warp
constexpr int kStageUnits = 1024;               // 16-byte units a ring stage holds
constexpr int kStageBytes = kStageUnits * 16;   // 16 KB
constexpr int kMinStages = 2;
constexpr int kMaxStages = 8;
constexpr int kTailLanes = 31;                  // producer-warp lanes 1..31
constexpr int kMaxBlockShared = 232448;         // 227 KB, a block's dynamic limit

// The slab of columns this block owns, in units of VEC elements: the row is cut into
// `units_total` units, the last units_total % gridDim.x blocks take one unit more (so
// the last slab, whose final unit may be partial, is never the narrowest by more than
// one unit).
struct Slab {
  int64_t u0;     // first unit
  int64_t units;  // unit count
};

__device__ __forceinline__ Slab slab_of(int64_t units_total) {
  const int64_t b = blockIdx.x;
  const int64_t base = units_total / gridDim.x;
  const int64_t first_wide = gridDim.x - units_total % gridDim.x;
  return {b * base + (b > first_wide ? b - first_wide : 0), base + (b >= first_wide ? 1 : 0)};
}

// The plan the host computed, checked: `blocks` slabs of `slab` elements (the
// narrower width) over P columns loaded `vec` elements at a time, and for the ring
// (vec == ring_vec, one 16-byte unit) `stages` stages in `shared_bytes` of dynamic
// shared memory.  False for a plan the kernels cannot run.
inline bool plan_ok(int vec, int ring_vec, int64_t P, int64_t blocks, int64_t slab,
                    int stages, int64_t shared_bytes) {
  if (vec < 1 || vec > ring_vec || (vec & (vec - 1)) != 0) return false;
  const int64_t units = (P + vec - 1) / vec;
  if (blocks < 1 || blocks > units || blocks > 0x7fffffff) return false;
  if (slab != (units / blocks) * vec) return false;
  if (vec == ring_vec) {
    return stages >= kMinStages && stages <= kMaxStages &&
           shared_bytes == static_cast<int64_t>(stages) * kStageBytes &&
           shared_bytes <= kMaxBlockShared;
  }
  return stages == 0 && shared_bytes == 0;
}

// Once per ring kernel and device (`done` is the kernel's own flags): allow its
// dynamic shared memory above 48 KB, and prefer shared memory over L1 (the ring
// bypasses L1).  A block's limit covers static and dynamic shared memory together.
inline cudaError_t prepare_ring(const void* kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxBlockShared - static_cast<int>(attr.sharedSizeBytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

// What the card makes of `kernel`: its registers a thread (ptxas's count) and how
// many of its blocks of `threads` an SM holds at `shared_bytes` of dynamic shared
// memory.
inline cudaError_t occupancy(const void* kernel, int threads, int64_t shared_bytes,
                             int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads,
                                                       static_cast<size_t>(shared_bytes));
}

}  // namespace nanofed

extern "C" const char* nf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
