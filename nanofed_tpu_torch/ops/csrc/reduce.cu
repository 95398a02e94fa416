// Kernel B1: the FedAvg weighted reduce over the client axis, [C, P] x [C] -> [P].
//
// Replaces nanofed_tpu/ops/reduce.py weighted_mean_flat (_wmean_kernel), which the
// TPU ran as one MXU dot per 512-lane tile in full f32 (Precision.HIGHEST).
//
//   normalised:  out[p]  = sum_c w[c] * x[c, p] / max(denom or sum_c w[c], 1e-12)
//   accumulate:  out[p] += sum_c w[c] * x[c, p]          (the streamed round)
//
// Bound on an H100: bytes.  It reads x once (4*C*P bytes) and does 2*C*P flops, a
// quarter of a flop per byte, far below the ~20 flop/byte where f32 FMA would bind
// (67 TFLOP/s over 3.35 TB/s).  At the flagship chunk (C=125, P=1,199,882) the
// 600 MB read takes at least 0.18 ms.
//
// Design: each thread owns VEC contiguous columns and walks the C rows in a fixed
// order with f32 FMAs, so neighbouring threads read neighbouring 16-byte (float4)
// words of a row and every byte of x is read exactly once.  No shared memory, no
// atomics, no tensor cores (the reference asks for full f32, which TF32 is not):
// the result does not depend on the launch and is the same on every run.  VEC is
// 4, 2 or 1, the widest that keeps every row start aligned (the caller pads the
// row stride to a multiple of 4 where it can); a thread whose VEC columns run
// past P masks the ragged tail.  The normalised form computes sum(w) in each
// block with a fixed-order tree; it is C floats, read from L2.
#include "common.cuh"

namespace {

using nanofed::kThreads;

template <int VEC, bool ACCUMULATE>
__global__ void __launch_bounds__(kThreads) weighted_sum_kernel(
    const float* __restrict__ x, int64_t ldx, const float* __restrict__ w, int64_t C,
    int64_t P, const float* __restrict__ denom, float* __restrict__ out) {
  __shared__ float s_denom;
  if constexpr (!ACCUMULATE) {
    float d;
    if (denom != nullptr) {
      d = *denom;
    } else {
      float part = 0.f;
      for (int64_t c = threadIdx.x; c < C; c += kThreads) part += w[c];
      d = nanofed::block_sum(part);
    }
    if (threadIdx.x == 0) s_denom = fmaxf(d, 1e-12f);
    __syncthreads();
  }

  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (p0 >= P) return;
  const int n = (P - p0 < VEC) ? static_cast<int>(P - p0) : VEC;
  const float* col = x + p0;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  if (n == VEC) {
#pragma unroll 4
    for (int64_t c = 0; c < C; ++c) {
      const float wc = __ldg(w + c);
      float v[VEC];
      nanofed::load_vec<VEC>(col + c * ldx, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wc, v[i], acc[i]);
    }
  } else {
    for (int64_t c = 0; c < C; ++c) {
      const float wc = __ldg(w + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (i < n) acc[i] = fmaf(wc, __ldg(col + c * ldx + i), acc[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (i < n) {
      if constexpr (ACCUMULATE) {
        out[p0 + i] += acc[i];
      } else {
        out[p0 + i] = acc[i] / s_denom;
      }
    }
  }
}

template <int VEC>
cudaError_t launch(const float* x, int64_t ldx, const float* w, int64_t C, int64_t P,
                   const float* denom, float* out, bool accumulate, cudaStream_t stream) {
  const int64_t threads = (P + VEC - 1) / VEC;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (accumulate) {
    weighted_sum_kernel<VEC, true><<<blocks, kThreads, 0, stream>>>(x, ldx, w, C, P, denom, out);
  } else {
    weighted_sum_kernel<VEC, false><<<blocks, kThreads, 0, stream>>>(x, ldx, w, C, P, denom, out);
  }
  return cudaGetLastError();
}

}  // namespace

// x: [C, P] f32 with row stride ldx (elements); w: [C] f32; denom: one f32 on the
// device or null (then sum(w)); out: [P] f32.  Returns cudaGetLastError().
extern "C" int nf_weighted_sum(const float* x, int64_t ldx, const float* w, int64_t C,
                               int64_t P, const float* denom, float* out, int accumulate,
                               int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool acc = accumulate != 0;
  switch (vec) {
    case 4: return static_cast<int>(launch<4>(x, ldx, w, C, P, denom, out, acc, s));
    case 2: return static_cast<int>(launch<2>(x, ldx, w, C, P, denom, out, acc, s));
    case 1: return static_cast<int>(launch<1>(x, ldx, w, C, P, denom, out, acc, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
