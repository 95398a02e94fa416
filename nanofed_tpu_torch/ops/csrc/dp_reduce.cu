// Kernel B3: per-row squared L2 norms, [C, P] -> [C].
//
// Replaces nanofed_tpu/ops/dp_reduce.py row_sq_norms (_sq_norm_kernel), which
// accumulated into one [1, C] output block across a grid the TPU runs in order.
//
// Bound on an H100: bytes.  It reads x once (4*C*P bytes) for 2*C*P flops; at the
// flagship chunk (C=125, P=1,199,882) the 600 MB read takes at least 0.18 ms.
//
// Design: CUDA blocks run concurrently and in no order, so the TPU kernel's
// carried accumulator has no counterpart.  Float atomics would make the sum depend
// on the order blocks finish; instead the reduction has two fixed-order stages:
//   1. a grid of (segment, row) blocks; each sums x[row, seg*L:(seg+1)*L]^2 with
//      coalesced VEC-wide loads, then a fixed tree over the block, and writes one
//      partial into partial[row, seg];
//   2. one warp per row sums that row's partials in a fixed order.
// The result is the same on every run.  Segments of L = 256 * VEC * 16 columns give
// thousands of stage-1 blocks at the flagship shape, enough to keep every SM's
// loads in flight; stage 2 reads C * ceil(P / L) floats, a rounding error.
#include "common.cuh"

namespace {

using nanofed::kThreads;

template <int VEC>
__global__ void __launch_bounds__(kThreads) row_sq_partial_kernel(
    const float* __restrict__ x, int64_t ldx, int64_t P, int64_t seg_len,
    float* __restrict__ partial) {
  const int64_t row = blockIdx.y;
  const int64_t seg = blockIdx.x;
  const float* r = x + row * ldx;
  const int64_t start = seg * seg_len;
  const int64_t end = (start + seg_len < P) ? start + seg_len : P;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

#pragma unroll 4
  for (int64_t p = start + static_cast<int64_t>(threadIdx.x) * VEC; p < end;
       p += static_cast<int64_t>(kThreads) * VEC) {
    if (p + VEC <= end) {
      float v[VEC];
      nanofed::load_vec<VEC>(r + p, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(v[i], v[i], acc[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (p + i < end) {
          const float v = __ldg(r + p + i);
          acc[i] = fmaf(v, v, acc[i]);
        }
      }
    }
  }

  float total = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) total += acc[i];
  total = nanofed::block_sum(total);
  if (threadIdx.x == 0) partial[row * gridDim.x + seg] = total;
}

__global__ void row_sq_final_kernel(const float* __restrict__ partial, int64_t nseg,
                                    float* __restrict__ out) {
  const int64_t row = blockIdx.x;
  float acc = 0.f;
  for (int64_t i = threadIdx.x; i < nseg; i += 32) acc += partial[row * nseg + i];
  acc = nanofed::warp_sum(acc);
  if (threadIdx.x == 0) out[row] = acc;
}

template <int VEC>
cudaError_t launch(const float* x, int64_t ldx, int64_t C, int64_t P, int64_t seg_len,
                   int64_t nseg, float* partial, float* out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(nseg), static_cast<unsigned>(C));
  row_sq_partial_kernel<VEC><<<grid, kThreads, 0, stream>>>(x, ldx, P, seg_len, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  row_sq_final_kernel<<<static_cast<unsigned>(C), 32, 0, stream>>>(partial, nseg, out);
  return cudaGetLastError();
}

}  // namespace

// x: [C, P] f32 with row stride ldx (elements); partial: [C, nseg] f32 scratch with
// nseg = ceil(P / seg_len); out: [C] f32.  Returns cudaGetLastError().
extern "C" int nf_row_sq_norms(const float* x, int64_t ldx, int64_t C, int64_t P,
                               int64_t seg_len, int64_t nseg, float* partial, float* out,
                               int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: return static_cast<int>(launch<4>(x, ldx, C, P, seg_len, nseg, partial, out, s));
    case 2: return static_cast<int>(launch<2>(x, ldx, C, P, seg_len, nseg, partial, out, s));
    case 1: return static_cast<int>(launch<1>(x, ldx, C, P, seg_len, nseg, partial, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
