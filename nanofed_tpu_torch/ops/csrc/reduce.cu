// Kernels B1 and B2: the FedAvg weighted reduce over the client axis,
// [C, P] x [C] -> [P], plain (B1) and with every element sanitized (B2).
//
// B1 replaces nanofed_tpu/ops/reduce.py weighted_mean_flat (_wmean_kernel), which
// the TPU ran as one MXU dot per 512-lane tile in full f32 (Precision.HIGHEST):
//
//   normalised:  out[p]  = sum_c w[c] * x[c, p] / max(denom or sum_c w[c], 1e-12)
//   accumulate:  out[p] += sum_c w[c] * x[c, p]          (the streamed round)
//
// B2 replaces nanofed_tpu/ops/reduce.py masked_weighted_mean_flat
// (_masked_wmean_kernel), the validated round's sanitize-then-reduce in one pass:
//
//   sanitized:   out[p]  = sum_c w[c] * s(x[c, p]) / max(sum_c w[c], 1e-12),
//                s(v) = isfinite(v) ? v : 0
//
// with w = weights * valid formed beside the launch (an O(C) tensor op).  Each
// element is sanitized in registers BEFORE its FMA: a rejected client's NaN must be
// zeroed as a value, because 0 * NaN = NaN, and the sanitized [C, P] stack is never
// written.  B2's bound is B1's: x is read once (at the validated flagship, C=1000 x
// 1,199,884 floats = 4.80 GB, 1.43 ms at 3.35 TB/s); the isfinite test is one
// compare per element and does not move it.
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

// isfinite(v) ? v : 0, on the bits: v is NaN or +-inf iff its exponent is all ones.
__device__ __forceinline__ float sanitize(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u ? 0.f : v;
}

template <int VEC, bool ACCUMULATE, bool SANITIZE>
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
      for (int i = 0; i < VEC; ++i) {
        if constexpr (SANITIZE) v[i] = sanitize(v[i]);
        acc[i] = fmaf(wc, v[i], acc[i]);
      }
    }
  } else {
    for (int64_t c = 0; c < C; ++c) {
      const float wc = __ldg(w + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (i < n) {
          float v = __ldg(col + c * ldx + i);
          if constexpr (SANITIZE) v = sanitize(v);
          acc[i] = fmaf(wc, v, acc[i]);
        }
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

// Three instantiations per VEC: B1 normalised, B1 accumulate, B2 (normalised only).
template <int VEC>
cudaError_t launch(const float* x, int64_t ldx, const float* w, int64_t C, int64_t P,
                   const float* denom, float* out, bool accumulate, bool sanitized,
                   cudaStream_t stream) {
  const int64_t threads = (P + VEC - 1) / VEC;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (sanitized) {
    if (accumulate || denom != nullptr) return cudaErrorInvalidValue;
    weighted_sum_kernel<VEC, false, true><<<blocks, kThreads, 0, stream>>>(
        x, ldx, w, C, P, denom, out);
  } else if (accumulate) {
    weighted_sum_kernel<VEC, true, false><<<blocks, kThreads, 0, stream>>>(
        x, ldx, w, C, P, denom, out);
  } else {
    weighted_sum_kernel<VEC, false, false><<<blocks, kThreads, 0, stream>>>(
        x, ldx, w, C, P, denom, out);
  }
  return cudaGetLastError();
}

}  // namespace

// x: [C, P] f32 with row stride ldx (elements); w: [C] f32; denom: one f32 on the
// device or null (then sum(w)); out: [P] f32; sanitized selects B2 (normalised by
// sum(w) only).  Returns cudaGetLastError().
extern "C" int nf_weighted_sum(const float* x, int64_t ldx, const float* w, int64_t C,
                               int64_t P, const float* denom, float* out, int accumulate,
                               int sanitized, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool acc = accumulate != 0;
  const bool san = sanitized != 0;
  switch (vec) {
    case 4: return static_cast<int>(launch<4>(x, ldx, w, C, P, denom, out, acc, san, s));
    case 2: return static_cast<int>(launch<2>(x, ldx, w, C, P, denom, out, acc, san, s));
    case 1: return static_cast<int>(launch<1>(x, ldx, w, C, P, denom, out, acc, san, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
