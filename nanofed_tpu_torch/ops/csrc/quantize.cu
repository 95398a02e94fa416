// Kernels B5, B6 and B7: secure aggregation's fixed-point and mask arithmetic.
//
// Replace nanofed_tpu/ops/quantize.py quantize_u32 (_quantize_kernel), dequantize_u32
// (_dequantize_kernel) and add_mask (_mask_kernel).  The TPU kernels pad a flat vector
// into [256, 512] VMEM tiles; here every kernel walks the flat [n] vector directly with
// a grid-stride loop, 16-byte loads where both pointers allow it and scalar accesses
// for the ragged tail and unaligned starts, so nothing is padded.
//
// Bound on an H100: bytes for B5 and B6 (each element is read once and written once,
// 8 bytes, for one multiply and one conversion).  B7 reads and writes 8 bytes per
// element too, but its Philox4x64-10 costs some 41 32-bit integer operations per
// output word (328 per 8-word block: ten rounds of two 64x64->128-bit products and two
// 3-way XORs, one LOP3 per 32-bit half, then the eight adds; the key bumps depend only
// on the launch's key, the same in every thread), so at the card's INT32 rate (64 lanes
// per SM, a quarter of the f32 FMA rate in operations) its operations take slightly
// longer than its bytes.
// The kernels are simple and fast enough that at the mnist_cnn width (1.2M words) a
// launch costs about as much as the work.
//
// B5  out[i] = bits(int32(round_half_even(x[i] * 2^frac)))   (float32 -> uint32)
//     x * 2^frac is exact (a power of two).  Outside |x * 2^frac| < 2^31, which the
//     secure-aggregation contract excludes, the result saturates to INT32_MIN or
//     INT32_MAX and NaN gives 0; the plain version does the same.
// B6  out[i] = float(int32(q[i])) * 2^-frac                  (uint32 -> float32)
//     One rounding (int32 -> float32, to nearest even); the scale is exact.
// B7  out[i] = q[i] + m[i]  or  q[i] - m[i]  (mod 2^32)
//     m is numpy's Philox4x64-10 stream (np.random.Philox) under the 128-bit key
//     (k0, k1): block b (b = 0, 1, ...) is the Philox of the 256-bit counter (b+1, 0,
//     0, 0), because numpy increments the counter before each block; its four 64-bit
//     words give uint32 m[8b .. 8b+7] as (low half, high half) of each word in turn.
//     Nothing but the output is written: the mask never exists in memory.
#include "common.cuh"

namespace {

using nanofed::kThreads;

constexpr int kMaxBlocks = 4096;  // grid-stride beyond 4096 x 256 threads

__device__ __forceinline__ uint32_t to_fixed(float x, float scale) {
  const float s = x * scale;
  int32_t r;
  if (s != s) {
    r = 0;
  } else if (s >= 2147483648.0f) {
    r = INT32_MAX;
  } else if (s < -2147483648.0f) {
    r = INT32_MIN;
  } else {
    r = __float2int_rn(s);  // cvt.rni: round half to even, like jnp.round
  }
  return static_cast<uint32_t>(r);
}

__device__ __forceinline__ float from_fixed(uint32_t q, float inv_scale) {
  return __fmul_rn(__int2float_rn(static_cast<int32_t>(q)), inv_scale);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) quantize_kernel(
    const float* __restrict__ x, uint32_t* __restrict__ out, int64_t n, float scale) {
  const int64_t groups = (n + VEC - 1) / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const int64_t i = g * VEC;
    if constexpr (VEC == 4) {
      if (i + 4 <= n) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(x + i));
        *reinterpret_cast<uint4*>(out + i) = make_uint4(
            to_fixed(v.x, scale), to_fixed(v.y, scale), to_fixed(v.z, scale),
            to_fixed(v.w, scale));
        continue;
      }
    }
    for (int k = 0; k < VEC && i + k < n; ++k) out[i + k] = to_fixed(__ldg(x + i + k), scale);
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) dequantize_kernel(
    const uint32_t* __restrict__ q, float* __restrict__ out, int64_t n, float inv_scale) {
  const int64_t groups = (n + VEC - 1) / VEC;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < groups;
       g += stride) {
    const int64_t i = g * VEC;
    if constexpr (VEC == 4) {
      if (i + 4 <= n) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(q + i));
        *reinterpret_cast<float4*>(out + i) = make_float4(
            from_fixed(v.x, inv_scale), from_fixed(v.y, inv_scale),
            from_fixed(v.z, inv_scale), from_fixed(v.w, inv_scale));
        continue;
      }
    }
    for (int k = 0; k < VEC && i + k < n; ++k) out[i + k] = from_fixed(__ldg(q + i + k), inv_scale);
  }
}

// Philox4x64-10 (Salmon et al., SC 2011), the Random123 / numpy definition.
constexpr uint64_t kPhiloxM0 = 0xD2E7470EE14C6C93ull;
constexpr uint64_t kPhiloxM1 = 0xCA5A826395121157ull;
constexpr uint64_t kPhiloxW0 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kPhiloxW1 = 0xBB67AE8584CAA73Bull;

__device__ __forceinline__ void philox4x64_10(uint64_t (&c)[4], uint64_t k0, uint64_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint64_t hi0 = __umul64hi(kPhiloxM0, c[0]);
    const uint64_t lo0 = kPhiloxM0 * c[0];
    const uint64_t hi1 = __umul64hi(kPhiloxM1, c[2]);
    const uint64_t lo1 = kPhiloxM1 * c[2];
    const uint64_t n0 = hi1 ^ c[1] ^ k0;
    const uint64_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__device__ __forceinline__ uint32_t combine(uint32_t q, uint32_t m, bool subtract) {
  return subtract ? q - m : q + m;  // uint32 wraps modulo 2^32
}

// One thread per Philox block: 8 output words.
template <int VEC>
__global__ void __launch_bounds__(kThreads) add_mask_kernel(
    const uint32_t* __restrict__ q, uint32_t* __restrict__ out, int64_t n, uint64_t k0,
    uint64_t k1, int subtract) {
  const int64_t blocks = (n + 7) / 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const bool sub = subtract != 0;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; b < blocks;
       b += stride) {
    uint64_t c[4] = {static_cast<uint64_t>(b) + 1, 0, 0, 0};
    philox4x64_10(c, k0, k1);
    const uint32_t m[8] = {
        static_cast<uint32_t>(c[0]), static_cast<uint32_t>(c[0] >> 32),
        static_cast<uint32_t>(c[1]), static_cast<uint32_t>(c[1] >> 32),
        static_cast<uint32_t>(c[2]), static_cast<uint32_t>(c[2] >> 32),
        static_cast<uint32_t>(c[3]), static_cast<uint32_t>(c[3] >> 32)};
    const int64_t i = b * 8;
    if constexpr (VEC == 4) {
      if (i + 8 <= n) {
        const uint4 a = __ldg(reinterpret_cast<const uint4*>(q + i));
        const uint4 d = __ldg(reinterpret_cast<const uint4*>(q + i + 4));
        *reinterpret_cast<uint4*>(out + i) = make_uint4(
            combine(a.x, m[0], sub), combine(a.y, m[1], sub), combine(a.z, m[2], sub),
            combine(a.w, m[3], sub));
        *reinterpret_cast<uint4*>(out + i + 4) = make_uint4(
            combine(d.x, m[4], sub), combine(d.y, m[5], sub), combine(d.z, m[6], sub),
            combine(d.w, m[7], sub));
        continue;
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (i + k < n) out[i + k] = combine(__ldg(q + i + k), m[k], sub);
    }
  }
}

unsigned grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? (blocks > 0 ? blocks : 1) : kMaxBlocks);
}

}  // namespace

// x: [n] f32; out: [n] uint32; vec 4 needs both pointers 16-byte aligned.
extern "C" int nf_quantize_u32(const float* x, uint32_t* out, int64_t n, float scale,
                               int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    quantize_kernel<4><<<grid_for((n + 3) / 4), kThreads, 0, s>>>(x, out, n, scale);
  } else if (vec == 1) {
    quantize_kernel<1><<<grid_for(n), kThreads, 0, s>>>(x, out, n, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q: [n] uint32; out: [n] f32; vec 4 needs both pointers 16-byte aligned.
extern "C" int nf_dequantize_u32(const uint32_t* q, float* out, int64_t n, float inv_scale,
                                 int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    dequantize_kernel<4><<<grid_for((n + 3) / 4), kThreads, 0, s>>>(q, out, n, inv_scale);
  } else if (vec == 1) {
    dequantize_kernel<1><<<grid_for(n), kThreads, 0, s>>>(q, out, n, inv_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q, out: [n] uint32 (distinct buffers); (k0, k1): the 128-bit Philox key; subtract 0
// adds the mask, 1 subtracts it; vec 4 needs both pointers 16-byte aligned.
extern "C" int nf_add_mask(const uint32_t* q, uint32_t* out, int64_t n, uint64_t k0,
                           uint64_t k1, int subtract, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for((n + 7) / 8);
  if (vec == 4) {
    add_mask_kernel<4><<<grid, kThreads, 0, s>>>(q, out, n, k0, k1, subtract);
  } else if (vec == 1) {
    add_mask_kernel<1><<<grid, kThreads, 0, s>>>(q, out, n, k0, k1, subtract);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
