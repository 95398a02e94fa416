// Kernels B5, B6 and B7: secure aggregation's fixed-point and mask arithmetic; kernel
// B4: the fused int8 dequant-accumulate of the q8/topk aggregation epilogue.
//
// B4 replaces nanofed_tpu/ops/quantize.py dequant_accumulate_flat (_dequant_acc_kernel):
//
//   out[p] = base[p] + sum_c coefs[c] * float(q[c, p]),  coefs = (w * s) / max(denom, 1e-12)
//
// with the O(C) coefficients formed beside the launch.  The per-client dequant scale is
// a row multiplier, so it folds into the reduce coefficients and the dequantized [C, P]
// float32 stack never exists.  Bound on an H100: bytes.  The int8 stack is read once
// (C*P bytes), base read and out written once (8*P), plus the C-sized vectors: at
// P = 1,199,882 that is 86 MB at C = 64 (0.0258 ms at 3.35 TB/s) and 1.2 GB at C = 1000
// (0.361 ms); its 2*C*P flops take a tenth of that at 67 TFLOP/s f32.
// Design: B1's.  Each thread owns VEC contiguous columns (VEC = 16, 8, 4, 2 or 1 int8,
// the widest load every row start allows: the caller pads the row stride to 16 bytes)
// and walks the C rows in a fixed order, converting each int8 to float32 in registers
// and FMA-ing it with coefs[c].  The coefficients are staged through shared memory in
// tiles of kCoefTile, so any C fits.  base is added once and out written once; the
// result does not depend on the launch and is the same on every run.  A thread whose
// VEC columns run past P takes the ragged tail one byte at a time.
//
// B5-B7 replace nanofed_tpu/ops/quantize.py quantize_u32 (_quantize_kernel),
// dequantize_u32 (_dequantize_kernel) and add_mask (_mask_kernel).  The TPU kernels pad a flat vector
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

constexpr int kCoefTile = 1024;  // B4 coefficients staged per shared-memory tile (4 KB)

// The int8 in byte k (little-endian) of w, sign-extended, as a float (exact).
__device__ __forceinline__ float byte_to_float(uint32_t w, int k) {
  return static_cast<float>(static_cast<int32_t>(w << (24 - 8 * k)) >> 24);
}

// VEC int8 values in one load (16, 8, 4, 2 or 1 bytes), converted to float in
// registers.  The caller guarantees `p` is aligned to VEC bytes.
template <int VEC>
__device__ __forceinline__ void load_i8(const int8_t* __restrict__ p, float (&v)[VEC]) {
  uint32_t w[(VEC + 3) / 4];
  if constexpr (VEC == 16) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else if constexpr (VEC == 8) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = t.x; w[1] = t.y;
  } else if constexpr (VEC == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VEC == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = byte_to_float(w[k / 4], k % 4);
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) dequant_acc_kernel(
    const int8_t* __restrict__ q, int64_t ldq, const float* __restrict__ coefs, int64_t C,
    int64_t P, const float* __restrict__ base, bool base_vec4, float* __restrict__ out) {
  __shared__ float s_coef[kCoefTile];
  const int64_t p0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  // Columns this thread owns: VEC, fewer at the ragged end, none past P.  A thread
  // with none still takes part in every tile's barriers.
  const int n = p0 >= P ? 0 : (P - p0 < VEC ? static_cast<int>(P - p0) : VEC);
  const int8_t* col = q + p0;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int64_t c0 = 0; c0 < C; c0 += kCoefTile) {
    const int tile = (C - c0 < kCoefTile) ? static_cast<int>(C - c0) : kCoefTile;
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < tile; i += kThreads) s_coef[i] = __ldg(coefs + c0 + i);
    __syncthreads();
    const int8_t* rows = col + c0 * ldq;
    if (n == VEC) {
#pragma unroll 4
      for (int c = 0; c < tile; ++c) {
        float v[VEC];
        load_i8<VEC>(rows + c * ldq, v);
        const float cc = s_coef[c];
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(cc, v[i], acc[i]);
      }
    } else if (n > 0) {
      for (int c = 0; c < tile; ++c) {
        const float cc = s_coef[c];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          if (i < n) {
            const uint32_t b = __ldg(reinterpret_cast<const unsigned char*>(rows + c * ldq + i));
            acc[i] = fmaf(cc, byte_to_float(b, 0), acc[i]);
          }
        }
      }
    }
  }

  if constexpr (VEC >= 4) {
    if (n == VEC) {  // out + p0 is 16-byte aligned: out is, and p0 is a multiple of 4
#pragma unroll
      for (int i = 0; i < VEC; i += 4) {
        float4 b;
        if (base_vec4) {
          b = __ldg(reinterpret_cast<const float4*>(base + p0 + i));
        } else {
          b = make_float4(__ldg(base + p0 + i), __ldg(base + p0 + i + 1),
                          __ldg(base + p0 + i + 2), __ldg(base + p0 + i + 3));
        }
        *reinterpret_cast<float4*>(out + p0 + i) =
            make_float4(b.x + acc[i], b.y + acc[i + 1], b.z + acc[i + 2], b.w + acc[i + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (i < n) out[p0 + i] = __ldg(base + p0 + i) + acc[i];
  }
}

template <int VEC>
cudaError_t launch_dequant_acc(const int8_t* q, int64_t ldq, const float* coefs, int64_t C,
                               int64_t P, const float* base, bool base_vec4, float* out,
                               cudaStream_t stream) {
  const int64_t threads = (P + VEC - 1) / VEC;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  dequant_acc_kernel<VEC><<<blocks, kThreads, 0, stream>>>(q, ldq, coefs, C, P, base,
                                                           base_vec4, out);
  return cudaGetLastError();
}

}  // namespace

// B4.  q: [C, P] int8 with row stride ldq (bytes); coefs: [C] f32; base: [P] f32
// (base_vec4 1 when it is 16-byte aligned); out: [P] f32, 16-byte aligned, not base;
// vec: int8 values per load (16, 8, 4, 2 or 1), which must divide ldq and q's address.
extern "C" int nf_dequant_accumulate(const int8_t* q, int64_t ldq, const float* coefs,
                                     int64_t C, int64_t P, const float* base, int base_vec4,
                                     float* out, int vec, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b4 = base_vec4 != 0;
  switch (vec) {
    case 16: return static_cast<int>(launch_dequant_acc<16>(q, ldq, coefs, C, P, base, b4, out, s));
    case 8: return static_cast<int>(launch_dequant_acc<8>(q, ldq, coefs, C, P, base, b4, out, s));
    case 4: return static_cast<int>(launch_dequant_acc<4>(q, ldq, coefs, C, P, base, b4, out, s));
    case 2: return static_cast<int>(launch_dequant_acc<2>(q, ldq, coefs, C, P, base, b4, out, s));
    case 1: return static_cast<int>(launch_dequant_acc<1>(q, ldq, coefs, C, P, base, b4, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

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
