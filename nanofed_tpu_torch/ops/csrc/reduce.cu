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
//   sanitized:   out[p]  = sum_c w[c] * s(x[c, p]) / max(denom or sum_c w[c], 1e-12),
//                s(v) = isfinite(v) ? v : 0
//
// (a rank of a mesh passes the whole cohort's valid weight as denom, so the ranks'
// outputs sum to the cohort's mean)
// with w = weights * valid formed beside the launch (an O(C) tensor op).  Each
// element is sanitized in registers BEFORE its FMA: a rejected client's NaN must be
// zeroed as a value, because 0 * NaN = NaN, and the sanitized [C, P] stack is never
// written.  B2 is B1's template with SANITIZE set.
//
// Bound on an H100: bytes.  x is read once (4*C*P bytes) for 2*C*P flops, a quarter
// of a flop per byte, far below the ~20 flop/byte where f32 FMA would bind (67
// TFLOP/s over 3.35 TB/s).  At the flagship chunk (C=125, P=1,199,882) the 600 MB
// read takes at least 0.1805 ms; at the validated round (C=1000) 4.8 GB, 1.434 ms.
// No tensor cores: the reference asks for full f32, which TF32 is not.
//
// The first design (one thread per 4 columns walking all C rows, a block per 1024
// columns) reached 72% of the bound at C=125 (0.252 ms, 4.6% slower than cuBLAS's
// GEMV on the same bytes) and 67% for B2 at C=1000 (2.131 ms), on an H100 80GB HBM3
// at 700 W.  What held it back, and what this design does about each point:
//
// 1. A wave tail.  1172 blocks of 256 threads are 1.11 waves at 8 blocks an SM, and
//    every block walks all C rows, so the last ~116 blocks ran while most SMs idled.
//    Now the grid is persistent and balanced: blocks = min(SMs x k, what P allows),
//    k the blocks an SM holds at this kernel's shared-memory footprint, and P is cut
//    into contiguous column slabs whose widths differ by at most one 16-byte unit
//    (ops/reduce.py launch_plan).  Every SM streams the same bytes in one wave.
// 2. Small, scattered requests with little in flight (64 B a thread).  On the
//    aligned layout (VEC 4: row stride a multiple of 4 floats, x 16-byte aligned,
//    which every hot caller passes) a block streams its slab through a ring of S
//    16 KB stages in dynamic shared memory, filled by 1-D bulk asynchronous copies
//    (cp.async.bulk ... mbarrier::complete_tx::bytes).  One producer thread issues
//    them against full/empty mbarrier pairs; 256 consumer threads FMA from shared
//    memory into register accumulators.  An SM holds 96 KB of ring in flight (k = 2
//    blocks of S = 3 stages; one block of 6 where the whole read is under 32 MB,
//    whose start-up a second block would not repay), where Little's law asks ~25 KB
//    (3.35 TB/s x ~1 us over 132 SMs); deeper rings measured slower.  A stage holds
//    one row segment of a column tile (up to 1024 16-byte units), or several whole
//    rows where the slab's tile is short.
// 3. A per-block sum(w) before the first load.  Now each warp sums w itself, with no
//    block barrier: the ring's consumers while the first copies are in flight, the
//    register path after its first loads.
//
// Unaligned layouts (VEC 2 or 1: the contiguous [C, P] with P % 4 != 0 that
// weighted_mean_tree hands the plain network round, Multi-Krum's [C, 2] scalars)
// cannot use bulk copies, which need 16-byte aligned addresses and sizes.  They keep
// register loads, one thread per VEC columns, on the same balanced persistent grid
// (k = 6 blocks of 256 threads an SM, so a thread has the registers for 8 rows of
// loads in flight); each warp sums w after its first loads, not before them.
//
// Order and determinism: each output column is one chain of fmaf over c = 0, 1, ...,
// C-1, on either path, so the result depends neither on the grid nor on the ring,
// and two launches give the same bits.  The one exception is the aligned layout's
// ragged right edge (P % 4 columns of a padded row): bulk copies cannot take them,
// so 31 lanes of the producer warp sum them over interleaved rows while the ring
// streams, and the 31 partial sums are added in a fixed order at the end.  (B4 in
// quantize.cu sums its wider edge, up to 15 bytes a row, after its ring; its note
// says why.  How the two forms compare here is not measured.)  The
// normalised form divides by max(denom or sum(w), 1e-12), not by a reciprocal; the
// accumulate form reads out once and writes it once, in place.
#include "common.cuh"

namespace {

using nanofed::bulk_copy_g2s;
using nanofed::imin;
using nanofed::kBulkThreads;
using nanofed::kConsumers;
using nanofed::kConsumerWarps;
using nanofed::kMaxStages;
using nanofed::kStageUnits;
using nanofed::kTailLanes;
using nanofed::kThreads;
using nanofed::mbar_arrive;
using nanofed::mbar_arrive_expect_tx;
using nanofed::mbar_init;
using nanofed::mbar_wait;
using nanofed::Slab;
using nanofed::slab_of;

constexpr int kUnitsPerThread = kStageUnits / kConsumers;

// isfinite(v) ? v : 0, on the bits: v is NaN or +-inf iff its exponent is all ones.
__device__ __forceinline__ float sanitize(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u ? 0.f : v;
}

// max(denom or sum(w), 1e-12), computed by one warp: lane l sums w[l], w[l+32], ...
// and a butterfly adds the 32 partial sums.  Every lane of every warp gets the same
// bits (each step adds two values in either order), with no block barrier.
__device__ __forceinline__ float warp_denominator(const float* __restrict__ w, int64_t C,
                                                  const float* __restrict__ denom) {
  if (denom != nullptr) return fmaxf(*denom, 1e-12f);
  float part = 0.f;
  for (int64_t c = threadIdx.x % 32; c < C; c += 32) part += __ldg(w + c);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  return fmaxf(part, 1e-12f);
}

// ---- the aligned layout: a bulk-copy ring ----------------------------------------

// Rows of a column tile `width` units wide that one stage carries.
__device__ __forceinline__ int rows_per_stage(int width) {
  return width >= kStageUnits ? 1 : kStageUnits / width;
}

template <bool ACCUMULATE, bool SANITIZE>
__global__ void __launch_bounds__(kBulkThreads, 2) weighted_sum_ring(
    const float* __restrict__ x, int64_t ldx, const float* __restrict__ w, int64_t C,
    int64_t P, const float* __restrict__ denom, float* __restrict__ out, int stages) {
  extern __shared__ __align__(128) float4 ring[];  // stages x kStageUnits
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ float tail_part[kTailLanes][3];

  const int64_t units_total = (P + 3) / 4;
  const Slab slab = slab_of(units_total);
  // The last unit of a P % 4 != 0 row is the ragged edge: not bulk-copied.
  const int tail = (slab.u0 + slab.units == units_total) ? static_cast<int>(P % 4) : 0;
  const int64_t ring_units = slab.units - (tail ? 1 : 0);
  const float* slab_x = x + slab.u0 * 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                 // the producer's arrive.expect_tx
      mbar_init(&empty[s], kConsumerWarps);   // one arrive per consumer warp
    }
    nanofed::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float d = 1.f;  // the normalised form's denominator, in every consumer thread

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      // Producer: walk the slab tile by tile, C rows each, filling the ring in order.
      int stage = 0;
      uint32_t phase = 0;
      for (int64_t t0 = 0; t0 < ring_units; t0 += kStageUnits) {
        const int width = static_cast<int>(imin(kStageUnits, ring_units - t0));
        const int rows = rows_per_stage(width);
        const uint32_t row_bytes = static_cast<uint32_t>(width) * 16u;
        for (int64_t c0 = 0; c0 < C; c0 += rows) {
          const int nr = static_cast<int>(imin(rows, C - c0));
          mbar_wait(&empty[stage], phase ^ 1u);  // the first pass finds every slot free
          mbar_arrive_expect_tx(&full[stage], row_bytes * nr);
          float4* dst = ring + static_cast<int64_t>(stage) * kStageUnits;
          for (int r = 0; r < nr; ++r) {
            bulk_copy_g2s(dst + r * width, slab_x + (c0 + r) * ldx + t0 * 4, row_bytes,
                          &full[stage]);
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    } else if (tail) {
      // The ragged edge: lane l sums rows l-1, l-1+31, ... of the last P % 4 columns.
      const int li = lane - 1;
      const float* col = x + (units_total - 1) * 4;
      float part[3] = {0.f, 0.f, 0.f};
      for (int64_t c = li; c < C; c += kTailLanes) {
        const float wc = __ldg(w + c);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          if (j < tail) {
            float v = __ldg(col + c * ldx + j);
            if constexpr (SANITIZE) v = sanitize(v);
            part[j] = fmaf(wc, v, part[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) tail_part[li][j] = part[j];
    }
  } else {
    // Consumers.  The denominator first, while the first copies land.
    if constexpr (!ACCUMULATE) d = warp_denominator(w, C, denom);

    int stage = 0;
    uint32_t phase = 0;
    for (int64_t t0 = 0; t0 < ring_units; t0 += kStageUnits) {
      const int width = static_cast<int>(imin(kStageUnits, ring_units - t0));
      const int rows = rows_per_stage(width);
      float acc[kUnitsPerThread][4];
#pragma unroll
      for (int q = 0; q < kUnitsPerThread; ++q) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
      }
      for (int64_t c0 = 0; c0 < C; c0 += rows) {
        const int nr = static_cast<int>(imin(rows, C - c0));
        mbar_wait(&full[stage], phase);
        const float4* st = ring + static_cast<int64_t>(stage) * kStageUnits;
        for (int r = 0; r < nr; ++r) {
          const float wc = __ldg(w + c0 + r);
#pragma unroll
          for (int q = 0; q < kUnitsPerThread; ++q) {
            const int u = threadIdx.x + q * kConsumers;
            if (u < width) {
              float4 v = st[r * width + u];
              if constexpr (SANITIZE) {
                v.x = sanitize(v.x);
                v.y = sanitize(v.y);
                v.z = sanitize(v.z);
                v.w = sanitize(v.w);
              }
              acc[q][0] = fmaf(wc, v.x, acc[q][0]);
              acc[q][1] = fmaf(wc, v.y, acc[q][1]);
              acc[q][2] = fmaf(wc, v.z, acc[q][2]);
              acc[q][3] = fmaf(wc, v.w, acc[q][3]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the slot
        if (++stage == stages) {
          stage = 0;
          phase ^= 1u;
        }
      }
#pragma unroll
      for (int q = 0; q < kUnitsPerThread; ++q) {
        const int u = threadIdx.x + q * kConsumers;
        if (u < width) {
          float* o = out + (slab.u0 + t0 + u) * 4;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (ACCUMULATE) {
              o[i] += acc[q][i];
            } else {
              o[i] = acc[q][i] / d;
            }
          }
        }
      }
    }
  }

  __syncthreads();
  if (tail && threadIdx.x < tail) {  // consumer threads: they hold d
    float s = 0.f;
    for (int li = 0; li < kTailLanes; ++li) s += tail_part[li][threadIdx.x];
    float* o = out + (units_total - 1) * 4 + threadIdx.x;
    if constexpr (ACCUMULATE) {
      *o += s;
    } else {
      *o = s / d;
    }
  }
}

// ---- unaligned layouts: register loads -------------------------------------------

template <int VEC, bool ACCUMULATE, bool SANITIZE>
__global__ void __launch_bounds__(kThreads, 6) weighted_sum_regs(
    const float* __restrict__ x, int64_t ldx, const float* __restrict__ w, int64_t C,
    int64_t P, const float* __restrict__ denom, float* __restrict__ out) {
  const Slab slab = slab_of((P + VEC - 1) / VEC);
  // Every thread runs the same passes (a thread past the slab's end idles), so each
  // warp reaches the denominator whole: after the first pass's loads, not before.
  const int64_t passes = (slab.units + kThreads - 1) / kThreads;
  float d = 1.f;
  for (int64_t pass = 0; pass < passes; ++pass) {
    const int64_t u = slab.u0 + threadIdx.x + pass * kThreads;
    const int64_t p0 = u * VEC;
    const int n = u >= slab.u0 + slab.units ? 0
                  : (P - p0 < VEC) ? static_cast<int>(P - p0) : VEC;
    const float* col = x + p0;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    if (n == VEC) {
#pragma unroll 8
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
    } else if (n > 0) {
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
    if constexpr (!ACCUMULATE) {
      if (pass == 0) d = warp_denominator(w, C, denom);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (i < n) {
        if constexpr (ACCUMULATE) {
          out[p0 + i] += acc[i];
        } else {
          out[p0 + i] = acc[i] / d;
        }
      }
    }
  }
}

// ---- the launch and its checks ---------------------------------------------------

template <bool ACCUMULATE, bool SANITIZE>
cudaError_t prepare_ring() {
  static bool done[64] = {};
  auto kernel = weighted_sum_ring<ACCUMULATE, SANITIZE>;
  return nanofed::prepare_ring(reinterpret_cast<const void*>(kernel), done);
}

template <bool ACCUMULATE, bool SANITIZE>
cudaError_t launch_ring(const float* x, int64_t ldx, const float* w, int64_t C, int64_t P,
                        const float* denom, float* out, int64_t blocks, int stages,
                        int64_t shared_bytes, cudaStream_t stream) {
  const cudaError_t err = prepare_ring<ACCUMULATE, SANITIZE>();
  if (err != cudaSuccess) return err;
  weighted_sum_ring<ACCUMULATE, SANITIZE>
      <<<static_cast<unsigned>(blocks), kBulkThreads, static_cast<size_t>(shared_bytes),
         stream>>>(x, ldx, w, C, P, denom, out, stages);
  return cudaGetLastError();
}

template <int VEC, bool ACCUMULATE, bool SANITIZE>
cudaError_t launch_regs(const float* x, int64_t ldx, const float* w, int64_t C, int64_t P,
                        const float* denom, float* out, int64_t blocks,
                        cudaStream_t stream) {
  weighted_sum_regs<VEC, ACCUMULATE, SANITIZE>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(x, ldx, w, C, P, denom, out);
  return cudaGetLastError();
}

// Three forms per layout: B1 normalised, B1 accumulate, B2 (normalised only).
template <bool ACCUMULATE, bool SANITIZE>
cudaError_t launch(const float* x, int64_t ldx, const float* w, int64_t C, int64_t P,
                   const float* denom, float* out, int vec, int64_t blocks, int stages,
                   int64_t shared_bytes, cudaStream_t stream) {
  switch (vec) {
    case 4:
      return launch_ring<ACCUMULATE, SANITIZE>(x, ldx, w, C, P, denom, out, blocks, stages,
                                               shared_bytes, stream);
    case 2:
      return launch_regs<2, ACCUMULATE, SANITIZE>(x, ldx, w, C, P, denom, out, blocks, stream);
    default:
      return launch_regs<1, ACCUMULATE, SANITIZE>(x, ldx, w, C, P, denom, out, blocks, stream);
  }
}

// The kernel a (vec, accumulate, sanitized) launch runs, and its thread count.
const void* kernel_of(int vec, bool accumulate, bool sanitized, int* threads) {
  *threads = vec == 4 ? kBulkThreads : kThreads;
  if (vec == 4) {
    if (sanitized) return reinterpret_cast<const void*>(weighted_sum_ring<false, true>);
    if (accumulate) return reinterpret_cast<const void*>(weighted_sum_ring<true, false>);
    return reinterpret_cast<const void*>(weighted_sum_ring<false, false>);
  }
  if (vec == 2) {
    if (sanitized) return reinterpret_cast<const void*>(weighted_sum_regs<2, false, true>);
    if (accumulate) return reinterpret_cast<const void*>(weighted_sum_regs<2, true, false>);
    return reinterpret_cast<const void*>(weighted_sum_regs<2, false, false>);
  }
  if (sanitized) return reinterpret_cast<const void*>(weighted_sum_regs<1, false, true>);
  if (accumulate) return reinterpret_cast<const void*>(weighted_sum_regs<1, true, false>);
  return reinterpret_cast<const void*>(weighted_sum_regs<1, false, false>);
}

}  // namespace

// x: [C, P] f32 with row stride ldx (elements); w: [C] f32; denom: one f32 on the
// device or null (then sum(w)); out: [P] f32; sanitized selects B2 (normalised, never
// accumulated).  vec is the layout's load width (4: the bulk-copy ring, which needs
// ldx % 4 == 0 and x 16-byte aligned; 2 or 1: register loads); blocks, slab, stages
// and shared_bytes are the host's launch plan.  Returns cudaErrorInvalidValue for a
// plan or a form it cannot run, else cudaGetLastError().
extern "C" int nf_weighted_sum(const float* x, int64_t ldx, const float* w, int64_t C,
                               int64_t P, const float* denom, float* out, int accumulate,
                               int sanitized, int vec, int64_t blocks, int64_t slab,
                               int stages, int64_t shared_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C < 1 || P < 1 || ldx < P ||
      !nanofed::plan_ok(vec, 4, P, blocks, slab, stages, shared_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec > 1 && (ldx % vec != 0 || reinterpret_cast<uintptr_t>(x) % (4 * vec) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (sanitized) {
    if (accumulate) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<false, true>(x, ldx, w, C, P, denom, out, vec, blocks,
                                                stages, shared_bytes, s));
  }
  if (accumulate) {
    return static_cast<int>(launch<true, false>(x, ldx, w, C, P, denom, out, vec, blocks,
                                                stages, shared_bytes, s));
  }
  return static_cast<int>(launch<false, false>(x, ldx, w, C, P, denom, out, vec, blocks,
                                               stages, shared_bytes, s));
}

// What the card makes of one form's kernel: its registers a thread (ptxas's count)
// and how many of its blocks an SM holds at `shared_bytes` of dynamic shared memory.
extern "C" int nf_weighted_sum_occupancy(int vec, int accumulate, int sanitized,
                                         int64_t shared_bytes, int* registers,
                                         int* blocks_per_sm) {
  if (vec == 4) {
    const cudaError_t err =
        sanitized ? prepare_ring<false, true>()
                  : (accumulate ? prepare_ring<true, false>() : prepare_ring<false, false>());
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = 0;
  const void* kernel = kernel_of(vec, accumulate != 0, sanitized != 0, &threads);
  return static_cast<int>(
      nanofed::occupancy(kernel, threads, shared_bytes, registers, blocks_per_sm));
}
