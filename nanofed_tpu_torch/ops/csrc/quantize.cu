// Kernels B5, B6 and B7: secure aggregation's fixed-point and mask arithmetic; kernel
// B4: the fused int8 dequant-accumulate of the q8/topk aggregation epilogue.
//
// ---- B4 ---------------------------------------------------------------------------
// Replaces nanofed_tpu/ops/quantize.py dequant_accumulate_flat (_dequant_acc_kernel):
//
//   out[p] = base[p] + sum_c coefs[c] * float(q[c, p]),  coefs = (w * s) / max(denom, 1e-12)
//
// with the O(C) coefficients formed beside the launch.  The per-client dequant scale is
// a row multiplier, so it folds into the reduce coefficients and the dequantized [C, P]
// float32 stack never exists.  Bound on an H100: bytes.  The int8 stack is read once
// (C*P bytes), base read and out written once (8*P), plus the C-sized vectors: at
// P = 1,199,882 that is 86 MB at C = 64 (0.0258 ms at 3.35 TB/s) and 1.2 GB at C = 1000
// (0.361 ms); its 2*C*P flops take a tenth of that at 67 TFLOP/s f32.
//
// The first design (one thread per 16 columns walking all C rows, 293 blocks at P =
// 1,199,882, about 560 of an SM's 2048 threads) kept too few loads in flight: 23-43%
// of the bound on an H100 80GB HBM3 at 700 W.  Now B4 runs on B1's template (reduce.cu,
// whose note gives the reasons): a persistent grid of at most SMs x k blocks over
// column slabs that differ by at most one 16-byte unit (16 int8 columns), planned on
// the host (ops/reduce.py launch_plan with itemsize 1), in one wave.
// * Rows 16-byte aligned (row stride and q a multiple of 16 bytes, as every hot caller
//   allocates them): a bulk-copy ring.  One producer thread fills 16 KB stages with
//   cp.async.bulk copies against full/empty mbarriers; 256 consumer threads FMA from
//   shared memory.  A stage holds 1024 / W row segments of a column tile W units wide,
//   and a consumer owns up to two units of the tile (16 float accumulators each), so a
//   slab of up to 512 units is one tile: at P = 1,199,882 each of the 264 slabs (284
//   units) streams its C rows as 4.5 KB copies, 3 rows a stage.  On an H100 the copy
//   length set the rate: the first cut's tiles of 142 units (2.2 KB copies) streamed
//   slower than whole-slab tiles, while a deeper ring and spreading a narrow tile's
//   rows over all 256 consumers did not help.  The result is 88% of the bound at
//   C = 1000 (PERF.md, from scripts/time_quantize_kernels.py).
// * Other layouts (load widths 8, 4, 2 and 1 bytes) keep register loads, one thread per
//   VEC columns, on the same balanced persistent grid (6 blocks an SM).
// * The ragged right edge (P % 16 columns of a padded row, 10 at P = 1,199,882): bulk
//   copies cannot take it and no byte at or past column P is read (a caller's padding
//   may be unallocated).  The last block sums it once its ring is done, over all of
//   its threads, and adds the partial sums in a fixed order.  Why not B1's form (31
//   idle lanes of the producer warp, while the ring streams): in a probe on an H100 it
//   held B4's last block back at C = 1000.  B4's edge is up to 15 one-byte loads a
//   row where B1's is at most 3 floats, and those lanes share a warp with the producer,
//   which here issues three copies a stage (B1's, at its slab widths, one), so the
//   lanes' dependent loads most likely delay the copies.  B1/B2 keep their form; the
//   after-ring form would add a read of the edge after their last block's ring, and
//   whether it costs or saves them anything is not measured (PERF.md section 7).
// * Conversion.  static_cast<float>(int8) is an I2F, which the throughput table for
//   compute capability 9.0 gives 16 results a clock an SM ("all other type
//   conversions"): 132 x 16 x 1.98 GHz = 4.2e12 a second, so at the bound's 3.35 TB/s
//   the conversions alone would need 79% (C=1000) and 71% (C=64) of the bound's time.
//   The kernel instead builds each float from its byte with integer and float-add
//   instructions (fma_bytes): PRMT places the byte (XOR 0x80) under the exponent of
//   2^23, and one FADD of -(2^23 + 128) leaves the int8 value, exact for all 256 bytes;
//   then FFMA.  Finding: the conversion pipe does not bind at either C.  Timed in one
//   call on an H100 with the I2F form, the two kernels ran within 0.35% of each other at
//   C = 64 and 1000 (each faster in 3 of 6 pairings; PERF.md gives the times), so the
//   byte permute, faster in both of the timing script's C = 1000 runs, is kept alone.
// Every output column is one chain of fmaf over c = 0, 1, ..., C-1 plus base, on
// either path, so two launches give the same bits and all-zero weights return base.
//
// ---- B5-B7 ------------------------------------------------------------------------
// Replace nanofed_tpu/ops/quantize.py quantize_u32 (_quantize_kernel), dequantize_u32
// (_dequantize_kernel) and add_mask (_mask_kernel).  The TPU kernels pad a flat vector
// into [256, 512] VMEM tiles; here every kernel walks the flat [n] vector directly,
// with 16-byte accesses where both pointers allow it and scalar accesses for the ragged
// tail and unaligned starts, so nothing is padded.
//
// B5  out[i] = bits(int32(round_half_even(x[i] * 2^frac)))   (float32 -> uint32)
//     x * 2^frac is exact (a power of two).  Outside |x * 2^frac| < 2^31, which the
//     secure-aggregation contract excludes, the result saturates to INT32_MIN or
//     INT32_MAX and NaN gives 0; the plain version does the same.  cvt.rni.s32.f32
//     (__float2int_rn) already clamps and gives 0 for NaN, so the first design's three
//     compares in front of it are gone (chip_smoke.py's saturation cases hold the bits).
// B6  out[i] = float(int32(q[i])) * 2^-frac                  (uint32 -> float32)
//     One rounding (int32 -> float32, to nearest even); the scale is exact.
// Bound on an H100: bytes (each element read once and written once, 8 bytes, for one
// multiply and one conversion): 0.002865 ms at the mnist_cnn width (1,199,882 words).
//
// B5 and B6 are one kernel template over a conversion functor (ToFixed, FromFixed).
// The first design launched ceil(n / 1024) blocks of 256 threads, one 16-byte load a
// thread: 1172 blocks at 1.2M words, two waves at 8 blocks an SM.  The grid is now
// planned on the host (ops/quantize.py stream_plan) and refused here when it is any
// other plan: at most SMs x 2 blocks, one wave, each over a contiguous slab of whole
// 16-byte units (slab_of; the last n % 4 words go to the last block, scalar).
// * The floor, measured on an H100 80GB HBM3 at 700 W with CUDA events after a 256 MB
//   L2 flush (scripts/time_quantize_kernels.py): an empty launch takes 0.0049-0.0051
//   ms, so a 1.2M-word pass cannot beat 0.0050 + 0.0029 = 0.0079 ms (36% of the
//   bound), and the first design already took 0.0079-0.0081 ms after a flush that
//   leaves L2 clean.
//   The flush that writes (the table's) adds 0.0013-0.0015 ms of write-backs to any
//   pass.  torch's own copy of the same bytes takes 0.0109-0.0113 ms.
// * The register form (kept on 16-byte-aligned pointers): 2 blocks an SM (264 slabs
//   of 1136-1137 units at 132 SMs), each thread issuing the loads of its 4-5 units
//   before its first store.  0.0092-0.0097 ms after the write flush, as the first
//   design, and 0.0069-0.0071 ms warm (input just written, as the callers leave it),
//   up to 7% faster; 0-8% slower after the read flush.  Unaligned starts take the same
//   form over single words.
// * A bulk form was measured and dropped: thread 0 asked for the whole slab at once
//   by bulk copies into shared memory, each chunk on its own mbarrier, and the block
//   converted each chunk in place and stored it by one bulk copy.  It was slower at
//   every grid and chunk tried (1-8 blocks an SM, 2-8 KB chunks): 0.0099-0.0112 ms
//   after the write flush, 0.0076-0.0089 warm (PERF.md keeps the times).
//
// B7  out[i] = q[i] + sum_j sign_j * m_j[i]   (mod 2^32), j = 0 .. k-1, in ONE launch
//     m_j is numpy's Philox4x64-10 stream (np.random.Philox) under the 128-bit key
//     (k0, k1) of seed j: block b (b = 0, 1, ...) is the Philox of the 256-bit counter
//     (b+1, 0, 0, 0), because numpy increments the counter before each block; its four
//     64-bit words give uint32 m[8b .. 8b+7] as (low half, high half) of each word in
//     turn.  Nothing but the output is written: the masks never exist in memory.
//     A client adds all of its pairwise masks and its self mask in one launch, and the
//     server's dropout recovery expands all of its corrections in one launch: q is read
//     once and written once whatever k is, so the bytes stay 8n and the work is k times
//     the per-block integer work.  The first design took one launch a mask (0.0097 ms
//     at 1.2M words on an H100, most of it the fixed cost of a pass).
//     Design: one thread per Philox block (8 output words).  It walks the k keys three
//     at a time (three independent Philox chains, for instruction-level parallelism)
//     and keeps the 8-word sum in registers (uint32 wraps), then reads and writes its 8
//     words of q once; thread 0 of each block first asks L2 for the block's words of q
//     (a bulk prefetch), so that read overlaps the Philox work.  A subtraction adds the
//     complement and one: each key's sign is folded into its last round key (half of
//     the output words come out complemented) and one XOR each for the other half, and
//     the ones (the number of subtracted keys) are added once.  The table of keys and
//     signs (3 x 64-bit words a key: k0, k1, subtract) travels in the kernel's
//     parameters up to kInlineKeys keys, and above that as a small device tensor that
//     the wrapper copies from pinned memory on the launch's stream, without
//     synchronising.  Both paths stay because the copy costs: timed in one call on an
//     H100 with the same product form, the device table alone took 2.9-3.9 us more a
//     launch at k = 1, 8 and 14 (0.0132-0.0134 against 0.0096-0.0097 ms at k = 1,
//     0.0286-0.0289 against 0.0257-0.0259 at k = 8; PERF.md), while a real cohort's
//     client (k = cohort size) and the server's recovery (a key a correction) take the
//     table.  Blocks stage it into shared memory kKeyTile keys at a time, so any k fits,
//     and expand each key's ten round keys (k0 + r*W0, k1 + r*W1) there once, where the
//     first design bumped them in every thread.  The grid is SMs x kMaskBlocksPerSm
//     blocks (the host reads the SM count), each covering an equal range of Philox
//     blocks (to within one), so at 150k Philox blocks (P = 1,199,882) every SM of an
//     H100 SXM holds 5 blocks of 227-228 busy threads in one wave (the first design's
//     586 blocks gave some SMs 5 and others 4).
//     Bound on an H100 for k >= 3 (bytes below): integer operations, counted from the
//     function, not from a compile of it (chip_smoke.py mask_bound_ms).  A block is 10
//     Philox rounds, each a 64x64->128 product and XORs; round 0's product (the
//     counter's) is the same for every key, so k keys need 18k + 1 products.  A product
//     is four 32x32->64 multiplies, IMAD.WIDE.U32, two results each on the FMA pipe;
//     its carries, the XORs and the mask sum are integer-ALU work (about 100
//     instructions a key, under the FMA pipe's 144 results).  The compute capability 9.0
//     throughput table gives 64 results a clock an SM for each integer class, so the
//     FMA pipe binds: 144 results, 2.25 clocks an SM per block and key, where the first
//     design's hand count assumed 328 operations (5.1 clocks). chip_smoke.py also
//     counts the key loop of the built library by class (cuobjdump -sass) and prints it
//     beside the function's count: what ptxas adds (moves, adds it puts on IMAD) shows
//     there and never raises the bound.  This kernel's loop holds 150.0 FMA-pipe results
//     a key (73.3 IMAD.WIDE, 3.3 other IMAD) and 136.7 ALU instructions (94.3 IADD3, 42
//     LOP3), and it reaches 56% of the function's bound at k = 999 (PERF.md).
#include <type_traits>

#include "common.cuh"

namespace {

using nanofed::bulk_copy_g2s;
using nanofed::imin;
using nanofed::kBulkThreads;
using nanofed::kConsumers;
using nanofed::kConsumerWarps;
using nanofed::kMaxStages;
using nanofed::kStageUnits;
using nanofed::kThreads;
using nanofed::mbar_arrive;
using nanofed::mbar_arrive_expect_tx;
using nanofed::mbar_init;
using nanofed::mbar_wait;
using nanofed::Slab;
using nanofed::slab_of;

// ---- B5/B6: one pass of a fixed-point conversion over a flat vector ----------------

constexpr int kUnitWords = 4;  // 32-bit words in a 16-byte unit
constexpr int kRegUnits = 8;   // 16-byte units a thread holds at once
constexpr int kRegWords = 32;  // words, where the start is not 16-byte aligned

// B5 on one word's bits.  cvt.rni.s32.f32 rounds half to even, clamps to the int32
// range and gives 0 for NaN: the saturation rule outside the contract.
struct ToFixed {
  float scale;
  __device__ __forceinline__ uint32_t operator()(uint32_t bits) const {
    return static_cast<uint32_t>(__float2int_rn(__fmul_rn(__uint_as_float(bits), scale)));
  }
};

// B6: one rounding (int32 -> float32, to nearest even), then the exact 2^-frac.
struct FromFixed {
  float inv_scale;
  __device__ __forceinline__ uint32_t operator()(uint32_t q) const {
    return __float_as_uint(__fmul_rn(__int2float_rn(static_cast<int32_t>(q)), inv_scale));
  }
};

template <class Op>
__device__ __forceinline__ uint4 convert4(const Op& op, uint4 v) {
  return make_uint4(op(v.x), op(v.y), op(v.z), op(v.w));
}

// The last n % 4 words (no whole 16-byte unit), by the last block with scalar accesses.
template <class Op>
__device__ __forceinline__ void convert_tail(const uint32_t* __restrict__ in,
                                             uint32_t* __restrict__ out, int64_t n,
                                             const Op& op) {
  const int64_t i = n / kUnitWords * kUnitWords + threadIdx.x;
  if (i < n) out[i] = op(__ldg(in + i));
}

// One pass over the block's slab in registers: VEC 4 (16-byte units; both pointers
// aligned) or VEC 1 (words; any start).  A thread issues the loads of up to kRegUnits
// units (kRegWords words) of its slab, kThreads apart, before its first store.
template <int VEC, class Op>
__global__ void __launch_bounds__(kThreads) convert_regs(const uint32_t* __restrict__ in,
                                                         uint32_t* __restrict__ out, int64_t n,
                                                         Op op) {
  constexpr int R = VEC == kUnitWords ? kRegUnits : kRegWords;
  using Unit = typename std::conditional<VEC == kUnitWords, uint4, uint32_t>::type;
  const Unit* src = reinterpret_cast<const Unit*>(in);
  Unit* dst = reinterpret_cast<Unit*>(out);
  const int64_t units_total = n / VEC;
  const Slab slab = slab_of(units_total);
  const int64_t end = slab.u0 + slab.units;
  for (int64_t u0 = slab.u0 + threadIdx.x; u0 < end; u0 += R * kThreads) {
    Unit v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (u0 + r * kThreads < end) v[r] = __ldg(src + u0 + r * kThreads);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (u0 + r * kThreads < end) {
        if constexpr (VEC == kUnitWords) {
          dst[u0 + r * kThreads] = convert4(op, v[r]);
        } else {
          dst[u0 + r * kThreads] = op(v[r]);
        }
      }
    }
  }
  if (VEC == kUnitWords && end == units_total) convert_tail(in, out, n, op);
}

// The host's plan (ops/quantize.py stream_plan), checked: `blocks` slabs over the n /
// vec whole units of vec words (the last n % vec words go to the last block), `slab`
// units the narrower.
bool stream_plan_ok(int64_t n, int vec, int64_t blocks, int64_t slab) {
  if (n < 0 || (vec != kUnitWords && vec != 1)) return false;
  const int64_t units = n / vec;
  if (blocks < 1 || blocks > (units > 1 ? units : 1) || blocks > 0x7fffffff) return false;
  return slab == units / blocks;
}

template <class Op>
cudaError_t launch_convert(const uint32_t* in, uint32_t* out, int64_t n, Op op, int vec,
                           int64_t blocks, int64_t slab, void* stream) {
  if (!stream_plan_ok(n, vec, blocks, slab)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec == kUnitWords) {
    if (reinterpret_cast<uintptr_t>(in) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
      return cudaErrorInvalidValue;
    }
    convert_regs<kUnitWords, Op><<<grid, kThreads, 0, s>>>(in, out, n, op);
  } else {
    convert_regs<1, Op><<<grid, kThreads, 0, s>>>(in, out, n, op);
  }
  return cudaGetLastError();
}

template <class Op>
cudaError_t convert_occupancy(int vec, int* registers, int* blocks_per_sm) {
  const void* kernel = vec == kUnitWords
                           ? reinterpret_cast<const void*>(convert_regs<kUnitWords, Op>)
                           : reinterpret_cast<const void*>(convert_regs<1, Op>);
  return nanofed::occupancy(kernel, kThreads, 0, registers, blocks_per_sm);
}

// ---- B7: Philox4x64-10 masks, k keys a launch ---------------------------------------

// Philox4x64-10 (Salmon et al., SC 2011), the Random123 / numpy definition.
constexpr uint64_t kPhiloxM0 = 0xD2E7470EE14C6C93ull;
constexpr uint64_t kPhiloxM1 = 0xCA5A826395121157ull;
constexpr uint64_t kPhiloxW0 = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kPhiloxW1 = 0xBB67AE8584CAA73Bull;
constexpr int kPhiloxRounds = 10;
constexpr int kKeyTile = 64;          // keys a block stages into shared memory at once
constexpr int kMaskBlocksPerSm = 5;   // ops/quantize.py MASK_BLOCKS_PER_SM
constexpr int kMaskChains = 3;        // keys a key-loop iteration (chip_smoke.py B7_CHAINS)
constexpr int kInlineKeys = 16;       // keys a launch takes in its parameters

// Up to kInlineKeys keys passed by value in the kernel's parameters, so a launch with
// few keys needs no copy to the card before it.
struct InlineKeys {
  uint64_t w[kInlineKeys][3];
};

// The 128-bit product (a1:a0) * (m1:m0) as four 32-bit words, r[0] the lowest: the
// four 32x32->64 products (mul.wide, IMAD.WIDE.U32 with a zero addend on the FMA
// pipe), p00 + p11 << 64 laid out as they come, then p01 << 32 and p10 << 32 added
// in two 96-bit carry chains (IADD3 on the integer ALU).  A multiply-add chain
// (mad.lo.cc / madc.hi) became IMAD.WIDE with 64-bit addends that moves on the FMA
// pipe had to build, and the same products written in C got adds moved onto IMAD.
__device__ __forceinline__ void mul128(uint32_t m0, uint32_t m1, uint32_t a0, uint32_t a1,
                                       uint32_t (&r)[4]) {
  asm("{\n\t"
      ".reg .u64 t;\n\t"
      ".reg .u32 x, y;\n\t"
      "mul.wide.u32   t, %4, %6;\n\t"
      "mov.b64        {%0, %1}, t;\n\t"
      "mul.wide.u32   t, %5, %7;\n\t"
      "mov.b64        {%2, %3}, t;\n\t"
      "mul.wide.u32   t, %4, %7;\n\t"
      "mov.b64        {x, y}, t;\n\t"
      "add.cc.u32     %1, %1, x;\n\t"
      "addc.cc.u32    %2, %2, y;\n\t"
      "addc.u32       %3, %3, 0;\n\t"
      "mul.wide.u32   t, %5, %6;\n\t"
      "mov.b64        {x, y}, t;\n\t"
      "add.cc.u32     %1, %1, x;\n\t"
      "addc.cc.u32    %2, %2, y;\n\t"
      "addc.u32       %3, %3, 0;\n\t"
      "}"
      : "=&r"(r[0]), "=&r"(r[1]), "=&r"(r[2]), "=&r"(r[3])
      : "r"(a0), "r"(a1), "r"(m0), "r"(m1));
}

// The Philox4x64-10 block of counter (ctr, 0, 0, 0) under the round keys `rk` (round
// r's key (k0 + r*W0, k1 + r*W1) as four 32-bit words), as 8 uint32 words c: the
// four 64-bit words, low half first.  The last round key carries the key's sign
// (XORed with 0 or ~0), so the words that take it come out complemented for a
// subtraction; `flip` (0 or ~0) complements the other four.
__device__ __forceinline__ void philox_block(uint64_t ctr, const uint4 (&rk)[kPhiloxRounds],
                                             uint32_t flip, uint32_t (&c)[8]) {
  constexpr uint32_t m0l = static_cast<uint32_t>(kPhiloxM0);
  constexpr uint32_t m0h = static_cast<uint32_t>(kPhiloxM0 >> 32);
  constexpr uint32_t m1l = static_cast<uint32_t>(kPhiloxM1);
  constexpr uint32_t m1h = static_cast<uint32_t>(kPhiloxM1 >> 32);
  // Round 0 on (ctr, 0, 0, 0): only ctr * M0 is not zero.
  uint32_t p[4];
  mul128(m0l, m0h, static_cast<uint32_t>(ctr), static_cast<uint32_t>(ctr >> 32), p);
  uint4 k = rk[0];
  c[0] = k.x;
  c[1] = k.y;
  c[2] = c[3] = 0;
  c[4] = p[2] ^ k.z;
  c[5] = p[3] ^ k.w;
  c[6] = p[0];
  c[7] = p[1];
#pragma unroll
  for (int r = 1; r < kPhiloxRounds; ++r) {
    uint32_t q[4];
    mul128(m0l, m0h, c[0], c[1], p);  // lo0 = p[0..1], hi0 = p[2..3]
    mul128(m1l, m1h, c[4], c[5], q);  // lo1 = q[0..1], hi1 = q[2..3]
    k = rk[r];
    c[0] = q[2] ^ c[2] ^ k.x;
    c[1] = q[3] ^ c[3] ^ k.y;
    c[4] = p[2] ^ c[6] ^ k.z;
    c[5] = p[3] ^ c[7] ^ k.w;
    c[2] = q[0];
    c[3] = q[1];
    c[6] = p[0];
    c[7] = p[1];
  }
  c[2] ^= flip;
  c[3] ^= flip;
  c[6] ^= flip;
  c[7] ^= flip;
}

// One thread per Philox block; the keys, [k][3] 64-bit words (k0, k1, subtract), are
// `keys` on the device or, where it is null, `inline_keys`; `nsub` of them subtract.
// Each block covers a contiguous range of Philox blocks (slab_of: the ranges differ by
// at most one), so every block (and, with the grid a multiple of the SM count, every
// SM) has the same work.  A subtraction adds the complement and one (-m = ~m + 1 modulo 2^32):
// the complements come out of the Philox rounds, the ones are nsub, added once.
template <int VEC>
__global__ void __launch_bounds__(kThreads, kMaskBlocksPerSm) add_mask_kernel(
    const uint32_t* __restrict__ q, uint32_t* __restrict__ out, int64_t n,
    const uint64_t* __restrict__ keys, const __grid_constant__ InlineKeys inline_keys, int k,
    uint32_t nsub) {
  __shared__ uint4 s_round[kKeyTile][kPhiloxRounds];
  __shared__ uint32_t s_flip[kKeyTile];
  const int64_t blocks = (n + 7) / 8;
  const Slab range = slab_of(blocks);  // this block's Philox blocks
  const int64_t first = range.u0;
  const int64_t last = range.u0 + range.units;
  if constexpr (VEC == 4) {
    // The block's words of q into L2 now, so their read overlaps the Philox work.
    const int64_t bytes = (imin(last * 8, n) - first * 8) * 4;
    if (threadIdx.x == 0 && bytes >= 16) {
      nanofed::prefetch_l2(q + first * 8, static_cast<uint32_t>(bytes) & ~15u);
    }
  }
  // Every thread of a block runs the same passes, so all of them reach every tile's
  // barriers (a thread past the block's last Philox block only stages keys).
  for (int64_t b0 = first; b0 < last; b0 += kThreads) {
    const int64_t b = b0 + threadIdx.x;
    const bool mine = b < last;
    const uint64_t ctr = static_cast<uint64_t>(b) + 1;
    uint32_t sum[8] = {nsub, nsub, nsub, nsub, nsub, nsub, nsub, nsub};
    for (int j0 = 0; j0 < k; j0 += kKeyTile) {
      const int tile = k - j0 < kKeyTile ? k - j0 : kKeyTile;
      __syncthreads();  // every thread is done with the previous tile
      if (static_cast<int>(threadIdx.x) < tile) {
        const int key = j0 + static_cast<int>(threadIdx.x);
        const uint64_t* w = keys ? keys + 3 * static_cast<int64_t>(key) : inline_keys.w[key];
        uint64_t k0 = w[0];
        uint64_t k1 = w[1];
        const uint64_t flip = w[2] ? ~0ull : 0ull;
#pragma unroll
        for (int r = 0; r < kPhiloxRounds; ++r) {
          const uint64_t x = r == kPhiloxRounds - 1 ? k0 ^ flip : k0;
          const uint64_t y = r == kPhiloxRounds - 1 ? k1 ^ flip : k1;
          s_round[threadIdx.x][r] = make_uint4(static_cast<uint32_t>(x),
                                               static_cast<uint32_t>(x >> 32),
                                               static_cast<uint32_t>(y),
                                               static_cast<uint32_t>(y >> 32));
          k0 += kPhiloxW0;
          k1 += kPhiloxW1;
        }
        s_flip[threadIdx.x] = static_cast<uint32_t>(flip);
      }
      __syncthreads();
      if (mine) {
        int j = 0;
        // kMaskChains keys an iteration (independent chains), not unrolled further:
        // the loop body is what chip_smoke.py counts in the SASS.
#pragma unroll 1
        for (; j + kMaskChains <= tile; j += kMaskChains) {
          uint32_t m[kMaskChains][8];
#pragma unroll
          for (int x = 0; x < kMaskChains; ++x) {
            philox_block(ctr, s_round[j + x], s_flip[j + x], m[x]);
          }
#pragma unroll
          for (int w = 0; w < 8; ++w) {
#pragma unroll
            for (int x = 0; x < kMaskChains; ++x) sum[w] += m[x][w];
          }
        }
        for (; j < tile; ++j) {
          uint32_t m[8];
          philox_block(ctr, s_round[j], s_flip[j], m);
#pragma unroll
          for (int w = 0; w < 8; ++w) sum[w] += m[w];
        }
      }
    }
    if (!mine) continue;
    const int64_t i = b * 8;
    if constexpr (VEC == 4) {
      if (i + 8 <= n) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(q + i));
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(q + i + 4));
        *reinterpret_cast<uint4*>(out + i) =
            make_uint4(u.x + sum[0], u.y + sum[1], u.z + sum[2], u.w + sum[3]);
        *reinterpret_cast<uint4*>(out + i + 4) =
            make_uint4(v.x + sum[4], v.y + sum[5], v.z + sum[6], v.w + sum[7]);
        continue;
      }
    }
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      if (i + w < n) out[i + w] = __ldg(q + i + w) + sum[w];
    }
  }
}

// ---- B4: int8 dequant-accumulate ------------------------------------------------------

constexpr int kInt8Unit = 16;   // int8 columns in a 16-byte unit

// acc[i] += coef * float(int8 byte i of w), for the first NB bytes of w.  Byte i, XOR
// 0x80, is v + 128 in [0, 256); PRMT puts it in the low mantissa bits of 2^23 (bits
// 0x4B0000bb), so the float is 2^23 + v + 128 and one exact FADD leaves v.
template <int NB>
__device__ __forceinline__ void fma_bytes(uint32_t w, float coef, float* acc) {
  const uint32_t x = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    const float v = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | i)) - 8388736.0f;
    acc[i] = fmaf(coef, v, acc[i]);
  }
}

constexpr int kMaxTileUnits = 2 * kConsumers;  // two 16-byte units a consumer

// The ring: rows of q (row stride ldq, both 16-byte multiples) in column tiles of at
// most kMaxTileUnits units, streamed through `stages` 16 KB stages of 1024 / W row
// segments of a tile W units wide.  Consumer t owns units t and t + kConsumers of the
// tile (16 float accumulators each), so a slab of up to 512 units is one tile and its
// copies are as long as the slab is wide.
__global__ void __launch_bounds__(kBulkThreads, 2) dequant_acc_ring(
    const int8_t* __restrict__ q, int64_t ldq, const float* __restrict__ coefs, int64_t C,
    int64_t P, const float* __restrict__ base, int base_vec4, float* __restrict__ out,
    int stages) {
  extern __shared__ __align__(128) uint4 ring[];  // stages x kStageUnits
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];
  __shared__ float tail_part[kBulkThreads / 32][kInt8Unit - 1];

  const int64_t units_total = (P + kInt8Unit - 1) / kInt8Unit;
  const Slab slab = slab_of(units_total);
  // The last unit of a P % 16 != 0 row is the ragged edge: not bulk-copied.
  const int tail = (slab.u0 + slab.units == units_total) ? static_cast<int>(P % kInt8Unit) : 0;
  const int64_t ring_units = slab.units - (tail ? 1 : 0);
  const int8_t* slab_q = q + slab.u0 * kInt8Unit;
  // Tiles of equal width (to within one unit), at most kMaxTileUnits units.
  const int64_t tiles = (ring_units + kMaxTileUnits - 1) / kMaxTileUnits;
  const int64_t tile_units = tiles ? (ring_units + tiles - 1) / tiles : 1;

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

  if (warp == kConsumerWarps) {
    if (lane == 0) {
      // Producer: walk the slab tile by tile, C rows each, filling the ring in order.
      int stage = 0;
      uint32_t phase = 0;
      for (int64_t t0 = 0; t0 < ring_units; t0 += tile_units) {
        const int width = static_cast<int>(imin(tile_units, ring_units - t0));
        const int rows = kStageUnits / width;
        const uint32_t row_bytes = static_cast<uint32_t>(width) * 16u;
        for (int64_t c0 = 0; c0 < C; c0 += rows) {
          const int nr = static_cast<int>(imin(rows, C - c0));
          mbar_wait(&empty[stage], phase ^ 1u);  // the first pass finds every slot free
          mbar_arrive_expect_tx(&full[stage], row_bytes * nr);
          uint4* dst = ring + static_cast<int64_t>(stage) * kStageUnits;
          for (int r = 0; r < nr; ++r) {
            bulk_copy_g2s(dst + r * width, slab_q + (c0 + r) * ldq + t0 * kInt8Unit, row_bytes,
                          &full[stage]);
          }
          if (++stage == stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
  } else {
    // Consumers: thread t owns units t and t + kConsumers of each tile (neither where
    // the tile is narrower).
    int stage = 0;
    uint32_t phase = 0;
    for (int64_t t0 = 0; t0 < ring_units; t0 += tile_units) {
      const int width = static_cast<int>(imin(tile_units, ring_units - t0));
      const int rows = kStageUnits / width;
      const int u0 = static_cast<int>(threadIdx.x);
      const int u1 = u0 + kConsumers;
      float acc[2][kInt8Unit];
#pragma unroll
      for (int i = 0; i < kInt8Unit; ++i) acc[0][i] = acc[1][i] = 0.f;
      for (int64_t c0 = 0; c0 < C; c0 += rows) {
        const int nr = static_cast<int>(imin(rows, C - c0));
        mbar_wait(&full[stage], phase);
        if (u0 < width) {
          const uint4* st = ring + static_cast<int64_t>(stage) * kStageUnits;
#pragma unroll 2
          for (int r = 0; r < nr; ++r) {
            const float cc = __ldg(coefs + c0 + r);
            const uint4 v = st[r * width + u0];
            fma_bytes<4>(v.x, cc, acc[0]);
            fma_bytes<4>(v.y, cc, acc[0] + 4);
            fma_bytes<4>(v.z, cc, acc[0] + 8);
            fma_bytes<4>(v.w, cc, acc[0] + 12);
            if (u1 < width) {
              const uint4 x = st[r * width + u1];
              fma_bytes<4>(x.x, cc, acc[1]);
              fma_bytes<4>(x.y, cc, acc[1] + 4);
              fma_bytes<4>(x.z, cc, acc[1] + 8);
              fma_bytes<4>(x.w, cc, acc[1] + 12);
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
      for (int k = 0; k < 2; ++k) {
        const int u = k ? u1 : u0;
        if (u >= width) break;
        // out + p0 is 64-byte aligned: out is 16-byte aligned and p0 a multiple of 16.
        const int64_t p0 = (slab.u0 + t0 + u) * kInt8Unit;
#pragma unroll
        for (int i = 0; i < kInt8Unit; i += 4) {
          float4 b;
          if (base_vec4) {
            b = __ldg(reinterpret_cast<const float4*>(base + p0 + i));
          } else {
            b = make_float4(__ldg(base + p0 + i), __ldg(base + p0 + i + 1),
                            __ldg(base + p0 + i + 2), __ldg(base + p0 + i + 3));
          }
          *reinterpret_cast<float4*>(out + p0 + i) =
              make_float4(b.x + acc[k][i], b.y + acc[k][i + 1], b.z + acc[k][i + 2],
                          b.w + acc[k][i + 3]);
        }
      }
    }
  }

  __syncthreads();
  if (tail) {
    // The ragged edge, once the ring is done, by every thread of the last block: thread
    // t sums rows t, t + kBulkThreads, ... of the last P % 16 columns (reading no byte
    // at or past column P), then a butterfly in each warp and the warps in order.  (Left
    // to the producer warp's idle lanes while the ring streamed, as B1 does, its ~C/31
    // rows of dependent loads held back the last block at C = 1000.)
    const int8_t* col = q + (units_total - 1) * kInt8Unit;
    float part[kInt8Unit - 1];
#pragma unroll
    for (int j = 0; j < kInt8Unit - 1; ++j) part[j] = 0.f;
    for (int64_t c = threadIdx.x; c < C; c += kBulkThreads) {
      const float cc = __ldg(coefs + c);
#pragma unroll
      for (int j = 0; j < kInt8Unit - 1; ++j) {
        if (j < tail) part[j] = fmaf(cc, static_cast<float>(col[c * ldq + j]), part[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kInt8Unit - 1; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) part[j] += __shfl_xor_sync(0xffffffffu, part[j], off);
      if (lane == 0) tail_part[warp][j] = part[j];
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < tail) {
      float sum = 0.f;
      for (int w = 0; w < kBulkThreads / 32; ++w) sum += tail_part[w][threadIdx.x];
      const int64_t p = (units_total - 1) * kInt8Unit + threadIdx.x;
      out[p] = __ldg(base + p) + sum;
    }
  }
}

// VEC int8 values (8, 4, 2 or 1 bytes) in one load; the caller guarantees `p` is
// aligned to VEC bytes.
template <int VEC>
__device__ __forceinline__ void load_i8(const int8_t* __restrict__ p, uint32_t (&w)[2]) {
  if constexpr (VEC == 8) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = t.x;
    w[1] = t.y;
  } else if constexpr (VEC == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VEC == 2) {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
}

// Register loads for the layouts the ring cannot take: one thread per VEC columns of
// the block's slab, walking the C rows.
template <int VEC>
__global__ void __launch_bounds__(kThreads, 6) dequant_acc_regs(
    const int8_t* __restrict__ q, int64_t ldq, const float* __restrict__ coefs, int64_t C,
    int64_t P, const float* __restrict__ base, float* __restrict__ out) {
  const Slab slab = slab_of((P + VEC - 1) / VEC);
  for (int64_t u = slab.u0 + threadIdx.x; u < slab.u0 + slab.units; u += kThreads) {
    const int64_t p0 = u * VEC;
    const int n = (P - p0 < VEC) ? static_cast<int>(P - p0) : VEC;
    const int8_t* col = q + p0;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    if (n == VEC) {
#pragma unroll 8
      for (int64_t c = 0; c < C; ++c) {
        const float cc = __ldg(coefs + c);
        uint32_t w[2];
        load_i8<VEC>(col + c * ldq, w);
        fma_bytes<(VEC < 4 ? VEC : 4)>(w[0], cc, acc);
        if constexpr (VEC == 8) fma_bytes<4>(w[1], cc, acc + 4);
      }
    } else {
      for (int64_t c = 0; c < C; ++c) {
        const float cc = __ldg(coefs + c);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          if (i < n) {
            const uint32_t byte = __ldg(reinterpret_cast<const unsigned char*>(col + c * ldq + i));
            fma_bytes<1>(byte, cc, acc + i);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      if (i < n) out[p0 + i] = __ldg(base + p0 + i) + acc[i];
    }
  }
}

cudaError_t prepare_dequant_ring() {
  static bool done[64] = {};
  return nanofed::prepare_ring(reinterpret_cast<const void*>(dequant_acc_ring), done);
}

cudaError_t launch_dequant(const int8_t* q, int64_t ldq, const float* coefs, int64_t C,
                           int64_t P, const float* base, int base_vec4, float* out, int vec,
                           int64_t blocks, int stages, int64_t shared_bytes,
                           cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (vec) {
    case 16: {
      const cudaError_t err = prepare_dequant_ring();
      if (err != cudaSuccess) return err;
      dequant_acc_ring<<<grid, kBulkThreads, static_cast<size_t>(shared_bytes), s>>>(
          q, ldq, coefs, C, P, base, base_vec4, out, stages);
      break;
    }
    case 8:
      dequant_acc_regs<8><<<grid, kThreads, 0, s>>>(q, ldq, coefs, C, P, base, out);
      break;
    case 4:
      dequant_acc_regs<4><<<grid, kThreads, 0, s>>>(q, ldq, coefs, C, P, base, out);
      break;
    case 2:
      dequant_acc_regs<2><<<grid, kThreads, 0, s>>>(q, ldq, coefs, C, P, base, out);
      break;
    default:
      dequant_acc_regs<1><<<grid, kThreads, 0, s>>>(q, ldq, coefs, C, P, base, out);
  }
  return cudaGetLastError();
}

// The B4 kernel a launch of load width `vec` runs, and its thread count.
const void* dequant_kernel_of(int vec, int* threads) {
  *threads = vec == 16 ? kBulkThreads : kThreads;
  switch (vec) {
    case 16: return reinterpret_cast<const void*>(dequant_acc_ring);
    case 8: return reinterpret_cast<const void*>(dequant_acc_regs<8>);
    case 4: return reinterpret_cast<const void*>(dequant_acc_regs<4>);
    case 2: return reinterpret_cast<const void*>(dequant_acc_regs<2>);
    default: return reinterpret_cast<const void*>(dequant_acc_regs<1>);
  }
}

}  // namespace

// B4.  q: [C, P] int8 with row stride ldq (bytes); coefs: [C] f32; base: [P] f32
// (base_vec4 1 when it is 16-byte aligned); out: [P] f32, 16-byte aligned, not base.
// vec is the layout's load width in int8 (16: the bulk-copy ring, which needs ldq and
// q 16-byte aligned; 8, 4, 2, 1: register loads, which need both aligned to vec);
// blocks, slab, stages and shared_bytes are the host's launch plan.  Returns
// cudaErrorInvalidValue for a plan or a layout it cannot run, else cudaGetLastError().
extern "C" int nf_dequant_accumulate(const int8_t* q, int64_t ldq, const float* coefs,
                                     int64_t C, int64_t P, const float* base, int base_vec4,
                                     float* out, int vec, int64_t blocks, int64_t slab,
                                     int stages, int64_t shared_bytes, void* stream) {
  if (C < 1 || P < 1 || ldq < P ||
      !nanofed::plan_ok(vec, kInt8Unit, P, blocks, slab, stages, shared_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec > 1 && (ldq % vec != 0 || reinterpret_cast<uintptr_t>(q) % vec != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_dequant(q, ldq, coefs, C, P, base, base_vec4, out, vec, blocks,
                                         stages, shared_bytes,
                                         static_cast<cudaStream_t>(stream)));
}

// What the card makes of B4's kernel for a launch of load width `vec`: its registers
// a thread and how many of its blocks an SM holds at `shared_bytes`.
extern "C" int nf_dequant_accumulate_occupancy(int vec, int64_t shared_bytes, int* registers,
                                               int* blocks_per_sm) {
  if (vec == 16) {
    const cudaError_t err = prepare_dequant_ring();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int threads = 0;
  const void* kernel = dequant_kernel_of(vec, &threads);
  return static_cast<int>(
      nanofed::occupancy(kernel, threads, shared_bytes, registers, blocks_per_sm));
}

// B5.  x: [n] f32; out: [n] uint32; vec, blocks and slab are the host's plan (vec 4
// needs both pointers 16-byte aligned).  Returns cudaErrorInvalidValue for a plan or a
// layout it cannot run, else cudaGetLastError().
extern "C" int nf_quantize_u32(const float* x, uint32_t* out, int64_t n, float scale, int vec,
                               int64_t blocks, int64_t slab, void* stream) {
  return static_cast<int>(launch_convert(reinterpret_cast<const uint32_t*>(x), out, n,
                                         ToFixed{scale}, vec, blocks, slab, stream));
}

// B6.  q: [n] uint32; out: [n] f32; the plan as for nf_quantize_u32.
extern "C" int nf_dequantize_u32(const uint32_t* q, float* out, int64_t n, float inv_scale,
                                 int vec, int64_t blocks, int64_t slab, void* stream) {
  return static_cast<int>(launch_convert(q, reinterpret_cast<uint32_t*>(out), n,
                                         FromFixed{inv_scale}, vec, blocks, slab, stream));
}

// What the card makes of B5's (dequantize 0) or B6's (1) kernel at a plan's vec: its
// registers a thread and how many of its blocks an SM holds.
extern "C" int nf_fixed_point_occupancy(int dequantize, int vec, int* registers,
                                        int* blocks_per_sm) {
  return static_cast<int>(dequantize
                              ? convert_occupancy<FromFixed>(vec, registers, blocks_per_sm)
                              : convert_occupancy<ToFixed>(vec, registers, blocks_per_sm));
}

// B7.  q, out: [n] uint32; the k >= 1 keys as [k][3] 64-bit words (the 128-bit Philox
// key (k0, k1) of each seed, then 1 to subtract its mask, 0 to add it), nsub of which
// subtract, in host memory (host_keys) and, for k > nf_add_mask_inline_keys(), on the
// card (device_keys); grid: the host's block count (at most SMs x kMaskBlocksPerSm, one
// wave); vec 4 needs q and out 16-byte aligned.
extern "C" int nf_add_mask(const uint32_t* q, uint32_t* out, int64_t n,
                           const uint64_t* host_keys, const uint64_t* device_keys, int k,
                           int nsub, int vec, int64_t grid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || k < 1 || nsub < 0 || nsub > k || grid < 1 || grid > 0x7fffffff ||
      (vec != 4 && vec != 1) || (k <= kInlineKeys ? host_keys : device_keys) == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  InlineKeys inline_keys = {};
  if (k <= kInlineKeys) {
    for (int j = 0; j < 3 * k; ++j) inline_keys.w[j / 3][j % 3] = host_keys[j];
    device_keys = nullptr;
  }
  const unsigned g = static_cast<unsigned>(grid);
  const uint32_t ns = static_cast<uint32_t>(nsub);
  if (vec == 4) {
    add_mask_kernel<4><<<g, kThreads, 0, s>>>(q, out, n, device_keys, inline_keys, k, ns);
  } else {
    add_mask_kernel<1><<<g, kThreads, 0, s>>>(q, out, n, device_keys, inline_keys, k, ns);
  }
  return static_cast<int>(cudaGetLastError());
}

// The most keys a B7 launch takes in its parameters.
extern "C" int nf_add_mask_inline_keys() { return kInlineKeys; }

// What the card makes of B7's kernel (the 16-byte form): its registers a thread and the
// blocks an SM holds.
extern "C" int nf_add_mask_occupancy(int* registers, int* blocks_per_sm) {
  return static_cast<int>(nanofed::occupancy(reinterpret_cast<const void*>(add_mask_kernel<4>),
                                             kThreads, 0, registers, blocks_per_sm));
}
