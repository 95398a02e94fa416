// Kernel B3: per-row squared L2 norms, [C, P] -> [C], out[c] = sum_p x[c, p]^2.
//
// Replaces nanofed_tpu/ops/dp_reduce.py row_sq_norms (_sq_norm_kernel), which
// accumulated into one [1, C] output block across a grid the TPU runs in order.
//
// Bound on an H100: bytes.  It reads x once (4*C*P bytes) for 2*C*P flops; at the
// flagship chunk (C=125, P=1,199,882) the 600 MB read takes at least 0.1791 ms, at a
// DP-SGD chunk (C=25) 0.0358 ms, at a (w3) rank's adapter chunk (C=2, P=1,398,784)
// 0.0033 ms, less than one launch.
//
// The first design ran two launches: a grid of (segment, row) blocks, each
// summing 16,384 columns (256 threads x 4 floats x 16 loads) into partial[row, seg],
// then one warp a row over the partials.  On an H100 80GB HBM3 at 700 W it took
// 0.2157 ms at C=125 (83% of the bound), 0.0585-0.0603 ms at C=25 (59-61%), 0.0166 ms
// at C=10, P=77,850 (5.6%), 0.0306 ms at C=8, P=1,398,784 (43.7%) and 0.0192-0.0344 ms
// at C=2, P=1,398,784 (9.7-17.4%, once slower than torch.linalg.vecdot).  What held it
// back, and what this design does about each point:
//
// 1. Two launches a call, and two allocations.  The second launch (1-2 us) cost about
//    as much as the whole bound at the small shapes.  Now one launch: the blocks
//    reduce across themselves with tickets (below), which measured 0.7-2.1 us faster
//    than the same kernel followed by a second launch at every timed shape but C=2,
//    P=97,745,408, where the two were level.  The wrapper keeps the partials and the
//    tickets in a per-(device, stream) workspace that it allocates once.
// 2. A grid fixed by the shape: ceil(P / 16,384) x C blocks, 1.3 blocks an SM at C=2,
//    P=1.4M, 0.65 of a wave at C=8, 8.8 waves with a tail at C=125, and every row's
//    last block ragged.  Now the host plans a persistent grid (ops/dp_reduce.py
//    row_sq_plan): each row is cut into S = min(SMs / 2, units / 256) segments, equal
//    to within one unit, from P, the load width and the SM count only (never C); the
//    C x S (row, segment) pairs, in row-major order, are dealt to at most 2 x SMs
//    blocks in contiguous runs equal to within one pair.  C=2 gives every SM a block
//    and C=125 is one wave.
// 3. Little in flight: four float4 register loads a thread, and two block barriers
//    every 64 KB.  Now, on 16-byte-aligned rows (VEC 4: every round's delta stack), a
//    block streams its run through B1's bulk-copy ring: one producer thread copies
//    each segment in equal chunks of at most one 16 KB stage against full/empty
//    mbarrier pairs, up to 3 stages a block and 2 blocks an SM (B1's 96 KB an SM),
//    and 256 consumer threads sum squares from shared memory.  Unaligned layouts
//    (VEC 2 or 1) take register loads on the same plan, 8 loads in flight a thread
//    (6 blocks of 256 an SM).  Each warp reduces its segment's values with shuffles
//    and stores its own partial: no block barrier in the stream.
//
// What a block pays for each segment and each chunk decides the plan.  A first version
// whose producer and consumers divided 64-bit integers and met at a barrier for every
// segment slowed down as segments shrank, so the run is walked with no division in
// the loop (Walk, Chunks) and no barrier; smaller segments still mean smaller chunks,
// and S = SMs / 2 and 3 stages measured best over the timed shapes
// (scripts/time_reduce_kernels.py --b3-sweep).  Blocks that claimed pairs from a
// counter instead of taking a static run measured 1.3% faster at C=125 but 22% slower
// at C=10, P=77,850 (a claim's round trip on every small segment), so the runs are
// static.
//
// The reduction across blocks, in fixed order.  A segment's 8 partials (one a warp:
// each lane's chain over its units in a fixed order, then a shuffle tree) go to
// partial[c, s, 0..7].  A row whose segments all fall in one block's run is finished
// by that block.  Only the first and the last row of a run can be shared with other
// blocks: for those, after a __threadfence(), the block adds its segment count to the
// row's ticket (an int32 a row in the workspace), and the block that brings it to S
// finishes the row and resets its ticket to 0.  Finishing is one warp: lane l sums
// partials l, l+32, ... of the row's 8 x S in order, then a shuffle tree.  The row's
// bits thus depend on its values, P, the layout and the SM count only: not on C, on
// the row's place, on the grid or on the order blocks finish.  A chunked round, a mesh
// rank's share and a fused block give each client the same norm bits at the same P,
// and two calls give the same bits.  (One ticket electing the last block to finish
// every row would leave that block C rows of work after every other block is done; a
// row's ticket leaves each block at most its own rows.)
//
// The aligned layout's ragged edge (P % 4 columns of a padded row) cannot be bulk
// copied; the segment's consumer thread 0 loads those columns itself.

#include "common.cuh"

namespace {

using nanofed::bulk_copy_g2s;
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

static_assert(kConsumers == kThreads, "the register path's block is the ring's consumers");

constexpr int kRegLoads = 8;  // register loads in flight a thread (VEC 2 and 1)

// Part i of `total` items cut into `parts` contiguous parts: the last total % parts
// parts take one item more (ops/dp_reduce.py _part mirrors it).
struct Part {
  int64_t start;
  int64_t count;
};

__device__ __forceinline__ Part part_of(int64_t total, int64_t parts, int64_t i) {
  const int64_t base = total / parts;
  const int64_t first_wide = parts - total % parts;
  return {i * base + (i > first_wide ? i - first_wide : 0), base + (i >= first_wide ? 1 : 0)};
}

// A block's run of (row, segment) pairs, walked in order with no division in the loop:
// the segment widths (base or base + 1 units) are worked out once.
struct Walk {
  int64_t S, base, first_wide;
  int64_t c, s;  // the current pair

  __device__ Walk(int64_t units_row, int64_t segments, int64_t first_pair)
      : S(segments), base(units_row / segments), first_wide(segments - units_row % segments),
        c(first_pair / segments), s(first_pair % segments) {}

  __device__ __forceinline__ Part segment() const {
    return {s * base + (s > first_wide ? s - first_wide : 0), base + (s >= first_wide ? 1 : 0)};
  }
  __device__ __forceinline__ void next() {
    if (++s == S) {
      s = 0;
      ++c;
    }
  }
};

// A segment of `units` ring units in `n` chunks of at most one stage, equal to within
// one unit (widths cb or cb + 1 from chunk first_wide on).  A segment is under 2^31
// units (the host's plan checks it), so one 32-bit division a segment.
struct Chunks {
  uint32_t n, cb, first_wide;

  __device__ __forceinline__ explicit Chunks(int64_t units) {
    const uint32_t u = static_cast<uint32_t>(units);
    n = (u + kStageUnits - 1) / kStageUnits;
    cb = n ? u / n : 0;
    first_wide = n ? n - u % n : 0;
  }
  __device__ __forceinline__ uint32_t start(uint32_t j) const {
    return j * cb + (j > first_wide ? j - first_wide : 0);
  }
  __device__ __forceinline__ uint32_t width(uint32_t j) const {
    return cb + (j >= first_wide ? 1 : 0);
  }
};

// The kConsumers threads (the ring's consumers, or the whole register-path block) meet;
// the ring's producer warp never takes part.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Each warp's partial of segment (c, s): a shuffle tree over its lanes' values, stored
// by lane 0 at partial[c, s, warp].  No barrier: the 8 warps' partials are summed when
// the row is finished.
__device__ __forceinline__ void store_partial(float v, float* __restrict__ partial, int64_t S,
                                              int64_t c, int64_t s) {
  v = nanofed::warp_sum(v);
  if (threadIdx.x % 32 == 0) partial[(c * S + s) * kConsumerWarps + threadIdx.x / 32] = v;
}

// One warp: out[c] = the sum of the row's S x 8 partials, lane l summing l, l+32, ...
// in order, then a shuffle tree.  With a ticket, reset it for the next launch.
__device__ __forceinline__ void finish_row(const float* __restrict__ partial, int64_t S,
                                           int64_t c, float* __restrict__ out,
                                           int* ticket) {
  const int lane = threadIdx.x % 32;
  const int64_t n = S * kConsumerWarps;
  const float* row = partial + c * n;
  float v = 0.f;
  for (int64_t k = lane; k < n; k += 32) v += __ldcg(row + k);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) {
    out[c] = v;
    if (ticket != nullptr) *ticket = 0;
  }
}

// After the run's partials: take the tickets of its first and last row where other
// blocks share them, then finish, one warp a row, every row this block completes.
// Every consumer thread calls it.
__device__ void finish_run(Part run, int64_t S, const float* __restrict__ partial,
                           int* __restrict__ tickets, float* __restrict__ out) {
  __shared__ int finish[2];  // the run's first and last row: 0 skip, 1 finish, 2 and reset
  const int64_t first = run.start / S;
  const int64_t last = (run.start + run.count - 1) / S;
  consumers_sync();  // every warp's partials of the run are written
  if (threadIdx.x == 0) {
    __threadfence();
    for (int e = 0; e < 2; ++e) {
      const int64_t c = e == 0 ? first : last;
      if (e == 1 && last == first) {
        finish[1] = finish[0];
        break;
      }
      const int64_t lo = run.start > c * S ? run.start : c * S;
      const int64_t hi = run.start + run.count < (c + 1) * S ? run.start + run.count : (c + 1) * S;
      const int n = static_cast<int>(hi - lo);
      if (n == S) {
        finish[e] = 1;
      } else {
        const int before = atomicAdd(tickets + c, n);
        finish[e] = before + n == S ? 2 : 0;
      }
    }
    __threadfence();
  }
  consumers_sync();
  const int warp = threadIdx.x / 32;
  for (int64_t c = first + warp; c <= last; c += kConsumerWarps) {
    const int f = c == first ? finish[0] : (c == last ? finish[1] : 1);
    if (f != 0) finish_row(partial, S, c, out, f == 2 ? tickets + c : nullptr);
  }
}

// ---- the aligned layout: a bulk-copy ring ----------------------------------------

__global__ void __launch_bounds__(kBulkThreads, 2) row_sq_ring(
    const float* __restrict__ x, int64_t ldx, int64_t C, int64_t P, int64_t S,
    float* __restrict__ partial, int* __restrict__ tickets, float* __restrict__ out,
    int stages) {
  extern __shared__ __align__(128) float4 ring[];  // stages x kStageUnits
  __shared__ __align__(8) uint64_t full[kMaxStages];
  __shared__ __align__(8) uint64_t empty[kMaxStages];

  const int64_t units_row = (P + 3) / 4;
  const int tail = static_cast<int>(P % 4);  // the row's last unit is partial: not copied
  const Part run = part_of(C * S, gridDim.x, blockIdx.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                // the producer's arrive.expect_tx
      mbar_init(&empty[s], kConsumerWarps);  // one arrive per consumer warp
    }
    nanofed::mbar_fence_init();
  }
  __syncthreads();

  Walk walk(units_row, S, run.start);
  if (threadIdx.x >= kConsumers) {
    // Producer: one thread copies the run's segments in order, each in equal chunks.
    if (threadIdx.x == kConsumers) {
      int stage = 0;
      uint32_t phase = 0;
      for (int64_t i = 0; i < run.count; ++i, walk.next()) {
        Part seg = walk.segment();
        if (tail != 0 && walk.s == S - 1) seg.count -= 1;
        const Chunks chunks(seg.count);
        const float4* src = reinterpret_cast<const float4*>(x + walk.c * ldx) + seg.start;
        for (uint32_t j = 0; j < chunks.n; ++j) {
          const uint32_t bytes = chunks.width(j) * 16u;
          mbar_wait(&empty[stage], phase ^ 1u);  // the first pass finds every slot free
          mbar_arrive_expect_tx(&full[stage], bytes);
          bulk_copy_g2s(ring + static_cast<int64_t>(stage) * kStageUnits,
                        src + chunks.start(j), bytes, &full[stage]);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1u;
          }
        }
      }
    }
    return;  // the producer warp takes no part in the consumers' barriers
  }

  // Consumers: thread t squares units t, t+256, ... of each chunk.
  const int lane = threadIdx.x % 32;
  int stage = 0;
  uint32_t phase = 0;
  for (int64_t i = 0; i < run.count; ++i, walk.next()) {
    const bool edge = tail != 0 && walk.s == S - 1;
    const Chunks chunks(walk.segment().count - (edge ? 1 : 0));
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (uint32_t j = 0; j < chunks.n; ++j) {
      const int width = static_cast<int>(chunks.width(j));
      mbar_wait(&full[stage], phase);
      const float4* st = ring + static_cast<int64_t>(stage) * kStageUnits;
#pragma unroll
      for (int q = 0; q < kStageUnits / kConsumers; ++q) {
        const int u = threadIdx.x + q * kConsumers;
        if (u < width) {
          const float4 v = st[u];
          a0 = fmaf(v.x, v.x, a0);
          a1 = fmaf(v.y, v.y, a1);
          a2 = fmaf(v.z, v.z, a2);
          a3 = fmaf(v.w, v.w, a3);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);  // this warp is done with the slot
      if (++stage == stages) {
        stage = 0;
        phase ^= 1u;
      }
    }
    if (edge && threadIdx.x == 0) {
      const float* ragged = x + walk.c * ldx + (units_row - 1) * 4;
      for (int k = 0; k < tail; ++k) {
        const float v = __ldg(ragged + k);
        a0 = fmaf(v, v, a0);
      }
    }
    store_partial((a0 + a1) + (a2 + a3), partial, S, walk.c, walk.s);
  }
  finish_run(run, S, partial, tickets, out);
}

// ---- unaligned layouts: register loads ---------------------------------------------

template <int VEC>
__global__ void __launch_bounds__(kThreads, 6) row_sq_regs(
    const float* __restrict__ x, int64_t ldx, int64_t C, int64_t P, int64_t S,
    float* __restrict__ partial, int* __restrict__ tickets, float* __restrict__ out) {
  const int64_t units_row = (P + VEC - 1) / VEC;
  const int tail = static_cast<int>(P % VEC);  // the row's last unit holds `tail` floats
  const Part run = part_of(C * S, gridDim.x, blockIdx.x);
  Walk walk(units_row, S, run.start);
  for (int64_t i = 0; i < run.count; ++i, walk.next()) {
    const Part seg = walk.segment();
    const bool edge = tail != 0 && walk.s == S - 1;
    const int64_t end = seg.start + seg.count - (edge ? 1 : 0);  // whole units
    const float* r = x + walk.c * ldx;
    float acc[kRegLoads];
#pragma unroll
    for (int j = 0; j < kRegLoads; ++j) acc[j] = 0.f;
    int64_t u = seg.start + threadIdx.x;
    for (; u + (kRegLoads - 1) * kThreads < end; u += kRegLoads * kThreads) {
      float v[kRegLoads][VEC];
#pragma unroll
      for (int j = 0; j < kRegLoads; ++j) nanofed::load_vec<VEC>(r + (u + j * kThreads) * VEC, v[j]);
#pragma unroll
      for (int j = 0; j < kRegLoads; ++j) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j] = fmaf(v[j][e], v[j][e], acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRegLoads; ++j) {
      if (u + j * kThreads < end) {
        float v[VEC];
        nanofed::load_vec<VEC>(r + (u + j * kThreads) * VEC, v);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[j] = fmaf(v[e], v[e], acc[j]);
      }
    }
    if (edge && threadIdx.x == 0) {
      for (int k = 0; k < tail; ++k) {
        const float v = __ldg(r + (units_row - 1) * VEC + k);
        acc[0] = fmaf(v, v, acc[0]);
      }
    }
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < kRegLoads; ++j) total += acc[j];
    store_partial(total, partial, S, walk.c, walk.s);
  }
  finish_run(run, S, partial, tickets, out);
}

// ---- the launch and its checks ---------------------------------------------------

cudaError_t prepare_ring() {
  static bool done[64] = {};
  return nanofed::prepare_ring(reinterpret_cast<const void*>(row_sq_ring), done);
}

// The plan the host computed, checked (ops/dp_reduce.py check_row_sq_plan mirrors it):
// S segments of a row of ceil(P / vec) units, `blocks` runs over the C x S pairs, and
// on the aligned layout `stages` ring stages in `shared_bytes` of dynamic shared memory.
bool row_sq_plan_ok(int vec, int64_t ldx, int64_t C, int64_t P, int64_t segments,
                    int64_t blocks, int stages, int64_t shared_bytes) {
  if (vec != 4 && vec != 2 && vec != 1) return false;
  if (C < 1 || P < 1 || ldx < P || C > 0x7fffffff) return false;
  const int64_t units = (P + vec - 1) / vec;
  if (segments < 1 || segments > units || segments > 0x7fffffff) return false;
  if ((units + segments - 1) / segments > 0x7fffffff) return false;  // a segment's units
  if (blocks < 1 || blocks > C * segments || blocks > 0x7fffffff) return false;
  if (vec == 4) {
    return ldx % 4 == 0 && stages >= nanofed::kMinStages && stages <= kMaxStages &&
           shared_bytes == static_cast<int64_t>(stages) * nanofed::kStageBytes &&
           shared_bytes <= nanofed::kMaxBlockShared;
  }
  return stages == 0 && shared_bytes == 0;
}

}  // namespace

// x: [C, P] f32 with row stride ldx (elements); vec its load width (4: the bulk-copy
// ring, which needs ldx % 4 == 0 and x 16-byte aligned; 2 or 1: register loads);
// segments, blocks, stages and shared_bytes the host's plan; partial: [C, segments, 8]
// f32 scratch (a partial a consumer warp); tickets: [C] int32, all 0 (and left all 0);
// out: [C] f32.  Returns cudaErrorInvalidValue for a plan or layout it cannot run, else
// cudaGetLastError().
extern "C" int nf_row_sq_norms(const float* x, int64_t ldx, int64_t C, int64_t P, int vec,
                               int64_t segments, int64_t blocks, int stages,
                               int64_t shared_bytes, float* partial, int* tickets,
                               float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!row_sq_plan_ok(vec, ldx, C, P, segments, blocks, stages, shared_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec > 1 && (ldx % vec != 0 || reinterpret_cast<uintptr_t>(x) % (4 * vec) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tickets == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec == 4) {
    const cudaError_t err = prepare_ring();
    if (err != cudaSuccess) return static_cast<int>(err);
    row_sq_ring<<<grid, kBulkThreads, static_cast<size_t>(shared_bytes), s>>>(
        x, ldx, C, P, segments, partial, tickets, out, stages);
  } else if (vec == 2) {
    row_sq_regs<2><<<grid, kThreads, 0, s>>>(x, ldx, C, P, segments, partial, tickets, out);
  } else {
    row_sq_regs<1><<<grid, kThreads, 0, s>>>(x, ldx, C, P, segments, partial, tickets, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// What the card makes of the layout's kernel: its registers a thread (ptxas's count)
// and how many of its blocks an SM holds at `shared_bytes` of dynamic shared memory.
extern "C" int nf_row_sq_norms_occupancy(int vec, int64_t shared_bytes, int* registers,
                                         int* blocks_per_sm) {
  if (vec == 4) {
    const cudaError_t err = prepare_ring();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(nanofed::occupancy(reinterpret_cast<const void*>(row_sq_ring),
                                               kBulkThreads, shared_bytes, registers,
                                               blocks_per_sm));
  }
  const void* kernel = vec == 2 ? reinterpret_cast<const void*>(row_sq_regs<2>)
                                : reinterpret_cast<const void*>(row_sq_regs<1>);
  return static_cast<int>(nanofed::occupancy(kernel, kThreads, shared_bytes, registers,
                                             blocks_per_sm));
}
