// Viterbi add-compare-select trellis of the order-15 convolutional code,
// with the traceback, for sm_90a: kernel K1.
//
// Replaces audiowmark_tpu/ops/viterbi_pallas.py::_acs_kernel_batch (the
// pallas_call of viterbi_acs_pallas_batch, :128) and, with B = 1,
// ::_acs_kernel (viterbi_acs_pallas, :162).  Per row and step t, over the
// 32768 states s:
//
//     new[s] = min(old[s >> 1], old[(s >> 1) + 16384]) + bm[t, s]
//
// where the high predecessor wins only if it is strictly smaller (the
// reference's tie rule; a NaN compare is false, so NaN picks the low one).
// The metric starts at 0 for state 0 and 1e9 elsewhere; the bits are traced
// back from state 0.  Every state costs one compare, one select and one f32
// add, as in the reference, so the result is the same bit for bit.
//
// Bound on an H100 (3.35 TB/s): per row and 143-step payload the kernel must
// read bm, 143 x 32768 x 4 B = 18.74 MB, and write the bit-packed
// decisions (143 x 2 KB), the final metrics (128 KB) and the bits (572 B):
// 19.17 MB, 5.72 us per row, 91.5 us at B = 16.  The arithmetic (about
// 3 operations per state and step, 14 MFLOP per row) is negligible.
//
// What limited the first design (one 1024-thread CTA per row, the 128 KB
// metric in place in shared memory, two block barriers per step, int8
// decisions, a one-thread traceback): 0.44 ms at B = 16 against 0.52 ms at
// B = 52, ~3.1 us per step whatever B, so the latency of one row's serial
// chain on one SM set the pace.  B rows used only B of the 132 SMs; every
// step waited a full HBM round trip for its bm (the metric filled the
// shared memory, so nothing could be staged); decisions were written one
// byte per state (32 KB per step for 16384 distinct bits); the traceback
// walked 143 dependent global loads on one thread.  This design:
//
// 1. A thread-block cluster of C = 2^c CTAs per row (C = 2, 4 or 8, chosen
//    by the wrapper so that B x C fills the SMs; rows past one wave run in
//    waves; C = 16, a non-portable cluster size, was faster only at B <= 3,
//    which no path of the port gives K1, and slower at B = 8).  Each CTA holds 2^(15-c) states of the metric: those
//    whose c bits at the "window" [w, w + c) equal the CTA's rank.  A
//    successor s has the predecessors s >> 1 and (s >> 1) + 2^14, so if the
//    old metric is cut at window w, the new one cut at w + 1 needs no state
//    of another CTA: such a step is local, and in the CTA's own numbering it
//    is the same trellis with 2^(15-c) states.  The window climbs from 6 to
//    15 - c that way; the step after it is an exchange step, back to window
//    6, whose predecessors come from the other CTAs through distributed
//    shared memory (mapa + ld.shared::cluster, float4).  One step in
//    10 - c exchanges (1 in 7 at C = 8).  A cluster barrier ends the step
//    before an exchange step; the metric rotates through three buffers
//    (read one, write another), so an exchange step's source is left alone
//    until the next exchange and needs no barrier after it (two buffers
//    and a barrier after it at C = 2, where three do not fit beside the
//    ring).  The local steps end on a barrier of the consumer warps.
//    Window 6 keeps every contiguous run of bm at least 64 floats long and
//    every 32-bit decision word in one CTA.  A first cut kept each CTA's
//    states contiguous (window 15 - c for good): every step an exchange,
//    one DSMEM round trip and one cluster barrier per step (PERF.md).
// 2. bm streams ahead of the recurrence.  A step's states of one CTA, in
//    the CTA's numbering, are runs of 2^w floats of bm's row, 2^(w + c)
//    apart: one box of a 5-D TMA descriptor per window (built on the host
//    at each launch).  A producer warp, outside the consumers' barrier,
//    loads one tile of 8 x kThreads floats per box with
//    cp.async.bulk.tensor into a ring of kSlots tiles; each slot has a
//    "full" mbarrier (the bytes have landed) and an "empty" one (every
//    consumer warp has used it).  The ring holds 4 steps ahead at C = 8
//    (ring 4 x 16 KB + metric 3 x 16 KB = 112 KB, so two CTAs fit on one
//    SM), 3 at C = 4 (96 + 96 KB) and 1.5 at C = 2 (the 2 x 64 KB metric
//    leaves room for 6 tiles: 224 KB).  Cuts that lost on the card
//    (PERF.md): one 1-D cp.async.bulk per run, issued by a consumer warp
//    or by each warp for its slice (a window-6 step needs 64 copies of
//    256 B per CTA, and issuing them stalled the step).
// 3. Decisions are bit-packed: a thread holds 4 consecutive predecessor
//    pairs, makes a nibble, and 8 lanes OR theirs into one 32-bit word
//    (bit k of word w is pair 32w + k): 2 KB per step and row instead of
//    32 KB.  The traceback runs in CTA 0 after a last cluster barrier has
//    made every CTA's words visible: the other warps copy the decision
//    rows from L2 into the free ring, a batch ahead, and warp 0 resolves 5
//    steps per round from shared memory: lane i guesses the 5 decisions
//    from the bits of i, reads the 5 words its guess leads to
//    (independent loads), and the one lane whose guesses all match carries
//    the state on: 29 rounds instead of 143 dependent loads.
//
// Shared memory per CTA: kSlots tiles, 3 (at C = 2: 2) x 2^(15-c) floats
// of metric and 2 kSlots mbarriers.  Threads: kThreads consumers and the
// producer warp.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kOrder = 15;
constexpr int kStates = 1 << kOrder;   // 32768
constexpr int kWords = kStates / 64;   // 512 decision words per step and row
constexpr int kFirstWindow = 6;        // the window after an exchange step
constexpr int kTracebackRound = 5;     // 2^5 = 32 lanes of guesses
constexpr int kMaxWindows = kOrder - kFirstWindow;   // at C = 2
constexpr int kMaxDevices = 64;        // devices a process may launch on

// One TMA descriptor per window w (index w - kFirstWindow): bm as a dense
// 5-D tensor (innermost first) of 64 floats x 2^(w-6) (the rest of a run of
// 2^w) x C (the rank at the window) x 2^(15-c-w) (the runs) x B steps, so
// that one box is one tile of a CTA's states in its own numbering.
struct BmMaps {
  CUtensorMap window[kMaxWindows];
};

// Per cluster size C = 2^kBits: threads per CTA and ring slots.  Every
// thread handles one group of 4 pairs (8 new states) per tile, so a tile
// holds 8 x kThreads states.
template <int C> struct Cfg;
template <> struct Cfg<8> {
  static constexpr int kBits = 3, kThreads = 512, kSlots = 4;
};
template <> struct Cfg<4> {
  static constexpr int kBits = 2, kThreads = 512, kSlots = 6;
};
template <> struct Cfg<2> {
  static constexpr int kBits = 1, kThreads = 512, kSlots = 6;
};

template <int C> __host__ __device__ constexpr int tile_floats() {
  return 8 * Cfg<C>::kThreads;
}
// Metric buffers: three where they fit beside the ring, so that an
// exchange step's source is left alone until the next exchange step; two
// at C = 2.
template <int C> __host__ __device__ constexpr int buffers() {
  return C == 2 ? 2 : 3;
}
template <int C> __host__ __device__ constexpr int smem_bytes() {
  return buffers<C>() * (kStates / C) * 4 +
         Cfg<C>::kSlots * tile_floats<C>() * 4 + Cfg<C>::kSlots * 16;
}

// x with the bits `bits` of value r inserted at bit w: the global index of
// a CTA's local index x, when the CTA owns the window [w, w + bits) = r.
__device__ __forceinline__ uint32_t spread(uint32_t x, int w, int bits,
                                           uint32_t r) {
  return (x & ((1u << w) - 1)) | (r << w) | ((x >> w) << (w + bits));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

// Waits for the phase `parity` of bar to complete.  A load that never
// lands traps (the launch then fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// One box of a 5-D tensor map -> this CTA's shared memory, completing on
// bar (TMA, cp.async.bulk.tensor).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c1, int c2, int c3, int c4,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];"
      :: "r"(smem_u32(dst)), "l"(map), "r"(0), "r"(c1), "r"(c2), "r"(c3),
         "r"(c4), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int C>
__global__ void __launch_bounds__(Cfg<C>::kThreads + 32)
viterbi_acs_cluster(const __grid_constant__ BmMaps maps,
                    uint32_t* __restrict__ dec, float* __restrict__ metrics,
                    int32_t* __restrict__ bits, int steps) {
  constexpr int kBits = Cfg<C>::kBits;
  constexpr int kThreads = Cfg<C>::kThreads;   // the consumers
  constexpr int kWarps = kThreads / 32;
  constexpr int kSlots = Cfg<C>::kSlots;
  constexpr int kTile = tile_floats<C>();
  constexpr int kOwn = kStates / C;            // states per CTA
  constexpr int kTilesPerStep = kOwn / kTile;
  constexpr int kTopWindow = kOrder - kBits;
  constexpr int kPeriod = kTopWindow - kFirstWindow + 1;   // steps
  static_assert(C == 1 << kBits && kTilesPerStep * kTile == kOwn, "");
  static_assert(kSlots >= kTilesPerStep, "a step must fit in the ring");

  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);     // TMA wants 128 B
  float* metric = ring + kSlots * kTile;            // buffers of kOwn
  // full[slot]: the tile has landed; empty[slot]: every consumer warp has
  // read it
  uint64_t* full =
      reinterpret_cast<uint64_t*>(metric + buffers<C>() * kOwn);
  uint64_t* empty = full + kSlots;

  const uint32_t rank = cg::this_cluster().block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  uint32_t* dec_row = dec + static_cast<size_t>(row) * steps * kWords;
  const int n_tiles = steps * kTilesPerStep;
  // the window of the metric before step t; step t is an exchange step
  // when it starts at the top window.  An exchange step reads the other
  // CTAs' metric: every CTA's must be complete before it (a cluster
  // barrier ends the step before it), and none may be overwritten until it
  // is done.  With three buffers the exchange step's source is left alone
  // until the next exchange step, which comes after the next such
  // barrier; with two, a cluster barrier ends the exchange step too.  A
  // CTA barrier of the consumers ends every other step.
  auto window = [](int t) { return kFirstWindow + t % kPeriod; };
  auto cluster_after = [&](int t) {
    return window(t + 1) == kTopWindow ||
           (buffers<C>() == 2 && window(t) == kTopWindow);
  };

  // the producer warp's lane 0: bm tile n (tile n % kTilesPerStep of step
  // n / kTilesPerStep, indexed by the step's new states, window w) into
  // slot n % kSlots, as one box: local states l0 .. l0 + kTile - 1 are run
  // l0 >> w from float l0 mod 2^w on
  auto issue = [&](int n) {
    const int slot = n % kSlots;
    const int t = n / kTilesPerStep;
    const int w = window(t + 1);
    const int l0 = (n % kTilesPerStep) * kTile;
    mbar_expect_tx(&full[slot], kTile * 4);
    tma_load(ring + slot * kTile, &maps.window[w - kFirstWindow],
             (l0 & ((1 << w) - 1)) >> 6, rank, l0 >> w, row * steps + t,
             &full[slot]);
  };

  if (tid < kThreads) {
    for (int i = tid; i < kOwn; i += kThreads) {
      metric[i] = (rank == 0 && i == 0) ? 0.0f : 1e9f;
    }
  } else {
    if (lane == 0) {
      for (int s = 0; s < kSlots; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], kWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int n = 0; n < kSlots && n < n_tiles; ++n) issue(n);
    }
  }
  cluster_sync();   // every CTA's initial metric and barriers are in place

  if (tid >= kThreads) {
    // Refill slot n % kSlots once the consumers have read tile n - kSlots,
    // taking part in the consumers' cluster barriers in order: the one
    // after step t is passed before waiting on a slot freed after step t.
    int t_sync = 0;
    for (int n = kSlots; n < n_tiles; ++n) {
      for (; t_sync < (n - kSlots) / kTilesPerStep; ++t_sync) {
        if (cluster_after(t_sync)) cluster_sync();
      }
      if (lane == 0) {
        mbar_wait(&empty[n % kSlots], (n / kSlots - 1) & 1);
        issue(n);
      }
      __syncwarp();
    }
    for (; t_sync < steps; ++t_sync) {
      if (cluster_after(t_sync)) cluster_sync();
    }
    cluster_sync();
    return;
  }

  // the consumers: lanes 0-3 and 4-7 of each quarter warp take the two
  // float4 halves of their 8 states in opposite order (no bank conflicts)
  const int half = (lane >> 2) & 1;
  // step t reads buffer `from` and writes buffer `to`; they swap after a
  // local step, and after an exchange step the source is set aside
  int from = 0, to = 1;
  for (int t = 0; t < steps; ++t) {
    const bool exchange = window(t) == kTopWindow;
    const int w_new = window(t + 1);
    const float* cur = metric + from * kOwn;
    float* nxt = metric + to * kOwn;
    // group g = tid + k kThreads: local pairs q = 4g .. 4g+3, new local
    // states 8g .. 8g+7.  In a local step the predecessors are the local
    // states q and q + kOwn/2; in an exchange step the global pair
    // P = spread(q, 5, ...) lives in CTA P >> kTopWindow (low state) and
    // C/2 further (high state), at local index P mod kOwn.
    float4 lo[kTilesPerStep], hi[kTilesPerStep];
#pragma unroll
    for (int k = 0; k < kTilesPerStep; ++k) {
      const uint32_t q = 4 * (tid + k * kThreads);
      if (!exchange) {
        lo[k] = *reinterpret_cast<const float4*>(cur + q);
        hi[k] = *reinterpret_cast<const float4*>(cur + q + kOwn / 2);
      } else {
        const uint32_t p = spread(q, kFirstWindow - 1, kBits, rank);
        const uint32_t at = smem_u32(cur) + (p % kOwn) * 4;
        lo[k] = ld_cluster_f4(map_rank(at, p >> kTopWindow));
        hi[k] = ld_cluster_f4(map_rank(at, (p >> kTopWindow) + C / 2));
      }
    }
#pragma unroll
    for (int k = 0; k < kTilesPerStep; ++k) {
      const int g = tid + k * kThreads;
      const int n = t * kTilesPerStep + k;
      mbar_wait(&full[n % kSlots], (n / kSlots) & 1);
      const float4* b =
          reinterpret_cast<const float4*>(ring + (n % kSlots) * kTile) +
          2 * tid;
      const float4 bx = b[half];
      const float4 by = b[half ^ 1];
      const float4 b0 = half ? by : bx;
      const float4 b1 = half ? bx : by;
      const bool d0 = hi[k].x < lo[k].x, d1 = hi[k].y < lo[k].y;
      const bool d2 = hi[k].z < lo[k].z, d3 = hi[k].w < lo[k].w;
      const float m0 = d0 ? hi[k].x : lo[k].x, m1 = d1 ? hi[k].y : lo[k].y;
      const float m2 = d2 ? hi[k].z : lo[k].z, m3 = d3 ? hi[k].w : lo[k].w;
      const float4 o0 = make_float4(m0 + b0.x, m0 + b0.y, m1 + b0.z, m1 + b0.w);
      const float4 o1 = make_float4(m2 + b1.x, m2 + b1.y, m3 + b1.z, m3 + b1.w);
      float4* out = reinterpret_cast<float4*>(nxt) + 2 * g;
      out[half] = half ? o1 : o0;
      out[half ^ 1] = half ? o0 : o1;
      // the stores used the warp's bm values, so its loads of the slot
      // are complete: the producer may refill it
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[n % kSlots]);
      uint32_t word = (static_cast<uint32_t>(d0) |
                       static_cast<uint32_t>(d1) << 1 |
                       static_cast<uint32_t>(d2) << 2 |
                       static_cast<uint32_t>(d3) << 3)
                      << (4 * (lane & 7));
      word |= __shfl_xor_sync(0xffffffffu, word, 1);
      word |= __shfl_xor_sync(0xffffffffu, word, 2);
      word |= __shfl_xor_sync(0xffffffffu, word, 4);
      if ((lane & 7) == 0) {
        // the 32 local pairs 32 (g / 8) .. + 31 are 32 consecutive global
        // pairs, since the pairs' window w_new - 1 is at least 5
        const uint32_t p = spread(32 * (g / 8), w_new - 1, kBits, rank);
        dec_row[static_cast<size_t>(t) * kWords + p / 32] = word;
      }
    }
    if (cluster_after(t)) {
      cluster_sync();
    } else {
      asm volatile("bar.sync 1, %0;" :: "n"(kThreads) : "memory");
    }
    const int read = from;
    from = to;
    to = exchange && buffers<C>() == 3 ? 3 - read - to : read;
  }
  cluster_sync();   // every CTA's decisions are written and visible

  const int w_end = window(steps);
  const float4* fin =
      reinterpret_cast<const float4*>(metric + from * kOwn);
  float* met = metrics + static_cast<size_t>(row) * kStates;
  for (int i = tid; i < kOwn / 4; i += kThreads) {
    *reinterpret_cast<float4*>(met + spread(4 * i, w_end, kBits, rank)) =
        fin[i];
  }

  if (rank != 0) return;

  // The traceback, in CTA 0.  The decision rows (2 KB per step) are copied
  // from L2 into the ring, which the loop has left free, kBatch rows at a
  // time in two halves: warps 1.. fetch the next batch while warp 0 walks
  // the current one.  Warp 0 resolves kTracebackRound steps per round:
  // lane i guesses the next decisions from the bits of i, reads the words
  // its guesses lead to, and the one lane whose guesses all match the
  // words carries the state on.
  constexpr int kBatch =
      kSlots * kTile / kWords / 2 / kTracebackRound * kTracebackRound;
  static_assert(kBatch >= kTracebackRound, "");
  uint32_t* rows = reinterpret_cast<uint32_t*>(ring);
  // rows t0, t0 - 1, .. t0 - n + 1 into half h, by the threads from first
  auto fetch = [&](int t0, int n, int h, int first) {
    const uint4* src = reinterpret_cast<const uint4*>(dec_row);
    uint4* dst = reinterpret_cast<uint4*>(rows) + h * kBatch * (kWords / 4);
    for (int i = tid - first; i < n * (kWords / 4); i += kThreads - first) {
      dst[i] = __ldcg(src + static_cast<size_t>(t0 - i / (kWords / 4)) *
                                (kWords / 4) + i % (kWords / 4));
    }
  };
  int32_t* bits_row = bits + static_cast<size_t>(row) * steps;
  uint32_t state = 0;
  fetch(steps - 1, steps < kBatch ? steps : kBatch, 0, 0);
  asm volatile("bar.sync 1, %0;" :: "n"(kThreads) : "memory");
  for (int b = 0, t0 = steps - 1; t0 >= 0; ++b, t0 -= kBatch) {
    const int n = t0 + 1 < kBatch ? t0 + 1 : kBatch;   // rows of batch b
    if (tid >= 32) {
      const int t1 = t0 - kBatch;
      if (t1 >= 0) {
        fetch(t1, t1 + 1 < kBatch ? t1 + 1 : kBatch, (b + 1) & 1, 32);
      }
    } else {
      const uint32_t* batch = rows + (b & 1) * kBatch * kWords;
      for (int t = t0; t > t0 - n; t -= kTracebackRound) {
        const int k = t - t0 + n < kTracebackRound ? t - t0 + n
                                                   : kTracebackRound;
        uint32_t st[kTracebackRound + 1];
        uint32_t w[kTracebackRound];
        st[0] = state;
#pragma unroll
        for (int j = 0; j < kTracebackRound; ++j) {
          // the state before step t - j, if the lane's guesses are right
          st[j + 1] = (st[j] >> 1) | (((lane >> j) & 1u) << (kOrder - 1));
          if (j < k) w[j] = batch[(t0 - t + j) * kWords + (st[j] >> 6)];
        }
        bool ok = lane < (1 << k);
#pragma unroll
        for (int j = 0; j < kTracebackRound; ++j) {
          if (j < k) {
            ok &= ((w[j] >> ((st[j] >> 1) & 31)) & 1u) == ((lane >> j) & 1u);
          }
        }
        const int hit = __ffs(__ballot_sync(0xffffffffu, ok)) - 1;
        uint32_t next = st[kTracebackRound];
#pragma unroll
        for (int j = 0; j < kTracebackRound; ++j) {
          if (j < k && lane == hit) bits_row[t - j] = st[j] & 1;
          if (j + 1 == k) next = st[j + 1];
        }
        state = __shfl_sync(0xffffffffu, next, hit);
      }
    }
    asm volatile("bar.sync 1, %0;" :: "n"(kThreads) : "memory");
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the CUDA runtime
// (no link against libcuda), or nullptr.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// The descriptors of BmMaps for bm (batch, steps, 32768) at cluster size C.
template <int C>
bool encode_maps(const float* bm, int batch, int steps, BmMaps* maps) {
  constexpr int kBits = Cfg<C>::kBits;
  constexpr int kTile = tile_floats<C>();
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  for (int w = kFirstWindow; w <= kOrder - kBits; ++w) {
    const int run = 1 << w;
    const int box_run = run < kTile ? run : kTile;
    const cuuint64_t dims[5] = {
        64, static_cast<cuuint64_t>(run / 64), C,
        static_cast<cuuint64_t>(1) << (kOrder - kBits - w),
        static_cast<cuuint64_t>(batch) * steps};
    const cuuint64_t strides[4] = {
        256, static_cast<cuuint64_t>(run) * 4,
        static_cast<cuuint64_t>(run) * C * 4,
        static_cast<cuuint64_t>(kStates) * 4};
    const cuuint32_t box[5] = {64, static_cast<cuuint32_t>(box_run / 64), 1,
                               static_cast<cuuint32_t>(kTile / box_run), 1};
    const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
    if (encode(&maps->window[w - kFirstWindow],
               CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(bm),
               dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return false;
    }
  }
  return true;
}

template <int C>
int launch_cluster(const float* bm, uint32_t* dec, float* metrics,
                   int32_t* bits, int batch, int steps, cudaStream_t stream,
                   int* active) {
  auto kernel = viterbi_acs_cluster<C>;
  constexpr int smem = smem_bytes<C>();
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(batch) * C);
  cfg.blockDim = dim3(Cfg<C>::kThreads + 32);   // + the producer warp
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the shared-memory attribute and the cluster occupancy, taken at the
  // first launch on each device
  static bool known[kMaxDevices];
  static int clusters[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= kMaxDevices) return -5;
  if (!known[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    clusters[device] = n;
    known[device] = true;
  }
  *active = clusters[device];
  if (clusters[device] == 0) return -1;
  BmMaps maps;
  if (!encode_maps<C>(bm, batch, steps, &maps)) return -4;
  err = cudaLaunchKernelEx(&cfg, kernel, maps, dec, metrics, bits, steps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bm (B, steps, 32768) f32 -> dec (B, steps, 512) int32 bit-packed
// decisions, metrics (B, 32768) f32, bits (B, steps) int32; all contiguous
// on the device, bm 16-byte aligned.  cluster: CTAs per row (2, 4 or 8).
// *active receives how many clusters of that size fit on the card at once.
// Launches on `stream`; returns 0, a cudaError_t, -1 if no cluster of that
// size fits on the card, -3 for an unsupported cluster size, -4 if bm's
// TMA descriptors cannot be encoded, or -5 if the current device's index
// is kMaxDevices or more.
extern "C" int viterbi_acs_launch(const float* bm, uint32_t* dec,
                                  float* metrics, int32_t* bits, int batch,
                                  int steps, int cluster, void* stream,
                                  int* active) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *active = 0;
  switch (cluster) {
    case 2:
      return launch_cluster<2>(bm, dec, metrics, bits, batch, steps, s,
                               active);
    case 4:
      return launch_cluster<4>(bm, dec, metrics, bits, batch, steps, s,
                               active);
    case 8:
      return launch_cluster<8>(bm, dec, metrics, bits, batch, steps, s,
                               active);
    default:
      return -3;
  }
}
