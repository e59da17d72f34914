// memsim stage B for Hopper (sm_90a): the DES's two sequential scans.
//
//   memsim_ts_scan     (K4) replaces _ts_chunk_core, the timestep engine's
//                      1-ns backlog scan (src/repro/core/memsim.py:639);
//   memsim_event_scan  (K5) replaces _event_chunk_core, the event engine's
//                      per-request Lindley scan (src/repro/core/memsim.py:887).
//
// Neither replaces a Pallas kernel: the reference runs both as lax.scan
// loops over one chunk of stage-A draws, (C, n) float32 arrays with the
// lane axis last.  PyTorch has no compiled scan, and a loop of torch ops
// would make ~14 launches a simulated step, so each chunk is one launch.
//
// What each computes, per lane and step k of the chunk (the reference's
// scan bodies, in their order of operations):
//   K4  in_burst <- in_burst > .5 ? (sw < p_leave ? 0 : 1) : (sw < p_enter)
//       lent     <- lent > .5 ? (hu < h_leave ? 0 : 1) : (hu < h_enter)
//       arrive   <- (au < (in_burst > .5 ? rate_hi : rate_lo))
//                   * (backlog <= bound)
//       latency  <- (backlog + lat0) + jitter
//       s_eff    <- lent > .5 ? svc * h_scale : svc
//       backlog  <- max((backlog + arrive * s_eff) - 1, 0)
//       record latency iff arrive and rec_lo <= k < rec_hi
//   K5  W <- max(W - gap, 0); record W + lat0 iff rec_time and W <= bound;
//       W <- W + (W <= bound ? svc : 0)
// A recorded latency is binned as the reference's _flat_bins: lat * 0.25
// converted toward zero with saturation (NaN to 0, as XLA converts),
// clipped to [0, N_BINS - 1].  The kernels add each count to a per-lane
// int32 histogram (n, N_BINS) that stays on the device across a run's
// chunks, where the reference emits (C, n) indices that the host bincounts.
//
// Bit-exactness.  The bodies are correctly-rounded float32 adds, multiplies
// and compares in the reference's order; the _rn intrinsics keep nvcc
// (-fmad=true by default) from contracting a multiply and an add into one
// FMA.  jnp.maximum(x, 0.0) keeps a NaN and gives +0 for x = -0, which is
// x <= 0 ? 0 : x; K4's x = y - 1 is never -0, so there it is written
// x < 0 ? 0 : x.  K4's arrive * s_eff multiplies by an exact 0/1: it is
// s_eff when the request arrives and is admitted, else 0 * s_eff (-0 for a
// negative service, NaN for an infinite or NaN one), and both are formed
// before the admission test selects one.  So a kernel and its plain
// version (kernels/ref.py) give equal histograms and carries, and both
// equal the reference's scan on the same stage-A arrays.
//
// Bound.  Bytes: each lane-step reads 16 B of draws for K4 (20 B with the
// harvest uniform) and 9 B for K5 (gap, svc, rec_time), and each run reads
// and writes the histogram once; the ~15 float32 operations a lane-step are
// far below the card's rate.  The recursion is serial in k, though: only
// the carry's own operations must wait for the step before, and however
// many lanes run beside it one lane cannot go faster than that chain, 4
// dependent operations a step at the shortest the reference's semantics
// allow (K4: the two adds of the service, the select, the max; K5: the
// - gap, the + svc, two selects), ~16 cycles.  At the study's widths (384-
// 512 lanes: 12-16 warps) a warp has an SM to itself, and what a step asks
// of it besides the chain decides the time: a warp issues one instruction
// a cycle, in order, and the SM's memory pipe serves its loads, copies and
// atomics.
//
// Design (tools/memsim_scan_levers.py times each choice against the
// others; PERF.md has the numbers).
//  * 32 lanes a block: thread j of each of its two warps serves lane
//    lane0 + j; 384 lanes spread over 12 SMs, 4,032 over 126.  The ragged
//    last block's spare threads do nothing (no padding lanes).
//  * Warp 1 copies the draws into a ring in shared memory, kDepth steps
//    deep in kStages stages of kStage steps, by cp.async (4 B a lane-step:
//    not TMA, since a row of n floats is not a multiple of 16 B for every
//    n); warp 0 runs the chain from the ring.  A stage is handed over by
//    two mbarriers a slot: "full" completes when the copies have landed
//    (cp.async.mbarrier.arrive), "empty" when warp 0 has read the stage.
//    So the chain warp's instruction stream and memory queue hold no
//    copies and no address arithmetic for them.  The ring keeps 4 steps of
//    a lane in one 16-byte word, so one conflict-free 16-byte read brings
//    4 steps of an array.  K5's one-byte rec_time: warp 1 copies the
//    aligned 4-byte word that holds the lane's byte and warp 0 shifts the
//    byte out; the few words at the array's ends that would reach past it
//    are not copied, and warp 0 reads those bytes itself.
//  * Every step adds 1 or 0 to the bin of its latency in the lane's row of
//    the device's histogram: a fire-and-forget atomic (RED), never a
//    branch (Counts).
//  * What does not depend on the carry is formed off the chain: K4's burst
//    and harvest chains, the rate, the arrival test, s_eff and 0 * s_eff,
//    the latency; K5's outcomes at a wait of +0.  K5's two outcomes at a
//    positive wait are formed before the selects (a 4-operation chain);
//    K4 keeps the reference's order (6 operations), which issues fewer
//    instructions.
// One launch a chunk, on the caller's stream; no synchronisation with the
// host and no allocation.  Plain C interface, loaded with ctypes; each
// launcher returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;                  // lanes a block: one chain warp
constexpr int kThreads = 2 * kLanes;        // and one warp that copies
constexpr int kGroup = 4;                   // steps a 16-byte ring read
constexpr int kStage = 32;                  // steps a hand-over
constexpr int kStages = 4;                  // stages in the ring
constexpr int kDepth = kStage * kStages;    // steps staged ahead
constexpr int kArrayBytes = kDepth * kLanes * 4;   // one array's ring
constexpr int kBins = 1024;                 // memsim.N_BINS
constexpr float kBinScale = 0.25f;          // 1 / memsim.BIN_NS
constexpr int kBarrierBytes = 2 * kStages * 8;    // full and empty, a slot
// A wait on the other warp that outlasts this many polls (each of which
// may suspend the thread for a while) means the pipeline is broken: trap
// rather than hang.
constexpr unsigned kSpinLimit = 1u << 24;

static_assert(kStage % kGroup == 0, "a stage holds whole ring words");

// Shared memory of a block whose ring holds `arrays` arrays: the ring, then
// the stage barriers.
constexpr int smem_bytes(int arrays) {
  return arrays * kArrayBytes + kBarrierBytes;
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- the ring -------------------------------------------------------------
// Thread j of each warp serves lane j: the copying warp fetches the lane's
// words of each step, the chain warp reads them.  Step k of an array sits
// at k mod kDepth; kGroup steps of a lane share one 16-byte word, and the
// 32 lanes' words of a group lie side by side, so a ring read of 4 steps is
// one conflict-free 16-byte load.

// Byte offset, in a thread's ring of one array, of the first step of stage
// t, and of step j of a stage from its first.
__device__ __forceinline__ uint32_t stage_offset(int t) {
  return (static_cast<unsigned>(t) % kStages) * (kStage / kGroup) * kLanes *
         kGroup * 4;
}

__host__ __device__ constexpr uint32_t step_offset(int j) {
  return (j / kGroup) * kLanes * kGroup * 4 + (j % kGroup) * 4;
}

__device__ __forceinline__ void copy4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 16 bytes of this thread's ring: 4 steps of one array.
__device__ __forceinline__ uint4 ring_read(uint32_t at) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(at)
               : "memory");
  return v;
}

// --- the hand-over --------------------------------------------------------
// Slot s of the ring has two barriers: full[s] completes a phase when the
// copies of the stage in it have landed (each copying thread's arrive is
// triggered by the completion of its copies), empty[s] when the chain warp
// has read it.  Both count the block's lanes.
struct Handover {
  uint32_t full;   // shared address of full[0]; empty[0] follows full[]

  __device__ __forceinline__ uint32_t full_at(int t) const {
    return full + 8u * (static_cast<unsigned>(t) % kStages);
  }
  __device__ __forceinline__ uint32_t empty_at(int t) const {
    return full_at(t) + 8u * kStages;
  }

  __device__ __forceinline__ void init(unsigned lanes) const {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       full_at(s)),
                   "r"(lanes)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       empty_at(s)),
                   "r"(lanes)
                   : "memory");
    }
  }

  // Waits until the barrier has completed the phase of the given parity.
  __device__ __forceinline__ static void wait(uint32_t bar, unsigned parity) {
    for (unsigned spin = 0;; ++spin) {
      uint32_t done;
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
      if (done) return;
      if (spin == kSpinLimit) __trap();
    }
  }

  // Copying thread: before stage t's copies go into its slot, after them.
  __device__ __forceinline__ void before_fill(int t) const {
    if (t >= kStages) wait(empty_at(t), (t / kStages - 1) & 1);
  }
  __device__ __forceinline__ void filled(int t) const {
    asm volatile(
        "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
            full_at(t))
        : "memory");
  }

  // Chain thread: before stage t is read, after.
  __device__ __forceinline__ void before_read(int t) const {
    wait(full_at(t), (t / kStages) & 1);
  }
  __device__ __forceinline__ void read(int t) const {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     empty_at(t))
                 : "memory");
  }
};

// --- the counts -----------------------------------------------------------
// A lane's recorded latencies go straight into its row of the device's
// histogram, one fire-and-forget atomic add a step: 1 where the step is
// recorded, 0 where it is not, so that no step branches (ptxas turns a
// predicated add into a branch, and a branch in the chain warp's stream
// costs more than the add; a table in shared memory, flushed at the end of
// a launch, measured slower: tools/memsim_scan_levers.py).  The counts are
// integers, so the order of the adds does not matter.
struct Counts {
  int* row;   // the lane's row of the device's histogram

  // The unsigned conversion saturates (negative and NaN to 0, huge to
  // 2^32 - 1), which equals the signed conversion clipped to
  // [0, kBins - 1].
  __device__ __forceinline__ void add(bool recorded, float latency) const {
    const unsigned b = min(__float2uint_rz(__fmul_rn(latency, kBinScale)),
                           static_cast<unsigned>(kBins - 1));
    asm volatile("red.global.add.s32 [%0], %1;\n" ::"l"(row + b),
                 "r"(static_cast<int>(recorded)));
  }
};

// --- the two warps ------------------------------------------------------
// Copier::fetch(t, m) issues the copies of the first m steps of stage t
// into its slot.  Scan::consume<kFull, kEdge>(t, m) runs the first m steps
// of stage t from the ring (kEdge: a stage Scan::edge says needs checks).
template <class Copier>
__device__ __forceinline__ void copy_all(Copier& c, const Handover& hand,
                                         int steps) {
  const int stages = (steps + kStage - 1) / kStage;
#pragma unroll 1
  for (int t = 0; t < stages; ++t) {
    hand.before_fill(t);
    const int m = steps - t * kStage;
    if (m >= kStage) {
      c.template fetch<true>(t, kStage);
    } else {
      c.template fetch<false>(t, m);
    }
    hand.filled(t);
  }
}

template <class Scan>
__device__ __forceinline__ void scan_all(Scan& s, const Handover& hand,
                                         int steps) {
  const int stages = (steps + kStage - 1) / kStage;
#pragma unroll 1
  for (int t = 0; t < stages; ++t) {
    hand.before_read(t);
    const int m = steps - t * kStage;
    if (s.edge(t, steps)) {
      s.template consume<false, true>(t, m < kStage ? m : kStage);
    } else {
      s.template consume<true, false>(t, kStage);
    }
    hand.read(t);
  }
}

// --- K4: the timestep engine's backlog scan -----------------------------

template <int kArrays>
struct TsCopier {
  const float* next[kArrays];   // the lane's word of the next step fetched
  uint32_t ring;                // this thread's first ring byte
  int n;

  template <bool kFull>
  __device__ __forceinline__ void fetch(int t, int m) {
    const uint32_t dst = ring + stage_offset(t);
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      if (kFull || j < m) {
#pragma unroll
        for (int a = 0; a < kArrays; ++a) {
          copy4(dst + step_offset(j) + a * kArrayBytes, next[a]);
          next[a] += n;
        }
      }
    }
  }
};

template <bool kHarvest>
struct TsScan {
  static constexpr int kArrays = kHarvest ? 5 : 4;   // sw, au, jit, svc, hu

  float p_leave, p_enter, rate_hi, rate_lo, bound, lat0;
  float h_leave, h_enter, h_scale;
  float backlog;
  bool burst, lent;
  uint32_t ring;                // this thread's first ring byte
  int rec_lo;
  unsigned rec_span;
  Counts counts;

  __device__ __forceinline__ bool edge(int t, int steps) const {
    return (t + 1) * kStage > steps;   // the short last stage
  }

  __device__ __forceinline__ void step(float sw, float au, float jit, float s,
                                       float hu, int k) {
    // Off the chain: the two 0/1 chains and what they select.
    burst = burst ? !(sw < p_leave) : (sw < p_enter);
    lent = lent ? !(hu < h_leave) : (hu < h_enter);
    const bool arrives = au < (burst ? rate_hi : rate_lo);
    const float s_eff = lent ? __fmul_rn(s, h_scale) : s;
    const float s_none = __fmul_rn(0.0f, s_eff);   // arrive * s_eff, arrive 0
    const float s_arr = arrives ? s_eff : s_none;  // ... when admitted
    const float latency = __fadd_rn(__fadd_rn(backlog, lat0), jit);
    // The chain: the admission test, the select of the service, two adds,
    // the max.  (Forming both outcomes before the select shortens it by
    // one operation but costs two more adds a step, and here the warp's
    // issue binds first: measured slower.)
    const bool admit = backlog <= bound;
    const float x =
        __fsub_rn(__fadd_rn(backlog, admit ? s_arr : s_none), 1.0f);
    counts.add(arrives && admit &&
                   static_cast<unsigned>(k - rec_lo) < rec_span,
               latency);
    backlog = x < 0.0f ? 0.0f : x;
  }

  template <bool kFull, bool kEdge>
  __device__ __forceinline__ void consume(int t, int m) {
#pragma unroll
    for (int g = 0; g < kStage / kGroup; ++g) {
      if (!kFull && g * kGroup >= m) break;
      const uint32_t at = ring + stage_offset(t) + step_offset(g * kGroup);
      float v[kArrays][kGroup];
#pragma unroll
      for (int a = 0; a < kArrays; ++a) {
        const uint4 w = ring_read(at + a * kArrayBytes);
        v[a][0] = __uint_as_float(w.x);
        v[a][1] = __uint_as_float(w.y);
        v[a][2] = __uint_as_float(w.z);
        v[a][3] = __uint_as_float(w.w);
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (!kFull && g * kGroup + u >= m) break;
        step(v[0][u], v[1][u], v[2][u], v[3][u],
             kHarvest ? v[kArrays - 1][u] : 0.0f,
             t * kStage + g * kGroup + u);
      }
    }
  }
};

template <bool kHarvest>
__global__ void __launch_bounds__(kThreads)
    ts_scan_kernel(const float* __restrict__ terms, float* __restrict__ carry,
                   const float* __restrict__ sw, const float* __restrict__ au,
                   const float* __restrict__ jit,
                   const float* __restrict__ svc,
                   const float* __restrict__ hu, int steps, int n,
                   int rec_lo, unsigned rec_span, int* __restrict__ hist) {
  using Scan = TsScan<kHarvest>;
  extern __shared__ float4 smem[];
  const uint32_t base = shared_address(smem);
  const Handover hand{base + Scan::kArrays * kArrayBytes};
  const int lane0 = blockIdx.x * kLanes;
  const int lanes = min(kLanes, n - lane0);
  const unsigned j = threadIdx.x % kLanes;   // the lane this thread serves
  const int lane = lane0 + static_cast<int>(j);
  const uint32_t ring = base + 16u * j;
  if (threadIdx.x == 0) hand.init(lanes);
  __syncthreads();
  if (threadIdx.x >= kLanes) {   // the copying warp
    if (lane < n) {
      TsCopier<Scan::kArrays> c;
      c.next[0] = sw + lane;
      c.next[1] = au + lane;
      c.next[2] = jit + lane;
      c.next[3] = svc + lane;
      if constexpr (kHarvest) c.next[4] = hu + lane;
      c.ring = ring;
      c.n = n;
      copy_all(c, hand, steps);
    }
    return;
  }
  if (lane < n) {
    Scan s;
    s.p_leave = terms[0 * n + lane];
    s.p_enter = terms[1 * n + lane];
    s.rate_hi = terms[2 * n + lane];
    s.rate_lo = terms[3 * n + lane];
    s.bound = terms[4 * n + lane];
    s.lat0 = terms[5 * n + lane];
    s.h_leave = terms[6 * n + lane];
    s.h_enter = terms[7 * n + lane];
    s.h_scale = terms[8 * n + lane];
    s.backlog = carry[lane];
    s.burst = carry[n + lane] > 0.5f;
    s.lent = carry[2 * n + lane] > 0.5f;
    s.ring = ring;
    s.rec_lo = rec_lo;
    s.rec_span = rec_span;
    s.counts.row = hist + static_cast<int64_t>(lane) * kBins;
    scan_all(s, hand, steps);
    carry[lane] = s.backlog;
    carry[n + lane] = s.burst ? 1.0f : 0.0f;
    carry[2 * n + lane] = s.lent ? 1.0f : 0.0f;
  }
}

// --- K5: the event engine's Lindley scan --------------------------------
// rec_time is one byte a step: the copying thread fetches the aligned
// 4-byte word that holds its lane's byte, and the chain thread shifts the
// byte out.  A word that would reach outside the array (its first and last
// bytes, in the first and last stage) is not fetched: there the chain
// thread reads the byte itself.

// Whether the aligned word holding byte p lies inside [lo, hi).
__device__ __forceinline__ bool word_inside(const uint8_t* p,
                                            const uint8_t* lo,
                                            const uint8_t* hi) {
  const uint8_t* word = reinterpret_cast<const uint8_t*>(
      reinterpret_cast<uintptr_t>(p) & ~uintptr_t{3});
  return word >= lo && word + 4 <= hi;
}

struct EventCopier {
  const float* gap_next;
  const float* svc_next;
  const uint8_t* rec_next;
  const uint8_t* rec_lo;        // rec_time's first byte
  const uint8_t* rec_hi;        // one past its last
  uint32_t ring;
  int n;

  template <bool kFull>
  __device__ __forceinline__ void fetch(int t, int m) {
#pragma unroll
    for (int j = 0; j < kStage; ++j) {
      if (kFull || j < m) {
        const uint32_t dst = ring + stage_offset(t) + step_offset(j);
        copy4(dst, gap_next);
        copy4(dst + kArrayBytes, svc_next);
        if (word_inside(rec_next, rec_lo, rec_hi)) {
          copy4(dst + 2 * kArrayBytes,
                reinterpret_cast<const void*>(
                    reinterpret_cast<uintptr_t>(rec_next) & ~uintptr_t{3}));
        }
        gap_next += n;
        svc_next += n;
        rec_next += n;
      }
    }
  }
};

struct EventScan {
  static constexpr int kArrays = 3;   // gaps, svc, rec_time words

  float bound, lat0, wc;
  bool admit0;                  // a wait of +0 is admitted: 0 <= bound
  float lat_at0;                // its latency, 0 + lat0
  const uint8_t* rec;           // this lane's byte of step 0
  const uint8_t* rec_lo;
  const uint8_t* rec_hi;
  unsigned shift[kGroup];       // where step 4m + u's flag sits in its word
  uint32_t ring;
  int n;
  Counts counts;

  // Only steps 0-2 and the last 3 can hold a byte whose word reaches
  // outside the array.
  __device__ __forceinline__ bool edge(int t, int steps) const {
    const int k0 = t * kStage;
    return k0 < 3 || k0 + kStage > steps - 3;
  }

  __device__ __forceinline__ void step(float gap, float s, bool flag) {
    // w = max(d, 0) is +0 when d <= 0 (jnp.maximum's +0 at d = -0), else
    // d (NaN included).  The outcomes at w = +0 are known before d is, and
    // both outcomes at w = d are formed before the selects: the chain is
    // the - gap, an add and two selects.
    const float d = __fsub_rn(wc, gap);
    const bool positive = !(d <= 0.0f);
    const bool admit_d = d <= bound;
    // + 0 turns a -0 wait into +0, as the reference's add of 0.0 does.
    const float w_d = admit_d ? __fadd_rn(d, s) : __fadd_rn(d, 0.0f);
    const float w_0 = admit0 ? __fadd_rn(0.0f, s) : 0.0f;
    const bool admit = positive ? admit_d : admit0;
    counts.add(admit && flag, positive ? __fadd_rn(d, lat0) : lat_at0);
    wc = positive ? w_d : w_0;
  }

  template <bool kFull, bool kEdge>
  __device__ __forceinline__ void consume(int t, int m) {
#pragma unroll
    for (int g = 0; g < kStage / kGroup; ++g) {
      if (!kFull && g * kGroup >= m) break;
      const uint32_t at = ring + stage_offset(t) + step_offset(g * kGroup);
      const uint4 gv = ring_read(at);
      const uint4 sv = ring_read(at + kArrayBytes);
      const uint4 fv = ring_read(at + 2 * kArrayBytes);
      const float gs[4] = {__uint_as_float(gv.x), __uint_as_float(gv.y),
                           __uint_as_float(gv.z), __uint_as_float(gv.w)};
      const float ss[4] = {__uint_as_float(sv.x), __uint_as_float(sv.y),
                           __uint_as_float(sv.z), __uint_as_float(sv.w)};
      const uint32_t fs[4] = {fv.x, fv.y, fv.z, fv.w};
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        if (!kFull && g * kGroup + u >= m) break;
        bool flag = ((fs[u] >> shift[u]) & 0xffu) != 0;
        if (kEdge) {
          const int k = t * kStage + g * kGroup + u;
          const uint8_t* p = rec + static_cast<int64_t>(k) * n;
          if (!word_inside(p, rec_lo, rec_hi)) flag = *p != 0;
        }
        step(gs[u], ss[u], flag);
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
    event_scan_kernel(const float* __restrict__ terms, float* __restrict__ w,
                      const float* __restrict__ gaps,
                      const float* __restrict__ svc,
                      const uint8_t* __restrict__ rec_time, int steps, int n,
                      int* __restrict__ hist) {
  extern __shared__ float4 smem[];
  const uint32_t base = shared_address(smem);
  const Handover hand{base + EventScan::kArrays * kArrayBytes};
  const int lane0 = blockIdx.x * kLanes;
  const int lanes = min(kLanes, n - lane0);
  const unsigned j = threadIdx.x % kLanes;   // the lane this thread serves
  const int lane = lane0 + static_cast<int>(j);
  const uint32_t ring = base + 16u * j;
  const uint8_t* const rec_hi = rec_time + static_cast<int64_t>(steps) * n;
  if (threadIdx.x == 0) hand.init(lanes);
  __syncthreads();
  if (threadIdx.x >= kLanes) {   // the copying warp
    if (lane < n) {
      EventCopier c;
      c.gap_next = gaps + lane;
      c.svc_next = svc + lane;
      c.rec_next = rec_time + lane;
      c.rec_lo = rec_time;
      c.rec_hi = rec_hi;
      c.ring = ring;
      c.n = n;
      copy_all(c, hand, steps);
    }
    return;
  }
  if (lane < n) {
    EventScan s;
    s.bound = terms[lane];
    s.lat0 = terms[n + lane];
    s.admit0 = 0.0f <= s.bound;
    s.lat_at0 = __fadd_rn(0.0f, s.lat0);
    s.wc = w[lane];
    s.rec = rec_time + lane;
    s.rec_lo = rec_time;
    s.rec_hi = rec_hi;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      // Steps k = 4m + u of this lane lie at rec_time + 4mn + un + lane.
      s.shift[u] = 8u * static_cast<unsigned>(
                            (reinterpret_cast<uintptr_t>(rec_time) +
                             static_cast<uintptr_t>(u) * n + lane) & 3);
    }
    s.ring = ring;
    s.n = n;
    s.counts.row = hist + static_cast<int64_t>(lane) * kBins;
    scan_all(s, hand, steps);
    w[lane] = s.wc;
  }
}

int blocks_for(int n) { return (n + kLanes - 1) / kLanes; }

// Above 48 KB of shared memory a kernel must be allowed it before its
// launch.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// terms: (9, n); carry: (3, n), updated; sw/au/jit/svc/hu: (steps, n), hu
// may be null (zeros); hist: (n, 1024) int32, accumulated.  n, steps >= 1.
int memsim_ts_scan_launch(const void* terms, void* carry, const void* sw,
                          const void* au, const void* jit, const void* svc,
                          const void* hu, int steps, int n, int rec_lo,
                          int rec_hi, void* hist, void* stream) {
  if (n < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  // The recorded steps, as the plain version clips them to the chunk.
  const int lo = rec_lo < 0 ? 0 : rec_lo;
  const int hi = rec_hi > steps ? steps : rec_hi;
  const unsigned span = hi > lo ? static_cast<unsigned>(hi - lo) : 0u;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  cudaError_t err;
  if (hu != nullptr) {
    const int bytes = smem_bytes(TsScan<true>::kArrays);
    err = allow_smem(ts_scan_kernel<true>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ts_scan_kernel<true><<<blocks_for(n), kThreads, bytes, st>>>(
        f(terms), static_cast<float*>(carry), f(sw), f(au), f(jit), f(svc),
        f(hu), steps, n, lo, span, static_cast<int*>(hist));
  } else {
    const int bytes = smem_bytes(TsScan<false>::kArrays);
    err = allow_smem(ts_scan_kernel<false>, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ts_scan_kernel<false><<<blocks_for(n), kThreads, bytes, st>>>(
        f(terms), static_cast<float*>(carry), f(sw), f(au), f(jit), f(svc),
        nullptr, steps, n, lo, span, static_cast<int*>(hist));
  }
  return static_cast<int>(cudaGetLastError());
}

// terms: (2, n); w: (n,), updated; gaps/svc: (steps, n) float32; rec_time:
// (steps, n) bool (one byte each); hist: (n, 1024) int32, accumulated.
int memsim_event_scan_launch(const void* terms, void* w, const void* gaps,
                             const void* svc, const void* rec_time, int steps,
                             int n, void* hist, void* stream) {
  if (n < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = smem_bytes(EventScan::kArrays);
  const cudaError_t err = allow_smem(event_scan_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  event_scan_kernel<<<blocks_for(n), kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(terms), static_cast<float*>(w),
      static_cast<const float*>(gaps), static_cast<const float*>(svc),
      static_cast<const uint8_t*>(rec_time), steps, n,
      static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// Steps the ring holds (kDepth): the tests place chunk lengths at its edges.
int memsim_scan_ring_steps() { return kDepth; }

const char* memsim_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
