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
// truncated toward zero, clipped to [0, N_BINS - 1].  The kernels add each
// count to a per-lane int32 histogram (n, N_BINS) that stays on the device
// across a run's chunks, where the reference emits (C, n) indices that the
// host bincounts.
//
// Bit-exactness.  The bodies are correctly-rounded float32 adds, multiplies
// and compares, in the reference's order; the _rn intrinsics keep nvcc
// (-fmad=true by default) from contracting a multiply and an add into one
// FMA.  The one a * b + c of K4 multiplies by an exact 0/1 in the
// reference, and stays a rounded multiply here.  max(x, 0) is written
// x < 0 ? 0 : x, which keeps a NaN as jnp.maximum does.  So a kernel and
// its plain version (kernels/ref.py) give equal histograms and carries,
// and both equal the reference's scan on the same stage-A arrays.  The
// launch needs no padding lanes: lane i is thread i.
//
// Bound.  Bytes: each lane-step reads 16 B of draws for K4 (20 B with the
// harvest uniform) and 9 B for K5 (gap, svc, rec_time), and each run
// reads and writes the histogram once; the ~15 float32 operations a
// lane-step are far below the card's rate per byte.  But the recursion is
// serial in k: a lane's step depends on the one before through ~6 dependent
// float32 operations, so one lane cannot go faster than about 6 x 4 cycles
// a step however many lanes run beside it.  Which of the two binds depends
// on the lane count: the default LUT grid's 4,032 lanes fill 126 warps,
// fewer than the card's 132 SMs.
//
// Design, simple first: one thread per lane, carry in registers.  At each
// step the 32 threads of a warp read 32 neighbouring floats of each array
// (one 128-byte line); the steps are unrolled by kUnroll with their loads
// issued first, so a thread has kUnroll x 4 loads in flight while it works
// through the serial chain.  The thread owns its lane's histogram row and
// increments it in place: no atomics.  One launch a chunk, on the caller's
// stream; no synchronisation and no allocation.
//
// Plain C interface, loaded with ctypes; each launcher returns a
// cudaError_t (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;
constexpr int kBins = 1024;           // memsim.N_BINS
constexpr float kBinScale = 0.25f;    // 1 / memsim.BIN_NS

__device__ __forceinline__ void bin_into(int* __restrict__ row,
                                         float latency) {
  int b = __float2int_rz(__fmul_rn(latency, kBinScale));
  b = b < 0 ? 0 : (b > kBins - 1 ? kBins - 1 : b);
  row[b] += 1;
}

struct TsLane {
  float p_leave, p_enter, rate_hi, rate_lo, bound, lat0;
  float h_leave, h_enter, h_scale;
  float backlog, in_burst, lent;

  __device__ __forceinline__ void step(float sw, float au, float jit,
                                       float s, float hu, bool recorded,
                                       int* __restrict__ row) {
    in_burst = in_burst > 0.5f ? (sw < p_leave ? 0.0f : 1.0f)
                               : (sw < p_enter ? 1.0f : 0.0f);
    lent = lent > 0.5f ? (hu < h_leave ? 0.0f : 1.0f)
                       : (hu < h_enter ? 1.0f : 0.0f);
    const float rate = in_burst > 0.5f ? rate_hi : rate_lo;
    float arrive = au < rate ? 1.0f : 0.0f;
    arrive = __fmul_rn(arrive, backlog <= bound ? 1.0f : 0.0f);
    const float latency = __fadd_rn(__fadd_rn(backlog, lat0), jit);
    const float s_eff = lent > 0.5f ? __fmul_rn(s, h_scale) : s;
    const float next =
        __fsub_rn(__fadd_rn(backlog, __fmul_rn(arrive, s_eff)), 1.0f);
    backlog = next < 0.0f ? 0.0f : next;
    if (recorded && arrive > 0.0f) bin_into(row, latency);
  }
};

__global__ void __launch_bounds__(kThreads)
    ts_scan_kernel(const float* __restrict__ terms, float* __restrict__ carry,
                   const float* __restrict__ sw, const float* __restrict__ au,
                   const float* __restrict__ jit,
                   const float* __restrict__ svc,
                   const float* __restrict__ hu, int steps, int n,
                   int rec_lo, int rec_hi, int* __restrict__ hist) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  TsLane l;
  l.p_leave = terms[0 * n + lane];
  l.p_enter = terms[1 * n + lane];
  l.rate_hi = terms[2 * n + lane];
  l.rate_lo = terms[3 * n + lane];
  l.bound = terms[4 * n + lane];
  l.lat0 = terms[5 * n + lane];
  l.h_leave = terms[6 * n + lane];
  l.h_enter = terms[7 * n + lane];
  l.h_scale = terms[8 * n + lane];
  l.backlog = carry[lane];
  l.in_burst = carry[n + lane];
  l.lent = carry[2 * n + lane];
  int* row = hist + static_cast<int64_t>(lane) * kBins;

  int k = 0;
  for (; k + kUnroll <= steps; k += kUnroll) {
    float r_sw[kUnroll], r_au[kUnroll], r_jit[kUnroll], r_s[kUnroll],
        r_hu[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = static_cast<int64_t>(k + u) * n + lane;
      r_sw[u] = sw[i];
      r_au[u] = au[i];
      r_jit[u] = jit[i];
      r_s[u] = svc[i];
      r_hu[u] = hu != nullptr ? hu[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ku = k + u;
      l.step(r_sw[u], r_au[u], r_jit[u], r_s[u], r_hu[u],
             ku >= rec_lo && ku < rec_hi, row);
    }
  }
  for (; k < steps; ++k) {
    const int64_t i = static_cast<int64_t>(k) * n + lane;
    l.step(sw[i], au[i], jit[i], svc[i], hu != nullptr ? hu[i] : 0.0f,
           k >= rec_lo && k < rec_hi, row);
  }
  carry[lane] = l.backlog;
  carry[n + lane] = l.in_burst;
  carry[2 * n + lane] = l.lent;
}

__device__ __forceinline__ float event_step(float wc, float gap, float s,
                                            bool rec, float bound,
                                            float lat0,
                                            int* __restrict__ row) {
  const float d = __fsub_rn(wc, gap);
  wc = d < 0.0f ? 0.0f : d;
  const bool admit = wc <= bound;
  if (rec && admit) bin_into(row, __fadd_rn(wc, lat0));
  return admit ? __fadd_rn(wc, s) : __fadd_rn(wc, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
    event_scan_kernel(const float* __restrict__ terms, float* __restrict__ w,
                      const float* __restrict__ gaps,
                      const float* __restrict__ svc,
                      const uint8_t* __restrict__ rec_time, int steps, int n,
                      int* __restrict__ hist) {
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  if (lane >= n) return;
  const float bound = terms[lane];
  const float lat0 = terms[n + lane];
  float wc = w[lane];
  int* row = hist + static_cast<int64_t>(lane) * kBins;

  int k = 0;
  for (; k + kUnroll <= steps; k += kUnroll) {
    float r_g[kUnroll], r_s[kUnroll];
    uint8_t r_r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = static_cast<int64_t>(k + u) * n + lane;
      r_g[u] = gaps[i];
      r_s[u] = svc[i];
      r_r[u] = rec_time[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      wc = event_step(wc, r_g[u], r_s[u], r_r[u] != 0, bound, lat0, row);
    }
  }
  for (; k < steps; ++k) {
    const int64_t i = static_cast<int64_t>(k) * n + lane;
    wc = event_step(wc, gaps[i], svc[i], rec_time[i] != 0, bound, lat0,
                    row);
  }
  w[lane] = wc;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// terms: (9, n); carry: (3, n), updated; sw/au/jit/svc/hu: (steps, n), hu
// may be null (zeros); hist: (n, 1024) int32, accumulated.  n, steps >= 1.
int memsim_ts_scan_launch(const void* terms, void* carry, const void* sw,
                          const void* au, const void* jit, const void* svc,
                          const void* hu, int steps, int n, int rec_lo,
                          int rec_hi, void* hist, void* stream) {
  if (n < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  ts_scan_kernel<<<blocks_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(terms), static_cast<float*>(carry),
      static_cast<const float*>(sw), static_cast<const float*>(au),
      static_cast<const float*>(jit), static_cast<const float*>(svc),
      static_cast<const float*>(hu), steps, n, rec_lo, rec_hi,
      static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

// terms: (2, n); w: (n,), updated; gaps/svc: (steps, n) float32; rec_time:
// (steps, n) bool (one byte each); hist: (n, 1024) int32, accumulated.
int memsim_event_scan_launch(const void* terms, void* w, const void* gaps,
                             const void* svc, const void* rec_time, int steps,
                             int n, void* hist, void* stream) {
  if (n < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  event_scan_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(terms), static_cast<float*>(w),
      static_cast<const float*>(gaps), static_cast<const float*>(svc),
      static_cast<const uint8_t*>(rec_time), steps, n,
      static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

const char* memsim_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
