// The backward of the RWKV6 WKV recurrence for Hopper (sm_90a): K3b.
//
// Replaces no Pallas kernel: it replaces JAX's reverse pass through the
// reference's lax.scan, repro/models/rwkv.py::_wkv_scan, which the
// training path differentiates.  PyTorch has no compiled scan, and a
// Python loop of autograd steps over 1,024 tokens a layer is unusable, so
// the backward is a hand kernel beside the forward one (rwkv_wkv.cu).
//
// Per (batch, head), with S indexed [key i][value j], steps t = 0..T-1,
// S^0 = s0 and
//
//     y_t = r_t (S^t + diag(u) k_t^T v_t),   S^{t+1} = diag(w_t) S^t + k_t^T v_t,
//
// given dy (B, T, H, D) fp32 and dS^T = ds_T (zero when ds_T is null), the
// kernel walks t = T-1 .. 0:
//
//     dr_t[i] = sum_j S^t[i][j] dy_t[j] + u_i k_t[i] (v_t . dy_t)
//     dk_t[i] = sum_j dS^{t+1}[i][j] v_t[j] + u_i r_t[i] (v_t . dy_t)
//     dv_t[j] = sum_i k_t[i] dS^{t+1}[i][j] + dy_t[j] sum_i r_t[i] u_i k_t[i]
//     dw_t[i] = sum_j dS^{t+1}[i][j] S^t[i][j]
//     du_i   += r_t[i] k_t[i] (v_t . dy_t)
//     dS^t    = diag(w_t) dS^{t+1} + r_t^T dy_t
//
// and writes ds0 = dS^0.  r, k, v and dr, dk, dv: (B, T, H, D) fp32 or
// bf16 (dr, dk, dv rounded once to that type); w, dy, dw: fp32; u: (H, D)
// fp32; s0, ds_T, ds0: (B, H, D, D) fp32; du_part: (B, H, D) fp32, one
// partial a (batch, head), which the wrapper sums over the batch (no float
// atomics, so the result does not depend on the order blocks run in).
// All arithmetic is fp32.  D is 16, 32 or 64; any T >= 1.
//
// Why the states are recomputed.  dw needs S^t and dS^{t+1} at the same
// step, and they come in opposite time orders.  S^t cannot be recovered
// from S^{t+1} by dividing by w_t (w may be ~1e-5 in the model's range),
// and the identity that trades <dS, S> for prefix sums of r.S.dy and
// k.dS.v needs the same division.  The chunked form on tensor cores
// rounds differently from the exact per-step recurrence that the plain
// version (ref.wkv_bwd_ref) and the tolerances hold it to, so the kernel
// keeps the recurrence, one block a (batch, head):
//   1. a forward pass from s0 (S <- S*w + k v, no output) that saves S at
//      the start of every segment of kSeg steps but the last: ckpt,
//      (B*H, ceil(T/kSeg) - 1, D, D) fp32, 533 MB at B 8, T 1,024, H 32,
//      D 64 and kSeg 8;
//   2. a backward pass over the segments, last first: each recomputes its
//      kSeg states from its checkpoint into shared memory and walks its
//      steps backwards reading S^t from there, with dS in registers.
// No per-step state goes to device memory.
//
// Bound.  Operations per step and state element: the recomputed update
// S*w + kv (3), the three row sums r.S.dy, dS.v, <dS, S> and the column
// sum k.dS (2 each), and the update of dS (3): 14 fp32 operations, plus
// O(D) for the bonus terms, so 14*B*T*H*D*D at a training shape, 0.224 ms
// at 67 TFLOP/s for B 8, T 1,024, H 32, D 64; the bytes (inputs and
// outputs once) bound it far below that.  The kernel issues 2 fp32
// instructions a state element and step in pass 1, 2 in the recompute
// and 6 in the walk back, and moves 8 bytes a state element and step
// through shared memory.  What holds it above that (PERF.md, cycles by
// phase from tools/wkv_bwd_levers.py): the walk's shuffle trees, bf16
// unpacking and addressing beside its fp32 work; pass 1 and the
// recompute; each segment's fixed phases (staging, bonus scalars,
// outputs); and one block of 8 warps an SM, which hides little latency.
//
// Why one block a (batch, head).  Both S and dS evolve column by column,
// and only dr, dk, dw sum over columns, so the columns could be split
// over a cluster of blocks that merge those sums through distributed
// shared memory.  On an H100 at the training shape a split of 2 or 4
// measured slower (PERF.md §6, K3b): a split adds no warps an SM (a warp's
// states take the same shared memory), every block would stage whole rows
// and compute the bonus scalars, and the merge and barriers cost more
// than the smaller blocks gain.
//
// Lane map.  A thread holds kK keys x kCt columns of S (in pass 1 and the
// recompute) and of dS (in the walk back): kCG = D / kCt column groups
// and kKG = D / kK key groups, tid = kg * kCG + cg, keys kK kg .. + kK - 1,
// columns kCt cg .. + kCt - 1.  The column groups of a key group sit in
// adjacent lanes of one warp, so the sums over columns (dr, dk, dw, 3 kK
// values a thread) meet in a reduce-scatter of xor shuffles over lane bits
// 1 .. kCG / 2 and go to shared memory; the sums over keys (dv, kCt
// values) meet over the other lane bits, then across warps in shared
// memory after the segment.  A thread's states are stored as float4s at
// [step][quad][tid], so a warp's 16-byte accesses are contiguous and
// conflict-free, and only the thread that wrote a state reads it back: no
// barrier guards them.
//
// Outputs a segment late.  A segment's walk leaves its column sums in one
// of two buffers (by the segment's parity); each thread keeps the bonus
// terms of its (step, key) items in registers while the stage holds r and
// k, and adds them to the sums and writes dr, dk, dw during the segment
// before, after its recompute.  No barrier stands between those writes
// and that segment's walk, so a warp that is done starts walking; on an
// H100 at the training shape this measured 7% faster in bf16 than writing
// them right after the walk (fp32 the same).
//
// Staging.  Pass 1 reads k, v and w only and is short a step, so it
// copies them (cp.async, 16 bytes a thread) up to kRing - 1 segments
// ahead into a ring over the states' space, which pass 1 does not use.
// Pass 2 copies a segment's r, k, v, w and dy into one of two stages
// while the segment before computes, and each thread copies the next
// segment's checkpoint into the state slot its walk has just left (the
// last).  Bulk copies (cp.async.bulk, a row each) and fp32 copies of the
// bf16 inputs made once a segment both measured slower.
//
// Shared memory a block: states kSeg * D * D * 4, two stages of
// kSeg * D * (3 itemsize + 8), two buffers of column sums
// 2 * 3 * kSeg * D * 4, dv's partials kWarps * kSeg * D * 4 and a few
// small arrays.  At D 64, kSeg 8 in bf16: 131,072 + 14,336 + 12,288 +
// 16,384 + 1,344 = 175,424 bytes and 256 threads, one block (8 warps) an
// SM; rwkv_wkv_bwd_geometry reports the launch, the registers and the
// blocks an SM.  Registers (ptxas, D 64): see PERF.md; no spills.
//
// Plain C interface, loaded with ctypes.  rwkv_wkv_bwd_launch returns a
// cudaError_t (0 on success), or -1 for a head dim this file does not
// instantiate; it launches on the given stream and allocates nothing (the
// wrapper allocates ckpt).  rwkv_wkv_bwd_geometry reports the launch it
// makes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

// Steps a segment (the checkpoint interval, and the states a block keeps
// in shared memory) and the preferred tile, keys x columns a thread;
// tools/wkv_bwd_levers.py builds copies with other values.
constexpr int kSeg = 8;
constexpr int kKeys = 4;
constexpr int kCols = 4;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

__host__ __device__ constexpr int pow2_at_most(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

// The tile (keys, columns a thread): the preferred one, halved (the larger
// side first) until a block of D x D states has at least a warp's threads.
struct Tile {
  int keys, cols;
};
__host__ __device__ constexpr Tile pick_tile(int D) {
  Tile t{kKeys, cmin(kCols, D)};
  while (D * D / (t.keys * t.cols) < 32 && t.keys * t.cols > 1) {
    if (t.keys >= t.cols)
      t.keys /= 2;
    else
      t.cols /= 2;
  }
  return t;
}

template <typename T, int D>
struct Geometry {
  static constexpr int kK = pick_tile(D).keys;            // keys a thread
  static constexpr int kCt = pick_tile(D).cols;           // columns a thread
  static constexpr int kCG = D / kCt;                     // column groups
  static constexpr int kKG = D / kK;                      // key groups
  static constexpr int kThreads = kCG * kKG;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kTile = kK * kCt;
  static constexpr int kQuads = kTile / 4;                // float4s
  // (step, key) items a thread writes dr, dk, dw of, a segment.
  static constexpr int kItems = (kSeg * D + kThreads - 1) / kThreads;
  static constexpr int kBP = pow2_at_most(cmin(32, cmin(D, kThreads / kSeg)));
  // Shared memory, in this order: the segment's states; two stages of
  // r, k, v ([kSeg][D] of T) then w, dy ([kSeg][D] fp32); two buffers of
  // column sums [3][kSeg][D]; dv's partials [kWarps][kSeg][D]; v.dy and
  // r.u.k [kSeg] each; u [D]; du [kThreads].
  static constexpr int kStates = kSeg * kTile * kThreads * 4;
  static constexpr int kArray = kSeg * D * static_cast<int>(sizeof(T));
  static constexpr int kArrayF = kSeg * D * 4;
  static constexpr int kStage = 3 * kArray + 2 * kArrayF;
  // Pass 1's ring of k, v, w segments over the states' space.
  static constexpr int kKvw = 2 * kArray + kArrayF;
  static constexpr int kRing = cmin(8, kStates / kKvw);
  static constexpr int kSums = 2 * 3 * kSeg * D * 4;
  static constexpr int kDv = kWarps * kSeg * D * 4;
  static constexpr int kSmall = (2 * kSeg + D + kThreads) * 4;
  static constexpr int kSmem = kStates + 2 * kStage + kSums + kDv + kSmall;
  static_assert(D % kCt == 0 && D % kK == 0, "whole tiles");
  static_assert(kThreads % 32 == 0 && 32 % kCG == 0,
                "whole warps; a key group's columns inside a warp");
  static_assert(kTile % 4 == 0, "a tile of whole float4s");
  static_assert(kThreads % D == 0, "a thread's items share one key");
  static_assert(kThreads % kBP == 0 && D % kBP == 0, "whole bonus lanes");
  static_assert(kArray % 16 == 0, "shared buffers keep 16-byte alignment");
  static_assert(kRing >= 2, "pass 1 stages a segment ahead");
};

// --- reductions across lanes ---------------------------------------------
// Over the lane bits kOff, 2 kOff, .. < kEnd: while the count of values is
// even, the lanes that differ in the bit swap halves (the lane with the bit
// set keeps the upper half) and add; an odd count is summed whole.  A lane
// is left with left_after(...) values: those at slice_of(...) .. of the
// original array, complete over the lanes; lanes that differ only in the
// bits of dup_mask(...) hold the same values.
__host__ __device__ constexpr int left_after(int n, int off, int end) {
  while (off < end) {
    if (n % 2 == 0) n /= 2;
    off *= 2;
  }
  return n;
}
__host__ __device__ constexpr int dup_mask(int n, int off, int end) {
  int mask = 0;
  while (off < end) {
    if (n % 2 == 0)
      n /= 2;
    else
      mask |= off;
    off *= 2;
  }
  return mask;
}
__device__ __forceinline__ int slice_of(int n, int off, int end, int lane) {
  int base = 0;
  while (off < end) {
    if (n % 2 == 0) {
      n /= 2;
      if (lane & off) base += n;
    }
    off *= 2;
  }
  return base;
}
template <int N, int kOff, int kEnd>
__device__ __forceinline__ void reduce_lanes(float* acc, int lane) {
  if constexpr (kOff < kEnd) {
    if constexpr (N % 2 == 0) {
      constexpr int kHalf = N / 2;
      const bool upper = lane & kOff;
#pragma unroll
      for (int m = 0; m < kHalf; ++m) {
        const float send = upper ? acc[m] : acc[m + kHalf];
        const float keep = upper ? acc[m + kHalf] : acc[m];
        acc[m] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, kOff));
      }
      reduce_lanes<kHalf, 2 * kOff, kEnd>(acc, lane);
    } else {
#pragma unroll
      for (int m = 0; m < N; ++m)
        acc[m] = __fadd_rn(acc[m], __shfl_xor_sync(kFull, acc[m], kOff));
      reduce_lanes<N, 2 * kOff, kEnd>(acc, lane);
    }
  }
}

// --- loads ----------------------------------------------------------------
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive elements at p (N-aligned) into fp32, in the widest loads.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = x.x, out[4 * q + 1] = x.y, out[4 * q + 2] = x.z,
              out[4 * q + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  } else {
#pragma unroll
    for (int m = 0; m < N; ++m) out[m] = p[m];
  }
}
template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  if constexpr (N % 4 == 0) {  // 8-byte loads; bf16 is fp32's upper half
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint2 x = reinterpret_cast<const uint2*>(p)[q];
      out[4 * q] = __uint_as_float(x.x << 16);
      out[4 * q + 1] = __uint_as_float(x.x & 0xffff0000u);
      out[4 * q + 2] = __uint_as_float(x.y << 16);
      out[4 * q + 3] = __uint_as_float(x.y & 0xffff0000u);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int m = 0; m < N / 2; ++m) {
      const __nv_bfloat162 x = reinterpret_cast<const __nv_bfloat162*>(p)[m];
      out[2 * m] = __low2float(x), out[2 * m + 1] = __high2float(x);
    }
  } else {
#pragma unroll
    for (int m = 0; m < N; ++m) out[m] = __bfloat162float(p[m]);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most the N newest committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy `steps` (<= kSeg) steps of one array, rows `seg + t * H * D` of D
// elements, into stage[t][0..D).  A thread's copies and their offsets in
// a segment follow from its index alone.
template <int D, int kThreads, typename E>
__device__ __forceinline__ void issue_array(unsigned char* stage,
                                            const E* seg, int H, int steps) {
  constexpr int kUnits = D * static_cast<int>(sizeof(E)) / 16;  // a row
  constexpr int kCopies = (kSeg * kUnits + kThreads - 1) / kThreads;
#pragma unroll
  for (int i = 0; i < kCopies; ++i) {
    const int n = threadIdx.x + i * kThreads;
    const int t = n / kUnits, c = n % kUnits;
    if (n < kSeg * kUnits && t < steps)
      cp_async16(stage + n * 16,
                 reinterpret_cast<const unsigned char*>(seg + t * H * D) +
                     c * 16);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Geometry<T, D>::kThreads)
    wkv_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   const float* __restrict__ dy,
                   const float* __restrict__ ds_T, T* __restrict__ dr,
                   T* __restrict__ dk, T* __restrict__ dv,
                   float* __restrict__ dw, float* __restrict__ du_part,
                   float* __restrict__ ds0, float4* __restrict__ ckpt,
                   int T_len, int H) {
  using G = Geometry<T, D>;
  constexpr int kK = G::kK, kCt = G::kCt, kCG = G::kCG;
  constexpr int kThreads = G::kThreads, kWarps = G::kWarps;
  constexpr int kTile = G::kTile, kQuads = G::kQuads, kItems = G::kItems;
  constexpr int kBP = G::kBP, kRing = G::kRing, kKvw = G::kKvw;
  // Column sums over the column groups (lane bits 1 .. kCG / 2): 3 kK
  // values, dr, dk, dw of the thread's keys.
  constexpr int kRows = 3 * kK;
  constexpr int kRowsLeft = left_after(kRows, 1, kCG);
  constexpr int kRowsDup = dup_mask(kRows, 1, kCG);
  // Key sums over the key groups of a warp (lane bits kCG .. 16): kCt
  // values, dv of the thread's columns.
  constexpr int kColsLeft = left_after(kCt, kCG, 32);
  constexpr int kColsDup = dup_mask(kCt, kCG, 32);

  extern __shared__ __align__(16) unsigned char smem[];
  float4* states = reinterpret_cast<float4*>(smem);
  unsigned char* stages = smem + G::kStates;
  float* sums = reinterpret_cast<float*>(stages + 2 * G::kStage);
  float* dv_parts = sums + 2 * 3 * kSeg * D;
  float* vdy = dv_parts + kWarps * kSeg * D;
  float* ruk = vdy + kSeg;
  float* u_s = ruk + kSeg;
  float* du_s = u_s + D;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int cg = tid % kCG, kg = tid / kCG;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int b = bh / H;
  const int n_seg = (T_len + kSeg - 1) / kSeg;
  const size_t row0 = static_cast<size_t>(b) * T_len * H + h;
  const size_t state0 = static_cast<size_t>(bh) * D * D;
  const int key0 = kK * kg;     // the thread's keys
  const int col0 = kCt * cg;    // and columns
  // Thread tid's quad q of the state at step t of the segment; of the
  // checkpoint of segment n.
  auto slot = [&](int t, int q) {
    return states + (t * kQuads + q) * kThreads + tid;
  };
  float4* my_ckpt =
      ckpt + static_cast<size_t>(bh) * (n_seg - 1) * kQuads * kThreads + tid;
  auto ckpt_at = [&](int n, int q) {
    return my_ckpt + (static_cast<size_t>(n) * kQuads + q) * kThreads;
  };

  auto stage_of = [&](int n) { return stages + (n & 1) * G::kStage; };
  auto seg_steps = [&](int n) { return cmin(kSeg, T_len - n * kSeg); };
  // Segment n's r, k, v, w and dy into its stage.
  auto issue = [&](int n) {
    const size_t at = (row0 + static_cast<size_t>(n) * kSeg * H) * D;
    const int steps = seg_steps(n);
    unsigned char* st = stage_of(n);
    issue_array<D, kThreads>(st, r + at, H, steps);
    issue_array<D, kThreads>(st + G::kArray, k + at, H, steps);
    issue_array<D, kThreads>(st + 2 * G::kArray, v + at, H, steps);
    issue_array<D, kThreads>(st + 3 * G::kArray, w + at, H, steps);
    issue_array<D, kThreads>(st + 3 * G::kArray + G::kArrayF, dy + at, H,
                             steps);
  };
  struct Stage {
    const T *r, *k, *v;
    const float *w, *dy;
  };
  auto view = [&](int n) {
    const unsigned char* st = stage_of(n);
    return Stage{reinterpret_cast<const T*>(st),
                 reinterpret_cast<const T*>(st + G::kArray),
                 reinterpret_cast<const T*>(st + 2 * G::kArray),
                 reinterpret_cast<const float*>(st + 3 * G::kArray),
                 reinterpret_cast<const float*>(st + 3 * G::kArray +
                                                G::kArrayF)};
  };

  // S <- S * w + k v for step t of a stage.
  auto advance = [&](float* s, const auto& in, int t) {
    float kq[kK], wq[kK], vq[kCt];
    load_row<kK>(in.k + t * D + key0, kq);
    load_row<kK>(in.w + t * D + key0, wq);
    load_row<kCt>(in.v + t * D + col0, vq);
#pragma unroll
    for (int m = 0; m < kK; ++m)
#pragma unroll
      for (int c = 0; c < kCt; ++c) {
        float& se = s[m * kCt + c];
        se = fmaf(se, wq[m], __fmul_rn(kq[m], vq[c]));
      }
  };
  auto store_tile = [&](float4* at, const float* s) {
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
      at[q * kThreads] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2],
                                     s[4 * q + 3]);
  };
  auto load_tile = [&](const float4* at, float* s) {
#pragma unroll
    for (int q = 0; q < kQuads; ++q) {
      const float4 x = at[q * kThreads];
      s[4 * q] = x.x, s[4 * q + 1] = x.y, s[4 * q + 2] = x.z,
            s[4 * q + 3] = x.w;
    }
  };

  for (int j = tid; j < D; j += kThreads) u_s[j] = u[h * D + j];

  // ---- pass 1: forward from s0, a checkpoint at every segment's start ----
  // Pass 1 reads k, v and w only and is short a step, so it stages them
  // kRing - 1 segments ahead in a ring over the (still unused) states.
  {
    auto ring_of = [&](int n) { return smem + (n % kRing) * kKvw; };
    auto issue_kvw = [&](int n) {
      const size_t at = (row0 + static_cast<size_t>(n) * kSeg * H) * D;
      unsigned char* st = ring_of(n);
      issue_array<D, kThreads>(st, k + at, H, kSeg);
      issue_array<D, kThreads>(st + G::kArray, v + at, H, kSeg);
      issue_array<D, kThreads>(st + 2 * G::kArray, w + at, H, kSeg);
    };
    float s[kTile];
#pragma unroll
    for (int m = 0; m < kK; ++m)
      load_row<kCt>(s0 + state0 + (key0 + m) * D + col0, s + m * kCt);
    issue(n_seg - 1);  // the last segment, where pass 2 begins
    cp_async_commit();
#pragma unroll
    for (int j = 0; j + 1 < kRing; ++j) {
      if (j + 1 < n_seg) issue_kvw(j);
      cp_async_commit();
    }
    for (int n = 0; n + 1 < n_seg; ++n) {
      cp_async_wait<kRing - 2>();
      __syncthreads();  // segment n is in; segment n - 1's slot read by all
      if (n + kRing < n_seg) issue_kvw(n + kRing - 1);
      cp_async_commit();
      store_tile(ckpt_at(n, 0), s);
      const unsigned char* st = ring_of(n);
      const Stage in{nullptr, reinterpret_cast<const T*>(st),
                     reinterpret_cast<const T*>(st + G::kArray),
                     reinterpret_cast<const float*>(st + 2 * G::kArray),
                     nullptr};
#pragma unroll
      for (int t = 0; t < kSeg; ++t) advance(s, in, t);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is read by all before the states reuse it
    // The last segment's start state: where pass 2 reads a checkpoint.
    store_tile(slot(kSeg - 1, 0), s);
  }

  // ---- pass 2: the segments backwards ------------------------------------
  float ds[kTile];
  if (ds_T == nullptr) {
#pragma unroll
    for (int e = 0; e < kTile; ++e) ds[e] = 0.f;
  } else {
#pragma unroll
    for (int m = 0; m < kK; ++m)
      load_row<kCt>(ds_T + state0 + (key0 + m) * D + col0, ds + m * kCt);
  }
  // The key of this thread's (step, key) items, its share of du, and the
  // bonus terms of dr and dk of its items in the segment whose outputs are
  // pending.
  const int my_key = tid % D;
  const float my_u = u_s[my_key];
  float du = 0.f, bonus_k[kItems], bonus_r[kItems];

  // dr, dk, dw of segment m: its column sums (buffer m & 1) plus the
  // bonus terms.
  auto outputs = [&](int m) {
    const float* buf = sums + (m & 1) * 3 * kSeg * D;
    const int steps = seg_steps(m);
    const size_t seg =
        (row0 + static_cast<size_t>(m) * kSeg * H) * D + my_key;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int t = (tid + i * kThreads) / D;
      if (t < steps) {
        const size_t at = seg + t * H * D;
        dr[at] = from_f32<T>(buf[t * D + my_key] + bonus_k[i]);
        dk[at] = from_f32<T>(buf[(kSeg + t) * D + my_key] + bonus_r[i]);
        dw[at] = buf[(2 * kSeg + t) * D + my_key];
      }
    }
  };

  // Where this lane leaves its share of a step's reduced sums (plus t D),
  // and whether it does.
  const bool rows_writer = (lane & kRowsDup) == 0;
  const bool cols_writer = (lane & kColsDup) == 0;
  int rows_at[kRowsLeft];
#pragma unroll
  for (int e = 0; e < kRowsLeft; ++e) {
    const int x = slice_of(kRows, 1, kCG, lane) + e;
    rows_at[e] = (x / kK) * kSeg * D + key0 + x % kK;
  }
  float* const cols_at =
      dv_parts + warp * kSeg * D + col0 + slice_of(kCt, kCG, 32, lane);
  // One step of the walk back: dS^{t+1} (registers) and S^t (its slot)
  // give the step's partial sums; dS becomes dS^t.
  auto walk_step = [&](const auto& in, float* buf, int t) {
    float rows[kRows];   // [dr | dk | dw] partials of the thread's keys
    float cols[kCt];     // dv partials of the thread's columns
    float rq[kK], kq[kK], wq[kK], vq[kCt], dyq[kCt], sq[kTile];
    load_tile(slot(t, 0), sq);
    load_row<kK>(in.r + t * D + key0, rq);
    load_row<kK>(in.k + t * D + key0, kq);
    load_row<kK>(in.w + t * D + key0, wq);
    load_row<kCt>(in.v + t * D + col0, vq);
    load_row<kCt>(in.dy + t * D + col0, dyq);
#pragma unroll
    for (int c = 0; c < kCt; ++c) cols[c] = 0.f;
#pragma unroll
    for (int m = 0; m < kK; ++m) {
      float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
      for (int c = 0; c < kCt; ++c) {
        const float se = sq[m * kCt + c];
        float& de = ds[m * kCt + c];
        pr = fmaf(se, dyq[c], pr);
        pk = fmaf(de, vq[c], pk);
        pw = fmaf(de, se, pw);
        cols[c] = fmaf(kq[m], de, cols[c]);
        de = fmaf(de, wq[m], __fmul_rn(rq[m], dyq[c]));
      }
      rows[m] = pr;
      rows[kK + m] = pk;
      rows[2 * kK + m] = pw;
    }
    reduce_lanes<kRows, 1, kCG>(rows, lane);
    if (rows_writer) {
#pragma unroll
      for (int e = 0; e < kRowsLeft; ++e) buf[rows_at[e] + t * D] = rows[e];
    }
    reduce_lanes<kCt, kCG, 32>(cols, lane);
    if (cols_writer) {
#pragma unroll
      for (int e = 0; e < kColsLeft; ++e) cols_at[e + t * D] = cols[e];
    }
  };

  for (int n = n_seg - 1; n >= 0; --n) {
    cp_async_wait<0>();
    __syncthreads();  // stage n and its checkpoint are in; stage n + 1 read
    if (n > 0) issue(n - 1);
    cp_async_commit();
    const Stage in = view(n);
    const int steps = seg_steps(n);
    // The steps' bonus scalars v.dy and r.u.k: kBP lanes a step, each
    // summing D / kBP products, then a shuffle tree.
    for (int t0 = 0; t0 < kSeg; t0 += kThreads / kBP) {
      const int t = t0 + tid / kBP;
      float a = 0.f, c = 0.f;
      if (t < steps) {
#pragma unroll
        for (int i = 0; i < D / kBP; ++i) {
          const int j = tid % kBP + i * kBP, e = t * D + j;
          a = fmaf(to_f32(in.v[e]), in.dy[e], a);
          c = fmaf(__fmul_rn(to_f32(in.r[e]), u_s[j]), to_f32(in.k[e]), c);
        }
      }
#pragma unroll
      for (int off = 1; off < kBP; off <<= 1) {
        a = __fadd_rn(a, __shfl_xor_sync(kFull, a, off));
        c = __fadd_rn(c, __shfl_xor_sync(kFull, c, off));
      }
      if (tid % kBP == 0 && t < steps) vdy[t] = a, ruk[t] = c;
    }

    // The segment's states S^t, t = n kSeg .. + steps - 1, into shared
    // memory, from the checkpoint in the last slot.
    {
      float s[kTile];
      load_tile(slot(kSeg - 1, 0), s);
      if (steps == kSeg) {
#pragma unroll
        for (int t = 0; t < kSeg; ++t) {
          store_tile(slot(t, 0), s);
          if (t + 1 < kSeg) advance(s, in, t);
        }
      } else {
        for (int t = 0; t < steps; ++t) {
          store_tile(slot(t, 0), s);
          if (t + 1 < steps) advance(s, in, t);
        }
      }
    }

    // The segment after's outputs, a segment late, with no barrier
    // before this segment's walk: a warp that is done starts walking.
    // The walk writes the other buffer.
    if (n + 1 < n_seg) outputs(n + 1);

    // The walk back.  After its first step, the walk has left the last
    // slot: the segment before's checkpoint goes there (after this
    // thread's reads of it).
    float* buf = sums + (n & 1) * 3 * kSeg * D;
    auto prefetch_ckpt = [&]() {
      if (n > 0) {
#pragma unroll
        for (int q = 0; q < kQuads; ++q)
          cp_async16(slot(kSeg - 1, q), ckpt_at(n - 1, q));
      }
      cp_async_commit();
    };
    if (steps == kSeg) {
#pragma unroll
      for (int t = kSeg - 1; t >= 0; --t) {
        walk_step(in, buf, t);
        if (t == kSeg - 1) prefetch_ckpt();
      }
    } else {
      for (int t = steps - 1; t >= 0; --t) {
        walk_step(in, buf, t);
        if (t == steps - 1) prefetch_ckpt();
      }
    }
    __syncthreads();  // the column sums, dv's partials, v.dy and r.u.k

    // dv: summed over the warps, plus the bonus.
    {
      const size_t seg = (row0 + static_cast<size_t>(n) * kSeg * H) * D;
#pragma unroll
      for (int i = 0; i < (kSeg * D + kThreads - 1) / kThreads; ++i) {
        const int e = tid + i * kThreads, t = e / D, c = e % D;
        if (e < steps * D) {
          float sum = 0.f;
#pragma unroll
          for (int x = 0; x < kWarps; ++x)
            sum += dv_parts[(x * kSeg + t) * D + c];
          dv[seg + t * H * D + c] =
              from_f32<T>(fmaf(in.dy[t * D + c], ruk[t], sum));
        }
      }
    }
    // The bonus terms of this segment's items, and du, while the stage
    // holds r and k.
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int t = (tid + i * kThreads) / D;
      if (t < steps) {
        const float rk = to_f32(in.r[t * D + my_key]);
        const float kk = to_f32(in.k[t * D + my_key]);
        const float bonus = __fmul_rn(my_u, vdy[t]);
        bonus_k[i] = __fmul_rn(bonus, kk);
        bonus_r[i] = __fmul_rn(bonus, rk);
        du = fmaf(__fmul_rn(rk, kk), vdy[t], du);
      }
    }
  }
  outputs(0);

  // ds0 = dS^0, each element by the thread that held it.
#pragma unroll
  for (int m = 0; m < kK; ++m)
#pragma unroll
    for (int c = 0; c < kCt; ++c)
      ds0[state0 + (key0 + m) * D + col0 + c] = ds[m * kCt + c];
  // du: the threads of a key add theirs in a fixed order; one writes.
  du_s[tid] = du;
  __syncthreads();
  if (tid < D) {
    float sum = 0.f;
    for (int x = tid; x < kThreads; x += D) sum += du_s[x];
    du_part[static_cast<size_t>(bh) * D + tid] = sum;
  }
}

template <typename T, int D>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (opted_in.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(wkv_bwd_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Geometry<T, D>::kSmem);
  if (err == cudaSuccess) opted_in.fetch_or(bit);
  return err;
}

template <typename T, int D>
struct Launch {
  static int run(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, const void* dy,
                 const void* ds_T, void* dr, void* dk, void* dv, void* dw,
                 void* du_part, void* ds0, void* ckpt, int B, int T_len,
                 int H, cudaStream_t stream) {
    using G = Geometry<T, D>;
    cudaError_t err = opt_in<T, D>();
    if (err != cudaSuccess) return err;
    wkv_bwd_kernel<T, D><<<B * H, G::kThreads, G::kSmem, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<const float*>(dy), static_cast<const float*>(ds_T),
        static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
        static_cast<float*>(dw), static_cast<float*>(du_part),
        static_cast<float*>(ds0), static_cast<float4*>(ckpt), T_len, H);
    return cudaGetLastError();
  }
};

// What rwkv_wkv_bwd_geometry writes, in this order.
template <typename T, int D>
struct Geom {
  static int run(int B, int T_len, int H, int* out) {
    using G = Geometry<T, D>;
    cudaError_t err = opt_in<T, D>();
    if (err != cudaSuccess) return err;
    int blocks_per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, wkv_bwd_kernel<T, D>, G::kThreads, G::kSmem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, wkv_bwd_kernel<T, D>);
    if (err != cudaSuccess) return err;
    const int values[] = {B * H,    G::kThreads,   kSeg,      G::kK,
                          G::kCt,   G::kSmem,      blocks_per_sm,
                          fa.numRegs};
    for (int i = 0; i < 8; ++i) out[i] = values[i];
    return cudaSuccess;
  }
};

template <typename T, template <typename, int> class F, typename... A>
int by_head_dim(int D, A... args) {
  switch (D) {
    case 16:
      return F<T, 16>::run(args...);
    case 32:
      return F<T, 32>::run(args...);
    case 64:
      return F<T, 64>::run(args...);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// is_bf16: 1 when r, k, v (and dr, dk, dv) are bfloat16, 0 when float32.
// ds_T may be null (zero).  ckpt: B*H*(ceil(T/seg) - 1)*D*D fp32, seg =
// out[2] of rwkv_wkv_bwd_geometry.
int rwkv_wkv_bwd_launch(int is_bf16, int D, const void* r, const void* k,
                        const void* v, const void* w, const void* u,
                        const void* s0, const void* dy, const void* ds_T,
                        void* dr, void* dk, void* dv, void* dw, void* du_part,
                        void* ds0, void* ckpt, int B, int T_len, int H,
                        void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? by_head_dim<__nv_bfloat16, Launch>(D, r, k, v, w, u, s0, dy,
                                                  ds_T, dr, dk, dv, dw,
                                                  du_part, ds0, ckpt, B,
                                                  T_len, H, st)
             : by_head_dim<float, Launch>(D, r, k, v, w, u, s0, dy, ds_T, dr,
                                          dk, dv, dw, du_part, ds0, ckpt, B,
                                          T_len, H, st);
}

// out[0..7] = blocks (one a (batch, head)), threads a block, steps a
// segment, keys a thread, value columns a thread, dynamic shared bytes a
// block, blocks an SM of the current device holds at once, registers a
// thread.  A cudaError_t, or -1 for a head dim this file does not
// instantiate.
int rwkv_wkv_bwd_geometry(int is_bf16, int D, int B, int T_len, int H,
                          int* out) {
  return is_bf16 ? by_head_dim<__nv_bfloat16, Geom>(D, B, T_len, H, out)
                 : by_head_dim<float, Geom>(D, B, T_len, H, out);
}

const char* rwkv_wkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
