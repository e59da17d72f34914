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
// The difficulty is dw: it needs S^t and dS^{t+1} at the same step, and
// they come in opposite time orders.  S^t cannot be recovered from S^{t+1}
// by dividing by w_t (w may be ~1e-5 in the model's range), and the
// identity that trades <dS, S> for prefix sums of r.S.dy and k.dS.v needs
// the same division.  So the kernel recomputes the states:
//   1. a forward pass from s0 (S <- S*w + k v, no output) that saves S at
//      the start of every segment of kSeg steps: ckpt, (B*H, T/kSeg, D, D)
//      fp32, 268 MB at B 8, T 1,024, H 32, D 64;
//   2. a backward pass over the segments, last first: each recomputes its
//      kSeg states from its checkpoint into scratch (B*H, kSeg, D, D) fp32,
//      67 MB at that shape, then walks its steps backwards reading S^t
//      from there, with dS in registers.
// Each thread writes and reads back only its own tile of ckpt and scratch
// (laid out so that a warp's 16-byte accesses are contiguous), so no
// barrier guards them.  Peak device scratch: ckpt + scratch, 335 MB at
// that shape (beside it, the outputs).
//
// Bound.  Operations per step and state element: the recomputed update
// S*w + kv (3), the three row sums r.S.dy, dS.v, <dS, S> and the column
// sum k.dS (2 each), and the update of dS (3): 14 fp32 operations, plus
// O(D) for the bonus terms, so 14*B*T*H*D*D at a training shape, 0.224 ms
// at 67 TFLOP/s for B 8, T 1,024, H 32, D 64; the bytes (inputs read once,
// outputs written once) bound it far below that.  This design does 3 of
// its instructions a state element in pass 1 (the update and the
// checkpoint), 3 in the recompute and 5 in the walk back, and moves each
// state through scratch twice (8.6 GB at that shape, through L2): it is
// the simple kernel, not the fast one.
//
// Lane map: K3's tile.  One block per (batch, head); a thread holds kK
// keys x kC columns of S (in pass 1 and the recompute) and of dS (in the
// walk back): kP = 4 key groups, tid = g * kP + p, group p's keys are the
// quads 4 (p + kP m) .. + 3, group g's columns kC g .. kC g + kC - 1.
// Sums over columns (dr, dk, dw) meet across the column groups: a
// reduce-scatter of xor shuffles over the lanes of a warp (lane bits 2..4),
// then, at D 64 (two warps), the two warps' partials add in shared memory
// after the segment.  The sum over keys (dv) meets across the key groups
// (lane bits 0..1) as K3's y does.  The bonus terms (v.dy, r.u.k) are
// per step and head, taken after the segment from the staged inputs.
//
// Inputs come a segment at a time into shared memory by cp.async
// 16-byte copies, the next segment's copies in flight while one computes
// (two stages).
//
// Plain C interface, loaded with ctypes.  rwkv_wkv_bwd_launch returns a
// cudaError_t (0 on success), or -1 for a head dim this file does not
// instantiate; it launches on the given stream and allocates nothing (the
// wrapper allocates ckpt and scratch).  rwkv_wkv_bwd_geometry reports the
// launch it makes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

constexpr int kKeyGroups = 4;
constexpr int kColumns = 4;
// Steps a segment: the checkpoint interval and the staging chunk.
constexpr int kSeg = 16;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

__host__ __device__ constexpr int pick_columns(int want, int D, int P) {
  int c = want;
  while (c > 2 && (c > P || D / c * P < 32)) c /= 2;
  return c;
}

template <typename T, int D>
struct Geometry {
  static constexpr int kP = cmin(kKeyGroups, D / 4);         // key groups
  static constexpr int kK = D / kP;                          // keys a thread
  static constexpr int kC = pick_columns(kColumns, D, kP);   // columns
  static constexpr int kG = D / kC;                          // column groups
  static constexpr int kThreads = kG * kP;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kTile = kK * kC;                      // a thread's
  static constexpr int kQuads = kTile / 4;                   // float4s
  // A stage: r, k, v ([kSeg][D] of T), then w and dy ([kSeg][D] fp32).
  static constexpr int kArray = kSeg * D * static_cast<int>(sizeof(T));
  static constexpr int kArrayF = kSeg * D * 4;
  static constexpr int kStage = 3 * kArray + 2 * kArrayF;
  // A segment's partial sums: dr, dk, dw by warp, [3][kWarps][kSeg][D];
  // dv [kSeg][D]; v.dy and r.u.k [kSeg] each.
  static constexpr int kParts = ((3 * kWarps + 1) * kSeg * D + 2 * kSeg) * 4;
  static constexpr int kSmem = 2 * kStage + kParts;
  static_assert(kArray % 16 == 0, "shared buffers keep 16-byte alignment");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(kThreads % D == 0, "the post-segment map gives a thread one key");
  static_assert(kK % 4 == 0 && kC <= kP && kTile % 4 == 0, "tile");
  static_assert(32 % kP == 0, "key groups inside a warp");
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most the newest committed group is in flight.
__device__ __forceinline__ void cp_async_wait_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy `steps` (<= kSeg) steps of one array, rows `row0 + t * H` of D
// elements, into stage[t][0..D).
template <int D, int kThreads, typename E>
__device__ __forceinline__ void issue_array(unsigned char* stage,
                                            const E* src, size_t row0, int H,
                                            int steps) {
  constexpr int kUnits = D * static_cast<int>(sizeof(E)) / 16;  // a row
  for (int n = threadIdx.x; n < kSeg * kUnits; n += kThreads) {
    const int t = n / kUnits, c = n % kUnits;
    if (t < steps)
      cp_async16(stage + n * 16,
                 reinterpret_cast<const unsigned char*>(
                     src + (row0 + static_cast<size_t>(t) * H) * D) +
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
                   float* __restrict__ ds0, float4* ckpt, float4* scratch,
                   int T_len, int H) {
  using G = Geometry<T, D>;
  constexpr int kP = G::kP, kK = G::kK, kC = G::kC, kThreads = G::kThreads;
  constexpr int kWarps = G::kWarps, kQuads = G::kQuads;
  // Column sums: 3 kK values (dr, dk, dw of the thread's keys) over the
  // column groups of a warp, lane bits kP .. 16.
  constexpr int kRows = 3 * kK;
  constexpr int kRowsLeft = left_after(kRows, kP, 32);
  constexpr int kRowsDup = dup_mask(kRows, kP, 32);
  // Key sums: kC values (dv of the thread's columns) over the key groups,
  // lane bits 1 .. kP / 2.
  static_assert(left_after(kC, 1, kP) == 1, "one column a lane");
  constexpr int kColsDup = dup_mask(kC, 1, kP);

  extern __shared__ __align__(16) unsigned char smem[];
  float* parts = reinterpret_cast<float*>(smem + 2 * G::kStage);
  float* parts_dv = parts + 3 * kWarps * kSeg * D;
  float* vdy = parts_dv + kSeg * D;
  float* ruk = vdy + kSeg;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = tid % kP, g = tid / kP;
  const int bh = blockIdx.x;
  const int h = bh % H;
  const int b = bh / H;
  const int n_seg = (T_len + kSeg - 1) / kSeg;
  const size_t row0 = static_cast<size_t>(b) * T_len * H + h;
  const size_t state0 = static_cast<size_t>(bh) * D * D;
  auto key_of = [&](int m) { return 4 * (p + kP * (m / 4)) + m % 4; };
  // Element (key m, column c) of a tile is e = m * kC + c; float4 q holds
  // elements 4q .. 4q + 3, stored at [.. q][tid] so that a warp's 16-byte
  // accesses are contiguous.
  float4* my_ckpt = ckpt + static_cast<size_t>(bh) * n_seg * kQuads * kThreads + tid;
  float4* my_scratch = scratch + static_cast<size_t>(bh) * kSeg * kQuads * kThreads + tid;

  auto stage_of = [&](int n) { return smem + (n & 1) * G::kStage; };
  auto seg_steps = [&](int n) { return cmin(kSeg, T_len - n * kSeg); };
  // Segment n's inputs into its stage; `all` adds r and dy (the backward
  // pass) to k, v and w (both passes).  Always commits one group.
  auto issue = [&](int n, bool all) {
    if (n >= 0 && n < n_seg) {
      const size_t rows = row0 + static_cast<size_t>(n) * kSeg * H;
      const int steps = seg_steps(n);
      unsigned char* st = stage_of(n);
      if (all) issue_array<D, kThreads>(st, r, rows, H, steps);
      issue_array<D, kThreads>(st + G::kArray, k, rows, H, steps);
      issue_array<D, kThreads>(st + 2 * G::kArray, v, rows, H, steps);
      issue_array<D, kThreads>(st + 3 * G::kArray, w, rows, H, steps);
      if (all)
        issue_array<D, kThreads>(st + 3 * G::kArray + G::kArrayF, dy, rows, H,
                                 steps);
    }
    cp_async_commit();
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
  auto advance = [&](float* s, const Stage& in, int t) {
    float kq[kK], wq[kK], vq[kC];
#pragma unroll
    for (int m = 0; m < kK; ++m) {
      kq[m] = to_f32(in.k[t * D + key_of(m)]);
      wq[m] = in.w[t * D + key_of(m)];
    }
#pragma unroll
    for (int c = 0; c < kC; ++c) vq[c] = to_f32(in.v[t * D + kC * g + c]);
#pragma unroll
    for (int m = 0; m < kK; ++m)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float& se = s[m * kC + c];
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

  // ---- pass 1: forward from s0, a checkpoint at every segment's start ----
  {
    float s[G::kTile];
#pragma unroll
    for (int m = 0; m < kK; ++m)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        s[m * kC + c] = s0[state0 + key_of(m) * D + kC * g + c];
    issue(0, false);
    for (int n = 0; n < n_seg; ++n) {
      issue(n + 1, false);
      cp_async_wait_but_newest();
      __syncthreads();
      store_tile(my_ckpt + static_cast<size_t>(n) * kQuads * kThreads, s);
      if (n + 1 < n_seg) {  // the last segment's end state is not needed
        const Stage in = view(n);
        for (int t = 0; t < kSeg; ++t) advance(s, in, t);
      }
      __syncthreads();  // stage n is read before segment n + 2 refills it
    }
  }

  // ---- pass 2: the segments backwards ------------------------------------
  float ds[G::kTile];
#pragma unroll
  for (int m = 0; m < kK; ++m)
#pragma unroll
    for (int c = 0; c < kC; ++c)
      ds[m * kC + c] =
          ds_T == nullptr ? 0.f : ds_T[state0 + key_of(m) * D + kC * g + c];
  // This thread's key in the post-segment sums, and its share of du.
  const int my_key = tid % D;
  const float my_u = u[h * D + my_key];
  float du = 0.f;

  issue(n_seg - 1, true);
  for (int n = n_seg - 1; n >= 0; --n) {
    issue(n - 1, true);
    cp_async_wait_but_newest();
    __syncthreads();
    const Stage in = view(n);
    const int steps = seg_steps(n);

    // The step's bonus scalars v.dy and r.u.k, a thread a step.
    if (tid < steps) {
      float a = 0.f, c = 0.f;
      for (int j = 0; j < D; ++j) {
        a = fmaf(to_f32(in.v[tid * D + j]), in.dy[tid * D + j], a);
        c = fmaf(__fmul_rn(to_f32(in.r[tid * D + j]), u[h * D + j]),
                 to_f32(in.k[tid * D + j]), c);
      }
      vdy[tid] = a;
      ruk[tid] = c;
    }

    // The segment's states S^t, t = n kSeg .. + steps - 1, into scratch.
    {
      float s[G::kTile];
      load_tile(my_ckpt + static_cast<size_t>(n) * kQuads * kThreads, s);
      for (int t = 0; t < steps; ++t) {
        store_tile(my_scratch + static_cast<size_t>(t) * kQuads * kThreads, s);
        if (t + 1 < steps) advance(s, in, t);
      }
    }

    // The walk back.
    for (int t = steps - 1; t >= 0; --t) {
      float rows[kRows];   // [dr | dk | dw] partials of the thread's keys
      float cols[kC];      // dv partials of the thread's columns
      float vq[kC], dyq[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        vq[c] = to_f32(in.v[t * D + kC * g + c]);
        dyq[c] = in.dy[t * D + kC * g + c];
        cols[c] = 0.f;
      }
      const float4* st = my_scratch + static_cast<size_t>(t) * kQuads * kThreads;
#pragma unroll
      for (int m0 = 0; m0 < kK; m0 += 4) {
        // Keys m0 .. m0 + 3: their S^t from scratch, 4 kC elements.
        float sq[4 * kC];
#pragma unroll
        for (int q = 0; q < kC; ++q) {
          const float4 x = st[(m0 * kC / 4 + q) * kThreads];
          sq[4 * q] = x.x, sq[4 * q + 1] = x.y, sq[4 * q + 2] = x.z,
                 sq[4 * q + 3] = x.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + e, key = key_of(m);
          const float rk = to_f32(in.r[t * D + key]);
          const float kk = to_f32(in.k[t * D + key]);
          const float wk = in.w[t * D + key];
          float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            const float se = sq[e * kC + c];
            float& de = ds[m * kC + c];
            pr = fmaf(se, dyq[c], pr);
            pk = fmaf(de, vq[c], pk);
            pw = fmaf(de, se, pw);
            cols[c] = fmaf(kk, de, cols[c]);
            de = fmaf(de, wk, __fmul_rn(rk, dyq[c]));
          }
          rows[m] = pr;
          rows[kK + m] = pk;
          rows[2 * kK + m] = pw;
        }
      }
      reduce_lanes<kRows, kP, 32>(rows, lane);
      if ((lane & kRowsDup) == 0) {
        const int base = slice_of(kRows, kP, 32, lane);
#pragma unroll
        for (int e = 0; e < kRowsLeft; ++e) {
          const int x = base + e, q = x / kK;
          parts[((q * kWarps + warp) * kSeg + t) * D + key_of(x % kK)] =
              rows[e];
        }
      }
      reduce_lanes<kC, 1, kP>(cols, lane);
      if ((lane & kColsDup) == 0)
        parts_dv[t * D + kC * g + slice_of(kC, 1, kP, lane)] = cols[0];
    }
    __syncthreads();

    // The segment's outputs: the warps' partials plus the bonus terms.
    for (int e = tid; e < steps * D; e += kThreads) {
      const int t = e / D;  // e % D == my_key
      const size_t at = (row0 + static_cast<size_t>(n * kSeg + t) * H) * D +
                        my_key;
      const float rk = to_f32(in.r[t * D + my_key]);
      const float kk = to_f32(in.k[t * D + my_key]);
      float sr = 0.f, sk = 0.f, sw = 0.f;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) {
        sr += parts[((0 * kWarps + x) * kSeg + t) * D + my_key];
        sk += parts[((1 * kWarps + x) * kSeg + t) * D + my_key];
        sw += parts[((2 * kWarps + x) * kSeg + t) * D + my_key];
      }
      const float bonus = __fmul_rn(my_u, vdy[t]);
      dr[at] = from_f32<T>(fmaf(bonus, kk, sr));
      dk[at] = from_f32<T>(fmaf(bonus, rk, sk));
      dw[at] = sw;
      dv[at] = from_f32<T>(
          fmaf(in.dy[t * D + my_key], ruk[t], parts_dv[t * D + my_key]));
      du = fmaf(__fmul_rn(rk, kk), vdy[t], du);
    }
    __syncthreads();  // parts and stage n are read before they are reused
  }

  // ds0 = dS^0, each element by the thread that held it.
#pragma unroll
  for (int m = 0; m < kK; ++m)
#pragma unroll
    for (int c = 0; c < kC; ++c)
      ds0[state0 + key_of(m) * D + kC * g + c] = ds[m * kC + c];
  // du: the threads of a key (kThreads / D of them, lanes D apart in one
  // warp) add theirs; one writes.
#pragma unroll
  for (int off = D; off < kThreads && off < 32; off <<= 1)
    du = __fadd_rn(du, __shfl_xor_sync(kFull, du, off));
  if (tid < D) du_part[static_cast<size_t>(bh) * D + my_key] = du;
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
                 void* du_part, void* ds0, void* ckpt, void* scratch, int B,
                 int T_len, int H, cudaStream_t stream) {
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
        static_cast<float*>(ds0), static_cast<float4*>(ckpt),
        static_cast<float4*>(scratch), T_len, H);
    return cudaGetLastError();
  }
};

template <typename T, int D>
struct Geom {
  static int run(int B, int T_len, int H, int* out) {
    using G = Geometry<T, D>;
    out[0] = B * H;
    out[1] = G::kThreads;
    out[2] = kSeg;
    out[3] = G::kP;
    out[4] = G::kC;
    out[5] = G::kSmem;
    cudaError_t err = opt_in<T, D>();
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &out[6], wkv_bwd_kernel<T, D>, G::kThreads, G::kSmem);
    return err;
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
// ds_T may be null (zero).  ckpt: B*H*ceil(T/seg)*D*D fp32, scratch:
// B*H*seg*D*D fp32, seg = out[2] of rwkv_wkv_bwd_geometry.
int rwkv_wkv_bwd_launch(int is_bf16, int D, const void* r, const void* k,
                        const void* v, const void* w, const void* u,
                        const void* s0, const void* dy, const void* ds_T,
                        void* dr, void* dk, void* dv, void* dw, void* du_part,
                        void* ds0, void* ckpt, void* scratch, int B, int T_len,
                        int H, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? by_head_dim<__nv_bfloat16, Launch>(D, r, k, v, w, u, s0, dy,
                                                  ds_T, dr, dk, dv, dw,
                                                  du_part, ds0, ckpt, scratch,
                                                  B, T_len, H, st)
             : by_head_dim<float, Launch>(D, r, k, v, w, u, s0, dy, ds_T, dr,
                                          dk, dv, dw, du_part, ds0, ckpt,
                                          scratch, B, T_len, H, st);
}

// out[0..6] = blocks, threads a block, steps a segment, key groups, value
// columns a thread, dynamic shared bytes a block, blocks an SM of the
// current device holds at once.  A cudaError_t, or -1 for a head dim this
// file does not instantiate.
int rwkv_wkv_bwd_geometry(int is_bf16, int D, int B, int T_len, int H,
                          int* out) {
  return is_bf16 ? by_head_dim<__nv_bfloat16, Geom>(D, B, T_len, H, out)
                 : by_head_dim<float, Geom>(D, B, T_len, H, out);
}

const char* rwkv_wkv_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
