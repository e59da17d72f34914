// RWKV6 WKV recurrence for Hopper (sm_90a).
//
// Replaces repro/kernels/rwkv_wkv.py::_wkv_kernel (the Pallas TPU kernel
// behind wkv).  Per (batch, head), with a (D, D) fp32 state S indexed
// [key i][value j]:
//
//     y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// sequential in t.  r, k, v: (B, T, H, D) contiguous, fp32 or bf16;
// w: (B, T, H, D) fp32; u: (H, D) fp32; s0: (B, H, D, D) fp32.  Outputs
// y: (B, T, H, D) fp32 and s_out: (B, H, D, D) fp32.  s_out may be s0
// itself (the decode cache is updated in place); it must not overlap s0
// in any other way, nor y any input.  All arithmetic is fp32, and the
// state passes through fp32 memory once per step, as in the reference.
// Any T >= 1; D is 16, 32 or 64.
//
// Bound.  Bytes: B*T*H*D*(3*itemsize + 4 + 4) + 2*B*H*D*D*4 (each input
// read once, y and the state written once).  Operations: the bonus term
// factors out of the sum, sum_i r_i u_i k_i v_j = v_j * c_t with
// c_t = sum_i r_i u_i k_i, so per step and head the function needs
// r . S (an FMA per state element), S * w + k v (a multiply and an FMA)
// and O(D) for c_t: 5*B*T*H*D*D + 5*B*T*H*D fp32 operations, done here in
// three instructions a state element.  At a prefill shape (T in the
// thousands) that is about 20 operations a byte, so the fp32 CUDA-core
// rate bounds it; at a decode step (T = 1) the state's read and write do.
//
// No tensor cores.  Every step is a rank-1 update and a matrix-vector
// product with the state, and the state rounds to fp32 once per step; a
// tensor-core product needs a chunk of steps folded into one matrix (the
// chunked form named in the reference's docstring), which rounds
// elsewhere and is held to the reference only within a tolerance.  That
// form is later work; this kernel keeps the exact recurrence.
//
// Lane map.  One block owns one (batch, head) and runs its whole time
// loop (blocks run in no order, so nothing carries between them).  Value
// columns are independent (y_t[j] reads column j only), and y is an
// output that no later step reads, so both axes of the state are split:
//   * a thread holds a tile of kK keys x kC columns of S in registers for
//     the whole loop: kP = 4 key groups (kK = D / kP) times D / kC column
//     groups, kC = 4, thread tid = g * kP + p.  Group p's keys are
//     the quads 4 (p + kP m) .. + 3; group g's columns are the kC / 4
//     16-byte vectors g + (D / kC) c.  A key's r, k and w are read once
//     for kC columns and a column's v once for kK keys, so a step reads
//     3 kK + kC values from shared memory for 3 kK kC instructions: the
//     shared-memory pipe (128 bytes a cycle an SM) stays below the
//     FP32 pipes.  A one-column tile needs as many shared loads as
//     arithmetic and measured 2-3x slower.  At D 64 a (b, h) is 64
//     threads, 2 warps a block and 2 blocks an SM: by design, the tile
//     buys instruction-level parallelism (64 independent state elements
//     and two register sets of inputs a thread) in place of more warps;
//     more key groups (more warps, smaller tiles) measured no faster.
//     kP and kC are fixed at compile time; tools/wkv_tiles.py builds a
//     copy of this source at other tiles and times them.
//   * The group's share of c_t = sum_i r_i u_i k_i is summed with its
//     keys, so a thread's partial y_t[j] is sum over its keys of
//     r_i S[i][j] plus that share times v_j.  The kP partials of a column
//     meet by a reduce-scatter of xor shuffles inside the warp (each
//     level halves the columns a lane carries), and the step's y is
//     summed while the next step computes.
//   * The state is read and written with 16-byte streaming accesses, a
//     warp's lanes on neighbouring vectors; each element is read and
//     written by one thread only, all reads before the time loop and all
//     writes after it, so s_out may be s0.
// Chunking.  r, k, v and w arrive kTc steps at a time (32 in bf16, 16 in
// fp32: 60 or 48 KB of shared memory, two or more blocks an SM) by
// cp.async 16-byte copies into a ring of three stages, issued two chunks
// ahead; the partial last chunk copies and runs only its steps.  One
// __syncthreads per chunk, after its copies landed, also frees the stage
// that the chunk two ahead then fills; none is needed inside a chunk.
// Inside it a step's inputs are loaded from shared memory into registers
// (bf16 widened there, exactly) while the step before computes.  A
// decode step (T = 1) is an instantiation of its own: its inputs come
// straight from global memory, beside the state, with no shared memory
// and CUDA's default split of L1 and shared memory, so that it
// does not make the SM reconfigure between the decode step's other
// kernels (that cost ~1 us a launch, measured).  There the state's bytes
// bound the kernel.
//
// Bit-exact chaining.  The operations of step t and their order depend
// only on the step's inputs, the state and the tile: not on T, on kTc, or
// on where a chunk starts.  The state leaves and re-enters through fp32
// memory unchanged, so wkv over T equals two chained pieces bit for bit.
//
// Plain C interface, loaded with ctypes.  rwkv_wkv_launch returns a
// cudaError_t (0 on success), or -1 for a head dim this file does not
// instantiate; it launches on the given stream and allocates nothing.
// rwkv_wkv_geometry reports the launch it makes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

// The tile (see the note above): key groups, and value columns a thread.
constexpr int kKeyGroups = 4;
constexpr int kColumns = 4;
constexpr unsigned kFull = 0xffffffffu;

// Steps a chunk, by the type of r, k and v.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kSteps = 16;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kSteps = 32;
};

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Columns a thread: the most of `want`, 4 and 2 that no more than the
// key groups can reduce and that leaves whole warps.
__host__ __device__ constexpr int pick_columns(int want, int D, int P) {
  int c = want;
  while (c > 2 && (c > P || D / c * P < 32)) c /= 2;
  return c;
}

template <typename T, int D>
struct Geometry {
  static constexpr int kP = cmin(kKeyGroups, D / 4);        // key groups
  static constexpr int kK = D / kP;                         // keys a thread
  static constexpr int kC = pick_columns(kColumns, D, kP);  // columns
  static constexpr int kThreads = D / kC * kP;
  static constexpr int kTc = Chunk<T>::kSteps;
  // A ring of three stages, each [kTc][D] of r, k, v (in T) and w (fp32).
  static constexpr int kArray = kTc * D * static_cast<int>(sizeof(T));
  static constexpr int kStage = 3 * kArray + kTc * D * 4;
  static constexpr int kSmem = 3 * kStage;
  static_assert(kArray % 16 == 0, "shared buffers keep 16-byte alignment");
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(kK % 4 == 0 && kC <= kP, "keys in quads; kC <= kP");
};

// N (4 or 2) neighbouring elements of T as one shared or global load,
// and widened to fp32 (bf16 to fp32 is exact: the bits move to the upper
// half of the word).
template <typename T, int N>
struct Vec;
template <>
struct Vec<float, 4> {
  using type = float4;
};
template <>
struct Vec<float, 2> {
  using type = float2;
};
template <>
struct Vec<__nv_bfloat16, 4> {
  using type = uint2;
};
template <>
struct Vec<__nv_bfloat16, 2> {
  using type = unsigned;
};
__device__ __forceinline__ void widen(float4 x, float* out) {
  out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
}
__device__ __forceinline__ void widen(float2 x, float* out) {
  out[0] = x.x, out[1] = x.y;
}
__device__ __forceinline__ void widen(unsigned x, float* out) {
  out[0] = __uint_as_float(x << 16);
  out[1] = __uint_as_float(x & 0xffff0000u);
}
__device__ __forceinline__ void widen(uint2 x, float* out) {
  widen(x.x, out);
  widen(x.y, out + 2);
}
template <int N, typename T>
__device__ __forceinline__ typename Vec<T, N>::type load_vec(const T* p) {
  return *reinterpret_cast<const typename Vec<T, N>::type*>(p);
}
// The state is read once and written once a launch: streaming accesses
// (evict first).
template <int N>
__device__ __forceinline__ typename Vec<float, N>::type load_state(
    const float* p) {
  return __ldcs(reinterpret_cast<const typename Vec<float, N>::type*>(p));
}
template <int N>
__device__ __forceinline__ void store_state(float* p, const float* x) {
  if constexpr (N == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  else
    __stcs(reinterpret_cast<float2*>(p), make_float2(x[0], x[1]));
}

// The reduce-scatter over key groups: at each level the lanes that differ
// in bit kO of the key group swap halves of their kN partial sums (the
// lane with the bit set keeps the upper half) and add, until one sum a
// lane is left: that of column mine_of<kC>(p) of the thread's kC.
template <int kN, int kO = 1>
__device__ __forceinline__ void reduce_scatter(float* acc, int p) {
  if constexpr (kN > 1) {
    constexpr int kHalf = kN / 2;
    const bool upper = p & kO;
#pragma unroll
    for (int m = 0; m < kHalf; ++m) {
      const float send = upper ? acc[m] : acc[m + kHalf];
      const float keep = upper ? acc[m + kHalf] : acc[m];
      acc[m] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, kO));
    }
    reduce_scatter<kHalf, 2 * kO>(acc, p);
  }
}
template <int kC>
__device__ __forceinline__ int mine_of(int p) {
  int mine = 0;
#pragma unroll
  for (int o = 1, n = kC; o < kC; o <<= 1, n >>= 1)
    if (p & o) mine += n / 2;
  return mine;
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

// Copy `steps` (<= kTc) steps of one array, rows `row0 + t * H` of D
// elements, into stage[t][0..D).
template <int kTc, int D, int kThreads, typename E>
__device__ __forceinline__ void issue_array(unsigned char* stage,
                                            const E* src, size_t row0, int H,
                                            int steps) {
  constexpr int kUnits = D * static_cast<int>(sizeof(E)) / 16;  // a row
  for (int n = threadIdx.x; n < kTc * kUnits; n += kThreads) {
    const int t = n / kUnits, c = n % kUnits;
    if (t < steps)
      cp_async16(stage + n * 16,
                 reinterpret_cast<const unsigned char*>(
                     src + (row0 + static_cast<size_t>(t) * H) * D) +
                     c * 16);
  }
}

// kDecode: the instantiation for T = 1, which stages nothing in shared
// memory; the other runs the chunks.
template <typename T, int D, bool kDecode>
__global__ void __launch_bounds__(Geometry<T, D>::kThreads, 2)
    wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* s0, float* s_out,
               float* __restrict__ y, int T_len, int H) {
  using G = Geometry<T, D>;
  constexpr int kP = G::kP, kK = G::kK, kC = G::kC, kThreads = G::kThreads;
  constexpr int kTc = G::kTc, kQ = kK / 4;  // key quads a thread
  constexpr int kV = cmin(kC, 4);           // columns a load
  using QT = typename Vec<T, 4>::type;
  using VT = typename Vec<T, kV>::type;

  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int p = tid % kP;  // key group
  // Column group g holds the kV-column vectors g + kG * c: one access of a
  // warp covers neighbouring vectors.
  constexpr int kG = D / kC;
  const int g = tid / kP;
  auto column = [&](int c) { return kV * (g + kG * (c / kV)) + c % kV; };
  // The column whose y this thread holds after the reduce-scatter.
  const int mine = column(mine_of<kC>(p));
  const int bh = blockIdx.x;  // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const int n_chunks = (T_len + kTc - 1) / kTc;
  // Row (b, t, h) of a (B, T, H, D) array is row0 + t * H.
  const size_t row0 = static_cast<size_t>(b) * T_len * H + h;
  const size_t state0 = static_cast<size_t>(bh) * D * D;

  auto stage_of = [&](int n) { return smem + (n % 3) * G::kStage; };
  auto issue = [&](int n) {
    if (n < n_chunks) {
      const size_t rows = row0 + static_cast<size_t>(n) * kTc * H;
      const int steps = cmin(kTc, T_len - n * kTc);
      unsigned char* st = stage_of(n);
      issue_array<kTc, D, kThreads>(st, r, rows, H, steps);
      issue_array<kTc, D, kThreads>(st + G::kArray, k, rows, H, steps);
      issue_array<kTc, D, kThreads>(st + 2 * G::kArray, v, rows, H, steps);
      issue_array<kTc, D, kThreads>(st + 3 * G::kArray, w, rows, H, steps);
    }
    cp_async_commit();
  };
  if constexpr (!kDecode) {
    issue(0);
    issue(1);
  }

  // Key 4 * (p + kP * m) + e is this thread's key 4 * m + e; the state
  // element (that key, column(c)) is s[(4 * m + e) * kC + c].  Each row's
  // kC columns are 16- or 8-byte accesses, neighbouring threads on
  // neighbouring addresses.
  float s[kK * kC], uk[kK];
#pragma unroll
  for (int m = 0; m < kQ; ++m) {
    const int key = 4 * (p + kP * m);
    widen(load_vec<4>(u + h * D + key), &uk[4 * m]);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < kC; c += kV)
        widen(load_state<kV>(s0 + state0 + (key + e) * D + column(c)),
              &s[(4 * m + e) * kC + c]);
  }

  // One step's inputs as loaded, r, k and v still in T.
  struct In {
    QT r[kQ], k[kQ];
    VT v[kC / kV];
    float4 w[kQ];
  };
  // The partial sums of y of the step before, and where its y goes: they
  // meet across the key groups while the next step computes.
  float prev[kC] = {};
  float* prev_y = y;
  bool pending = false;

  // A step's inputs from rows of r, k, v and w: rows of a chunk in shared
  // memory, or the global rows when T = 1.
  auto load = [&](const T* rr, const T* rk, const T* rv, const float* rw,
                  In& in) {
#pragma unroll
    for (int m = 0; m < kQ; ++m) {
      const int i = 4 * (p + kP * m);
      in.r[m] = load_vec<4>(rr + i);
      in.k[m] = load_vec<4>(rk + i);
      in.w[m] = load_vec<4>(rw + i);
    }
#pragma unroll
    for (int c = 0; c < kC / kV; ++c)
      in.v[c] = load_vec<kV>(rv + column(kV * c));
  };
  // The step before's y: its partial sums meet across the key groups.
  auto flush = [&]() {
    reduce_scatter<kC>(prev, p);
    float part = prev[0];
#pragma unroll
    for (int off = kC; off < kP; off <<= 1)
      part = __fadd_rn(part, __shfl_xor_sync(kFull, part, off));
    if (pending && p < kC) *prev_y = part;
  };
  // One step from `in`, its y to go to `y_at` at the next flush: r . S
  // and (r u) . k over this thread's keys, and the state update.
  auto step = [&](float* y_at, const In& in) {
    float rq[kK], kq[kK], wq[kK], vq[kC];
#pragma unroll
    for (int m = 0; m < kQ; ++m) {
      widen(in.r[m], &rq[4 * m]);
      widen(in.k[m], &kq[4 * m]);
      widen(in.w[m], &wq[4 * m]);
    }
#pragma unroll
    for (int c = 0; c < kC / kV; ++c) widen(in.v[c], &vq[kV * c]);
    // This group's share of c_t = sum_i r_i u_i k_i.
    float cg = __fmul_rn(__fmul_rn(rq[0], uk[0]), kq[0]);
#pragma unroll
    for (int i = 1; i < kK; ++i)
      cg = fmaf(__fmul_rn(rq[i], uk[i]), kq[i], cg);
#pragma unroll
    for (int i = 0; i < kK; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float& se = s[i * kC + c];
        prev[c] = i == 0 ? __fmul_rn(rq[i], se) : fmaf(rq[i], se, prev[c]);
        se = fmaf(se, wq[i], __fmul_rn(kq[i], vq[c]));
      }
#pragma unroll
    for (int c = 0; c < kC; ++c) prev[c] = fmaf(cg, vq[c], prev[c]);
    prev_y = y_at;
    pending = true;
  };

  if constexpr (kDecode) {
    // A decode step: its inputs come straight from global memory, beside
    // the state, and nothing waits on shared memory.
    const size_t at = row0 * D;
    In in;
    load(r + at, k + at, v + at, w + at, in);
    step(y + at + mine, in);
  }
  for (int n = 0; !kDecode && n < n_chunks; ++n) {
    cp_async_wait_but_newest();  // chunk n, this thread's copies
    __syncthreads();  // everyone's copies of chunk n landed; chunk n - 1's
                      // stage, which chunk n + 2 reuses, is read
    issue(n + 2);
    const unsigned char* st = stage_of(n);
    const T* sr = reinterpret_cast<const T*>(st);
    const T* sk = reinterpret_cast<const T*>(st + G::kArray);
    const T* sv = reinterpret_cast<const T*>(st + 2 * G::kArray);
    const float* sw = reinterpret_cast<const float*>(st + 3 * G::kArray);
    const int steps = cmin(kTc, T_len - n * kTc);
    float* yrow = y + (row0 + static_cast<size_t>(n) * kTc * H) * D + mine;
    auto load_at = [&](int t, In& in) {
      load(sr + t * D, sk + t * D, sv + t * D, sw + t * D, in);
    };
    auto y_at = [&](int t) { return yrow + static_cast<size_t>(t) * H * D; };

    // Two register sets in turn: step t computes from one while step t + 1
    // loads into the other (the last step of a chunk reloads itself).  The
    // step before's y meets while this step computes.
    In a, nb;
    load_at(0, a);
    int t = 0;
    for (; t + 2 <= steps; t += 2) {
      load_at(t + 1, nb);
      flush();
      step(y_at(t), a);
      load_at(t + 2 < steps ? t + 2 : t + 1, a);
      flush();
      step(y_at(t + 1), nb);
    }
    if (t < steps) {
      flush();
      step(y_at(t), a);
    }
  }
  // The state back, each element by the thread that read it; then the
  // last step's y.
#pragma unroll
  for (int m = 0; m < kQ; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < kC; c += kV)
        store_state<kV>(
            s_out + state0 + (4 * (p + kP * m) + e) * D + column(c),
            &s[(4 * m + e) * kC + c]);
  flush();
}

// Above 48 KB of dynamic shared memory a kernel must opt in; once per
// device, for the chunked instantiation only.  The decode one keeps
// CUDA's default split of L1 and shared memory, so that it runs between
// other kernels without reconfiguring the SM.
template <typename T, int D>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> opted_in{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (opted_in.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(wkv_kernel<T, D, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Geometry<T, D>::kSmem);
  if (err != cudaSuccess) return err;
  // The most shared memory the SM can give, so two blocks fit.
  err = cudaFuncSetAttribute(wkv_kernel<T, D, false>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) opted_in.fetch_or(bit);
  return err;
}

template <typename T, int D>
int geometry(int B, int T_len, int H, int* out) {
  using G = Geometry<T, D>;
  out[0] = B * H;
  out[1] = G::kThreads;
  out[2] = G::kTc;
  out[3] = G::kP;
  out[4] = G::kC;
  if (T_len == 1) {
    out[5] = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[6], wkv_kernel<T, D, true>, G::kThreads, 0);
  }
  out[5] = G::kSmem;
  cudaError_t err = opt_in<T, D>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[6], wkv_kernel<T, D, false>, G::kThreads, G::kSmem);
  return err;
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_out, int B, int T_len, int H,
                   cudaStream_t stream) {
  using G = Geometry<T, D>;
  const auto run = [&](auto kernel, int smem) {
    kernel<<<B * H, G::kThreads, smem, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<float*>(s_out), static_cast<float*>(y), T_len, H);
  };
  if (T_len == 1) {
    run(wkv_kernel<T, D, true>, 0);
  } else {
    const cudaError_t err = opt_in<T, D>();
    if (err != cudaSuccess) return err;
    run(wkv_kernel<T, D, false>, G::kSmem);
  }
  return cudaGetLastError();
}

// Calls F<T, D>::run(args...) for the head dims this file instantiates;
// -1 for any other.
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

template <typename T, int D>
struct Launch {
  static int run(const void* r, const void* k, const void* v, const void* w,
                 const void* u, const void* s0, void* y, void* s_out, int B,
                 int T_len, int H, cudaStream_t stream) {
    return launch<T, D>(r, k, v, w, u, s0, y, s_out, B, T_len, H, stream);
  }
};

template <typename T, int D>
struct Geom {
  static int run(int B, int T_len, int H, int* out) {
    return geometry<T, D>(B, T_len, H, out);
  }
};

}  // namespace

extern "C" {

// is_bf16: 1 when r, k, v are bfloat16, 0 when they are float32.
int rwkv_wkv_launch(int is_bf16, int D, const void* r, const void* k,
                    const void* v, const void* w, const void* u,
                    const void* s0, void* y, void* s_out, int B, int T_len,
                    int H, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? by_head_dim<__nv_bfloat16, Launch>(
                       D, r, k, v, w, u, s0, y, s_out, B, T_len, H, st)
                 : by_head_dim<float, Launch>(D, r, k, v, w, u, s0, y, s_out,
                                              B, T_len, H, st);
}

// The launch rwkv_wkv_launch makes for these arguments: out[0..6] =
// blocks, threads a block, steps a chunk, key groups, value columns a
// thread, dynamic shared bytes a block, and the blocks an SM of the
// current device holds at once.  A cudaError_t, or -1 for a head dim
// this file does not instantiate.
int rwkv_wkv_geometry(int is_bf16, int D, int B, int T_len, int H,
                      int* out) {
  return is_bf16 ? by_head_dim<__nv_bfloat16, Geom>(D, B, T_len, H, out)
                 : by_head_dim<float, Geom>(D, B, T_len, H, out);
}

const char* rwkv_wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
