// GQA flash-decode attention for Hopper (sm_90a), split over the cache.
//
// Replaces repro/kernels/decode_attn.py::_decode_kernel (the Pallas TPU
// kernel behind decode_attn): one query token per sequence attends the
// valid prefix pos < length of its KV cache, with G = Hq / Hk query heads
// per KV head.  q: (B, Hq, D); k, v: (B, S, Hk, D), contiguous, fp32 or
// bf16; out: (B, Hq, D) in q's type.  D is 16, 32, 64, 80 or 128 and G 1,
// 2, 4, 8 or 12; any other shape returns -1.
//
// Bound.  The K/V bytes read, 2 * B * length * Hk * D * itemsize: each
// cache byte is read once and feeds 2 * G multiply-adds.  At G 12 (one
// mistral-large-123b layer, or starcoder2-3b) that is 12.9 GFLOP over
// 1.07 GB at 32k context: 0.19 ms on the FP32 units (67 TFLOP/s), 60% of
// the 0.32-ms byte bound, so a design on the CUDA cores is pressed by its
// arithmetic even if it streams perfectly.  On the tensor cores (989
// TFLOP/s bf16) the same work takes 0.013 ms.  So bf16 scores and
// products go through mma.sync and the kernel is left to stream bytes.
//
// The split.  The TPU kernel walks a sequential grid axis of key tiles for
// each (batch, KV head).  One block per (batch, KV head) gives 16 to 64
// blocks at narrow-KV shapes, too few for 132 SMs, so the wrapper cuts
// each (b, h)'s prefix into P parts of whole tiles (decode_attn.partition:
// the most parts, a power of two up to 16, that keep one wave of at most
// one block an SM, parts of at least 256 keys); part p holds
// [p * part_keys, (p + 1) * part_keys) within length and may be empty.
// The grid is (P, Hk, B) and the P blocks of one (b, h) form a
// thread-block cluster (P > 8 is a non-portable cluster size).  More
// parts than that measured slower on an H100: each block pays its first
// tiles' latency and the merge, and the GPCs hold few large clusters at
// once (tools/decode_attn_levers.py).
//
// The merge, in the same launch.  Each block leaves its (m, l, acc[G][D])
// -- running max, sum of exponentials, unnormalized output -- in its own
// shared memory.  After cluster.sync() every block reads its peers'
// partials through distributed shared memory, takes the softmax weights
// exp(m_r - max) / sum_r l_r exp(m_r - max), and writes its slice of the
// (G, D) result; a second cluster.sync() keeps each block's shared memory
// alive until its peers have read it.  No scratch in device memory, no
// counter, nothing carried from one launch to the next.  A block that is
// the only part of its (b, h) (P 1: stablelm's, olmoe's and zamba2's
// decode) writes its result itself, with no cluster barrier and no merge
// through distributed shared memory (tools/decode_attn_levers.py times
// the two).
//
// Inside a block (bf16): 4 warps share a ring of kStages tiles of
// kTileKeys keys x D of K and of V in shared memory (rows padded by 16
// bytes, so ldmatrix reads them without bank conflicts at every D),
// filled kStages - 1 tiles ahead by cp.async with a 128-byte L2 prefetch;
// key rows at or past the part's end are zero-filled, never read, so
// poisoned entries past length cannot move the output.  Each warp takes
// 16 keys of a tile:
//   * the (G padded to 16) x D query tile is held, unscaled, as
//     mma.m16n8k16 bf16 A fragments; S = Q K^T goes through mma.sync with
//     fp32 accumulation and is then scaled by D**-0.5 and masked past the
//     part's end with the reference's -1e30;
//   * the online softmax runs once per tile and row (a max over the
//     warp's 16 keys, a quad shuffle), not once per key;
//   * P is rounded to bf16 and P V is added with mma.sync into fp32
//     accumulators (ldmatrix.trans reads V in place);
//   * at the end the 4 warps' partials are merged through shared memory
//     (aliasing the drained ring) into the block's (m, l, acc).
// fp32 inputs stay exact fp32 on the CUDA cores (no TF32): lane groups
// share a key, each lane a 16-byte slice of the K and V rows, with a
// per-key online softmax, then the same warp, block and cluster merges.
//
// The partial build (decode_attn_partials_launch).  A rank that holds one
// slice of a cache whose sequence is split over several cards (the
// channelized layout) needs the softmax terms of its own keys, not their
// normalized output: the same launch, cut and merged the same way, writes
// the cluster's merged (m, l, acc) -- running max of the scaled scores,
// sum of exponentials, output before the division by l -- as float32
// (B, Hq), (B, Hq) and (B, Hq, D) in place of acc / l, and the caller
// merges the ranks' triples (kernels/ops.merge_partials).  Its length may
// be 0 (a slice wholly past the valid prefix): every part is empty and it
// writes m = -1e30, l = 0, acc = 0, the terms of no key.
//
// Plain C interface, loaded with ctypes.  Each launcher returns a
// cudaError_t (0 on success), or -1 for a shape this file does not
// instantiate; it launches on the given stream and allocates nothing.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileKeys = 16 * kWarps;   // keys a ring tile: 16 a warp
constexpr int kStages = 3;               // ring tiles; kStages - 1 ahead
constexpr int kMaxParts = 16;            // largest cluster (non-portable)
constexpr int kMaxDevices = 64;
constexpr int kUnroll = 4;               // fp32 body: keys in flight a lane
constexpr unsigned kFull = 0xffffffffu;

// -- the merge region (floats), shared by both bodies ---------------------

template <int D, int G>
struct Merge {
  static constexpr int kWm = 0;                        // [kWarps][G]
  static constexpr int kWl = kWm + kWarps * G;         // [kWarps][G]
  static constexpr int kWw = kWl + kWarps * G;         // [kWarps][G]
  static constexpr int kWacc = kWw + kWarps * G;       // [kWarps][G][D]
  static constexpr int kBm = kWacc + kWarps * G * D;   // [G], read by peers
  static constexpr int kBl = kBm + G;                  // [G], read by peers
  static constexpr int kBacc = kBl + G;                // [G][D], by peers
  static constexpr int kCw = kBacc + G * D;            // [kMaxParts][G]
  static constexpr int kBytes = (kCw + kMaxParts * G) * 4;
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// Where the partial build writes the merged terms of one (b, h)'s G rows:
// m and l (G floats each) and acc (G x D floats); m is null in the
// ordinary build, which writes acc / l at `out` instead.
struct Partials {
  float* m;
  float* l;
  float* acc;

  __device__ Partials at(size_t row0, int D) const {
    return m ? Partials{m + row0, l + row0, acc + row0 * D} : Partials{};
  }
};

// The warps' partials (wm, wl, wacc, written by the body) -> the block's
// (bm, bl, bacc) -> the cluster's result, each block writing its slice of
// the (G, D) rows at `out` (or, in the partial build, of the un-divided
// terms at `part`).  A block that is the only part of its (b, h) writes
// its result itself.
template <typename T, int D, int G>
__device__ void merge_and_store(float* sm, T* out, Partials part) {
  using M = Merge<D, G>;
  const int tid = threadIdx.x;
  __syncthreads();
  if (tid < G) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm[M::kWm + w * G + tid]);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float e = expf(sm[M::kWm + w * G + tid] - mx);
      sm[M::kWw + w * G + tid] = e;
      den += sm[M::kWl + w * G + tid] * e;
    }
    sm[M::kBm + tid] = mx;
    sm[M::kBl + tid] = den;
    if (gridDim.x == 1 && part.m) {
      part.m[tid] = mx;
      part.l[tid] = den;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a += sm[M::kWw + w * G + g] * sm[M::kWacc + w * G * D + idx];
    if (gridDim.x > 1)
      sm[M::kBacc + idx] = a;
    else if (part.m)
      part.acc[idx] = a;
    else
      store(out + idx, (1.f / sm[M::kBl + g]) * a);
  }
  if (gridDim.x == 1) return;   // one part: no peers

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every block's (bm, bl, bacc) is written
  const int parts = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (tid < G) {
    float mx = kNegInf;
    for (int r = 0; r < parts; ++r)
      mx = fmaxf(mx, *cluster.map_shared_rank(sm + M::kBm + tid, r));
    float den = 0.f;
    for (int r = 0; r < parts; ++r) {
      const float e = expf(*cluster.map_shared_rank(sm + M::kBm + tid, r) - mx);
      sm[M::kCw + r * G + tid] = e;
      den += *cluster.map_shared_rank(sm + M::kBl + tid, r) * e;
    }
    if (!part.m) {
      for (int r = 0; r < parts; ++r) sm[M::kCw + r * G + tid] /= den;
    } else if (rank == 0) {
      part.m[tid] = mx;
      part.l[tid] = den;
    }
  }
  __syncthreads();
  const int per = (G * D + parts - 1) / parts;
  const int end = min((rank + 1) * per, G * D);
  for (int idx = rank * per + tid; idx < end; idx += kThreads) {
    const int g = idx / D;
    float a = 0.f;
    for (int r = 0; r < parts; ++r)
      a += sm[M::kCw + r * G + g] *
           *cluster.map_shared_rank(sm + M::kBacc + idx, r);
    if (part.m)
      part.acc[idx] = a;
    else
      store(out + idx, a);
  }
  cluster.sync();   // peers keep their shared memory until all have read
}

// -- bf16: the ring and the tensor cores -----------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !ok.  L2
// fetches the 128 bytes around the address at once.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile(
      "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(ok ? 16 : 0)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <int D>
struct Ring {
  static constexpr int kRow = D + 8;                  // elements, 16 B pad
  static constexpr int kTile = kTileKeys * kRow;      // elements a K tile
  static constexpr int kBytes = kStages * 2 * kTile * 2;
};

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4): A regs
// hold rows (g, g + 8) x cols (2t, 2t + 8) pairs; B regs k (2t, 2t + 8)
// pairs at col g; C holds rows (g, g + 8) x cols (2t, 2t + 1).  Rows are
// query heads (>= G are zero), A's cols and B's k are head dims for the
// scores and keys for P V.
template <int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_attn_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out,
                Partials terms, int S, int Hk, int length, int part_keys) {
  static_assert(D % 16 == 0 && G <= 16, "bad shape");
  using Rg = Ring<D>;
  constexpr int kRow = Rg::kRow, kChunks = D / 8, kSteps = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* sm = reinterpret_cast<float*>(smem);   // after the ring drains

  const int part = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int lo = min(part * part_keys, length);
  const int hi = min(lo + part_keys, length);
  const int ntiles = (hi - lo + kTileKeys - 1) / kTileKeys;

  // The query tile as A fragments, unscaled; rows >= G are zero.
  const size_t q_row0 = (static_cast<size_t>(b) * Hk + h) * G;
  const bf16* qb = q + q_row0 * D + 2 * tq;
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    qa[kk][0] = gq < G ? ld32(qb + gq * D + kk * 16) : 0u;
    qa[kk][1] = gq + 8 < G ? ld32(qb + (gq + 8) * D + kk * 16) : 0u;
    qa[kk][2] = gq < G ? ld32(qb + gq * D + kk * 16 + 8) : 0u;
    qa[kk][3] = gq + 8 < G ? ld32(qb + (gq + 8) * D + kk * 16 + 8) : 0u;
  }

  // Consecutive positions are Hk * D elements apart.
  const size_t row = static_cast<size_t>(Hk) * D;
  const size_t head0 = static_cast<size_t>(b) * S * row +
                       static_cast<size_t>(h) * D;
  const bf16* kb = k + head0;
  const bf16* vb = v + head0;
  static_assert(kTileKeys * kChunks % kThreads == 0, "ragged tile copy");
  auto load_tile = [&](int tile, int slot) {
    const int base = lo + tile * kTileKeys;
    bf16* ks = ring + slot * 2 * Rg::kTile;
    bf16* vs = ks + Rg::kTile;
#pragma unroll
    for (int i = 0; i < kTileKeys * kChunks / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kChunks, ch = c % kChunks, pos = base + r;
      const bool ok = pos < hi;
      const size_t off = ok ? pos * row + ch * 8 : 0;
      cp_async16(ks + r * kRow + ch * 8, kb + off, ok);
      cp_async16(vs + r * kRow + ch * 8, vb + off, ok);
    }
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float scale = rsqrtf(static_cast<float>(D));

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile t landed; slot (t - 1) % kStages is free
    if (t + kStages - 1 < ntiles)
      load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();

    const bf16* ks = ring + (t % kStages) * 2 * Rg::kTile + warp * 16 * kRow;
    const bf16* vs = ks + Rg::kTile;
    // S = Q K^T over this warp's 16 keys: two n-blocks of 8 keys.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t kf[4];
      ldmatrix_x4(kf, ks + ((lane >> 4) * 8 + (lane & 7)) * kRow +
                          (2 * kk + ((lane >> 3) & 1)) * 8);
      mma(s[0], qa[kk], kf[0], kf[1]);
      mma(s[1], qa[kk], kf[2], kf[3]);
    }
    const int key0 = lo + t * kTileKeys + warp * 16 + 2 * tq;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[j][c] = key0 + j * 8 + (c & 1) < hi ? s[j][c] * scale : kNegInf;
    // Online softmax, once per tile: rows g (c 0, 1) and g + 8 (c 2, 3).
    float mx[2] = {fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])),
                   fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]))};
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      corr[i] = exp2f((m[i] - mn) * kLog2e);
      m[i] = mn;
    }
    float p[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p[j][c] = exp2f((s[j][c] - m[c >> 1]) * kLog2e);
    l[0] = l[0] * corr[0] + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);
    l[1] = l[1] * corr[1] + (p[0][2] + p[0][3]) + (p[1][2] + p[1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // P V: P (rows x 16 keys) as an A fragment, V read transposed.
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]),
                            pack_bf16(p[0][2], p[0][3]),
                            pack_bf16(p[1][0], p[1][1]),
                            pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * kRow +
                                (2 * n2 + (lane >> 4)) * 8);
      mma(acc[2 * n2], pa, vf[0], vf[1]);
      mma(acc[2 * n2 + 1], pa, vf[2], vf[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is drained: its bytes become the merge region

  using M = Merge<D, G>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const int g = gq + 8 * i;
    if (g < G) {
      if (tq == 0) {
        sm[M::kWm + warp * G + g] = m[i];
        sm[M::kWl + warp * G + g] = l[i];
      }
      float* wacc = sm + M::kWacc + (warp * G + g) * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        wacc[n * 8] = acc[n][2 * i];
        wacc[n * 8 + 1] = acc[n][2 * i + 1];
      }
    }
  }
  merge_and_store<bf16, D, G>(sm, out + q_row0 * D, terms.at(q_row0, D));
}

// -- fp32: lanes on the CUDA cores -----------------------------------------

template <int Bytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };

// Floats a lane: 16 bytes, halved while G * E would hold too many
// registers (q slice and accumulator are G * E floats each), as long as a
// key still fits in one warp.
constexpr int pick_elems(int e, int d, int g) {
  return (e > 2 && e * g > 32 && d / (e / 2) <= 32) ? pick_elems(e / 2, d, g)
                                                    : e;
}

constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }

template <int D, int G>
struct Lanes {
  static constexpr int E = pick_elems(4, D, G);
  static constexpr int TPK = pow2_ceil(D / E);   // lanes a key; past D idle
  static constexpr int KPW = 32 / TPK;           // keys a warp takes a step
  static constexpr int STEP = kWarps * KPW;      // keys a block takes a step
  using R = typename Raw<E * 4>::type;
  static_assert(D % E == 0 && TPK <= 32, "bad head dim");
};

template <int E>
__device__ __forceinline__ void unpack(const typename Raw<E * 4>::type& raw,
                                       float (&out)[E]) {
  const float* e = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < E; ++i) out[i] = e[i];
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_attn_lanes(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  Partials terms, int S, int Hk, int length, int part_keys) {
  using C = Lanes<D, G>;
  constexpr int E = C::E, TPK = C::TPK, KPW = C::KPW;
  using R = typename C::R;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sm = reinterpret_cast<float*>(smem);

  const int part = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / TPK, d0 = (lane % TPK) * E;
  const bool active = d0 < D;
  const int lo = min(part * part_keys, length);
  const int hi = min(lo + part_keys, length);

  // This lane's slice of the block's G query rows, pre-scaled.
  const size_t q_row0 = (static_cast<size_t>(b) * Hk + h) * G;
  const float scale = rsqrtf(static_cast<float>(D));
  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (active) {
      unpack<E>(*reinterpret_cast<const R*>(q + (q_row0 + g) * D + d0), qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) qr[g][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < E; ++i) qr[g][i] *= scale;
  }

  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[g][i] = 0.f;
  }

  const size_t row = static_cast<size_t>(Hk) * D;
  const size_t head0 = static_cast<size_t>(b) * S * row +
                       static_cast<size_t>(h) * D + (active ? d0 : 0);
  const float* kb = k + head0;
  const float* vb = v + head0;
  const int first = warp * KPW + grp;

  for (int base = lo; base < hi; base += C::STEP * kUnroll) {
    R kraw[kUnroll], vraw[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * C::STEP + first;
      ok[u] = pos < hi;
      if (ok[u] && active) {
        kraw[u] = __ldg(reinterpret_cast<const R*>(kb + pos * row));
        vraw[u] = __ldg(reinterpret_cast<const R*>(vb + pos * row));
      } else {
        kraw[u] = R{};
        vraw[u] = R{};
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[E], vf[E], s[G];
      unpack<E>(kraw[u], kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[g] = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) s[g] = fmaf(qr[g][i], kf[i], s[g]);
      }
      // Every lane of the warp takes part, valid key or not.
#pragma unroll
      for (int off = TPK / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(kFull, s[g], off);
      }
      if (!ok[u]) continue;
      unpack<E>(vraw[u], vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float mn = fmaxf(m[g], s[g]);
        const float corr = expf(m[g] - mn);
        const float p = expf(s[g] - mn);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i] * corr);
        m[g] = mn;
      }
    }
  }

  // Merge the lane groups of this warp (same d slice, other keys).
#pragma unroll
  for (int off = TPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float mo = __shfl_xor_sync(kFull, m[g], off);
      const float lo_ = __shfl_xor_sync(kFull, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), c = expf(mo - mn);
      l[g] = l[g] * a + lo_ * c;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float ao = __shfl_xor_sync(kFull, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + ao * c;
      }
      m[g] = mn;
    }
  }

  using M = Merge<D, G>;
  if (grp == 0 && active) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (d0 == 0) {
        sm[M::kWm + warp * G + g] = m[g];
        sm[M::kWl + warp * G + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < E; ++i)
        sm[M::kWacc + (warp * G + g) * D + d0 + i] = acc[g][i];
    }
  }
  merge_and_store<float, D, G>(sm, out + q_row0 * D, terms.at(q_row0, D));
}

// -- launch ------------------------------------------------------------------

template <typename T, int D, int G>
struct Traits;

template <int D, int G>
struct Traits<bf16, D, G> {
  static constexpr int kStagesUsed = kStages;
  static constexpr int kRingBytes = Ring<D>::kBytes;
  static constexpr int kSmem = kRingBytes > Merge<D, G>::kBytes
                                   ? kRingBytes
                                   : Merge<D, G>::kBytes;
  static auto kernel() { return decode_attn_mma<D, G>; }
};

template <int D, int G>
struct Traits<float, D, G> {
  static constexpr int kStagesUsed = 0;
  static constexpr int kRingBytes = 0;
  static constexpr int kSmem = Merge<D, G>::kBytes;
  static auto kernel() { return decode_attn_lanes<D, G>; }
};

// Shared-memory size and cluster attributes, set once a device.
template <typename T, int D, int G>
cudaError_t configure() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  using K = Traits<T, D, G>;
  err = cudaFuncSetAttribute(K::kernel(),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        K::kernel(), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) ready[dev] = true;
  return err;
}

cudaLaunchConfig_t launch_config(int parts, int Hk, int B, int smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(parts, Hk, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = parts;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Partials part, int B, int S, int Hk, int length,
                   int parts, int part_keys, cudaStream_t stream) {
  using K = Traits<T, D, G>;
  cudaError_t err = configure<T, D, G>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(parts, Hk, B, K::kSmem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, K::kernel(), static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<T*>(out), part, S, Hk, length,
                           part_keys);
  if (err != cudaSuccess) cudaGetLastError();   // reported here, not later
  return err;
}

// What decode_attn_geometry writes, in this order.
template <typename T, int D, int G>
cudaError_t geometry(int parts, int* out) {
  using K = Traits<T, D, G>;
  cudaError_t err = configure<T, D, G>();
  if (err != cudaSuccess) return err;
  int blocks_per_sm = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks_per_sm, K::kernel(), kThreads, K::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(parts, 1, 1, K::kSmem, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(&clusters, K::kernel(), &cfg);
  if (err != cudaSuccess) return err;
  const int values[] = {kThreads,      kTileKeys,     K::kStagesUsed,
                        K::kRingBytes, K::kSmem,      kMaxParts,
                        blocks_per_sm, clusters};
  for (int i = 0; i < 8; ++i) out[i] = values[i];
  return cudaSuccess;
}

template <typename T> struct Type { using type = T; };
template <int N> using Int = std::integral_constant<int, N>;

template <typename T, int D, typename F>
int switch_g(int G, F&& f) {
  switch (G) {
    case 1: return f(Type<T>{}, Int<D>{}, Int<1>{});
    case 2: return f(Type<T>{}, Int<D>{}, Int<2>{});
    case 4: return f(Type<T>{}, Int<D>{}, Int<4>{});
    case 8: return f(Type<T>{}, Int<D>{}, Int<8>{});
    case 12: return f(Type<T>{}, Int<D>{}, Int<12>{});
    default: return -1;
  }
}

template <typename T, typename F>
int switch_d(int D, int G, F&& f) {
  switch (D) {
    case 16: return switch_g<T, 16>(G, f);
    case 32: return switch_g<T, 32>(G, f);
    case 64: return switch_g<T, 64>(G, f);
    case 80: return switch_g<T, 80>(G, f);
    case 128: return switch_g<T, 128>(G, f);
    default: return -1;
  }
}

// Calls f(Type<T>, Int<D>, Int<G>) for an instantiated shape, else -1.
template <typename F>
int dispatch(int is_bf16, int D, int G, F&& f) {
  return is_bf16 ? switch_d<bf16>(D, G, f) : switch_d<float>(D, G, f);
}

// The checks both launchers share: the split covers [0, length) in whole
// tiles.
bool bad_split(int length, int parts, int part_keys) {
  return parts < 1 || parts > kMaxParts || part_keys < kTileKeys ||
         part_keys % kTileKeys != 0 || length < 0 ||
         static_cast<long long>(parts) * part_keys < length;
}

int launch_any(int is_bf16, int D, int G, const void* q, const void* k,
               const void* v, void* out, Partials part, int B, int S, int Hk,
               int length, int parts, int part_keys, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return dispatch(is_bf16, D, G, [&](auto t, auto d, auto g) {
    using T = typename decltype(t)::type;
    return static_cast<int>(launch<T, decltype(d)::value, decltype(g)::value>(
        q, k, v, out, part, B, S, Hk, length, parts, part_keys, st));
  });
}

}  // namespace

extern "C" {

// is_bf16: 1 for bfloat16, 0 for float32.  parts (1..16) blocks a (b, h),
// one cluster, each taking part_keys keys (a multiple of the tile);
// length in [1, S].
int decode_attn_launch(int is_bf16, int D, int G, const void* q,
                       const void* k, const void* v, void* out, int B, int S,
                       int Hk, int length, int parts, int part_keys,
                       void* stream) {
  if (length < 1 || bad_split(length, parts, part_keys))
    return cudaErrorInvalidValue;
  return launch_any(is_bf16, D, G, q, k, v, out, Partials{}, B, S, Hk, length,
                    parts, part_keys, stream);
}

// The partial build: as decode_attn_launch, but writes the merged float32
// terms m (B, Hq), l (B, Hq) and acc (B, Hq, D) and no output; length in
// [0, S].
int decode_attn_partials_launch(int is_bf16, int D, int G, const void* q,
                                const void* k, const void* v, float* m,
                                float* l, float* acc, int B, int S, int Hk,
                                int length, int parts, int part_keys,
                                void* stream) {
  if (!m || !l || !acc || bad_split(length, parts, part_keys))
    return cudaErrorInvalidValue;
  return launch_any(is_bf16, D, G, q, k, v, nullptr, Partials{m, l, acc}, B,
                    S, Hk, length, parts, part_keys, stream);
}

// out[8]: threads a block, keys a tile, ring stages (0: no ring), ring
// bytes, dynamic shared bytes a block, the largest parts, blocks an SM of
// the current device holds, clusters of `parts` blocks it holds at once.
int decode_attn_geometry(int is_bf16, int D, int G, int parts, int* out) {
  if (parts < 1 || parts > kMaxParts) return cudaErrorInvalidValue;
  return dispatch(is_bf16, D, G, [&](auto t, auto d, auto g) {
    using T = typename decltype(t)::type;
    return static_cast<int>(
        geometry<T, decltype(d)::value, decltype(g)::value>(parts, out));
  });
}

const char* decode_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
