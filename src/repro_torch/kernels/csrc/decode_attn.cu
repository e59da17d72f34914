// GQA flash-decode attention for Hopper (sm_90a).
//
// Replaces repro/kernels/decode_attn.py::_decode_kernel (the Pallas TPU
// kernel behind decode_attn): one query token per sequence attends the
// valid prefix pos < length of its KV cache, with G = Hq / Hk query heads
// per KV head.  q: (B, Hq, D); k, v: (B, S, Hk, D), contiguous, fp32 or
// bf16; out: (B, Hq, D) in q's type.  All arithmetic is fp32.
//
// Bound: the K/V bytes it reads, 2 * B * length * Hk * D * itemsize.  Each
// cache byte feeds 2 * G flops (G = 1 at stablelm-1.6b), far below the
// ~295 flops per byte at which the card's tensor cores would bound it, so
// the only thing that matters is streaming K and V once at full rate.
//
// Design.  The TPU kernel carries (m, l, acc) in scratch across a
// sequential grid axis of 512-key tiles.  Hopper blocks run in parallel in
// no order, so here one block owns one (batch, kv head) and loops over the
// keys itself, only up to `length` (not S):
//   * A group of TPK lanes shares one key; each lane loads a 16-byte (or
//     narrower) slice of the K and V rows, so a warp reads whole,
//     contiguous D-element rows and every byte of each sector is used.
//   * Each lane keeps its slice of the G query rows, pre-scaled by
//     D**-0.5, and its own online softmax (m, l, acc) in fp32 registers.
//     UNROLL keys' loads are issued before any is used, to keep enough
//     bytes in flight per SM.
//   * K/V are read exactly once; the score of a key is a dot over the
//     group (shuffle reduction), and each key's K/V bytes serve all G
//     query heads.
//   * At the end the partial (m, l, acc) of every lane group are merged,
//     first across the warp by shuffles, then across warps through shared
//     memory, and the (G, D) result is written once.
// Keys past `length` are never loaded, so poisoned entries there cannot
// move the output.
//
// Limits of this first version, for a later PR: a block count of B * Hk.
// At stablelm-1.6b (B 8, Hk 32) that is 256 blocks on 132 SMs; at a
// narrow-KV shape such as starcoder2-3b (Hk 2) it is 16 blocks, which
// cannot pull the card's bandwidth.  The cure is a split over S plus a
// combine pass: the same (m, l, acc) merge that the reference's
// channelized multi-chip read applies across chips.  No wgmma or TMA yet.
//
// Plain C interface, loaded with ctypes.  decode_attn_launch returns a
// cudaError_t (0 on success), or -1 for a configuration this file does not
// instantiate; it launches on the given stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

template <int Bytes> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Elements per lane: 16 bytes, halved while G * E would hold too many
// registers (q slice and accumulator are G * E floats each), as long as a
// key still fits in one warp.
constexpr int pick_elems(int e, int d, int g) {
  return (e > 2 && e * g > 32 && d / (e / 2) <= 32) ? pick_elems(e / 2, d, g)
                                                    : e;
}

template <typename T, int D, int G>
struct Shape {
  static constexpr int E = pick_elems(16 / sizeof(T), D, G);
  static constexpr int TPK = D / E;      // lanes that share one key
  static constexpr int KPW = 32 / TPK;   // keys a warp takes per step
  // Warps per block: 8, or 4 where the merge buffer would pass 40 KB.
  static constexpr int NW = (8 * G * (D + 2) * 4 <= 40960) ? 8 : 4;
  static constexpr int STEP = NW * KPW;  // keys a block takes per step
  using R = typename Raw<static_cast<int>(E * sizeof(T))>::type;
  static_assert(D % E == 0 && TPK <= 32 && 32 % TPK == 0, "bad head dim");
};

template <typename T, int E>
__device__ __forceinline__ void unpack(
    const typename Raw<static_cast<int>(E * sizeof(T))>::type& raw,
    float (&out)[E]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < E; ++i) out[i] = to_f32(e[i]);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(Shape<T, D, G>::NW * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ out, int S,
                   int Hk, int length) {
  using C = Shape<T, D, G>;
  constexpr int E = C::E, TPK = C::TPK, KPW = C::KPW, NW = C::NW;
  using R = typename C::R;

  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / TPK, d0 = (lane % TPK) * E;

  // This lane's slice of the block's G query rows, pre-scaled.
  const size_t q_row0 = (static_cast<size_t>(b) * Hk + h) * G;
  const float scale = rsqrtf(static_cast<float>(D));
  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    unpack<T, E>(*reinterpret_cast<const R*>(q + (q_row0 + g) * D + d0), qr[g]);
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

  // Consecutive positions are Hk * D elements apart.
  const size_t row = static_cast<size_t>(Hk) * D;
  const size_t head0 = static_cast<size_t>(b) * S * row +
                       static_cast<size_t>(h) * D + d0;
  const T* kb = k + head0;
  const T* vb = v + head0;
  const int first = warp * KPW + grp;

  for (int base = 0; base < length; base += C::STEP * kUnroll) {
    R kraw[kUnroll], vraw[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * C::STEP + first;
      ok[u] = pos < length;
      if (ok[u]) {
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
      unpack<T, E>(kraw[u], kf);
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
      unpack<T, E>(vraw[u], vf);
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
      const float lo = __shfl_xor_sync(kFull, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float ao = __shfl_xor_sync(kFull, acc[g][i], off);
        acc[g][i] = acc[g][i] * a + ao * c;
      }
      m[g] = mn;
    }
  }

  // Merge the warps through shared memory and write (G, D) once.
  __shared__ float sm_m[NW][G], sm_l[NW][G];
  __shared__ float sm_acc[NW][G][D];
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (d0 == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < E; ++i) sm_acc[warp][g][d0 + i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += NW * 32) {
    const int g = idx / D, d = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float c = expf(sm_m[w][g] - mx);
      den += sm_l[w][g] * c;
      num += sm_acc[w][g][d] * c;
    }
    store(out + (q_row0 + g) * D + d, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Hk, int length, cudaStream_t stream) {
  const dim3 grid(Hk, B);
  decode_attn_kernel<T, D, G><<<grid, Shape<T, D, G>::NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hk, length);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_g(int G, const void* q, const void* k, const void* v, void* out,
             int B, int S, int Hk, int length, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, out, B, S, Hk, length, stream);
    case 2: return launch<T, D, 2>(q, k, v, out, B, S, Hk, length, stream);
    case 4: return launch<T, D, 4>(q, k, v, out, B, S, Hk, length, stream);
    case 8: return launch<T, D, 8>(q, k, v, out, B, S, Hk, length, stream);
    case 12: return launch<T, D, 12>(q, k, v, out, B, S, Hk, length, stream);
    default: return -1;
  }
}

template <typename T>
int launch_d(int D, int G, const void* q, const void* k, const void* v,
             void* out, int B, int S, int Hk, int length,
             cudaStream_t stream) {
  switch (D) {
    case 16: return launch_g<T, 16>(G, q, k, v, out, B, S, Hk, length, stream);
    case 32: return launch_g<T, 32>(G, q, k, v, out, B, S, Hk, length, stream);
    case 64: return launch_g<T, 64>(G, q, k, v, out, B, S, Hk, length, stream);
    case 128: return launch_g<T, 128>(G, q, k, v, out, B, S, Hk, length, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// is_bf16: 1 for bfloat16, 0 for float32.
int decode_attn_launch(int is_bf16, int D, int G, const void* q,
                       const void* k, const void* v, void* out, int B, int S,
                       int Hk, int length, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(D, G, q, k, v, out, B, S, Hk,
                                           length, st)
                 : launch_d<float>(D, G, q, k, v, out, B, S, Hk, length, st);
}

const char* decode_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
