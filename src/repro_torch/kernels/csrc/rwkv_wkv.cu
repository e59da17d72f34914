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
// itself (the decode cache is updated in place): one block owns one
// (batch, head) state, thread j alone reads and writes column j, and it
// reads all of its column before the time loop and writes it back only
// after it.  s_out must not overlap s0 in any other way, nor y any input.
// All arithmetic is fp32.  Any T >= 1: the loop runs to T, there is no
// tile and nothing is masked.
//
// Bound.  Bytes: B*T*H*D*(3*itemsize + 4 + 4) + 2*B*H*D*D*4 (each input
// read once, y and the state written once).  Operations: the bonus term
// factors out of the sum, sum_i r_i u_i k_i v_j = v_j * c_t with
// c_t = sum_i r_i u_i k_i, so per step and head the function needs
// r . S (one FMA per state element), S * w + k v (a multiply and an FMA)
// and O(D) for c_t and its product with v: 5*B*T*H*D*D + 5*B*T*H*D fp32
// operations.  At a prefill shape (T in the thousands) that is about 20
// operations per byte, so the fp32 CUDA-core rate bounds it; at a decode
// step (T = 1) the state read and write bound it.  This exact form cannot
// use tensor cores: every step is a rank-1 update and a matrix-vector
// product with the state, and the state must round through fp32 once per
// step.  The chunked-matmul form named in the reference's docstring
// (intra-chunk products on tensor cores, the state carried per chunk) is
// later work.
//
// Design.  The TPU kernel keeps the state in VMEM scratch across a
// sequential third grid axis of time tiles.  Hopper blocks run in no
// order, so here one block owns one (batch, head) and runs the whole time
// loop itself; nothing carries between blocks.
//   * D threads per block; thread j keeps column j of S (D floats) in
//     registers for the whole loop, and reads and writes its column of the
//     state in memory once (neighbouring threads on neighbouring
//     addresses).
//   * Each step stages r_t, k_t, w_t (indexed by the key i) in shared
//     memory; thread j keeps v_t[j] and u[j] in registers.  Thread j also
//     forms r_j u_j k_j; a warp-shuffle sum and one shared slot per warp
//     give every thread c_t after the step's barrier.  The vectors are
//     double buffered, so one __syncthreads per step suffices: a thread
//     writes buffer t&1 only after the barrier of step t-1, which every
//     thread passes only after it has finished reading that buffer at
//     step t-2.
//   * Step t+1's four inputs are loaded into registers before step t
//     computes, so their latency overlaps the D-long inner loop.
//   * The inner loop is the 5 operations per state element above;
//     r . S is summed in four interleaved partial sums to cut the
//     dependent chain of adds by four.
// The operations and their order do not depend on T or on where a
// sequence is cut, and the state passes through fp32 memory unchanged, so
// wkv over T equals two chained halves bit for bit.
//
// Limits of this first version: B * H blocks of D threads (256 blocks of
// 64 threads at rwkv6-1.6b with batch 8) leave most of the card's warp
// schedulers idle, and each step waits on the previous step's loads.  A
// split of the state's value columns over more threads, or the chunked
// form, is later work.
//
// Plain C interface, loaded with ctypes.  rwkv_wkv_launch returns a
// cudaError_t (0 on success), or -1 for a head dim this file does not
// instantiate; it launches on the given stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
    wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* s0, float* s_out,
               float* __restrict__ y, int T_len, int H) {
  constexpr int kWarps = (D + 31) / 32;
  constexpr int kLanes = D < 32 ? D : 32;
  constexpr unsigned kMask = D < 32 ? (1u << D) - 1u : 0xffffffffu;
  __shared__ __align__(16) float sr[2][D];
  __shared__ __align__(16) float sk[2][D];
  __shared__ __align__(16) float sw[2][D];
  __shared__ float sc[2][kWarps];  // per-warp sums of r_i u_i k_i

  const int j = threadIdx.x;
  const int bh = blockIdx.x;  // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const size_t step = static_cast<size_t>(H) * D;  // t -> t + 1
  // Element (b, t = 0, h, j) of a (B, T, H, D) array.
  const size_t base = (static_cast<size_t>(b) * T_len * H + h) * D + j;
  const size_t col = static_cast<size_t>(bh) * D * D + j;  // S[0][j]

  float s[D];
#pragma unroll
  for (int i = 0; i < D; ++i) s[i] = s0[col + static_cast<size_t>(i) * D];
  const float uj = u[h * D + j];

  float rn = to_f32(r[base]), kn = to_f32(k[base]);
  float vn = to_f32(v[base]), wn = w[base];
  for (int t = 0; t < T_len; ++t) {
    const int buf = t & 1;
    sr[buf][j] = rn;
    sk[buf][j] = kn;
    sw[buf][j] = wn;
    float p = rn * uj * kn;
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      p += __shfl_xor_sync(kMask, p, off);
    if ((j & 31) == 0) sc[buf][j >> 5] = p;
    const float vj = vn;
    __syncthreads();
    if (t + 1 < T_len) {
      const size_t nxt = base + static_cast<size_t>(t + 1) * step;
      rn = to_f32(r[nxt]);
      kn = to_f32(k[nxt]);
      vn = to_f32(v[nxt]);
      wn = w[nxt];
    }
    float c = sc[buf][0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) c += sc[buf][q];
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D; ++i) {
      acc[i & 3] = fmaf(sr[buf][i], s[i], acc[i & 3]);
      s[i] = fmaf(s[i], sw[buf][i], sk[buf][i] * vj);
    }
    y[base + static_cast<size_t>(t) * step] =
        fmaf(c, vj, (acc[0] + acc[1]) + (acc[2] + acc[3]));
  }

#pragma unroll
  for (int i = 0; i < D; ++i) s_out[col + static_cast<size_t>(i) * D] = s[i];
}

template <typename T, int D>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_out, int B, int T_len, int H,
                   cudaStream_t stream) {
  wkv_kernel<T, D><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(s_out), static_cast<float*>(y), T_len, H);
  return cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* r, const void* k, const void* v,
             const void* w, const void* u, const void* s0, void* y,
             void* s_out, int B, int T_len, int H, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, y, s_out, B, T_len, H, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, y, s_out, B, T_len, H, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, y, s_out, B, T_len, H, stream);
    default:
      return -1;
  }
}

}  // namespace

extern "C" {

// is_bf16: 1 when r, k, v are bfloat16, 0 when they are float32.
int rwkv_wkv_launch(int is_bf16, int D, const void* r, const void* k,
                    const void* v, const void* w, const void* u,
                    const void* s0, void* y, void* s_out, int B, int T_len,
                    int H, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_d<__nv_bfloat16>(D, r, k, v, w, u, s0, y, s_out, B,
                                           T_len, H, st)
                 : launch_d<float>(D, r, k, v, w, u, s0, y, s_out, B, T_len,
                                   H, st);
}

const char* rwkv_wkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
