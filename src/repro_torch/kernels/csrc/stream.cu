// STREAM copy / scale / add / triad for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of repro/kernels/stream.py
// (_copy_kernel, _scale_kernel, _add_kernel, _triad_kernel), the paper's
// bandwidth probe (its §5):
//   copy   o = a              scale  o = alpha * a
//   add    o = a + b          triad  o = a + alpha * b
// over n elements of float32 or bfloat16.  The TPU kernels cut an (M, N)
// array into (512, 128) tiles, a layout of the TPU's vector memory and not
// part of what they compute: here the arrays are n flat, contiguous
// elements, any n >= 1, indexed in 64 bits.
//
// Bound: bytes.  Each element of each input is read once and each output
// element written once: 2 * n * itemsize bytes for copy and scale,
// 3 * n * itemsize for add and triad.  At most 2 flops an element is far
// below the ~20 flops per byte at which the fp32 CUDA cores would bound
// it.  At n = 2**26 float32 that is 536.9 MB (0.1603 ms at 3.35 TB/s) and
// 805.3 MB (0.2404 ms).  Only arrays well past the 50 MB L2 measure HBM.
//
// Design.  Each thread moves one 16-byte vector (4 float32 or 8 bfloat16)
// of each array, so a warp reads and writes 512 contiguous bytes an array:
// whole 32-byte sectors, no byte read twice, and no write that reads its
// line first.  The last n mod V elements (less than one vector) take one
// thread each after the vector part.  One launch a call, on the caller's
// stream; no synchronisation and no allocation.
//
// Rounding follows kernels/ref.py (and the reference) exactly.  alpha
// arrives as a float that already holds alpha rounded to the arrays' type.
// float32 scale and add round once; the float32 triad is fmaf(alpha, b, a),
// rounded once.  bfloat16 ops compute in float32 and round to bfloat16 to
// nearest even; the bfloat16 triad rounds alpha * b to bfloat16 before the
// add.  The _rn intrinsics keep nvcc (--fmad=true by default) from fusing
// a multiply and an add that the reference rounds apart.
//
// Plain C interface, loaded with ctypes.  stream_<op>_launch returns a
// cudaError_t (0 on success).  The pointers must be 16-byte aligned (the
// wrapper checks) and n >= 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Copy {
  static constexpr int kInputs = 1;
  template <typename T>
  __device__ static T apply(T a, T, float) { return a; }
};

struct Scale {
  static constexpr int kInputs = 1;
  __device__ static float apply(float a, float, float alpha) {
    return __fmul_rn(alpha, a);
  }
  __device__ static __nv_bfloat16 apply(__nv_bfloat16 a, __nv_bfloat16,
                                        float alpha) {
    return __float2bfloat16_rn(__fmul_rn(alpha, __bfloat162float(a)));
  }
};

struct Add {
  static constexpr int kInputs = 2;
  __device__ static float apply(float a, float b, float) {
    return __fadd_rn(a, b);
  }
  __device__ static __nv_bfloat16 apply(__nv_bfloat16 a, __nv_bfloat16 b,
                                        float) {
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};

struct Triad {
  static constexpr int kInputs = 2;
  __device__ static float apply(float a, float b, float alpha) {
    return fmaf(alpha, b, a);
  }
  __device__ static __nv_bfloat16 apply(__nv_bfloat16 a, __nv_bfloat16 b,
                                        float alpha) {
    const __nv_bfloat16 p =
        __float2bfloat16_rn(__fmul_rn(alpha, __bfloat162float(b)));
    return __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(a), __bfloat162float(p)));
  }
};

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
    stream_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, float alpha, int64_t n) {
  constexpr int V = 16 / sizeof(T);
  const int64_t n_vec = n / V;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n_vec) {
    const uint4 va = reinterpret_cast<const uint4*>(a)[i];
    uint4 vb = va;
    if constexpr (Op::kInputs == 2) {
      vb = reinterpret_cast<const uint4*>(b)[i];
    }
    uint4 vo;
    const T* ea = reinterpret_cast<const T*>(&va);
    const T* eb = reinterpret_cast<const T*>(&vb);
    T* eo = reinterpret_cast<T*>(&vo);
#pragma unroll
    for (int e = 0; e < V; ++e) eo[e] = Op::apply(ea[e], eb[e], alpha);
    reinterpret_cast<uint4*>(out)[i] = vo;
  } else {
    const int64_t j = n_vec * V + (i - n_vec);
    if (j < n) {
      if constexpr (Op::kInputs == 2) {
        out[j] = Op::apply(a[j], b[j], alpha);
      } else {
        out[j] = Op::apply(a[j], a[j], alpha);
      }
    }
  }
}

template <typename T, typename Op>
int launch_t(const void* a, const void* b, void* out, float alpha,
             long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int64_t V = 16 / sizeof(T);
  const int64_t work = n / V + n % V;            // vectors, then the tail
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  stream_kernel<T, Op>
      <<<dim3(static_cast<unsigned>(blocks)), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<T*>(out), alpha, static_cast<int64_t>(n));
  return static_cast<int>(cudaGetLastError());
}

template <typename Op>
int launch(int is_bf16, const void* a, const void* b, void* out,
           float alpha, long long n, void* stream) {
  return is_bf16 ? launch_t<__nv_bfloat16, Op>(a, b, out, alpha, n, stream)
                 : launch_t<float, Op>(a, b, out, alpha, n, stream);
}

}  // namespace

extern "C" {

// is_bf16: 1 when the arrays are bfloat16, 0 when they are float32.  n is
// the number of elements of each array.
int stream_copy_launch(int is_bf16, const void* a, void* out, long long n,
                       void* stream) {
  return launch<Copy>(is_bf16, a, nullptr, out, 0.0f, n, stream);
}

int stream_scale_launch(int is_bf16, const void* a, void* out, float alpha,
                        long long n, void* stream) {
  return launch<Scale>(is_bf16, a, nullptr, out, alpha, n, stream);
}

int stream_add_launch(int is_bf16, const void* a, const void* b, void* out,
                      long long n, void* stream) {
  return launch<Add>(is_bf16, a, b, out, 0.0f, n, stream);
}

int stream_triad_launch(int is_bf16, const void* a, const void* b, void* out,
                        float alpha, long long n, void* stream) {
  return launch<Triad>(is_bf16, a, b, out, alpha, n, stream);
}

const char* stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
