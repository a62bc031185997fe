// Row-wise RMSNorm, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/rmsnorm/kernel.py:_rmsnorm_kernel
// (wrapper rmsnorm_kernel).  It computes the same function, row by row:
//   out[r, :] = (x[r, :] * rsqrt(mean(x[r, :]^2) + eps)) * w
// with the statistics and the products in float32 and the result cast to
// x's dtype (float32 or bfloat16; w has x's dtype).
//
// Design.  One warp per row, four rows per block.  Each lane reads a
// strided slice of the row, squares and sums it in float32, and the warp
// reduces with __shfl_xor_sync, so every lane ends with the row's sum.  A
// second pass re-reads the row (a few KB, still in L1/L2) and writes the
// normalised, scaled values.  Where the row width allows (d a multiple of
// 16 bytes' worth of elements and 16-byte aligned pointers) each lane
// moves 16 bytes per load and store; otherwise one element at a time.
//
// What bounds it: bytes.  It reads x once from device memory and w once
// per row (from L2), and writes out once: 2 * rows * d * sizeof(x) bytes
// against ~4 operations per element, far below the ~295 operations per
// byte at which the H100 turns compute-bound.  The TPU kernel's point —
// one pass instead of the unfused graph's three — holds here too.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns
// cudaGetLastError() of its launch (0 = success) and launches nothing for
// rows == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // rows per block

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// VEC elements per lane per access; VEC == 1 is the plain path.
template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
rmsnorm_rows(const T* __restrict__ x, const T* __restrict__ w,
             T* __restrict__ out, int64_t rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  using P = Pack<T, VEC>;
  const P* xr = reinterpret_cast<const P*>(x + row * d);
  const P* wr = reinterpret_cast<const P*>(w);
  P* orow = reinterpret_cast<P*>(out + row * d);
  const int n = d / VEC;

  float ss = 0.f;
  for (int i = lane; i < n; i += 32) {
    const P p = xr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f(p.v[e]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / (float)d + eps);

  for (int i = lane; i < n; i += 32) {
    const P p = xr[i];
    const P pw = wr[i];
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = from_f<T>((to_f(p.v[e]) * r) * to_f(pw.v[e]));
    orow[i] = o;
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* w, void* out, int64_t rows, int d,
           float eps, int vec, cudaStream_t stream) {
  if (rows == 0) return 0;
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  if (vec)
    rmsnorm_rows<T, VEC><<<blocks, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), rows, d, eps);
  else
    rmsnorm_rows<T, 1><<<blocks, WARPS * 32, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(out), rows, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [rows, d] contiguous; w: [d].  vec != 0 selects 16-byte
// accesses: the caller guarantees d % (16 / sizeof(T)) == 0 and 16-byte
// aligned pointers.
extern "C" int rmsnorm_f32(const void* x, const void* w, void* out,
                           int64_t rows, int d, float eps, int vec,
                           void* stream) {
  return launch<float, 4>(x, w, out, rows, d, eps, vec,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int rmsnorm_bf16(const void* x, const void* w, void* out,
                            int64_t rows, int d, float eps, int vec,
                            void* stream) {
  return launch<__nv_bfloat16, 8>(x, w, out, rows, d, eps, vec,
                                  static_cast<cudaStream_t>(stream));
}
