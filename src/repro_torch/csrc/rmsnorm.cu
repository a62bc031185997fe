// Row-wise RMSNorm, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/rmsnorm/kernel.py:_rmsnorm_kernel
// (wrapper rmsnorm_kernel).  It computes the same function, row by row:
//   out[r, :] = (x[r, :] * rsqrt(mean(x[r, :]^2) + eps)) * w
// with the statistics and the products in float32 and the result cast to
// x's dtype (float32 or bfloat16; w has x's dtype).
//
// What bounds it: bytes.  x read once, w once and out written once is
// 2 * rows * d * sizeof(x) + d * sizeof(x) bytes against ~4 operations
// per element, far below the ~295 operations per byte at which the H100
// turns compute-bound.  The TPU kernel's point -- one pass instead of the
// unfused graph's three -- holds here too.
//
// Design (rmsnorm_one_pass).  TPR threads share a row (32, 64 or 128:
// the fewest that hold the row in at most 8 16-byte packs a thread) and a
// block of 128 threads takes 128 / TPR rows at a time in a grid-stride
// loop over as many blocks as the SMs hold at once.  Each thread loads
// its slice of w once, into registers, and keeps it for every row it
// visits.  For a row
// it issues all of its loads of x before reducing, keeps them in
// registers, reduces the sum of squares in float32 (shuffles within the
// warp, then shared memory across the warps of the row), and writes the
// row from the same registers: x crosses from device memory once and w
// once per thread, not once per row.
//
// Widths the one-pass path does not cover -- d not a multiple of 16
// bytes' worth of elements, pointers not 16-byte aligned, or more than
// 1,024 packs a row (d > 8192 in bf16, > 4096 in float32) -- take
// rmsnorm_rows: one warp a row, a first pass for the sum of squares and a
// second that re-reads the row (16 bytes a lane where the width allows,
// one element otherwise).
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

constexpr int BLOCK = 128;          // threads of a one-pass block
constexpr int PACKS = 8;            // 16-byte packs a thread holds
constexpr int MAX_PACKS = 128 * PACKS;

template <typename T, int TPR>
__global__ void __launch_bounds__(BLOCK)
rmsnorm_one_pass(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ out, int64_t rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int RPB = BLOCK / TPR;  // rows a block takes at a time
  constexpr int WPR = TPR / 32;     // warps a row
  using P = Pack<T, VEC>;
  __shared__ float part[BLOCK / 32];
  const int t = threadIdx.x % TPR;
  const int r_in = threadIdx.x / TPR;
  const int warp = threadIdx.x / 32;
  const int n = d / VEC;

  P wv[PACKS];
#pragma unroll
  for (int i = 0; i < PACKS; ++i)
    if (t + TPR * i < n) wv[i] = reinterpret_cast<const P*>(w)[t + TPR * i];

  for (int64_t r0 = (int64_t)blockIdx.x * RPB; r0 < rows;
       r0 += (int64_t)gridDim.x * RPB) {
    const int64_t row = r0 + r_in;
    const bool live = row < rows;
    const P* xr = reinterpret_cast<const P*>(x + (live ? row : 0) * d);
    P xv[PACKS];
#pragma unroll
    for (int i = 0; i < PACKS; ++i)
      if (live && t + TPR * i < n) xv[i] = xr[t + TPR * i];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < PACKS; ++i)
      if (live && t + TPR * i < n) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f(xv[i].v[e]);
          ss += f * f;
        }
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (WPR > 1) {  // the row's warps add their sums in shared memory
      if (threadIdx.x % 32 == 0) part[warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int k = 0; k < WPR; ++k) ss += part[r_in * WPR + k];
      __syncthreads();
    }
    const float r = rsqrtf(ss / (float)d + eps);
    if (!live) continue;
    P* orow = reinterpret_cast<P*>(out + row * d);
#pragma unroll
    for (int i = 0; i < PACKS; ++i)
      if (t + TPR * i < n) {
        P o;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          o.v[e] = from_f<T>((to_f(xv[i].v[e]) * r) * to_f(wv[i].v[e]));
        orow[t + TPR * i] = o;
      }
  }
}

// As many blocks as the card holds at once (the occupancy query's blocks
// an SM times the SMs), or fewer when the rows run out: every block stays
// resident and walks its share of the rows with its slice of w.  The
// count is taken once, on the first launch's device: it sets only how
// the rows are shared out, never what is computed, and a decode step's
// few rows would otherwise pay for the queries on every launch.
template <typename T, int TPR>
void launch_one_pass(const T* x, const T* w, T* out, int64_t rows, int d,
                     float eps, cudaStream_t stream) {
  constexpr int RPB = BLOCK / TPR;
  static const int64_t cap = [] {
    int per_sm = 0, dev = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_one_pass<T, TPR>, BLOCK, 0);
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return (int64_t)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  }();
  const int64_t need = (rows + RPB - 1) / RPB;
  const unsigned blocks = (unsigned)(need < cap ? need : cap);
  rmsnorm_one_pass<T, TPR><<<blocks, BLOCK, 0, stream>>>(x, w, out, rows, d,
                                                         eps);
}

// mode 2: one pass (the caller guarantees what rmsnorm_one_pass needs);
// 1: two passes, 16 bytes a lane; 0: two passes, one element a lane.
template <typename T, int VEC>
int launch(const void* x, const void* w, void* out, int64_t rows, int d,
           float eps, int mode, cudaStream_t stream) {
  if (rows == 0) return 0;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  const int n = d / VEC;
  if (mode == 2) {
    if (n > MAX_PACKS || d % VEC) return (int)cudaErrorInvalidValue;
    if (n <= 32 * PACKS)
      launch_one_pass<T, 32>(xp, wp, op, rows, d, eps, stream);
    else if (n <= 64 * PACKS)
      launch_one_pass<T, 64>(xp, wp, op, rows, d, eps, stream);
    else
      launch_one_pass<T, 128>(xp, wp, op, rows, d, eps, stream);
    return (int)cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  if (mode == 1)
    rmsnorm_rows<T, VEC><<<blocks, WARPS * 32, 0, stream>>>(xp, wp, op, rows,
                                                           d, eps);
  else
    rmsnorm_rows<T, 1><<<blocks, WARPS * 32, 0, stream>>>(xp, wp, op, rows,
                                                         d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: [rows, d] contiguous; w: [d].  `mode` as for launch(): modes 1
// and 2 need d % (16 / sizeof(T)) == 0 and 16-byte aligned pointers, mode
// 2 also d / (16 / sizeof(T)) <= 1024.
extern "C" int rmsnorm_f32(const void* x, const void* w, void* out,
                           int64_t rows, int d, float eps, int mode,
                           void* stream) {
  return launch<float, 4>(x, w, out, rows, d, eps, mode,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int rmsnorm_bf16(const void* x, const void* w, void* out,
                            int64_t rows, int d, float eps, int mode,
                            void* stream) {
  return launch<__nv_bfloat16, 8>(x, w, out, rows, d, eps, mode,
                                  static_cast<cudaStream_t>(stream));
}
