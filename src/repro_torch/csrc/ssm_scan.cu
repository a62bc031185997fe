// Fused selective scan (the hybrid family's SSM), for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/ssm_scan/kernel.py:_ssm_kernel
// (wrapper ssm_scan_kernel).  It computes the same function:
//   proj[b,t,:] = xc[b,t,:] . x_proj            (f32, columns B | C | dt)
//   dt   = softplus(proj[b,t,2n] + dt_bias[d])
//   a    = exp(-exp(a_log[d,n]) * dt)
//   h    = a * h + (dt * xc[b,t,d]) * B[n]      (h starts at h0[b,d,n])
//   y[b,t,d] = sum_n h * C[n]
// with every product and sum in float32, y and the final h in float32,
// and no d_skip term (the model adds it outside).  xc and x_proj are
// float32 or bfloat16 (both of one type); dt_bias, a_log and h0 float32.
//
// Design.  The TPU kernel walks a sequential grid over chunks of T with
// h[d, n] in VMEM and the chunk's coefficients [chunk, d, n] beside it.
// Hopper has no sequential grid, so the carry lives in registers:
//   pass 1 (ssm_proj_rows): the projection, a small CUDA-core matrix
//     product.  A block takes 64 rows of xc ([B*T, d]) and one of
//     `splits` slices of d, walks its slice in chunks of 32 with the xc
//     tile and the matching x_proj rows staged in shared memory, and keeps
//     up to 17 column sums per thread in registers (4 column groups x 17 >=
//     2n+1 = 65 columns).  Writes its partial sums to
//     proj [splits, B*T, 2n+1].  The split over d is what keeps a decode
//     step (B*T = 4 rows: one row block) from walking all of d in one
//     block; the caller picks `splits` so that the card gets ~2 blocks an
//     SM.  With more than one split, ssm_proj_sum adds the partials into
//     the first in a fixed order (so the result does not depend on
//     scheduling).
//   pass 2 (ssm_scan_states): one thread per state (b, d, n), h in a
//     register.  G lanes (n rounded up to a power of two) share channel d;
//     each thread loops over t, loading 8 steps' inputs at a time before it
//     runs them, so the loads of a group of steps overlap.  y is the
//     shuffle-sum of h * C over the G lanes.  The loop runs to exactly T:
//     there is no padded tail to mask.
//
// What bounds it: latency.  Its bytes (xc read once, y written once: ~79
// MB at hymba's prefill, 4 x 2048 x 1600) take ~24 us at 3.35 TB/s and its
// operations (~2.3 G) ~35 us at the CUDA cores' 67 T/s, but pass 2 runs T
// dependent steps, each a load, a softplus, two exps and a shuffle
// reduction; with 102,400 threads (~24 warps an SM) the card cannot hide
// that chain.  A chunked two-level scan (each chunk scanned in parallel,
// then the chunk carries) is the known remedy and is left for later.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns the first
// non-zero cudaGetLastError() of its launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_STATE = 32;
constexpr int MAX_COLS = 2 * MAX_STATE + 1;
constexpr int PROJ_ROWS = 64;     // rows of xc per block (pass 1)
constexpr int PROJ_K = 32;        // d-chunk staged in shared memory
constexpr int PROJ_THREADS = 256; // 64 rows x 4 column groups
constexpr int COL_GROUPS = PROJ_THREADS / PROJ_ROWS;
constexpr int COLS_PER_THREAD = (MAX_COLS + COL_GROUPS - 1) / COL_GROUPS;
constexpr int SCAN_THREADS = 128; // pass 2
constexpr int UNROLL = 8;         // steps whose loads are issued together

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// jax.nn.softplus: logaddexp(x, 0)
__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

// Block (x, y): rows 64x .. 64x + 63, d-slice y of gridDim.y, each slice
// `k_per` wide (a multiple of PROJ_K).
template <typename T>
__global__ void __launch_bounds__(PROJ_THREADS)
ssm_proj_rows(const T* __restrict__ xc, const T* __restrict__ w,
              float* __restrict__ proj, int64_t rows, int d, int cols,
              int k_per) {
  __shared__ float xs[PROJ_ROWS][PROJ_K + 1];
  __shared__ float ws[PROJ_K][MAX_COLS];
  const int tid = threadIdx.x;
  const int r = tid % PROJ_ROWS;
  const int cg = tid / PROJ_ROWS;  // one column group per 2 warps
  const int64_t row0 = (int64_t)blockIdx.x * PROJ_ROWS;
  const int k_begin = blockIdx.y * k_per;
  const int k_end = min(d, k_begin + k_per);
  proj += (int64_t)blockIdx.y * rows * cols;

  float acc[COLS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < COLS_PER_THREAD; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += PROJ_K) {
    // a warp loads 32 consecutive elements of one row
    for (int i = tid; i < PROJ_ROWS * PROJ_K; i += PROJ_THREADS) {
      const int rr = i / PROJ_K, kk = i % PROJ_K;
      const int64_t row = row0 + rr;
      const int k = k0 + kk;
      xs[rr][kk] = (row < rows && k < k_end) ? to_f(xc[row * d + k]) : 0.f;
    }
    // x_proj rows k0 .. k0 + 31 lie contiguous: [PROJ_K * cols]
    for (int i = tid; i < PROJ_K * cols; i += PROJ_THREADS) {
      const int kk = i / cols, c = i % cols;
      ws[kk][c] = (k0 + kk < k_end) ? to_f(w[(int64_t)k0 * cols + i]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < PROJ_K; ++kk) {
      const float xv = xs[r][kk];  // stride 33: no bank conflicts
#pragma unroll
      for (int i = 0; i < COLS_PER_THREAD; ++i) {
        const int c = cg + COL_GROUPS * i;  // one c per warp: a broadcast
        if (c < cols) acc[i] = fmaf(xv, ws[kk][c], acc[i]);
      }
    }
    __syncthreads();
  }
  const int64_t row = row0 + r;
  if (row >= rows) return;
#pragma unroll
  for (int i = 0; i < COLS_PER_THREAD; ++i) {
    const int c = cg + COL_GROUPS * i;
    if (c < cols) proj[row * cols + c] = acc[i];
  }
}

// proj[0] += proj[1] + ... + proj[splits - 1], element by element.
__global__ void ssm_proj_sum(float* __restrict__ proj, int64_t count,
                             int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = proj[i];
  for (int k = 1; k < splits; ++k) v += proj[k * count + i];
  proj[i] = v;
}

// G: lanes per channel, a power of two >= n and <= 32.
template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
ssm_scan_states(const T* __restrict__ xc, const float* __restrict__ proj,
                const float* __restrict__ dt_bias,
                const float* __restrict__ a_log,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_out, int steps, int d, int n, int G) {
  const int lane = threadIdx.x % G;
  const int ch = blockIdx.x * (SCAN_THREADS / G) + threadIdx.x / G;
  const int b = blockIdx.y;
  const bool active = ch < d && lane < n;
  // idle lanes read valid addresses and add 0 to the group's sum
  const int c = min(ch, d - 1);
  const int s = min(lane, n - 1);
  const int cols = 2 * n + 1;

  const float A = expf(a_log[(int64_t)c * n + s]);
  const float bias = dt_bias[c];
  const int64_t state = ((int64_t)b * d + c) * n + s;
  float h = active ? h0[state] : 0.f;
  const T* xb = xc + (int64_t)b * steps * d + c;
  const float* pb = proj + (int64_t)b * steps * cols;
  float* yb = y + (int64_t)b * steps * d + c;
  const bool writes = lane == 0 && ch < d;

  auto step = [&](int t, float x, float bt, float ct, float dr) {
    const float dt = softplus(dr + bias);
    const float a = expf(-A * dt);
    h = a * h + (dt * x) * bt;
    float part = active ? h * ct : 0.f;
    for (int off = G / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (writes) yb[(int64_t)t * d] = part;
  };

  int t = 0;
  for (; t + UNROLL <= steps; t += UNROLL) {
    float xv[UNROLL], bv[UNROLL], cv[UNROLL], dv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float* pr = pb + (int64_t)(t + u) * cols;
      xv[u] = to_f(xb[(int64_t)(t + u) * d]);
      bv[u] = pr[s];
      cv[u] = pr[n + s];
      dv[u] = pr[2 * n];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) step(t + u, xv[u], bv[u], cv[u], dv[u]);
  }
  for (; t < steps; ++t) {
    const float* pr = pb + (int64_t)t * cols;
    step(t, to_f(xb[(int64_t)t * d]), pr[s], pr[n + s], pr[2 * n]);
  }
  if (active) h_out[state] = h;
}

template <typename T>
int launch(const void* xc, const void* x_proj, const float* dt_bias,
           const float* a_log, const float* h0, float* proj, float* y,
           float* h_out, int b, int steps, int d, int n, int splits,
           cudaStream_t stream) {
  const int k_chunks = (d + PROJ_K - 1) / PROJ_K;
  if (b <= 0 || steps <= 0 || d <= 0 || n <= 0 || n > MAX_STATE ||
      splits < 1 || splits > k_chunks)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)b * steps;
  const int cols = 2 * n + 1;
  const int k_per = (k_chunks + splits - 1) / splits * PROJ_K;
  splits = (d + k_per - 1) / k_per;  // rounding may leave fewer slices
  const dim3 proj_grid((unsigned)((rows + PROJ_ROWS - 1) / PROJ_ROWS),
                       (unsigned)splits);
  ssm_proj_rows<T><<<proj_grid, PROJ_THREADS, 0, stream>>>(
      static_cast<const T*>(xc), static_cast<const T*>(x_proj), proj, rows,
      d, cols, k_per);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (splits > 1) {
    const int64_t count = rows * cols;
    ssm_proj_sum<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
        proj, count, splits);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  int G = 1;
  while (G < n) G *= 2;
  const int per_block = SCAN_THREADS / G;
  const dim3 grid((unsigned)((d + per_block - 1) / per_block), (unsigned)b);
  ssm_scan_states<T><<<grid, SCAN_THREADS, 0, stream>>>(
      static_cast<const T*>(xc), proj, dt_bias, a_log, h0, y, h_out, steps,
      d, n, G);
  return (int)cudaGetLastError();
}

}  // namespace

// xc: [b, steps, d] contiguous; x_proj: [d, 2n+1] of xc's type; dt_bias:
// [d]; a_log: [d, n]; h0, h_out: [b, d, n]; proj: [splits, b * steps,
// 2n+1] scratch, 1 <= splits <= ceil(d / 32); y: [b, steps, d].  All
// float32 but xc and x_proj.
extern "C" int ssm_scan_f32(const void* xc, const void* x_proj,
                            const void* dt_bias, const void* a_log,
                            const void* h0, void* proj, void* y, void* h_out,
                            int b, int steps, int d, int n, int splits,
                            void* stream) {
  return launch<float>(xc, x_proj, static_cast<const float*>(dt_bias),
                       static_cast<const float*>(a_log),
                       static_cast<const float*>(h0),
                       static_cast<float*>(proj), static_cast<float*>(y),
                       static_cast<float*>(h_out), b, steps, d, n, splits,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ssm_scan_bf16(const void* xc, const void* x_proj,
                             const void* dt_bias, const void* a_log,
                             const void* h0, void* proj, void* y,
                             void* h_out, int b, int steps, int d, int n,
                             int splits, void* stream) {
  return launch<__nv_bfloat16>(
      xc, x_proj, static_cast<const float*>(dt_bias),
      static_cast<const float*>(a_log), static_cast<const float*>(h0),
      static_cast<float*>(proj), static_cast<float*>(y),
      static_cast<float*>(h_out), b, steps, d, n, splits,
      static_cast<cudaStream_t>(stream));
}
