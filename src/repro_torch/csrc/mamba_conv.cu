// The published Mamba-1 mixer's depthwise causal conv, its bias and SiLU,
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference has no Jamba.  It takes the
// place of the tensor code of the mixer's plain version
// (kernels/mamba_conv/ref.py:mamba_conv_ref), which made one float32 pass
// over [T, d] a tap, then the bias, SiLU and a cast.  It computes
//   in[t]   = x[b, t, c] for t >= 0, window[b, K-1+t, c] for t < 0
//   acc     = in[t-K+1] * w[0, c]; acc = fma(in[t-K+1+i], w[i, c], acc)
//             for i = 1 .. K-1 (the taps in order, as PyTorch's addcmul
//             on the card); acc += bias[c]
//   u[b,t,c] = T(acc / (1 + exp(-acc)))       (SiLU, one rounding)
//   window_out[b, j, c] = in[T - (K-1) + j]   (the last K-1 inputs)
// in float32 with one accumulator.  x is read through its row stride
// (the first half of the in-projection's [b, T, 2 d] output, in place);
// window (a decode's carried rows; null reads zeros, a prefill's) and
// window_out (null: not written) are [b, K-1, d] contiguous; w [K, d],
// bias [d] (null: none) and u [b, T, d] contiguous, all of x's type
// (float32 or bfloat16).  K = 4, the published Mamba's d_conv; d and the
// row stride whole 16-byte packs, every pointer 16-byte aligned.
//
// What bounds it: bytes.  x read once and u written once are 2 GiB at
// Jamba's 65,536 x 8,192 bf16 prefill, ~0.64 ms at 3.35 TB/s; the
// operations (2K + 4 a channel-step) are 3 G at 67 TFLOP/s, ~0.04 ms.
// Design: one launch at every T.  A thread owns V neighbouring channels
// (one 16-byte load and store a row: 8 bf16 or 4 f32) and walks CONV_ROWS
// steps of them, its K-1 previous inputs and the K weights in registers,
// so each input row is read once (and K-1 halo rows again by the next
// block's threads, 3/64 more, mostly from L2).  A warp reads 512
// contiguous bytes of one row; four rows' loads are issued before any is
// used.
//
// Interface: plain C, loaded with ctypes; each launcher returns
// cudaGetLastError() (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONV_THREADS = 128;
constexpr int CONV_ROWS = 64;   // steps a thread walks
constexpr int CONV_UNROLL = 4;  // rows whose loads are issued together
constexpr int K = 4;            // taps

// The V = 16 / sizeof(T) values of T a 16-byte load brings, as floats.
__device__ __forceinline__ void widen(uint4 p, float (&v)[4]) {
  v[0] = __uint_as_float(p.x), v[1] = __uint_as_float(p.y);
  v[2] = __uint_as_float(p.z), v[3] = __uint_as_float(p.w);
}

__device__ __forceinline__ void widen(uint4 p, float (&v)[8]) {
  const unsigned w[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ uint4 load(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ unsigned short bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// V floats rounded to T (to nearest even) and stored at p.
__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (unsigned)bf16_bits(v[2 * i])
           | ((unsigned)bf16_bits(v[2 * i + 1]) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, int V>
__device__ __forceinline__ void load_floats(const T* p, float (&v)[V]) {
  widen(load(p), v);
}

// One output row: the K-1 inputs in hist and the row raw through the taps,
// the bias and SiLU, stored at dst; then raw joins the history.
template <typename T, int V>
__device__ __forceinline__ void conv_row(float (&hist)[K - 1][V],
                                         const float (&wt)[K][V],
                                         const float (&bv)[V], bool has_bias,
                                         uint4 raw, T* dst) {
  float cur[V], out[V];
  widen(raw, cur);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float acc = hist[0][v] * wt[0][v];
#pragma unroll
    for (int i = 1; i < K - 1; ++i) acc = fmaf(hist[i][v], wt[i][v], acc);
    acc = fmaf(cur[v], wt[K - 1][v], acc);
    if (has_bias) acc += bv[v];
    out[v] = acc / (1.f + expf(-acc));
  }
  store(dst, out);
#pragma unroll
  for (int j = 0; j + 1 < K - 1; ++j)
#pragma unroll
    for (int v = 0; v < V; ++v) hist[j][v] = hist[j + 1][v];
#pragma unroll
  for (int v = 0; v < V; ++v) hist[K - 2][v] = cur[v];
}

// Block (channel tile, step tile, b); thread: channels [col, col + V).
template <typename T, int V = 16 / sizeof(T)>
__global__ void __launch_bounds__(CONV_THREADS)
mamba_conv_silu(const T* __restrict__ x, const T* __restrict__ win,
                const T* __restrict__ w, const T* __restrict__ bias,
                T* __restrict__ u, T* __restrict__ win_out, int steps, int d,
                int xs) {
  const int col = (blockIdx.x * CONV_THREADS + threadIdx.x) * V;
  if (col >= d) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * CONV_ROWS;
  const int t1 = min(steps, t0 + CONV_ROWS);
  const T* xb = x + (int64_t)b * steps * xs + col;
  T* ub = u + (int64_t)b * steps * d + col;

  float wt[K][V], bv[V];
#pragma unroll
  for (int i = 0; i < K; ++i) load_floats<T, V>(w + (int64_t)i * d + col, wt[i]);
  const bool has_bias = bias != nullptr;
  if (has_bias) {
    load_floats<T, V>(bias + col, bv);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) bv[v] = 0.f;
  }
  // hist[j]: the input at t0 - (K-1) + j
  float hist[K - 1][V];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int t = t0 - (K - 1) + j;
    if (t >= 0) {
      load_floats<T, V>(xb + (int64_t)t * xs, hist[j]);
    } else if (win != nullptr) {
      load_floats<T, V>(win + ((int64_t)b * (K - 1) + (K - 1) + t) * d + col,
                        hist[j]);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) hist[j][v] = 0.f;
    }
  }

  int t = t0;
  for (; t + CONV_UNROLL <= t1; t += CONV_UNROLL) {
    uint4 raw[CONV_UNROLL];
#pragma unroll
    for (int q = 0; q < CONV_UNROLL; ++q) raw[q] = load(xb + (int64_t)(t + q) * xs);
#pragma unroll
    for (int q = 0; q < CONV_UNROLL; ++q)
      conv_row<T, V>(hist, wt, bv, has_bias, raw[q], ub + (int64_t)(t + q) * d);
  }
  for (; t < t1; ++t)
    conv_row<T, V>(hist, wt, bv, has_bias, load(xb + (int64_t)t * xs),
                   ub + (int64_t)t * d);

  // the last step tile holds the last K-1 inputs (from the window where
  // T < K-1): the state's new window, exact in T
  if (win_out != nullptr && t1 == steps) {
#pragma unroll
    for (int j = 0; j < K - 1; ++j)
      store(win_out + ((int64_t)b * (K - 1) + j) * d + col, hist[j]);
  }
}

template <typename T>
int launch(const void* x, const void* win, const void* w, const void* bias,
           void* u, void* win_out, int b, int steps, int d, int k, int xs,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  auto aligned = [](const void* p) {
    return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  if (b <= 0 || b > 65535 || steps <= 0 || d <= 0 || d % V || xs < d ||
      xs % V || k != K || (steps + CONV_ROWS - 1) / CONV_ROWS > 65535 ||
      !aligned(x) || !aligned(win) || !aligned(w) || !aligned(bias) ||
      !aligned(u) || !aligned(win_out))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((d / V + CONV_THREADS - 1) / CONV_THREADS),
                  (unsigned)((steps + CONV_ROWS - 1) / CONV_ROWS),
                  (unsigned)b);
  mamba_conv_silu<T><<<grid, CONV_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(win),
      static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(u), static_cast<T*>(win_out), steps, d, xs);
  return (int)cudaGetLastError();
}

}  // namespace

// x: [b, steps, d] with row stride xs (batch stride steps * xs); window,
// window_out: [b, k-1, d] or null; w: [k, d]; bias: [d] or null; u: [b,
// steps, d]; k = 4.
#define MAMBA_CONV_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* x, const void* window, const void* w,    \
                      const void* bias, void* u, void* window_out, int b,  \
                      int steps, int d, int k, int xs, void* stream) {     \
    return launch<T>(x, window, w, bias, u, window_out, b, steps, d, k,    \
                     xs, static_cast<cudaStream_t>(stream));               \
  }
MAMBA_CONV_ENTRY(mamba_conv_f32, float)
MAMBA_CONV_ENTRY(mamba_conv_bf16, __nv_bfloat16)
