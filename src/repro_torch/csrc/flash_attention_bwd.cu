// Flash attention backward, for Hopper (sm_90a), on the CUDA cores.
//
// The reference has no backward kernel: it trains through XLA's autodiff
// of attention_ref / chunked_attention, and jax.grad through its Pallas
// kernel (src/repro/kernels/flash_attention/kernel.py:_flash_kernel)
// raises.  The port's forward is the flash kernel (flash_attention.cu),
// so its gradient is this kernel: it computes dq, dk and dv exactly as
// the gradient of attention_ref would be, on the forward's flattened
// layout q, o, do [BH, Sq, D], k, v [BKV, Sk, D], BH = BKV * group:
//   kv head of query head bh = bh / group       (GQA: dk, dv sum over the
//                                                group's query heads)
//   qpos = i + (Sk - Sq)                        (right-aligned queries)
//   mask = i < Sq & kpos < Sk [& qpos >= kpos if causal or windowed]
//                             [& kpos > qpos - window if windowed]
//   P = mask ? exp(sm_scale * q.k - lse) : 0    (recomputed from the
//                                                forward's row lse)
//   dV = P^T dO;  dP = dO V^T;  delta = rowsum(dO o O)
//   dS = P o (dP - delta);  dQ = sm_scale dS K;  dK = sm_scale dS^T Q
// A query row that sees no key has lse = +inf from the forward, P = 0,
// and so a zero gradient, consistent with its zero output.
//
// Design (the first, simple one): three launches, no float atomics, so
// two runs give the same bytes.
//   flash_bwd_delta: one warp a row, delta = rowsum(dO o O) in float32.
//   flash_bwd_dkdv: one block of 256 threads a (kv head, 64-key tile); K
//     and V stay in shared memory as float32 while the block walks the
//     group's query heads and, for each, the 64-row query tiles whose
//     rows see a key of the tile; dK and dV accumulate in registers in a
//     fixed order and are written once.
//   flash_bwd_dq: one block a (query head, 64-row query tile); Q, dO, lse
//     and delta stay in shared memory while it walks the key tiles its
//     rows see; dQ accumulates in registers.
// Each 64 x 64 product (S = Q K^T, dP = dO V^T) gives a thread a 4 x 4
// register tile (rows ty + 16 i, columns tx + 16 j); the tile rows are
// padded to D + 1 floats so that 16 threads reading 16 rows at one column
// hit 16 banks.  Everything is float32 on the CUDA cores, with bf16 inputs
// widened as they are staged.
//
// What bounds it: operations.  At the Llama-3.2-1B training shape (q
// [4, 32, 2048, 64], k/v [4, 8, 2048, 64], causal) the mask keeps
// 268,566,528 (query, key) pairs; the gradient needs five products of
// 2 D operations a pair (10 D), ~172 GFLOP, against ~84 MB of inputs
// and ~42 MB of outputs: 0.174 ms at the tensor cores' 989 TFLOP/s in
// bf16.  This design recomputes S and dP in both passes (16 D a pair) on
// the CUDA cores (67 TFLOP/s at best in float32), so it sits far above
// that bound; wgmma and TMA are later work.
//
// Interface: plain C, loaded with ctypes.  The launcher returns
// cudaGetLastError() of its launches (0 = success), or
// cudaErrorInvalidValue for a head dim it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // query rows and keys per tile
constexpr int THREADS = 256;  // 16 x 16 threads over a 64 x 64 tile
constexpr int LDS = TILE + 1; // padded row of a 64 x 64 score tile

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
  return __float2bfloat16(x);
}

// Shared-memory plan (floats) of both tile kernels: four row tiles of
// TILE x (D + 1) and two score tiles of TILE x (TILE + 1), then two rows
// of TILE floats.
template <int D>
struct Plan {
  static constexpr int LD = D + 1;
  static constexpr int ROWS = TILE * LD;
  static constexpr int SCORES = TILE * LDS;
  static constexpr int FLOATS = 4 * ROWS + 2 * SCORES + 2 * TILE;
  static constexpr int BYTES = FLOATS * 4;
};

// rows [r0, r0 + TILE) of a [n, D] matrix into dst [TILE][D + 1] as
// float32; rows at or past n as zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int r0, int n) {
  for (int idx = threadIdx.x; idx < TILE * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * (D + 1) + c] =
        r0 + r < n ? to_f(src[(int64_t)(r0 + r) * D + c]) : 0.f;
  }
}

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d] over a thread's 4 x 4
// register tile of a 64 x 64 product.
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4],
                                         const float* __restrict__ a,
                                         const float* __restrict__ b, int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * (D + 1) + d];
      bv[i] = b[(tx + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
  }
}

struct Mask {
  int sq, sk, shift, window;
  bool masked, use_window;
  __device__ __forceinline__ bool ok(int i, int kpos) const {
    if (i >= sq || kpos >= sk) return false;
    const int qpos = i + shift;
    if (masked && qpos < kpos) return false;
    if (use_window && kpos <= qpos - window) return false;
    return true;
  }
};

// The 64 x 64 tile of dS = P o (dP - delta) for query rows q0.. against
// keys k0..; writes P (if p_out) and dS into shared memory.  qs, dos:
// staged Q and dO rows; ks, vs: staged K and V rows; lse, delta: the
// rows' values.
template <int D>
__device__ __forceinline__ void score_tiles(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse, const float* delta, float* p_out, float* ds_out,
    int q0, int k0, float scale, const Mask& mk) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
  dot_tile<D>(s, qs, ks, ty, tx);
  dot_tile<D>(dp, dos, vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p =
          mk.ok(q0 + r, k0 + c) ? __expf(s[i][j] * scale - lse[r]) : 0.f;
      if (p_out) p_out[r * LDS + c] = p;
      ds_out[r * LDS + c] = p * (dp[i][j] - delta[r]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
                float* __restrict__ delta, int64_t rows, int d) {
  const int64_t row = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32)
    acc += to_f(o[row * d + c]) * to_f(dout[row * d + c]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk,
               T* __restrict__ dv, int sq, int sk, int group, float scale,
               int causal, int use_window, int window) {
  using P = Plan<D>;
  constexpr int NE = D / 16;  // columns a thread owns
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + P::ROWS;
  float* qs = vs + P::ROWS;
  float* dos = qs + P::ROWS;
  float* ps = dos + P::ROWS;
  float* dss = ps + TILE * LDS;
  float* lse_s = dss + TILE * LDS;
  float* delta_s = lse_s + TILE;

  const int kvh = blockIdx.x;
  const int k0 = blockIdx.y * TILE;
  const Mask mk{sq, sk, sk - sq, window, causal || use_window,
                use_window != 0};
  const int64_t kv_off = (int64_t)kvh * sk * D;
  stage<T, D>(ks, k + kv_off, k0, sk);
  stage<T, D>(vs, v + kv_off, k0, sk);

  // query rows that see a key of this tile: qpos >= k0 when masked,
  // qpos <= k0 + TILE - 2 + window when windowed
  int q_lo = 0, q_hi = sq;
  if (mk.masked) q_lo = max(0, k0 - mk.shift);
  if (use_window)
    q_hi = (int)min((int64_t)sq,
                    (int64_t)k0 + TILE - 1 + window - mk.shift);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float dk_acc[4][NE], dv_acc[4][NE];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < NE; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int bh = kvh * group + g;
    const int64_t q_off = (int64_t)bh * sq * D;
    for (int q0 = q_lo; q0 < q_hi; q0 += TILE) {
      __syncthreads();  // the previous tile's readers are done
      stage<T, D>(qs, q + q_off, q0, sq);
      stage<T, D>(dos, dout + q_off, q0, sq);
      for (int r = threadIdx.x; r < TILE; r += THREADS) {
        const bool in = q0 + r < sq;
        lse_s[r] = in ? lse[(int64_t)bh * sq + q0 + r] : INFINITY;
        delta_s[r] = in ? delta[(int64_t)bh * sq + q0 + r] : 0.f;
      }
      __syncthreads();
      score_tiles<D>(qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0, scale,
                     mk);
      __syncthreads();
      // dV[c][e] += P[r][c] dO[r][e]; dK[c][e] += dS[r][c] Q[r][e]
#pragma unroll 4
      for (int r = 0; r < TILE; ++r) {
        float pv[4], dsv[4], dov[NE], qv[NE];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[r * LDS + tx + 16 * i];
          dsv[i] = dss[r * LDS + tx + 16 * i];
        }
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          dov[e] = dos[r * P::LD + ty + 16 * e];
          qv[e] = qs[r * P::LD + ty + 16 * e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < NE; ++e) {
            dv_acc[i][e] += pv[i] * dov[e];
            dk_acc[i][e] += dsv[i] * qv[e];
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = k0 + tx + 16 * i;
    if (c >= sk) continue;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int64_t at = kv_off + (int64_t)c * D + ty + 16 * e;
      dk[at] = from_f<T>(dk_acc[i][e] * scale);
      dv[at] = from_f<T>(dv_acc[i][e]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int sq, int sk, int group, float scale,
             int causal, int use_window, int window) {
  using P = Plan<D>;
  constexpr int NE = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + P::ROWS;
  float* ks = dos + P::ROWS;
  float* vs = ks + P::ROWS;
  float* dss = vs + P::ROWS + TILE * LDS;
  float* lse_s = dss + TILE * LDS;
  float* delta_s = lse_s + TILE;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TILE;  // heaviest first
  const Mask mk{sq, sk, sk - sq, window, causal || use_window,
                use_window != 0};
  const int64_t q_off = (int64_t)bh * sq * D;
  const int64_t kv_off = (int64_t)(bh / group) * sk * D;
  stage<T, D>(qs, q + q_off, q0, sq);
  stage<T, D>(dos, dout + q_off, q0, sq);
  for (int r = threadIdx.x; r < TILE; r += THREADS) {
    const bool in = q0 + r < sq;
    lse_s[r] = in ? lse[(int64_t)bh * sq + q0 + r] : INFINITY;
    delta_s[r] = in ? delta[(int64_t)bh * sq + q0 + r] : 0.f;
  }

  // keys any row of this tile sees (as the forward's)
  const int q_first = q0 + mk.shift;
  const int q_last = min(q0 + TILE, sq) - 1 + mk.shift;
  const int k_end = mk.masked ? min(sk, q_last + 1) : sk;
  const int k_begin = use_window ? max(0, q_first - window + 1) : 0;

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float dq_acc[4][NE];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < NE; ++e) dq_acc[i][e] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += TILE) {
    __syncthreads();  // the previous tile's readers are done
    stage<T, D>(ks, k + kv_off, k0, sk);
    stage<T, D>(vs, v + kv_off, k0, sk);
    __syncthreads();
    score_tiles<D>(qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0, k0,
                   scale, mk);
    __syncthreads();
    // dQ[r][e] += dS[r][c] K[c][e]; the thread owns rows tx + 16 i
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float dsv[4], kv[NE];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(tx + 16 * i) * LDS + c];
#pragma unroll
      for (int e = 0; e < NE; ++e) kv[e] = ks[c * P::LD + ty + 16 * e];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < NE; ++e) dq_acc[i][e] += dsv[i] * kv[e];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tx + 16 * i;
    if (r >= sq) continue;
#pragma unroll
    for (int e = 0; e < NE; ++e)
      dq[q_off + (int64_t)r * D + ty + 16 * e] =
          from_f<T>(dq_acc[i][e] * scale);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, const T* dout,
             const float* lse, const float* delta, T* dq, T* dk, T* dv,
             int bh, int sq, int sk, int group, float scale, int causal,
             int use_window, int window, cudaStream_t stream) {
  constexpr int smem = Plan<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  if (sk > 0) {
    const dim3 grid(bh / group, (sk + TILE - 1) / TILE);
    flash_bwd_dkdv<T, D><<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, sq, sk, group, scale, causal,
        use_window, window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (sq > 0) {
    const dim3 grid(bh, (sq + TILE - 1) / TILE);
    flash_bwd_dq<T, D><<<grid, THREADS, smem, stream>>>(
        q, k, v, dout, lse, delta, dq, sq, sk, group, scale, causal,
        use_window, window);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int bh, int sq, int sk, int d, int group,
           float scale, int causal, int use_window, int window,
           cudaStream_t stream) {
  if (bh == 0) return 0;
  const int64_t rows = (int64_t)bh * sq;
  if (rows > 0) {
    const int per_block = THREADS / 32;
    flash_bwd_delta<T><<<(unsigned)((rows + per_block - 1) / per_block),
                         THREADS, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows,
        d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  T* dqp = static_cast<T*>(dq);
  T* dkp = static_cast<T*>(dk);
  T* dvp = static_cast<T*>(dv);
#define BWD_CASE(DIM)                                                     \
  case DIM:                                                               \
    return launch_d<T, DIM>(qp, kp, vp, dop, lse, delta, dqp, dkp, dvp,   \
                            bh, sq, sk, group, scale, causal, use_window, \
                            window, stream);
  switch (d) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(96)
    BWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

}  // namespace

// q, o, dout, dq: [bh, sq, d]; k, v, dk, dv: [bh / group, sk, d]; all
// contiguous, one dtype.  lse: the forward's [bh, sq] float32; delta:
// [bh, sq] float32 scratch.  d in {16, 32, 64, 96, 128}.  use_window != 0
// applies `window`.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int bh, int sq, int sk, int d, int group, float scale,
    int causal, int use_window, int window, void* stream) {
  return launch<float>(q, k, v, o, dout, static_cast<const float*>(lse),
                       static_cast<float*>(delta), dq, dk, dv, bh, sq, sk, d,
                       group, scale, causal, use_window, window,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int bh, int sq, int sk, int d, int group, float scale,
    int causal, int use_window, int window, void* stream) {
  return launch<__nv_bfloat16>(
      q, k, v, o, dout, static_cast<const float*>(lse),
      static_cast<float*>(delta), dq, dk, dv, bh, sq, sk, d, group, scale,
      causal, use_window, window, static_cast<cudaStream_t>(stream));
}
