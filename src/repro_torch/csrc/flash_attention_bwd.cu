// Flash attention backward, for Hopper (sm_90a).
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
// Both routes take two passes and no float atomics, so two runs give the
// same bytes: one over key tiles that loops the GQA group's query heads
// and their query tiles (dK, dV accumulate in registers in a fixed order
// and are written once), one over query tiles that walks the key tiles
// its rows see (dQ in registers), after a pre-pass for delta.  Both
// recompute S and dP.
//
// What bounds it: operations.  At the Llama-3.2-1B training shape (q
// [4, 32, 2048, 64], k/v [4, 8, 2048, 64], causal) the mask keeps
// 268,566,528 (query, key) pairs; the gradient needs five products of
// 2 D operations a pair (10 D), ~172 GFLOP, against ~84 MB of inputs
// and ~42 MB of outputs: 0.174 ms at the tensor cores' 989 TFLOP/s in
// bf16.  Two passes recompute S and dP, 14 D a pair: 0.243 ms.
//
// The "wgmma" route (bf16 at D = 64 and 128): flash_bwd_prep_wgmma, then
// flash_bwd_dkdv_wgmma and flash_bwd_dq_wgmma, each a block of three
// warpgroups a work item, the heaviest items first.  Warpgroup 2 is the
// producer: after setmaxnreg hands its registers to the consumers, one
// thread loads every tile by TMA (3-D maps, so rows past a head's end
// arrive as zeros) into 128-byte-swizzled shared memory, and lse and
// delta rows by bulk copy, each buffer and ring stage with a full and an
// empty mbarrier.  Warpgroups 0 and 1 own 64 rows each and run all five
// products as wgmma m64n64k16 with f32 accumulators in registers:
//   dkdv (item: kv head x 128 keys; K and V resident; Q, dO, lse, delta
//   of each 64-row query tile through a two-stage ring): S^T = K Q^T and
//   dP^T = V dO^T from shared memory (both operands K-major), so that P^T
//   and dS^T land in the accumulator layout that is wgmma's A fragment;
//   P^T = exp2(S^T scale log2e - lse log2e), lse and delta read per
//   column; dS^T = P^T o (dP^T - delta); dV += P^T dO and dK += dS^T Q
//   with A from registers (rounded to bf16) and B read MN-major.
//   dq (item: query head x 128 rows; Q, dO, lse, delta resident; K and V
//   of each 64-key tile through a two-stage ring): S = Q K^T, dP = dO
//   V^T, dS = P o (dP - delta), dQ += dS K with K read MN-major.
// The pre-pass writes delta and lse log2e (+inf past Sq) into rows padded
// to 128, so a tile's rows are one aligned bulk copy and rows past Sq get
// P = 0.  Key and query tiles that the mask empties for a whole item are
// never loaded; the mask runs only on tiles that the diagonal, the
// window's edge or Sk's end cross, as a separate branch.
//
// The "simt" route (f32 at every D, bf16 at D = 16, 32, 96), the first
// design: flash_bwd_delta (one warp a row), flash_bwd_dkdv (one block of
// 256 threads a kv head x 64 keys; K and V in shared memory as float32)
// and flash_bwd_dq (one block a query head x 64 rows).  Each 64 x 64
// product (S = Q K^T, dP = dO V^T) gives a thread a 4 x 4 register tile
// (rows ty + 16 i, columns tx + 16 j); the tile rows are padded to D + 1
// floats so that 16 threads reading 16 rows at one column hit 16 banks.
// Everything is float32 on the CUDA cores (67 TFLOP/s at best), with
// bf16 inputs widened as they are staged.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns
// cudaGetLastError() of its launches (0 = success), or
// cudaErrorInvalidValue for a head dim it was not built for (or a tensor
// map that cannot be encoded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // the wgmma, mbarrier and TMA helpers

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

// ---------------------------------------------------------------------------
// bf16 at head dims 64 and 128: the tensor-core route
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int ITEM = 128;       // keys of a dkdv item, query rows of a dq item
constexpr int T = 64;           // rows of a streamed tile (dkdv: queries;
                                // dq: keys) and of a warpgroup's share
constexpr int STAGES = 2;       // ring depth
constexpr int PAD = 128;        // lse / delta rows padded to a multiple
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BIG = 1 << 30;

// Shared-memory plans, in bytes from a 1024-aligned base.  A tile of R
// rows x D columns is stored as D / 64 panels of R rows x 128 bytes, each
// in the 128-byte swizzle (16-byte chunk c of row r at chunk c ^ (r % 8)):
// the layout TMA's SWIZZLE_128B writes and wgmma's B128 descriptors read.
template <int D>
struct DkdvPlan {
  static constexpr int KV_BYTES = ITEM * D * 2;         // K or V
  static constexpr int TILE_BYTES = T * D * 2;          // one Q or dO tile
  static constexpr int K = 0;
  static constexpr int V = KV_BYTES;
  static constexpr int Q = 2 * KV_BYTES;                // + stage * TILE
  static constexpr int DO = Q + STAGES * TILE_BYTES;    // + stage * TILE
  static constexpr int LSE = DO + STAGES * TILE_BYTES;  // + stage * T * 4
  static constexpr int DELTA = LSE + STAGES * T * 4;    // + stage * T * 4
  static constexpr int BARS = DELTA + STAGES * T * 4;
  static constexpr int BYTES = BARS + 64 + 1024;        // + alignment slack
};

template <int D>
struct DqPlan {
  static constexpr int Q_BYTES = ITEM * D * 2;          // Q or dO
  static constexpr int TILE_BYTES = T * D * 2;          // one K or V tile
  static constexpr int Q = 0;
  static constexpr int DO = Q_BYTES;
  static constexpr int K = 2 * Q_BYTES;                 // + stage * TILE
  static constexpr int V = K + STAGES * TILE_BYTES;     // + stage * TILE
  static constexpr int LSE = V + STAGES * TILE_BYTES;
  static constexpr int DELTA = LSE + ITEM * 4;
  static constexpr int BARS = DELTA + ITEM * 4;
  static constexpr int BYTES = BARS + 64 + 1024;
};

// d[32] (+)= A[64 x 16] . B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da,
                                                   uint64_t db,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory into
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// A tile's rows [r0, r0 + ROWS) of all D columns: D / 64 panels of ROWS
// rows, each as ROWS / 64 boxes.
template <int D, int ROWS>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int r0, int mat) {
#pragma unroll
  for (int pn = 0; pn < D / PANEL_COLS; ++pn)
#pragma unroll
    for (int h = 0; h < ROWS; h += T)
      tma_load(dst + pn * ROWS * 128 + h * 128, map, bar, pn * PANEL_COLS,
               r0 + h, mat);
}

// Issue acc[32] = A . B^T for A's 64 rows at a_s (in panels of a_panel
// bytes) and B's 64 rows at b_s (panels of T rows), both [rows, D]
// K-major in shared memory.
template <int D>
__device__ __forceinline__ void issue_abt(float (&acc)[32], uint32_t a_s,
                                          int a_panel, uint32_t b_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int panel = kk / 4, off = (kk % 4) * 32;
    wgmma_m64n64k16_ss(acc, desc_sw128(a_s + panel * a_panel + off, 16, 1024),
                       desc_sw128(b_s + panel * T * 128 + off, 16, 1024),
                       kk > 0);
  }
}

// Issue acc[D / 2] += A . B: A [64 x 64] from registers (bf16 pairs in the
// accumulator layout of a 64 x 64 product, which is wgmma's A fragment),
// B [64 rows, D] at b_s read MN-major.
template <int D>
__device__ __forceinline__ void issue_ab(float (&acc)[D / 2],
                                         const uint32_t (&a)[16],
                                         uint32_t b_s) {
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk) {
#pragma unroll
    for (int panel = 0; panel < D / PANEL_COLS; ++panel)
      wgmma_m64n64k16_rs(
          acc + panel * 32, a + 4 * kk,
          desc_sw128(b_s + panel * T * 128 + kk * 16 * 128, T * 128, 1024));
  }
}

// Per-thread view of the m64n64 accumulator: element j = 2k + e of the
// thread's 32 sits in row (warp % 4) * 16 + lane / 4 + 8 * (k & 1) and
// column (k / 2) * 8 + (lane % 4) * 2 + e.
//
// One tile of dS (dS^T in dkdv) from S (S^T) and dP (dP^T) in the
// accumulators: p = exp2(s * scale_log2 - lse2), ds = p (dp - delta),
// packed to bf16 pairs (p into pp when it is given).  lse2 and delta are
// per row (ROWS: the thread's two rows' values in l[0..1], d[0..1]) or per
// column (the tile's 64 in shared memory at l, d).  MASK (a tile that the
// diagonal, the window's edge or an end crosses): an element is kept
// where its column, counted from the thread's first, lies in its row's
// [lo, hi), and gets p = 0 elsewhere.
template <bool MASK, bool ROWS>
__device__ __forceinline__ void grad_tile(const float (&s)[32],
                                          const float (&dp)[32],
                                          const float* l, const float* d,
                                          const int (&lo)[2],
                                          const int (&hi)[2], float scale_log2,
                                          int lane, uint32_t* pp,
                                          uint32_t (&pds)[16]) {
#pragma unroll
  for (int cb = 0; cb < 8; ++cb) {  // 8-column block
    float lc[2] = {0.f, 0.f}, dc[2] = {0.f, 0.f};
    if (!ROWS) {
      const int c = cb * 8 + (lane % 4) * 2;
      const float2 lv = *reinterpret_cast<const float2*>(l + c);
      const float2 dv = *reinterpret_cast<const float2*>(d + c);
      lc[0] = lv.x;
      lc[1] = lv.y;
      dc[0] = dv.x;
      dc[1] = dv.y;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 2 * cb + h;
      float p2[2], d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 2 * k + e;
        const float lse2 = ROWS ? l[h] : lc[e];
        const float del = ROWS ? d[h] : dc[e];
        float x = fmaf(s[j], scale_log2, -lse2);
        if (MASK) {
          const int col = cb * 8 + e;
          x = (col >= lo[h] && col < hi[h]) ? x : -INFINITY;
        }
        const float p = ex2(x);
        p2[e] = p;
        d2[e] = p * (dp[j] - del);
      }
      if (pp != nullptr) pp[k] = pack_bf16(p2[0], p2[1]);
      pds[k] = pack_bf16(d2[0], d2[1]);
    }
  }
}

// Store a warpgroup's 64 rows of acc * scale as bf16 rows of `out` (D
// columns): rows first_row + warp * 16 + lane / 4 + {0, 8}, those < n.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           __nv_bfloat16* out, int first_row,
                                           int n, float scale, int warp,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = first_row + warp * 16 + lane / 4 + 8 * h;
    if (r >= n) continue;
    __nv_bfloat16* row = out + (int64_t)r * D;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb) {
      const int c = jb * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(
          acc[4 * jb + 2 * h] * scale, acc[4 * jb + 2 * h + 1] * scale);
    }
  }
}

// delta = rowsum(dO o O) and lse2 = lse log2e into rows padded to sq_pad
// (0 and +inf past sq); one warp a row.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_wgmma(const __nv_bfloat16* __restrict__ o,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ lse2,
                     float* __restrict__ delta, int sq, int sq_pad,
                     int64_t rows) {
  constexpr int PER = D / 32;  // bf16 a lane: 2 or 4
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int64_t bh = row / sq_pad;
  const int i = (int)(row % sq_pad);
  float acc = 0.f, l2 = INFINITY;
  if (i < sq) {
    const int64_t at = (bh * sq + i) * D + lane * PER;
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(o + at);
    const __nv_bfloat162* d2 =
        reinterpret_cast<const __nv_bfloat162*>(dout + at);
#pragma unroll
    for (int p = 0; p < PER / 2; ++p) {
      const float2 a = __bfloat1622float2(o2[p]);
      const float2 b = __bfloat1622float2(d2[p]);
      acc += a.x * b.x + a.y * b.y;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    l2 = lse[bh * sq + i] * LOG2E;
  }
  if (lane == 0) {
    lse2[row] = l2;
    delta[row] = acc;
  }
}

// dK, dV: one block a (kv head, 128-key tile), key tile 0 first (the
// heaviest under a causal mask).  Warpgroup w owns keys k0 + 64 w.. and
// walks the group's heads and the 64-row query tiles that see a key of
// the block's tile.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ lse2,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int bkv, int sq,
                     int sq_pad, int sk, int group, float scale,
                     float scale_log2, int causal, int use_window,
                     int window) {
  using P = DkdvPlan<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = base + P::BARS;
  const uint32_t full = kv_full + 8;           // + 8 * stage
  const uint32_t empty = full + 8 * STAGES;    // + 8 * stage

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // 0, 1: consumers; 2: the producer
  const bool masked = causal || use_window;
  const int shift = sk - sq;
  const int kvh = blockIdx.x % bkv;
  const int k0 = (blockIdx.x / bkv) * ITEM;
  // query rows that see a key of the tile (qpos >= k0 when masked, qpos <
  // k0 + ITEM - 1 + window when windowed), from a tile boundary
  int q_lo = masked ? max(0, k0 - shift) : 0;
  q_lo = (q_lo / T) * T;
  const int q_hi =
      use_window ? (int)min((int64_t)sq,
                            (int64_t)k0 + ITEM - 1 + window - shift)
                 : sq;
  const int n_q = q_hi > q_lo ? (q_hi - q_lo + T - 1) / T : 0;
  const int n_tiles = group * n_q;

  if (tid == 0) {
    mbar_init(kv_full, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    if (tid == CONSUMERS && n_tiles > 0) {
      mbar_expect_tx(kv_full, 2 * P::KV_BYTES);
      tma_rows<D, ITEM>(base + P::K, &k_map, kv_full, k0, kvh);
      tma_rows<D, ITEM>(base + P::V, &v_map, kv_full, k0, kvh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const int bh = kvh * group + t / n_q;
        const int q0 = q_lo + (t % n_q) * T;
        mbar_wait(empty + 8 * st, ((t / STAGES) & 1) ^ 1);
        const uint32_t bar = full + 8 * st;
        mbar_expect_tx(bar, 2 * P::TILE_BYTES + 2 * T * 4);
        tma_rows<D, T>(base + P::Q + st * P::TILE_BYTES, &q_map, bar, q0,
                       bh);
        tma_rows<D, T>(base + P::DO + st * P::TILE_BYTES, &do_map, bar, q0,
                       bh);
        const int64_t at = (int64_t)bh * sq_pad + q0;
        bulk_load(base + P::LSE + st * T * 4, lse2 + at, T * 4, bar);
        bulk_load(base + P::DELTA + st * T * 4, delta + at, T * 4, bar);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int wk0 = k0 + wgi * T;  // this warpgroup's keys
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;

    if (n_tiles > 0) {
      mbar_wait(kv_full, 0);
      const uint32_t k_wg = base + P::K + wgi * T * 128;
      const uint32_t v_wg = base + P::V + wgi * T * 128;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const int q0 = q_lo + (t % n_q) * T;
        const uint32_t q_s = base + P::Q + st * P::TILE_BYTES;
        const uint32_t do_s = base + P::DO + st * P::TILE_BYTES;
        mbar_wait(full + 8 * st, (t / STAGES) & 1);

        float s[32], dp[32];
        wgmma_fence();
        issue_abt<D>(s, k_wg, ITEM * 128, q_s);     // S^T = K Q^T
        issue_abt<D>(dp, v_wg, ITEM * 128, do_s);   // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        // each of the thread's two keys sees query columns [lo, hi),
        // counted from its first column q0 + (lane % 4) * 2
        const int first = q0 + shift + (lane % 4) * 2;
        int lo[2], hi[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kpos = wk0 + warp * 16 + lane / 4 + 8 * h;
          lo[h] = kpos >= sk ? BIG : (masked ? kpos - first : -BIG);
          hi[h] = use_window ? (int)min((int64_t)kpos + window - first,
                                        (int64_t)BIG)
                             : BIG;
        }
        const bool mask_tile =
            (wk0 + T > sk) || (masked && q0 + shift < wk0 + T - 1) ||
            (use_window && q0 + T - 1 + shift >= wk0 + window);
        const float* l_s =
            reinterpret_cast<const float*>(smem + P::LSE + st * T * 4);
        const float* d_s =
            reinterpret_cast<const float*>(smem + P::DELTA + st * T * 4);
        uint32_t pp[16], pds[16];
        if (mask_tile)
          grad_tile<true, false>(s, dp, l_s, d_s, lo, hi, scale_log2, lane,
                                 pp, pds);
        else
          grad_tile<false, false>(s, dp, l_s, d_s, lo, hi, scale_log2, lane,
                                  pp, pds);

        wgmma_fence();
        issue_ab<D>(dv_acc, pp, do_s);  // dV += P^T dO
        issue_ab<D>(dk_acc, pds, q_s);  // dK += dS^T Q
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        mbar_arrive(empty + 8 * st);  // the stage is read
      }
    }
    const int64_t at = (int64_t)kvh * sk * D;
    store_rows<D>(dk_acc, dk + at, wk0, sk, scale, warp, lane);
    store_rows<D>(dv_acc, dv + at, wk0, sk, 1.f, warp, lane);
  }
}

// dQ: one block a (query head, 128-row query tile), the last query tiles
// first (the heaviest under a causal mask).  Warpgroup w owns rows q0 +
// 64 w.. and walks the 64-key tiles the block's rows see.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const float* __restrict__ lse2,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int bh_count, int sq,
                   int sq_pad, int sk, int group, float scale,
                   float scale_log2, int causal, int use_window,
                   int window) {
  using P = DqPlan<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint8_t* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_full = base + P::BARS;
  const uint32_t k_full = q_full + 8;           // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES;  // + 8 * stage
  const uint32_t empty = v_full + 8 * STAGES;   // + 8 * stage

  const int tid = threadIdx.x;
  const int wgi = tid / 128;
  const bool masked = causal || use_window;
  const int shift = sk - sq;
  const int n_qtiles = (sq + ITEM - 1) / ITEM;
  const int bh = blockIdx.x % bh_count;
  const int q0 = (n_qtiles - 1 - (int)(blockIdx.x / bh_count)) * ITEM;
  const int kvh = bh / group;
  // keys any row of the block sees (as the forward's)
  const int q_first = q0 + shift;
  const int q_last = min(q0 + ITEM, sq) - 1 + shift;
  const int k_end = masked ? min(sk, q_last + 1) : sk;
  int k_begin = use_window ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / T) * T;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + T - 1) / T : 0;

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(empty + 8 * st, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PRODUCER_REGS));
    if (tid == CONSUMERS && n_tiles > 0) {
      mbar_expect_tx(q_full, 2 * P::Q_BYTES + 2 * ITEM * 4);
      tma_rows<D, ITEM>(base + P::Q, &q_map, q_full, q0, bh);
      tma_rows<D, ITEM>(base + P::DO, &do_map, q_full, q0, bh);
      const int64_t at = (int64_t)bh * sq_pad + q0;
      bulk_load(base + P::LSE, lse2 + at, ITEM * 4, q_full);
      bulk_load(base + P::DELTA, delta + at, ITEM * 4, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const int k0 = k_begin + t * T;
        mbar_wait(empty + 8 * st, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full + 8 * st, P::TILE_BYTES);
        tma_rows<D, T>(base + P::K + st * P::TILE_BYTES, &k_map,
                       k_full + 8 * st, k0, kvh);
        mbar_expect_tx(v_full + 8 * st, P::TILE_BYTES);
        tma_rows<D, T>(base + P::V + st * P::TILE_BYTES, &v_map,
                       v_full + 8 * st, k0, kvh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        CONSUMER_REGS));
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int wq0 = q0 + wgi * T;  // this warpgroup's rows
    float dq_acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq_acc[j] = 0.f;

    if (n_tiles > 0) {
      mbar_wait(q_full, 0);
      // keys [key_lo, key_hi) of the thread's two rows, and their lse2
      // and delta
      int key_lo[2], key_hi[2];
      float l[2], d[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wgi * T + warp * 16 + lane / 4 + 8 * h;
        const int qpos = q0 + r + shift;
        key_lo[h] = use_window ? max(qpos - window + 1, 0) : 0;
        key_hi[h] = masked ? min(qpos + 1, sk) : sk;
        l[h] = reinterpret_cast<const float*>(smem + P::LSE)[r];
        d[h] = reinterpret_cast<const float*>(smem + P::DELTA)[r];
      }
      const int wq_first = wq0 + shift, wq_last = wq_first + T - 1;
      const uint32_t q_wg = base + P::Q + wgi * T * 128;
      const uint32_t do_wg = base + P::DO + wgi * T * 128;
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const uint32_t parity = (t / STAGES) & 1;
        const int k0 = k_begin + t * T;
        const uint32_t k_s = base + P::K + st * P::TILE_BYTES;
        const uint32_t v_s = base + P::V + st * P::TILE_BYTES;

        float s[32], dp[32];
        mbar_wait(k_full + 8 * st, parity);
        mbar_wait(v_full + 8 * st, parity);
        wgmma_fence();
        issue_abt<D>(s, q_wg, ITEM * 128, k_s);    // S = Q K^T
        issue_abt<D>(dp, do_wg, ITEM * 128, v_s);  // dP = dO V^T
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
        fence_regs(dp);

        const bool mask_tile = (k0 + T > sk) ||
                               (masked && k0 + T - 1 > wq_first) ||
                               (use_window && k0 <= wq_last - window);
        const int first = k0 + (lane % 4) * 2;
        const int lo[2] = {key_lo[0] - first, key_lo[1] - first};
        const int hi[2] = {key_hi[0] - first, key_hi[1] - first};
        uint32_t pds[16];
        if (mask_tile)
          grad_tile<true, true>(s, dp, l, d, lo, hi, scale_log2, lane,
                                nullptr, pds);
        else
          grad_tile<false, true>(s, dp, l, d, lo, hi, scale_log2, lane,
                                 nullptr, pds);

        wgmma_fence();
        issue_ab<D>(dq_acc, pds, k_s);  // dQ += dS K
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dq_acc);
        mbar_arrive(empty + 8 * st);
      }
    }
    store_rows<D>(dq_acc, dq + (int64_t)bh * sq * D, wq0, sq, scale, warp,
                  lane);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* scratch, void* dq,
           void* dk, void* dv, int bh, int sq, int sk, int group,
           float scale, int causal, int use_window, int window,
           cudaStream_t stream) {
  if (sq == 0 && sk == 0) return 0;
  const int sq_pad = (sq + PAD - 1) / PAD * PAD;
  float* lse2 = scratch;
  float* delta = scratch + (int64_t)bh * sq_pad;
  const int64_t rows = (int64_t)bh * sq_pad;
  if (rows > 0) {
    flash_bwd_prep_wgmma<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const __nv_bfloat16*>(dout), lse, lse2, delta, sq,
        sq_pad, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // with no queries (keys) nothing reads Q and dO (K and V): map the
  // other side's rows in their place
  const int bkv = bh / group;
  const bool qs = sq > 0, ks = sk > 0;
  CUtensorMap q_map, k_map, v_map, do_map;
  const int q_mats = qs ? bh : bkv, q_rows = qs ? sq : sk;
  const int k_mats = ks ? bkv : bh, k_rows = ks ? sk : sq;
  if (!make_map(&q_map, qs ? q : k, q_mats, q_rows, D, T) ||
      !make_map(&do_map, qs ? dout : k, q_mats, q_rows, D, T) ||
      !make_map(&k_map, ks ? k : q, k_mats, k_rows, D, T) ||
      !make_map(&v_map, ks ? v : q, k_mats, k_rows, D, T))
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = scale * LOG2E;
  if (ks) {
    constexpr int smem = DkdvPlan<D>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t items = (int64_t)bkv * ((sk + ITEM - 1) / ITEM);
    flash_bwd_dkdv_wgmma<D><<<(unsigned)items, THREADS, smem, stream>>>(
        q_map, k_map, v_map, do_map, lse2, delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        bkv, sq, sq_pad, sk, group, scale, scale_log2, causal, use_window,
        window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (qs) {
    constexpr int smem = DqPlan<D>::BYTES;
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t items = (int64_t)bh * ((sq + ITEM - 1) / ITEM);
    flash_bwd_dq_wgmma<D><<<(unsigned)items, THREADS, smem, stream>>>(
        q_map, k_map, v_map, do_map, lse2, delta,
        static_cast<__nv_bfloat16*>(dq), bh, sq, sq_pad, sk, group, scale,
        scale_log2, causal, use_window, window);
  }
  return (int)cudaGetLastError();
}

}  // namespace wg

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

// bf16 on the tensor-core route; d in {64, 128}.  scratch: float32 [2, bh,
// sq_pad], sq_pad = sq rounded up to a multiple of 128 (the pre-pass's lse
// log2e and delta); q, k, v, dout 16-byte aligned.
extern "C" int flash_attention_bwd_bf16_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* scratch, void* dq, void* dk,
    void* dv, int bh, int sq, int sk, int d, int group, float scale,
    int causal, int use_window, int window, void* stream) {
  if (bh == 0) return 0;
  const float* lse_f = static_cast<const float*>(lse);
  float* scratch_f = static_cast<float*>(scratch);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return wg::launch<64>(q, k, v, o, dout, lse_f, scratch_f, dq, dk, dv,
                            bh, sq, sk, group, scale, causal, use_window,
                            window, s);
    case 128:
      return wg::launch<128>(q, k, v, o, dout, lse_f, scratch_f, dq, dk, dv,
                             bh, sq, sk, group, scale, causal, use_window,
                             window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
