// Flash attention forward (online softmax), for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/flash_attention/kernel.py:_flash_kernel
// (wrapper flash_attention_kernel).  It computes the same function on the
// flattened layout q [BH, Sq, D], k and v [BKV, Sk, D], o [BH, Sq, D]:
//   kv head of query head bh = bh / group       (GQA, never materialised)
//   qpos = i + (Sk - Sq)                        (right-aligned queries)
//   mask = kpos < Sk  [& qpos >= kpos if causal or windowed]
//                     [& kpos > qpos - window if windowed]
//   s = (q . k) * sm_scale, masked to NEG_INF = -1e30
//   online softmax over key tiles: m, l, acc in float32
//   o = acc / l, and 0 where l == 0 (a row that sees no key), cast to q's
//   dtype.
// K/V rows at or past Sk are never read: the tile staging zero-fills
// them, and the mask gives them p = 0, so no 0 * garbage reaches acc.
//
// Design (simple and right first; no tensor cores yet).  One block of 256
// threads per (bh, 64-row query tile); four adjacent threads share one
// query row, each holding a quarter of its q and of its acc in registers
// (interleaved 16-byte chunks, so a warp's shared-memory reads of a key
// row hit distinct banks).  The block walks 32-key K/V tiles staged in
// shared memory as float32: each thread takes partial dot products for
// the 32 keys, two __shfl_xor_sync steps complete them, and every thread
// of the row then runs the same online-softmax update on all 32 scores
// and rescales its quarter of acc.  Key tiles that the causal or window
// mask empties for the whole query tile are skipped, and the query tiles
// with the most keys are scheduled first (grid y runs backwards).
//
// What bounds it: operations.  Causal prefill at B=4, S=2048, 32 query /
// 8 KV heads, D=64 is ~68.7 GFLOP per call against ~84 MB of q, k, v and
// o, ~820 FLOP per byte: far above the ~295 at which the H100 turns
// compute-bound.  The bound is the tensor cores' 989 TFLOP/s in bf16;
// this kernel does its multiply-adds on the CUDA cores in float32 (67
// TFLOP/s at best) and reads every K/V element from shared memory once per
// four multiply-adds, so it sits far above that bound.  wgmma on
// TMA-staged tiles is the later step.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns
// cudaGetLastError() of its launch (0 = success), or cudaErrorInvalidValue
// for a head dim it was not built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;             // query rows per block
constexpr int BK = 32;             // keys per K/V tile
constexpr int TPR = 4;             // threads per query row
constexpr int THREADS = BQ * TPR;  // 256
constexpr float NEG_INF = -1e30f;

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
          int group, float scale, int causal, int use_window, int window) {
  static_assert(D % (4 * TPR) == 0, "D must be a multiple of 16");
  constexpr int NC = D / (4 * TPR);  // 16-byte chunks of a row per thread
  __shared__ float4 ks[BK][D / 4];
  __shared__ float4 vs[BK][D / 4];

  const int bh = blockIdx.x;
  const int qtile = gridDim.y - 1 - blockIdx.y;
  const int row = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int qi = qtile * BQ + row;
  const bool row_ok = qi < sq;
  const int shift = sk - sq;
  const int qpos = qi + shift;
  const bool masked = causal || use_window;

  const T* qrow = q + ((int64_t)bh * sq + (row_ok ? qi : 0)) * D;
  const int64_t kv_off = (int64_t)(bh / group) * sk * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  float4 qr[NC], acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int e = (t + TPR * c) * 4;
    qr[c] = row_ok ? make_float4(to_f(qrow[e]), to_f(qrow[e + 1]),
                                 to_f(qrow[e + 2]), to_f(qrow[e + 3]))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = NEG_INF, l = 0.f;

  // Keys any row of this tile can see.
  const int q_first = qtile * BQ + shift;
  const int q_last = min(qtile * BQ + BQ, sq) - 1 + shift;
  const int k_end = masked ? min(sk, q_last + 1) : sk;
  int k_begin = use_window ? max(0, q_first - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    float* kf = reinterpret_cast<float*>(ks);
    float* vf = reinterpret_cast<float*>(vs);
    const int64_t base = (int64_t)k0 * D;
    const int avail = min(BK, sk - k0) * D;
    for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
      const bool in = idx < avail;
      kf[idx] = in ? to_f(kb[base + idx]) : 0.f;
      vf[idx] = in ? to_f(vb[base + idx]) : 0.f;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = ks[j][t + TPR * c];
        part += qr[c].x * kk.x + qr[c].y * kk.y + qr[c].z * kk.z +
                qr[c].w * kk.w;
      }
      s[j] = part;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
    }

    unsigned ok_bits = 0u;
    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kpos = k0 + j;
      bool ok = kpos < sk;
      if (masked) ok = ok && qpos >= kpos;
      if (use_window) ok = ok && kpos > qpos - window;
      s[j] = ok ? s[j] * scale : NEG_INF;
      ok_bits |= (ok ? 1u : 0u) << j;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = ((ok_bits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = alpha * l + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float4 a = acc[c];
      a.x *= alpha;
      a.y *= alpha;
      a.z *= alpha;
      a.w *= alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        const float4 vv = vs[j][t + TPR * c];
        a.x += s[j] * vv.x;
        a.y += s[j] * vv.y;
        a.z += s[j] * vv.z;
        a.w += s[j] * vv.w;
      }
      acc[c] = a;
    }
  }

  if (!row_ok) return;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* orow = o + ((int64_t)bh * sq + qi) * D;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int e = (t + TPR * c) * 4;
    orow[e] = from_f<T>(acc[c].x * inv);
    orow[e + 1] = from_f<T>(acc[c].y * inv);
    orow[e + 2] = from_f<T>(acc[c].z * inv);
    orow[e + 3] = from_f<T>(acc[c].w * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int sk, int d, int group, float scale, int causal,
           int use_window, int window, cudaStream_t stream) {
  if (bh == 0 || sq == 0) return 0;
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
#define FLASH_CASE(DIM)                                                   \
  case DIM:                                                               \
    flash_fwd<T, DIM><<<grid, THREADS, 0, stream>>>(                      \
        qp, kp, vp, op, sq, sk, group, scale, causal, use_window, window); \
    break;
  switch (d) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(96)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: [bh, sq, d]; k, v: [bh / group, sk, d]; all contiguous, one dtype.
// d in {16, 32, 64, 96, 128}.  use_window != 0 applies `window`.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int bh, int sq,
                                   int sk, int d, int group, float scale,
                                   int causal, int use_window, int window,
                                   void* stream) {
  return launch<float>(q, k, v, o, bh, sq, sk, d, group, scale, causal,
                       use_window, window,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int bh, int sq,
                                    int sk, int d, int group, float scale,
                                    int causal, int use_window, int window,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, group, scale,
                               causal, use_window, window,
                               static_cast<cudaStream_t>(stream));
}
