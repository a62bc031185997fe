// Flash attention forward (online softmax), for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/flash_attention/kernel.py:_flash_kernel
// (wrapper flash_attention_kernel).  Both kernels here compute the same
// function on the flattened layout q [BH, Sq, D], k and v [BKV, Sk, D],
// o [BH, Sq, D]:
//   kv head of query head bh = bh / group       (GQA, never materialised)
//   qpos = i + (Sk - Sq)                        (right-aligned queries)
//   mask = kpos < Sk  [& qpos >= kpos if causal or windowed]
//                     [& kpos > qpos - window if windowed]
//   s = (q . k) * sm_scale, masked to NEG_INF = -1e30
//   online softmax over key tiles: m, l, acc in float32
//   o = acc / l, and 0 where l == 0 (a row that sees no key), cast to q's
//   dtype;
//   lse = m + log(l) in float32 [BH, Sq] (natural log of the row's sum of
//   exp(s)), +inf for a row that sees no key, written only where the
//   caller passes an lse pointer (training: the backward,
//   flash_attention_bwd.cu, recomputes P from it; serving passes null).
// K/V rows at or past Sk are never read: the tile staging zero-fills
// them, and the mask gives them p = 0, so no 0 * garbage reaches acc.
//
// What bounds it: operations.  Causal prefill at B=4, S=2048, 32 query /
// 8 KV heads, D=64 is ~68.7 GFLOP per call against ~84 MB of q, k, v and
// o, ~820 FLOP per byte: far above the ~295 at which the H100 turns
// compute-bound.  The bound is the tensor cores' 989 TFLOP/s in bf16.
//
// flash_fwd_wgmma (bf16 at D = 64 and 128; the wrapper's "wgmma" route).
// Persistent: one block of three warpgroups an SM walks the work items
// (bh, 128-row query tile) i = blockIdx.x + k * gridDim.x, heaviest
// query tiles first.  Warpgroup 2 is the producer: after setmaxnreg hands
// its registers to the consumers, one thread loads each item's Q tile
// into one of two buffers and the K and V tiles of 128 keys into a
// two-stage ring, all by TMA into 128-byte-swizzled shared memory, every
// buffer and stage with a full and an empty mbarrier; it runs on into the
// next item while the consumers finish one, so no block pays for a cold
// start or its epilogue.  Warpgroups 0 and 1 take 64 query rows each:
// S = Q K^T by wgmma m64n128k16 from shared memory (both operands
// K-major), the online softmax on the accumulator in registers (a row
// lives in the four threads of a quad: two shuffles give its max;
// ex2.approx with the scale folded into one FFMA; the mask only on tiles
// that the causal diagonal, the window's edge or Sk's end cross, as a
// separate branch, from each row's key range), P rounded to bf16 in
// registers as wgmma's A fragment, and acc += P V by wgmma m64n64k16
// with V read MN-major (the transpose bit) from the same stage, which is
// then released.  Key tiles that the mask empties for a whole query tile
// are never loaded.  The TMA maps are 3-D (d, rows, matrices), so a tile
// past a head's last row loads zeros, never the next head's rows.
//
// flash_fwd (f32 at every D, bf16 at D = 16, 32, 96; the "simt" route).
// One block of 256 threads per (bh, 64-row query tile); four adjacent
// threads share one query row, each holding a quarter of its q and of
// its acc in registers (interleaved 16-byte chunks, so a warp's
// shared-memory reads of a key row hit distinct banks).  The block walks
// 32-key K/V tiles staged in shared memory as float32: each thread takes
// partial dot products for the 32 keys, two __shfl_xor_sync steps
// complete them, and every thread of the row then runs the same
// online-softmax update on all 32 scores and rescales its quarter of acc.
// Its multiply-adds run on the CUDA cores in float32 (67 TFLOP/s at
// best), which keeps f32 within 2e-5 of the plain version; it sits far
// above the tensor cores' bound.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns
// cudaGetLastError() of its launch (0 = success), or cudaErrorInvalidValue
// for a head dim it was not built for (or a tensor map that cannot be
// encoded).

#include <cuda.h>  // CUtensorMap and its enums; no -lcuda link
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
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int sq, int sk, int group, float scale,
          int causal, int use_window, int window) {
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
  if (lse != nullptr && t == 0)
    lse[(int64_t)bh * sq + qi] = l == 0.f ? INFINITY : m + logf(l);
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

// ---------------------------------------------------------------------------
// bf16 at head dims 64 and 128: the tensor-core route (flash_fwd_wgmma)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BKV = 128;        // keys per K/V tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int PANEL_COLS = 64;  // one 128-byte swizzle row of bf16

// Shared-memory plan of one block, in bytes from a 1024-aligned base.  A
// tile of R rows x D columns is stored as D / 64 panels of R rows x 128
// bytes, each in the 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ (r % 8)): the layout TMA's SWIZZLE_128B writes and wgmma's
// B128 descriptors read.
template <int D>
struct Plan {
  // two consumer warpgroups of 64 query rows each, and one producer
  // warpgroup; setmaxnreg moves the producer's registers to them
  static constexpr int NWG = 2;
  static constexpr int BQ = 64 * NWG;            // query rows per block
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int PRODUCER_REGS = 24;
  static constexpr int CONSUMER_REGS = 240;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BKV * D * 2;
  static constexpr int K = 2 * Q_BYTES;                 // after two Qs;
                                                        // + stage * KV_BYTES
  static constexpr int V = K + STAGES * KV_BYTES;       // + stage * KV_BYTES
  static constexpr int BARS = V + STAGES * KV_BYTES;    // mbarriers
  static constexpr int BYTES = BARS + 128 + 1024;       // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  K-major
// operands (Q, K): 8-row groups 1024 bytes apart (SBO), LBO unused.
// MN-major V: SBO steps 8 keys, LBO one 64-column panel.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous issue / wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_F8(i)                                                   \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d[64] (+)= A[64 x 16] . B[16 x 128]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t da,
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24), WG_F8(32), WG_F8(40),
        WG_F8(48), WG_F8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[32] += A[64 x 16] . B[16 x 64]; A in registers (bf16 pairs), B
// MN-major in shared memory (the transpose-B bit set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d,
                                                   const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F8(0), WG_F8(8), WG_F8(16), WG_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef WG_F8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One 64-column x R-row box of a 3-D map (d, rows, matrices) into shared
// memory, completing on `bar`; rows past the map's end arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int mat) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(mat)
      : "memory");
}

// S = Q K^T for one warpgroup's 64 rows against a 128-key tile.
template <int D, int BQ>
__device__ __forceinline__ void qk_tile(float (&s)[64], uint32_t q_s,
                                        uint32_t k_s) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int panel = kk / 4, off = (kk % 4) * 32;
    wgmma_m64n128k16_ss(
        s, desc_sw128(q_s + panel * BQ * 128 + off, 16, 1024),
        desc_sw128(k_s + panel * BKV * 128 + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
}

// acc += P V: P from registers (bf16 pairs, the S accumulator's layout
// read as wgmma's A fragment), V [keys, D] MN-major.
template <int D>
__device__ __forceinline__ void pv_tile(float (&acc)[D / 2],
                                        const uint32_t (&p)[32],
                                        uint32_t v_s) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
    for (int panel = 0; panel < D / PANEL_COLS; ++panel)
      wgmma_m64n64k16_rs(
          acc + panel * 32, p + 4 * kk,
          desc_sw128(v_s + panel * BKV * 128 + kk * 16 * 128, BKV * 128,
                     1024));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

// Per-thread view of the m64nN accumulator: element j of the thread's
// array sits in row (warp % 4) * 16 + lane / 4 + 8 * ((j >> 1) & 1) of
// the warpgroup's 64 and column (j / 4) * 8 + (lane % 4) * 2 + (j & 1).
__device__ __forceinline__ int acc_half(int j) { return (j >> 1) & 1; }

// 2^x on the special-function unit, subnormal results flushed to 0 (a p
// below 2^-126 of its row's maximum).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online-softmax step in the log2 domain, in place: raw scores
// s in, p out; m and l of the thread's two rows updated (l a per-thread
// partial, summed over the quad at the end) and alpha set to the factor
// that rescales the old accumulator.  Each row lives in one quad, so two
// shuffles give its maximum.  MASK (a tile that the causal diagonal, the
// window's edge or Sk's end crosses): a score is kept where its column,
// counted from the thread's first column of the tile, lies in its row's
// [lo, hi), and is -inf elsewhere, so that its p is 0; a row with no key
// yet keeps m = -inf and takes 0 as its maximum in the exponent.  Other
// tiles skip the mask, as a separate branch, so that a whole tile pays
// for no predicated-off mask arithmetic.  FOLD (a scale > 0, so the
// maximum of the scores is that of the scaled scores): m is kept in raw
// units and the scale goes into one FFMA with the subtraction.
template <bool MASK, bool FOLD>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2],
                                             float (&alpha)[2],
                                             const int (&lo)[2],
                                             const int (&hi)[2],
                                             float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int h = acc_half(j);
    float x = FOLD ? s[j] : s[j] * scale_log2;
    if (MASK) {
      const int col = (j / 4) * 8 + (j & 1);  // + (lane % 4) * 2 + k0
      x = (col >= lo[h] && col < hi[h]) ? x : -INFINITY;
    }
    s[j] = x;
    mx[h] = fmaxf(mx[h], x);
  }
  float ms[2];  // the new maxima in the log2 domain
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const bool none = mx[h] == -INFINITY;  // no key of the row seen yet
    alpha[h] = none ? 1.f
                    : ex2(FOLD ? (m[h] - mx[h]) * scale_log2 : m[h] - mx[h]);
    ms[h] = none ? 0.f : (FOLD ? mx[h] * scale_log2 : mx[h]);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int h = acc_half(j);
    const float p =
        ex2(FOLD ? fmaf(s[j], scale_log2, -ms[h]) : s[j] - ms[h]);
    s[j] = p;
    l[h] += p;
  }
}

// One work item of the persistent kernel: query tile q0.. of head bh,
// and the key tiles any of its rows sees (those the mask empties for the
// whole tile are never loaded).
struct Item {
  int bh, q0, k_begin, n_tiles;
};

template <int BQ>
__device__ __forceinline__ Item item_at(int i, int bh_count, int sq, int sk,
                                        bool masked, bool use_window,
                                        int window) {
  Item it;
  const int n_qtiles = (sq + BQ - 1) / BQ;
  it.bh = i % bh_count;
  it.q0 = (n_qtiles - 1 - i / bh_count) * BQ;  // heaviest tiles first
  const int shift = sk - sq;
  const int q_first = it.q0 + shift;
  const int q_last = min(it.q0 + BQ, sq) - 1 + shift;
  const int k_end = masked ? min(sk, q_last + 1) : sk;
  int k_begin = use_window ? max(0, q_first - window + 1) : 0;
  it.k_begin = (k_begin / BKV) * BKV;
  it.n_tiles = k_end > it.k_begin ? (k_end - it.k_begin + BKV - 1) / BKV : 0;
  return it;
}

template <int D>
__global__ void __launch_bounds__(Plan<D>::THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int bh_count, int sq, int sk, int group, float scale_log2,
                int causal, int use_window, int window) {
  using P = Plan<D>;
  constexpr int BQ = P::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  // mbarriers: per Q buffer full and empty; per stage K full, V full,
  // K/V empty
  const uint32_t q_full = base + P::BARS;             // + 8 * buffer
  const uint32_t q_empty = q_full + 16;               // + 8 * buffer
  const uint32_t k_full = q_empty + 16;               // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES;        // + 8 * stage
  const uint32_t kv_empty = v_full + 8 * STAGES;      // + 8 * stage

  const int tid = threadIdx.x;
  const int wgi = tid / 128;  // < NWG: consumer of rows 64 * wgi; NWG:
                              // the producer
  const bool masked = causal || use_window;
  const int n_items = bh_count * ((sq + BQ - 1) / BQ);

  if (tid == 0) {
#pragma unroll
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full + 8 * qb, 1);
      mbar_init(q_empty + 8 * qb, P::CONSUMERS);
    }
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(kv_empty + 8 * st, P::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Every role walks the same items, i = blockIdx.x + k * gridDim.x, and
  // counts the same Q loads (jj) and K/V tiles (tile): the buffers and
  // the barriers' phases follow from those counts.
  if (wgi == P::NWG) {
    // producer: one thread keeps Q's two buffers and the K/V ring full
    // with TMA loads, running ahead into the next item
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        P::PRODUCER_REGS));
    if (tid == P::CONSUMERS) {
      int jj = 0, tile = 0;
      for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
        const Item it =
            item_at<BQ>(i, bh_count, sq, sk, masked, use_window, window);
        if (it.n_tiles == 0) continue;
        const int qb = jj % 2;
        mbar_wait(q_empty + 8 * qb, ((jj / 2) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, P::Q_BYTES);
#pragma unroll
        for (int pn = 0; pn < D / PANEL_COLS; ++pn)
          tma_load(base + qb * P::Q_BYTES + pn * BQ * 128, &q_map,
                   q_full + 8 * qb, pn * PANEL_COLS, it.q0, it.bh);
        ++jj;
        const int kvh = it.bh / group;
        for (int t = 0; t < it.n_tiles; ++t, ++tile) {
          const int st = tile % STAGES;
          const int k0 = it.k_begin + t * BKV;
          mbar_wait(kv_empty + 8 * st, ((tile / STAGES) & 1) ^ 1);
          const uint32_t k_s = base + P::K + st * P::KV_BYTES;
          const uint32_t v_s = base + P::V + st * P::KV_BYTES;
          mbar_expect_tx(k_full + 8 * st, P::KV_BYTES);
#pragma unroll
          for (int pn = 0; pn < D / PANEL_COLS; ++pn)
            tma_load(k_s + pn * BKV * 128, &k_map, k_full + 8 * st,
                     pn * PANEL_COLS, k0, kvh);
          mbar_expect_tx(v_full + 8 * st, P::KV_BYTES);
#pragma unroll
          for (int pn = 0; pn < D / PANEL_COLS; ++pn)
            tma_load(v_s + pn * BKV * 128, &v_map, v_full + 8 * st,
                     pn * PANEL_COLS, k0, kvh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        P::CONSUMER_REGS));
    const int warp = (tid % 128) / 32;
    const int lane = tid % 32;
    const int shift = sk - sq;
    const bool fold = scale_log2 > 0.f;
    int jj = 0, tile = 0;
    for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
      const Item it =
          item_at<BQ>(i, bh_count, sq, sk, masked, use_window, window);
      // this warpgroup's rows, and this thread's two of them
      const int wq_first = it.q0 + wgi * 64 + shift;
      const int wq_last = wq_first + 63;
      const int row0 = it.q0 + wgi * 64 + warp * 16 + lane / 4;
      // keys [key_lo, key_hi) of the thread's two rows
      int key_lo[2], key_hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qpos = row0 + 8 * h + shift;
        key_lo[h] = use_window ? max(qpos - window + 1, 0) : 0;
        key_hi[h] = masked ? min(qpos + 1, sk) : sk;
      }

      float acc[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

      if (it.n_tiles > 0) {
        const int qb = jj % 2;
        mbar_wait(q_full + 8 * qb, (jj / 2) & 1);
        ++jj;
        const uint32_t q_wg = base + qb * P::Q_BYTES + wgi * 64 * 128;
        for (int t = 0; t < it.n_tiles; ++t, ++tile) {
          const int st = tile % STAGES;
          const uint32_t parity = (tile / STAGES) & 1;
          const int k0 = it.k_begin + t * BKV;

          float s[64];
          mbar_wait(k_full + 8 * st, parity);
          qk_tile<D, BQ>(s, q_wg, base + P::K + st * P::KV_BYTES);
          if (t == it.n_tiles - 1)
            mbar_arrive(q_empty + 8 * qb);  // Q's last reader is done

          float alpha[2];
          // tiles that the causal diagonal, the window's edge or Sk's end
          // cross for some row of this warpgroup take the mask
          const bool mask_tile = (k0 + BKV > sk) ||
                                 (masked && k0 + BKV - 1 > wq_first) ||
                                 (use_window && k0 <= wq_last - window);
          // the rows' key ranges from this thread's first column
          const int first = k0 + (lane % 4) * 2;
          const int lo[2] = {key_lo[0] - first, key_lo[1] - first};
          const int hi[2] = {key_hi[0] - first, key_hi[1] - first};
          if (fold) {
            if (mask_tile)
              softmax_tile<true, true>(s, m, l, alpha, lo, hi, scale_log2);
            else
              softmax_tile<false, true>(s, m, l, alpha, lo, hi, scale_log2);
          } else {
            if (mask_tile)
              softmax_tile<true, false>(s, m, l, alpha, lo, hi, scale_log2);
            else
              softmax_tile<false, false>(s, m, l, alpha, lo, hi,
                                         scale_log2);
          }
#pragma unroll
          for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[acc_half(j)];
          uint32_t pf[32];
#pragma unroll
          for (int k = 0; k < 32; ++k)
            pf[k] = pack_bf16(s[2 * k], s[2 * k + 1]);
          mbar_wait(v_full + 8 * st, parity);
          pv_tile<D>(acc, pf, base + P::V + st * P::KV_BYTES);
          mbar_arrive(kv_empty + 8 * st);  // P.V has read the stage
        }
      }

      // epilogue: quad-sum l, O / l (0 for a row without keys), bf16;
      // lse from the log2-domain maximum and sum, in natural-log units
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 8 * h;
        if (r >= sq) continue;
        if (lse != nullptr && lane % 4 == 0)
          lse[(int64_t)it.bh * sq + r] =
              l[h] == 0.f ? INFINITY
                          : ((fold ? m[h] * scale_log2 : m[h]) + log2f(l[h])) *
                                LN2;
        const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
        __nv_bfloat16* orow = o + ((int64_t)it.bh * sq + r) * D;
#pragma unroll
        for (int jb = 0; jb < D / 8; ++jb) {
          const int c = jb * 8 + (lane % 4) * 2;
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(acc[4 * jb + 2 * h] * inv,
                                    acc[4 * jb + 2 * h + 1] * inv);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 3-D map over a contiguous bf16 [mats, rows, d] tensor, read in boxes
// of 64 columns x box_rows rows of one matrix, 128-byte swizzled.  Rows
// past `rows` (and so never the next matrix's) load as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int mats, int rows, int d,
              int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)PANEL_COLS, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int sq, int sk, int group, float scale, int causal,
           int use_window, int window, cudaStream_t stream) {
  // with no keys nothing reads K or V: map q's rows in their place
  const int krows = sk > 0 ? sk : 1;
  CUtensorMap q_map, k_map, v_map;
  constexpr int BQ = Plan<D>::BQ;
  if (!make_map(&q_map, q, bh, sq, D, BQ) ||
      !make_map(&k_map, sk > 0 ? k : q, bh / group, krows, D, BKV) ||
      !make_map(&v_map, sk > 0 ? v : q, bh / group, krows, D, BKV))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = Plan<D>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one block an SM (taken once, on the first launch's device:
  // it sets only how the items are shared out), at most one an item
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  const int64_t n_items = (int64_t)bh * ((sq + BQ - 1) / BQ);
  const int blocks = (int)(n_items < sms ? n_items : sms);
  flash_fwd_wgmma<D><<<blocks, Plan<D>::THREADS, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse, bh, sq, sk,
      group, scale * LOG2E, causal, use_window, window);
  return (int)cudaGetLastError();
}

}  // namespace wg


template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int sq, int sk, int d, int group, float scale, int causal,
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
        qp, kp, vp, op, lse, sq, sk, group, scale, causal, use_window,    \
        window);                                                          \
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
// lse: null, or [bh, sq] float32 for the rows' log-sum-exp.  d in {16, 32,
// 64, 96, 128}.  use_window != 0 applies `window`.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int sq, int sk, int d, int group,
                                   float scale, int causal, int use_window,
                                   int window, void* stream) {
  return launch<float>(q, k, v, o, static_cast<float*>(lse), bh, sq, sk, d,
                       group, scale, causal, use_window, window,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse, int bh,
                                    int sq, int sk, int d, int group,
                                    float scale, int causal, int use_window,
                                    int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), bh, sq,
                               sk, d, group, scale, causal, use_window,
                               window, static_cast<cudaStream_t>(stream));
}

// bf16 on the tensor-core route; d in {64, 128}.
extern "C" int flash_attention_bf16_wgmma(const void* q, const void* k,
                                          const void* v, void* o, void* lse,
                                          int bh, int sq, int sk, int d,
                                          int group, float scale, int causal,
                                          int use_window, int window,
                                          void* stream) {
  if (bh == 0 || sq == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  switch (d) {
    case 64:
      return wg::launch<64>(q, k, v, o, lse_f, bh, sq, sk, group, scale,
                            causal, use_window, window, s);
    case 128:
      return wg::launch<128>(q, k, v, o, lse_f, bh, sq, sk, group, scale,
                             causal, use_window, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
