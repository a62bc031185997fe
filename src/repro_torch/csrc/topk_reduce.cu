// Top-k selection over a masked score vector, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/topk_reduce/kernel.py:_topk_kernel
// (wrapper topk_reduce_kernel): the k best of scores[n], entries at or
// past valid_count counting as -inf, values in descending order with
// their int32 indices, ties to the earlier index.  The result equals
// lax.top_k on the masked scores, and a stable descending sort's first k:
// where k > valid_count the slots after the valid entries hold the
// lowest-indexed invalid entries (-inf) in index order.  (The TPU kernel
// gives -1e30 and index -1 there, because its initial buffer comes first
// among its candidates; wherever k <= valid_count the two agree.)  Scores
// are ordered as lax.top_k orders them, by the total order of their bits:
// -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN.
//
// Design.  The TPU kernel walks the blocks in order, carrying a running
// top-k buffer in VMEM and merging each block into it by k max-
// extractions.  Blocks on Hopper run in no order, so the carry becomes a
// tree: a block takes a tile of 4,096 candidates (256 threads x 16, held
// in registers as integer order keys of their bits), and extracts its k
// best by k rounds of a block-wide argmax keyed on (key descending, index
// ascending) -- a warp butterfly of __shfl_xor_sync, then the eight warp
// winners read from shared memory by every thread.  The winner's owner
// marks it taken.  Each tile
// leaves k candidates; levels repeat over the candidates until one tile
// remains, whose block writes the result.  The key is a strict order on
// distinct indices, so the result is exact and independent of the order
// in which blocks run.  valid_count is read on the device: no host sync.
//
// What bounds it: bytes.  It must read n scores and write k values and
// indices; at n = 262,144 that is 1 MB, ~0.3 us at 3.35 TB/s.  The k
// rounds of block-wide reductions (~k * 16 compares and ~k * 20 shuffles
// a thread) set its time instead, a few microseconds a level.
//
// Interface: plain C, loaded with ctypes.  The launcher returns
// cudaGetLastError() of its launches (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
// A slot past the input's end: the lowest key and the highest index, so
// that it comes after every real candidate.
constexpr int NONE_KEY = (int)0x80000000;
constexpr int NONE = 0x7fffffff;

// The float's bits as an int whose order is the floats' total order (the
// map is its own inverse).
__device__ __forceinline__ int order_key(int bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

// a before b: the larger key, then the earlier index.
__device__ __forceinline__ bool before(int ak, int ai, int bk, int bi) {
  return ak > bk || (ak == bk && ai < bi);
}

// One tile of `count` candidates -> its k best at out_v/out_i[tile * k].
// Level 0 reads scores with implicit indices and masks idx >= *valid
// to -inf; later levels read (value, index) candidates.
template <bool LEVEL0>
__global__ void __launch_bounds__(THREADS)
topk_tile(const float* __restrict__ in_v, const int* __restrict__ in_i,
          int64_t count, const int* __restrict__ valid, int k,
          float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ int wv[2][WARPS];
  __shared__ int wi[2][WARPS];
  __shared__ int wp[2][WARPS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int64_t base = (int64_t)blockIdx.x * TILE;
  const int vc = LEVEL0 ? *valid : 0;
  const int neg_inf = order_key(__float_as_int(-INFINITY));

  int v[ITEMS];  // order keys
  int ix[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t e = base + j * THREADS + tid;
    if (e < count) {
      if (LEVEL0) {
        ix[j] = (int)e;
        v[j] = e < vc ? order_key(__float_as_int(in_v[e])) : neg_inf;
      } else {
        ix[j] = in_i[e];
        v[j] = order_key(__float_as_int(in_v[e]));
      }
    } else {
      ix[j] = NONE;
      v[j] = NONE_KEY;
    }
  }

  unsigned taken = 0;
  for (int r = 0; r < k; ++r) {
    // this thread's best untaken item; p = its slot j * THREADS + tid
    int bv = NONE_KEY, bi = NONE, bp = -1;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (!((taken >> j) & 1u) && before(v[j], ix[j], bv, bi)) {
        bv = v[j];
        bi = ix[j];
        bp = j * THREADS + tid;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      const int op = __shfl_xor_sync(FULL, bp, off);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
        bp = op;
      }
    }
    const int buf = r & 1;  // double-buffered: one barrier a round
    if (lane == 0) {
      wv[buf][warp] = bv;
      wi[buf][warp] = bi;
      wp[buf][warp] = bp;
    }
    __syncthreads();
    bv = wv[buf][0];
    bi = wi[buf][0];
    bp = wp[buf][0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      if (before(wv[buf][w], wi[buf][w], bv, bi)) {
        bv = wv[buf][w];
        bi = wi[buf][w];
        bp = wp[buf][w];
      }
    }
    if (bp >= 0 && bp % THREADS == tid) taken |= 1u << (bp / THREADS);
    if (tid == 0) {
      out_v[(int64_t)blockIdx.x * k + r] = __int_as_float(order_key(bv));
      out_i[(int64_t)blockIdx.x * k + r] = bi;
    }
  }
}

}  // namespace

// scores: [n] float32; valid: [1] int32 on the device; out_v [k] float32,
// out_i [k] int32.  scratch_v/scratch_i: 2 * ceil(n / 4096) * k entries
// each (unused when n <= 4096).  The caller guarantees 1 <= k <= n,
// k <= 1024 (so that every level shrinks) and n < 2**31.
extern "C" int topk_f32(const float* scores, int64_t n, const int* valid,
                        int k, float* out_v, int* out_i, float* scratch_v,
                        int* scratch_i, void* stream_) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int64_t half = ((n + TILE - 1) / TILE) * (int64_t)k;
  const float* in_v = scores;
  const int* in_i = nullptr;
  int64_t count = n;
  bool level0 = true;
  int ping = 0;
  for (;;) {
    const int64_t tiles = (count + TILE - 1) / TILE;
    float* ov = tiles == 1 ? out_v : scratch_v + ping * half;
    int* oi = tiles == 1 ? out_i : scratch_i + ping * half;
    if (level0)
      topk_tile<true><<<(unsigned)tiles, THREADS, 0, stream>>>(
          in_v, in_i, count, valid, k, ov, oi);
    else
      topk_tile<false><<<(unsigned)tiles, THREADS, 0, stream>>>(
          in_v, in_i, count, valid, k, ov, oi);
    if (tiles == 1) break;
    in_v = ov;
    in_i = oi;
    count = tiles * k;
    level0 = false;
    ping ^= 1;
  }
  return (int)cudaGetLastError();
}
