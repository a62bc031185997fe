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
// The TPU kernel walks the blocks in order, carrying a running top-k
// buffer in VMEM and merging each block into it by k max-extractions.
// Blocks on Hopper run in no order, so the carry has to cross blocks some
// other way.  Every candidate is ranked by one composite key,
//   (order_key(bits) << 32) | ~index   as a uint64,
// larger first: the score's total order, then the earlier index.  It is
// a strict order on distinct indices, so both routes are exact and
// independent of the order in which blocks run.  Entries at or past
// valid_count take the key of -inf; valid_count is read on the device, so
// nothing waits for the host.  Two routes, picked by the wrapper from k:
//
// Route `select` (1 <= k <= 32): one launch, topk_select.  A grid of up to
// one block an SM (512 threads) covers the input; each warp keeps its 32
// best keys so far as a list sorted across its lanes, in registers.  It
// loads 4 batches of 32 candidates at once (coalesced; the warps take the
// batches in turn, so a short input spreads over them), and a
// __ballot_sync against its current k-th key lets a batch in only if one
// of its candidates beats it; such a batch is sorted by a bitonic network
// of shuffles and merged into the list (the elementwise max of the list
// and the reversed batch is bitonic and holds the 32 best of both; five
// more shuffle steps sort it).  On random scores almost nothing passes
// after the first batches; on ascending scores every batch passes, at one
// merge each.  Each block merges its warps' lists pairwise in shared
// memory and writes its 32 best.  The last block to finish, which learns
// it is last from a global atomic ticket taken after a __threadfence,
// merges every block's list (one cheap merge a list: they are sorted
// already), writes the result and resets the ticket for the next call.
// A short input (the tree combines' tens of rows) is one block of as few
// warps as give each a batch, with no ticket.  The ticket and the blocks'
// lists are this module's own device memory, so calls must not run on two
// streams at once (the port makes all of them on one stream).
//
// Route `tree` (32 < k <= 1024): the port's first design.  A block takes
// a tile of 4,096 candidates (256 threads x 16, held in registers as
// integer order keys of their bits), and extracts its k best by k rounds
// of a block-wide argmax keyed on (key descending, index ascending) -- a
// warp butterfly of __shfl_xor_sync, then the eight warp winners read
// from shared memory by every thread.  The winner's owner marks it taken.
// Each tile leaves k candidates; levels repeat over the candidates until
// one tile remains, whose block writes the result.
//
// What bounds it: bytes.  It must read n scores and write k values and
// indices; at n = 262,144 that is 1 MB, ~0.3 us at 3.35 TB/s.  On the
// select route a launch's latency, the loads' and a few dependent
// merges a warp set its time; on the tree route the k rounds of
// block-wide reductions (~k * 16 compares and ~k * 20 shuffles a thread),
// a few microseconds a level.
//
// Interface: plain C, loaded with ctypes.  The launchers return
// cudaGetLastError() of their launches (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

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

// ---------------------------------------------------------------------------
// route select
// ---------------------------------------------------------------------------

using u64 = unsigned long long;
constexpr int SELECT_THREADS = 512;
constexpr int SELECT_WARPS = SELECT_THREADS / 32;
constexpr int SELECT_MAX_K = 32;
constexpr int SELECT_UNROLL = 4;             // batches a warp loads at once
constexpr int SELECT_BLOCK_IDS = 2048;       // ids a block takes at least
constexpr int SELECT_LISTS = 16;             // block lists a warp merges
constexpr int SELECT_MAX_BLOCKS = SELECT_WARPS * SELECT_LISTS;  // 256
constexpr int MAX_DEVICES = 64;

// The blocks' lists and the arrival ticket of the last call (see the note
// at the top); the last block resets the ticket to 0.
__device__ u64 select_lists[SELECT_MAX_BLOCKS * 32];
__device__ unsigned select_ticket;

// A candidate's composite key: its order key (sign flipped, so that the
// unsigned order is the signed one), then its index complemented.  0 is
// below every candidate, and marks an empty slot.
__device__ __forceinline__ u64 compose(int bits, int index) {
  const unsigned key = (unsigned)order_key(bits) ^ 0x80000000u;
  return ((u64)key << 32) | (unsigned)~index;
}

__device__ __forceinline__ float key_value(u64 c) {
  return __int_as_float(order_key((int)((unsigned)(c >> 32) ^ 0x80000000u)));
}

__device__ __forceinline__ int key_index(u64 c) { return (int)~(unsigned)c; }

// One compare-exchange step across lanes `stride` apart.
__device__ __forceinline__ u64 exchange(u64 x, int stride, bool keep_max) {
  const u64 y = __shfl_xor_sync(FULL, x, stride);
  return keep_max == (x > y) ? x : y;
}

// 32 keys, one a lane -> sorted descending across the lanes.
__device__ __forceinline__ u64 sort32(u64 x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      x = exchange(x, stride, ((lane & stride) == 0) == ((lane & size) == 0));
  return x;
}

// Two lists sorted descending across the lanes -> the 32 largest keys of
// both, sorted descending: the elementwise max of one list and the other
// reversed is bitonic, and five steps sort it.
__device__ __forceinline__ u64 merge32(u64 list, u64 other, int lane) {
  const u64 rev = __shfl_sync(FULL, other, 31 - lane);
  u64 x = list > rev ? list : rev;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    x = exchange(x, stride, (lane & stride) == 0);
  return x;
}

// The block's warps' lists in lists[warps][32] (warps a power of two)
// -> their merge in lists[0]; every thread of the block takes part.
__device__ __forceinline__ void merge_warps(u64 (*lists)[32], int warps,
                                            int warp, int lane) {
  for (int s = warps / 2; s > 0; s >>= 1) {
    __syncthreads();
    if (warp < s)
      lists[warp][lane] =
          merge32(lists[warp][lane], lists[warp + s][lane], lane);
  }
  __syncthreads();
}

// Warp w of the grid's W warps takes the batches of 32 candidates w,
// w + W, w + 2W, ..., SELECT_UNROLL of them loaded at once.
__global__ void __launch_bounds__(SELECT_THREADS)
topk_select(const float* __restrict__ scores, int n,
            const int* __restrict__ valid, int k, float* __restrict__ out_v,
            int* __restrict__ out_i) {
  __shared__ u64 lists[SELECT_WARPS][32];
  __shared__ bool last;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int vc = *valid;
  const int neg_inf = __float_as_int(-INFINITY);
  u64 best = 0;  // lane j: the warp's j-th best key so far
  u64 kth = 0;   // the warp's k-th best key (lane k - 1's)
  const int64_t step = (int64_t)gridDim.x * warps * 32;
  for (int64_t base = ((int64_t)blockIdx.x * warps + warp) * 32; base < n;
       base += step * SELECT_UNROLL) {
    u64 c[SELECT_UNROLL];
#pragma unroll
    for (int u = 0; u < SELECT_UNROLL; ++u) {
      const int64_t e = base + u * step + lane;
      c[u] = 0;
      if (e < n)
        c[u] = compose(e < vc ? __float_as_int(scores[e]) : neg_inf, (int)e);
    }
#pragma unroll
    for (int u = 0; u < SELECT_UNROLL; ++u) {
      if (__ballot_sync(FULL, c[u] > kth)) {
        best = merge32(best, sort32(c[u] > kth ? c[u] : 0, lane), lane);
        kth = __shfl_sync(FULL, best, k - 1);
      }
    }
  }
  lists[warp][lane] = best;
  merge_warps(lists, warps, warp, lane);
  if (gridDim.x > 1) {
    if (warp == 0) {
      select_lists[blockIdx.x * 32 + lane] = lists[0][lane];
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(&select_ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the last block: warp w merges block lists w, w + warps, ...
    const int nb = gridDim.x;
    u64 l[SELECT_LISTS];
#pragma unroll
    for (int j = 0; j < SELECT_LISTS; ++j) {
      const int b = warp + j * warps;
      l[j] = b < nb ? __ldcg(&select_lists[b * 32 + lane]) : 0;
    }
    best = 0;
    kth = 0;
#pragma unroll
    for (int j = 0; j < SELECT_LISTS; ++j) {
      if (__shfl_sync(FULL, l[j], 0) > kth) {  // the list's best
        best = merge32(best, l[j], lane);
        kth = __shfl_sync(FULL, best, k - 1);
      }
    }
    lists[warp][lane] = best;
    merge_warps(lists, warps, warp, lane);
    if (threadIdx.x == 0) select_ticket = 0;
  }
  if (warp == 0 && lane < k) {
    const u64 c = lists[0][lane];
    out_v[lane] = key_value(c);
    out_i[lane] = key_index(c);
  }
}

// ---------------------------------------------------------------------------
// route tree
// ---------------------------------------------------------------------------

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

// The select route.  scores: [n] float32; valid: [1] int32 on the device;
// out_v [k] float32, out_i [k] int32.  Takes 1 <= k <= 32, k <= n <
// 2**31.
extern "C" int topk_select_f32(const float* scores, int64_t n,
                               const int* valid, int k, float* out_v,
                               int* out_i, void* stream_) {
  if (k < 1 || k > SELECT_MAX_K || k > n || n >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  static std::atomic<int> sms_of[MAX_DEVICES];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  int sms = dev < MAX_DEVICES ? sms_of[dev].load() : 0;
  if (!sms) {
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
    if (err) return err;
    if (dev < MAX_DEVICES) sms_of[dev].store(sms);
  }
  const int64_t want = (n + SELECT_BLOCK_IDS - 1) / SELECT_BLOCK_IDS;
  const int blocks = (int)std::min<int64_t>(
      want, std::min(sms, SELECT_MAX_BLOCKS));
  // one block: the fewest warps (a power of two) that give each a batch
  int warps = SELECT_WARPS;
  if (blocks == 1)
    while (warps > 1 && (int64_t)(warps / 2) * 32 >= n) warps /= 2;
  topk_select<<<blocks, warps * 32, 0, static_cast<cudaStream_t>(stream_)>>>(
      scores, (int)n, valid, k, out_v, out_i);
  return (int)cudaGetLastError();
}

// The tree route.  scores: [n] float32; valid: [1] int32 on the device;
// out_v [k] float32, out_i [k] int32.  scratch_v/scratch_i: 2 * ceil(n /
// 4096) * k entries each (unused when n <= 4096).  The caller guarantees
// 1 <= k <= n, k <= 1024 (so that every level shrinks) and n < 2**31.
extern "C" int topk_tree_f32(const float* scores, int64_t n, const int* valid,
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
