// The exchange of MaRe's repartitionBy over the logical shards of one
// card, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's exchange
// (src/repro/core/shuffle.py:shuffle_partition) is a stable sort by
// destination and a gather into a [n, capacity] send buffer per shard,
// lax.all_to_all, and a false-first sort and gather per destination.
// The port's first design did the same in torch on each shard.  This
// kernel computes that function in one pass over the rows:
//   destination d receives, for s = 0 .. n-1 in order, the first
//   min(count[s][d], capacity) of source s's valid rows bound for d, in
//   source order, front-compacted in a partition of n * capacity rows
//   whose tail is zero;
//   send[s][d] = min(count[s][d], capacity), recv[d] = sum_s send[s][d],
//   dropped[s] = sum_d max(count[s][d] - capacity, 0),
// where count[s][d] counts source s's valid rows (row < its count) bound
// for d.  A row's destination is the 32-bit splitmix hash of its key's low
// 32 bits, modulo n (kinds KEYS_I32, KEYS_I64: bit-equal to the port's
// hash_keys), or is given (DESTS_I32); a destination outside [0, n)
// matches none and is neither sent nor dropped, as in the reference.
//
// All n sources lie on one card, so one grid covers them: blockIdx.y is
// the source, blockIdx.x a tile of TILE rows, and a tile at or past the
// source's valid count (read on the device: no host read) does nothing.
// Three launches:
//   1. exchange_count: each warp ranks its 32 x ITEMS rows 32 at a time
//      by ballots on the destination's bits (the lanes bound for the same
//      destination agree on each bit; __popc of those below a lane is its
//      rank), as csrc/moe_dispatch.cu's cluster route ranks group ids,
//      keeping its running count of each destination in shared memory;
//      the block writes its tile's count of each destination.
//   2. exchange_offsets (one block): each (source, destination) row of
//      tile counts becomes its exclusive prefix over the tiles; the row
//      totals give send, dropped, recv and each destination's base for
//      source s, sum_{s' < s} send[s'][d].
//   3. exchange_scatter: the same ranks again, plus the earlier warps'
//      counts and the tile's prefix, give each row's slot within its
//      (source, destination); a slot below capacity puts the row at base
//      + slot of its destination, and each leaf's row is copied there as
//      raw bytes, in 16-byte vectors where the row's width and the
//      pointers allow.  The same grid zeroes the tail [recv[d], n *
//      capacity) of every destination's outputs, a chunk a block.
// No sort, no atomics, no global scratch but the tile counts; stable by
// construction and independent of the order in which blocks run.
//
// What bounds it: bytes.  It must read each valid row's key twice (the
// count and the scatter) and its leaves once, and write every
// destination's n * capacity rows once.  At the k-mer action's exchange
// (8 sources of 16,777,216 rows, ~0.245 of them valid, 3 leaves of 4
// bytes, capacity 2,097,152-odd) that is ~2.3 GB, ~0.7 ms at 3.35 TB/s;
// the torch design moved each row through a sort, a send buffer, two
// copies of the stacked buffers and a compaction, about 90x that time.
// The rows' reads are coalesced; a warp's writes land in at most n runs
// of consecutive slots, which L2 merges before they reach memory.
//
// The pointers travel in the kernels' parameters (up to MAX_SHARDS
// sources of MAX_LEAVES leaves, ~10 KB: the parameter space of CUDA 12.1
// and later), so no table has to be copied to the card first.
//
// Interface: plain C, loaded with ctypes.  exchange_launch returns the
// first cudaGetLastError() of its launches (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ITEMS = 8;                   // rows a lane holds
constexpr int TILE = THREADS * ITEMS;      // 2,048 rows a block
constexpr int MAX_SHARDS = 64;
constexpr int MAX_LEAVES = 16;
constexpr int SHARD_BITS = 6;              // a destination below MAX_SHARDS
constexpr int OFFSET_THREADS = 1024;
constexpr int SCAN_ITEMS = 8;              // tile counts a lane scans a step
static_assert(MAX_SHARDS <= (1 << SHARD_BITS) &&
                  32 * ITEMS < (1 << (31 - SHARD_BITS)),
              "a warp's rank and a destination share one int");

enum Kind { KEYS_I32 = 0, KEYS_I64 = 1, DESTS_I32 = 2 };

// Each source's keys (or given destinations) [cap_in] and its valid
// count, an int32 on the card.
struct Sources {
  const void* keys[MAX_SHARDS];
  const int* counts[MAX_SHARDS];
};

// Each leaf's rows: src[l][s] source s's [cap_in] rows of row_bytes[l]
// bytes; out[l] the [n, n * capacity] rows of every destination; vec[l]
// the bytes one load or store moves (1, 2, 4, 8 or 16, dividing the row's
// bytes and the pointers).
struct Leaves {
  const char* src[MAX_LEAVES][MAX_SHARDS];
  char* out[MAX_LEAVES];
  long long row_bytes[MAX_LEAVES];
  int vec[MAX_LEAVES];
};

__device__ __forceinline__ long long valid_rows(const int* count,
                                                long long cap_in) {
  const long long c = *count;
  return c < 0 ? 0 : (c < cap_in ? c : cap_in);
}

template <int KIND>
__device__ __forceinline__ int dest_of(const void* keys, long long i, int n) {
  if (KIND == DESTS_I32) return static_cast<const int*>(keys)[i];
  uint32_t x = KIND == KEYS_I32
                   ? (uint32_t) static_cast<const int*>(keys)[i]
                   : (uint32_t) static_cast<const long long*>(keys)[i];
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return (int)(x % (uint32_t)n);
}

// This warp's rows first + i * 32 + lane (i < ITEMS), those below `rows`
// valid.  On return id[i] is (the row's rank among this warp's rows bound
// for its destination << SHARD_BITS) | destination, or -1 for a row that
// goes nowhere, and hist[0, n) holds the warp's count of each
// destination.
template <int KIND>
__device__ __forceinline__ void rank_rows(const void* keys, long long first,
                                          long long rows, int n,
                                          int* hist, int (&id)[ITEMS]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const long long r = first + i * 32 + lane;
    int g = -1;
    if (r < rows) {
      g = dest_of<KIND>(keys, r, n);
      if (g < 0 || g >= n) g = -1;
    }
    id[i] = g;
  }
  for (int g = lane; g < n; g += 32) hist[g] = 0;
  __syncwarp();
  const int bits = n > 1 ? 32 - __clz(n - 1) : 0;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (first + i * 32 < rows) {  // uniform across the warp
      const int g = id[i];
      unsigned peers = __ballot_sync(FULL, g >= 0);
#pragma unroll
      for (int bit = 0; bit < SHARD_BITS; ++bit) {
        if (bit < bits) {
          const unsigned set = __ballot_sync(FULL, (g >> bit) & 1);
          peers &= (g >> bit) & 1 ? set : ~set;
        }
      }
      const int r = __popc(peers & below);
      if (g >= 0) id[i] = ((hist[g] + r) << SHARD_BITS) | g;
      __syncwarp();
      if (g >= 0 && r == 0) hist[g] += __popc(peers);  // one lane a group
      __syncwarp();
    }
  }
}

// 1. Tile t of source s: its count of each destination, written to
// tile_counts[(s * n + d) * tiles + t].
template <int KIND>
__global__ void __launch_bounds__(THREADS)
exchange_count(Sources src, int n, long long cap_in, int tiles,
               int* __restrict__ tile_counts) {
  __shared__ int hist[WARPS * MAX_SHARDS];
  const int s = blockIdx.y, t = blockIdx.x;
  const long long rows = valid_rows(src.counts[s], cap_in);
  const long long start = (long long)t * TILE;
  if (start >= rows) return;  // uniform across the block
  const int warp = threadIdx.x / 32;
  int id[ITEMS];
  rank_rows<KIND>(src.keys[s], start + (long long)warp * 32 * ITEMS, rows,
                  n, hist + warp * n, id);
  __syncthreads();
  for (int d = threadIdx.x; d < n; d += THREADS) {
    int sum = 0;
    for (int w = 0; w < WARPS; ++w) sum += hist[w * n + d];
    tile_counts[((long long)s * n + d) * tiles + t] = sum;
  }
}

// 2. One block: each (s, d) row of tile counts -> its exclusive prefix,
// in place, over the tiles source s used; then send, base (s-major),
// recv and dropped from the rows' totals.
__global__ void __launch_bounds__(OFFSET_THREADS)
exchange_offsets(Sources src, int n, long long cap_in, int cap, int tiles,
                 int* __restrict__ tile_counts, int* __restrict__ base,
                 int* __restrict__ send, int* __restrict__ recv,
                 int* __restrict__ dropped) {
  __shared__ int totals[MAX_SHARDS * MAX_SHARDS];
  constexpr int W = OFFSET_THREADS / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int row = warp; row < n * n; row += W) {
    const long long rows = valid_rows(src.counts[row / n], cap_in);
    const int used = (int)((rows + TILE - 1) / TILE);
    int* p = tile_counts + (long long)row * tiles;
    int carry = 0;
    for (int t0 = 0; t0 < used; t0 += 32 * SCAN_ITEMS) {
      const int first = t0 + lane * SCAN_ITEMS;
      int v[SCAN_ITEMS];
      int local = 0;
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k) {
        v[k] = first + k < used ? p[first + k] : 0;
        local += v[k];
      }
      int x = local;  // inclusive scan of the lanes' sums
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, x, off);
        if (lane >= off) x += y;
      }
      int run = carry + x - local;
#pragma unroll
      for (int k = 0; k < SCAN_ITEMS; ++k) {
        if (first + k < used) p[first + k] = run;
        run += v[k];
      }
      carry += __shfl_sync(FULL, x, 31);
    }
    if (lane == 0) totals[row] = carry;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < n; d += OFFSET_THREADS) {
    int run = 0;
    for (int s = 0; s < n; ++s) {
      const int c = min(totals[s * n + d], cap);
      send[s * n + d] = c;
      base[s * n + d] = run;
      run += c;
    }
    recv[d] = run;
  }
  for (int s = threadIdx.x; s < n; s += OFFSET_THREADS) {
    int lost = 0;
    for (int d = 0; d < n; ++d) lost += max(totals[s * n + d] - cap, 0);
    dropped[s] = lost;
  }
}

// One leaf's kept rows of this lane: row first + i * 32 + lane of the
// source to row at[i] of destination dst[i] (-1: not kept), in words of V.
// Every index into dst and at is a constant, so both stay in registers.
template <typename V>
__device__ __forceinline__ void copy_leaf(const char* __restrict__ src,
                                          char* __restrict__ out,
                                          long long rb, long long dest_bytes,
                                          long long first,
                                          const int (&dst)[ITEMS],
                                          const int (&at)[ITEMS]) {
  const int lane = threadIdx.x & 31;
  if (rb == (long long)sizeof(V)) {  // one word a row: four loads ahead
#pragma unroll
    for (int i0 = 0; i0 < ITEMS; i0 += 4) {
      V v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (dst[i0 + i] >= 0)
          v[i] = reinterpret_cast<const V*>(src)[first + (i0 + i) * 32 +
                                                 lane];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (dst[i0 + i] >= 0)
          reinterpret_cast<V*>(out + dst[i0 + i] * dest_bytes)[at[i0 + i]] =
              v[i];
    }
    return;
  }
  const long long words = rb / (long long)sizeof(V);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (dst[i] < 0) continue;
    const V* a = reinterpret_cast<const V*>(src + (first + i * 32 + lane) *
                                                      rb);
    V* b = reinterpret_cast<V*>(out + dst[i] * dest_bytes +
                                (long long)at[i] * rb);
    for (long long w = 0; w < words; ++w) b[w] = a[w];
  }
}

// Zero bytes [0, nb) of p with the block's threads: 16-byte stores
// between an unaligned head and tail.
__device__ __forceinline__ void zero_bytes(char* p, long long nb) {
  const long long head =
      min(nb, (long long)((16 - ((uintptr_t)p & 15)) & 15));
  for (long long i = threadIdx.x; i < head; i += THREADS) p[i] = 0;
  int4* body = reinterpret_cast<int4*>(p + head);
  const long long words = (nb - head) / 16;
  for (long long i = threadIdx.x; i < words; i += THREADS)
    body[i] = make_int4(0, 0, 0, 0);
  char* tail = p + head + words * 16;
  for (long long i = threadIdx.x; i < nb - head - words * 16; i += THREADS)
    tail[i] = 0;
}

// 3. Tile t of source s to its destinations; then chunk t of destination
// s's zero tail (blockIdx.y names a source in the first part and a
// destination in the second).
template <int KIND>
__global__ void __launch_bounds__(THREADS)
exchange_scatter(Sources src, Leaves lv, int n, int leaves, long long cap_in,
                 int cap, int tiles, const int* __restrict__ tile_prefix,
                 const int* __restrict__ base,
                 const int* __restrict__ recv) {
  __shared__ int hist[WARPS * MAX_SHARDS];
  __shared__ int off[MAX_SHARDS];
  const int s = blockIdx.y, t = blockIdx.x;
  const long long out_rows = (long long)n * cap;
  const long long rows = valid_rows(src.counts[s], cap_in);
  const long long start = (long long)t * TILE;
  if (start < rows) {  // uniform across the block
    const int warp = threadIdx.x / 32;
    const long long first = start + (long long)warp * 32 * ITEMS;
    int id[ITEMS];
    rank_rows<KIND>(src.keys[s], first, rows, n, hist + warp * n, id);
    __syncthreads();
    // each warp's count of a destination -> the rows of (s, d) before it
    for (int d = threadIdx.x; d < n; d += THREADS) {
      int run = tile_prefix[((long long)s * n + d) * tiles + t];
      for (int w = 0; w < WARPS; ++w) {
        const int v = hist[w * n + d];
        hist[w * n + d] = run;
        run += v;
      }
      off[d] = base[s * n + d];
    }
    __syncthreads();
    const int* before = hist + warp * n;
    int dst[ITEMS], at[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int v = id[i];
      dst[i] = -1;
      at[i] = 0;
      if (v >= 0) {
        const int g = v & ((1 << SHARD_BITS) - 1);
        const int slot = before[g] + (v >> SHARD_BITS);
        if (slot < cap) {
          dst[i] = g;
          at[i] = off[g] + slot;
        }
      }
    }
    for (int l = 0; l < leaves; ++l) {
      const long long rb = lv.row_bytes[l];
      const long long dest_bytes = out_rows * rb;
      const char* sp = lv.src[l][s];
      char* op = lv.out[l];
      switch (lv.vec[l]) {
        case 16:
          copy_leaf<int4>(sp, op, rb, dest_bytes, first, dst, at);
          break;
        case 8:
          copy_leaf<int2>(sp, op, rb, dest_bytes, first, dst, at);
          break;
        case 4:
          copy_leaf<int>(sp, op, rb, dest_bytes, first, dst, at);
          break;
        case 2:
          copy_leaf<short>(sp, op, rb, dest_bytes, first, dst, at);
          break;
        default:
          copy_leaf<char>(sp, op, rb, dest_bytes, first, dst, at);
      }
    }
  }
  // the zero tail of destination d = blockIdx.y, chunk t of gridDim.x
  const int d = blockIdx.y;
  const long long per = (out_rows + gridDim.x - 1) / gridDim.x;
  const long long from = (long long)recv[d];
  const long long lo = max((long long)t * per, from);
  const long long hi = min((long long)(t + 1) * per, out_rows);
  if (lo >= hi) return;
  for (int l = 0; l < leaves; ++l) {
    const long long rb = lv.row_bytes[l];
    zero_bytes(lv.out[l] + (d * out_rows + lo) * rb, (hi - lo) * rb);
  }
}

template <int KIND>
int launch_kind(const Sources& S, const Leaves& L, int n, int leaves,
                long long cap_in, int cap, int tiles, int* tile_counts,
                int* base, int* send, int* recv, int* dropped,
                cudaStream_t stream) {
  exchange_count<KIND><<<dim3((unsigned)tiles, (unsigned)n), THREADS, 0,
                         stream>>>(S, n, cap_in, tiles, tile_counts);
  int err = (int)cudaGetLastError();
  if (err) return err;
  exchange_offsets<<<1, OFFSET_THREADS, 0, stream>>>(
      S, n, cap_in, cap, tiles, tile_counts, base, send, recv, dropped);
  err = (int)cudaGetLastError();
  if (err) return err;
  // enough blocks for the tiles and for the zero tails, a TILE of rows a
  // block at least
  const long long out_rows = (long long)n * cap;
  const long long zero_blocks = (out_rows + TILE - 1) / TILE;
  const unsigned grid_x =
      (unsigned)(zero_blocks > tiles ? zero_blocks : (long long)tiles);
  exchange_scatter<KIND><<<dim3(grid_x, (unsigned)n), THREADS, 0, stream>>>(
      S, L, n, leaves, cap_in, cap, tiles, tile_counts, base, recv);
  return (int)cudaGetLastError();
}

}  // namespace

// Rows a tile of the count and scatter kernels covers; the caller sizes
// the tile counts (n * n * max(1, ceil(cap_in / TILE)) ints) with it.
extern "C" int exchange_tile_rows() { return TILE; }

// kind: KEYS_I32 (0), KEYS_I64 (1) or DESTS_I32 (2).  keys[n]: each
// source's keys or destinations, [cap_in]; counts[n]: each source's valid
// count (int32 on the card); src[leaves * n]: leaf l of source s at
// [l * n + s], [cap_in] rows of row_bytes[l]; out[leaves]: leaf l of every
// destination, [n, n * cap] rows; vec[leaves]: see Leaves.  tile_counts:
// [n * n * tiles] int32 scratch; base, send: [n * n] int32 (base is
// scratch); recv, dropped: [n] int32.  1 <= n <= MAX_SHARDS, 0 <= leaves
// <= MAX_LEAVES, n * cap < 2**31.
extern "C" int exchange_launch(int kind, int n, int leaves, long long cap_in,
                               int cap, const void* const* keys,
                               const void* const* counts,
                               const void* const* src, void* const* out,
                               const long long* row_bytes, const int* vec,
                               int* tile_counts, int* base, int* send,
                               int* recv, int* dropped, void* stream_) {
  if (n < 1 || n > MAX_SHARDS || leaves < 0 || leaves > MAX_LEAVES ||
      cap_in < 0 || cap < 0 || (long long)n * cap > 0x7fffffffLL ||
      cap_in > 0x7fffffffLL || kind < KEYS_I32 || kind > DESTS_I32)
    return (int)cudaErrorInvalidValue;
  Sources S;
  Leaves L;
  memset(&S, 0, sizeof(S));
  memset(&L, 0, sizeof(L));
  for (int s = 0; s < n; ++s) {
    S.keys[s] = keys[s];
    S.counts[s] = static_cast<const int*>(counts[s]);
  }
  for (int l = 0; l < leaves; ++l) {
    const int v = vec[l];
    if ((v != 1 && v != 2 && v != 4 && v != 8 && v != 16) ||
        row_bytes[l] < 0 || row_bytes[l] % v)
      return (int)cudaErrorInvalidValue;
    for (int s = 0; s < n; ++s)
      L.src[l][s] = static_cast<const char*>(src[l * n + s]);
    L.out[l] = static_cast<char*>(out[l]);
    L.row_bytes[l] = row_bytes[l];
    L.vec[l] = v;
  }
  const long long t = (cap_in + TILE - 1) / TILE;
  const int tiles = (int)(t > 0 ? t : 1);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  switch (kind) {
    case KEYS_I32:
      return launch_kind<KEYS_I32>(S, L, n, leaves, cap_in, cap, tiles,
                                   tile_counts, base, send, recv, dropped,
                                   stream);
    case KEYS_I64:
      return launch_kind<KEYS_I64>(S, L, n, leaves, cap_in, cap, tiles,
                                   tile_counts, base, send, recv, dropped,
                                   stream);
    default:
      return launch_kind<DESTS_I32>(S, L, n, leaves, cap_in, cap, tiles,
                                    tile_counts, base, send, recv, dropped,
                                    stream);
  }
}
