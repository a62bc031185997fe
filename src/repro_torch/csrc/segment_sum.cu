// Masked keyed segment sum into a bounded key table, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/segment_reduce/kernel.py:_segment_sum_tiled_kernel
// (wrapper segment_sum_tiled), the reduce_by_key combiner and merge hot
// spot.  It computes the same function:
//   for every record i with valid[i]:
//     if 0 <= keys[i] < num_keys:  table[keys[i], :] += values[i, :]
//                                  counts[keys[i]]   += 1
//     else:                        overflow[0]       += 1
// Invalid slots are skipped, never read as values, because padding may
// hold NaN.  int32 sums are exact; float32 sums add in a run-dependent
// order.
//
// What bounds it: bytes.  The function must read every valid flag, the
// key and values of each valid record, and write the whole table and
// counts (num_keys * (d + 1) * 4 B: 134 MB for d = 1 and 201 MB for
// d = 2 at 4**12 keys).  Both tables are larger than the 50 MB L2, so a
// record scattered straight into them (the atomic kernel below, one
// thread and one global atomicAdd a column a record) misses L2 on every
// atomic and pays a device-memory round trip for one 32-byte sector; on
// top of that the table must be zero-filled before it starts.
//
// Design (the binned route, d <= 3).  The TPU kernel keeps one key tile
// resident in VMEM and streams every record block past it.  Here every
// tile's records are first made contiguous, so that a block can fold a
// whole tile in shared memory and write it out once, coalesced:
//   1. segsum_bin_count: each block takes a contiguous chunk of records
//      and counts them by tile (key >> shift) in a shared-memory
//      histogram; it stores the histogram and its count of valid
//      out-of-range keys (the overflow, counted here once).
//   2. segsum_tile_totals: each tile's count, summed over the blocks.
//   3. segsum_scan_tiles: one block scans the counts into tile starts,
//      the hot tiles' extra fold items into their starts (a tile of more
//      than `split` records is folded in items of `split`), the buckets
//      of 64 tiles into the next step's items, and sums the overflow.
//   4. segsum_to_buckets and 5. segsum_to_tiles: the partition into tile
//      order, in two steps of at most 64 ways each: valid in-range
//      records to rows (key, values) grouped by bucket, then rows to rows
//      (local key, values) grouped by tile.  A block stages a batch of
//      rows in shared memory grouped by destination, takes each group's
//      range with one atomicAdd on its cursor, and writes the batch out
//      with neighbouring threads on neighbouring rows.  (Scattered 8- and
//      16-byte stores, one a record, cost the SM's store path several
//      cycles a sector, whether they hit L2 or not; the 64-way runs of a
//      staged batch are written whole.)  A batch whose tiles fit one
//      window of 64 (a merge's sorted runs) skips the second step.
//   6. segsum_fold: one block a tile zeroes the tile in shared memory,
//      folds the tile's first `split` rows in with shared-memory atomics
//      and writes the WHOLE tile, zeros included, to table and counts: no
//      memset, every row written once.
//   7. segsum_fold_extra: the extra items of hot tiles, each folded the
//      same way and added to the written tile with global atomics (only
//      keys it saw).  It runs after the fold on the same stream.
// In every pass a warp first gathers the lanes that share its first
// active lane's bucket, tile or key and adds them with one atomic (one
// hot key costs one atomic a warp, not 32 that serialise); the others add
// alone.  A row is one 8-byte (d = 1) or 16-byte (d = 2, 3) vector.
//
// The atomic kernel (segment_sum_atomic_*) is the route for what the
// binned route does not take (d > 3, too many tiles, n past int32); its
// outputs must arrive zero-filled.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns
// cudaGetLastError() of its launches (0 = success) and launches nothing
// for n == 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BIN_THREADS = 1024;
constexpr int SCAN_WARPS = 8;
constexpr int TILES_THREADS = 1024;
constexpr int FOLD_THREADS = 256;
constexpr int PART_THREADS = 512;
// records a thread takes at a step of the counting pass, and records
// (rows) at a step of the partition (multiples of 4)
constexpr int PER = 8;
constexpr int PART_PER = 4;
// rows a partition block stages at once
constexpr int BATCH = PART_THREADS * PART_PER;
// a bucket of the partition's first step is 2**BUCKET_SHIFT tiles
constexpr int BUCKET_SHIFT = 6;
constexpr int BUCKET_TILES = 1 << BUCKET_SHIFT;
constexpr int MAX_BUCKETS = 128;  // 8,192 tiles

// ---------------------------------------------------------------------------
// the atomic kernel: one thread a record
// ---------------------------------------------------------------------------

template <typename T>
__global__ void segment_sum_kernel(const int32_t* __restrict__ keys,
                                   const T* __restrict__ values,
                                   const uint8_t* __restrict__ valid,
                                   int64_t n, int d, int64_t num_keys,
                                   T* __restrict__ table,
                                   int32_t* __restrict__ counts,
                                   int32_t* __restrict__ overflow) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!valid[i]) continue;
    const int64_t k = keys[i];
    if (k < 0 || k >= num_keys) {
      atomicAdd(overflow, 1);
      continue;
    }
    atomicAdd(counts + k, 1);
    const T* row = values + i * d;
    T* out = table + k * d;
    for (int j = 0; j < d; ++j) atomicAdd(out + j, row[j]);
  }
}

template <typename T>
int launch_atomic(const int32_t* keys, const T* values, const uint8_t* valid,
                  int64_t n, int d, int64_t num_keys, T* table,
                  int32_t* counts, int32_t* overflow, int blocks,
                  cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t need = (n + threads - 1) / threads;
  const int grid = (int)(need < blocks ? need : blocks);
  segment_sum_kernel<T><<<grid, threads, 0, stream>>>(
      keys, values, valid, n, d, num_keys, table, counts, overflow);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the binned route
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Reserve one slot of cur[id] for every lane with id >= 0 and return its
// old value plus the lane's rank (an exclusive position); -1 for id < 0.
// Lanes sharing the first active lane's id take one atomic together.
// Called by all 32 lanes.
__device__ __forceinline__ int warp_reserve(int32_t* cur, int id, int lane) {
  const unsigned act = __ballot_sync(FULL, id >= 0);
  if (act == 0) return -1;
  const int leader = __ffs(act) - 1;
  const int lid = __shfl_sync(FULL, id, leader);
  const unsigned same = __ballot_sync(FULL, id == lid);
  int base = 0;
  if (lane == leader) base = atomicAdd(cur + lid, __popc(same));
  base = __shfl_sync(FULL, base, leader);
  if (id == lid) return base + __popc(same & lanes_below(lane));
  return id >= 0 ? atomicAdd(cur + id, 1) : -1;
}

// Exclusive scan of one int a thread over the block; returns the prefix,
// *total gets the sum.  Every thread of the block calls it.
__device__ int block_scan(int v, int* total) {
  __shared__ int warp_sums[32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  if (w == 0) {
    const int nw = blockDim.x >> 5;
    int s = lane < nw ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    warp_sums[lane] = s;                 // inclusive over warps
  }
  __syncthreads();
  const int before = w ? warp_sums[w - 1] : 0;
  *total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();
  return before + x - v;
}

// A row for D value columns: the key and the values, padded to 2 or 4
// words so that one vector load or store moves it.
template <int D>
struct Row {
  using V = int4;
};
template <>
struct Row<1> {
  using V = int2;
};

// A thread's N consecutive records: their valid flags (one byte each) and,
// when any is set, their keys and D value words each, loaded with
// streaming hints (read once).  Whole vectors where the records and
// pointers allow it.
template <int N, int D>
struct Records {
  uint32_t f[N / 4];                   // four flag bytes a word
  int32_t k[N];
  int32_t v[D ? N * D : 1];
  __device__ __forceinline__ bool flag(int j) const {
    return (f[j >> 2] >> (8 * (j & 3))) & 0xff;
  }
  __device__ __forceinline__ bool any() const {
    uint32_t a = 0;
#pragma unroll
    for (int q = 0; q < N / 4; ++q) a |= f[q];
    return a != 0;
  }
};

template <int N, int D>
__device__ __forceinline__ Records<N, D> load_records(
    const int32_t* __restrict__ keys, const int32_t* __restrict__ values,
    const uint8_t* __restrict__ valid, int64_t i0, int64_t hi, bool vec) {
  static_assert(N == 4 || N == 8, "4 or 8 records a thread");
  Records<N, D> r;
#pragma unroll
  for (int q = 0; q < N / 4; ++q) r.f[q] = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) r.k[j] = 0;
#pragma unroll
  for (int j = 0; j < N * D; ++j) r.v[j] = 0;
  if (vec && i0 + N <= hi) {
    if constexpr (N == 8) {
      const uint2 x = __ldcs(reinterpret_cast<const uint2*>(valid + i0));
      r.f[0] = x.x; r.f[1] = x.y;
    } else {
      r.f[0] = __ldcs(reinterpret_cast<const unsigned*>(valid + i0));
    }
    if (r.any()) {
      const int4* k4 = reinterpret_cast<const int4*>(keys + i0);
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const int4 x = __ldcs(k4 + q);
        r.k[4 * q] = x.x; r.k[4 * q + 1] = x.y;
        r.k[4 * q + 2] = x.z; r.k[4 * q + 3] = x.w;
      }
      const int4* v4 = reinterpret_cast<const int4*>(values + i0 * D);
#pragma unroll
      for (int q = 0; q < N * D / 4; ++q) {
        const int4 x = __ldcs(v4 + q);
        r.v[4 * q] = x.x; r.v[4 * q + 1] = x.y;
        r.v[4 * q + 2] = x.z; r.v[4 * q + 3] = x.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (i0 + j < hi && __ldcs(valid + i0 + j)) {
        r.f[j >> 2] |= 1u << (8 * (j & 3));
        r.k[j] = __ldcs(keys + i0 + j);
#pragma unroll
        for (int c = 0; c < D; ++c)
          r.v[j * D + c] = __ldcs(values + (i0 + j) * D + c);
      }
    }
  }
  return r;
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// 1. Per-block tile histogram of a contiguous chunk, and its overflow.
__global__ void __launch_bounds__(BIN_THREADS)
segsum_bin_count(const int32_t* __restrict__ keys,
                 const uint8_t* __restrict__ valid, int64_t n, int64_t chunk,
                 int64_t num_keys, int shift, int tiles,
                 int32_t* __restrict__ hist, int32_t* __restrict__ ovf_part) {
  extern __shared__ int32_t h[];
  __shared__ int32_t ovf_sm;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) h[t] = 0;
  if (threadIdx.x == 0) ovf_sm = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const bool vec = aligned(valid, 8) && aligned(keys, 16);
  const int64_t lo = blockIdx.x * chunk;
  const int64_t hi = lo + chunk < n ? lo + chunk : n;
  int ovf = 0;
  for (int64_t base = lo; base < hi; base += (int64_t)blockDim.x * PER) {
    const int64_t i0 = base + (int64_t)threadIdx.x * PER;
    const Records<PER, 0> r =
        load_records<PER, 0>(keys, nullptr, valid, i0, hi, vec);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      int tile = -1;
      if (r.flag(j)) {
        if (r.k[j] >= 0 && r.k[j] < num_keys) tile = r.k[j] >> shift;
        else ++ovf;
      }
      warp_reserve(h, tile, lane);
    }
  }
  ovf = warp_sum(ovf);
  if (lane == 0 && ovf) atomicAdd(&ovf_sm, ovf);
  __syncthreads();
  int32_t* row = hist + (int64_t)blockIdx.x * tiles;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) row[t] = h[t];
  if (threadIdx.x == 0) ovf_part[blockIdx.x] = ovf_sm;
}

// 2. hist [blocks, tiles] -> tile_total [tiles], the sums over the blocks.
// A block takes 32 tiles (one a lane) and SCAN_WARPS slices of the blocks
// (one a warp): reads are 128-byte rows.
__global__ void __launch_bounds__(SCAN_WARPS * 32)
segsum_tile_totals(const int32_t* __restrict__ hist, int blocks, int tiles,
                   int32_t* __restrict__ tile_total) {
  __shared__ int32_t part[SCAN_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int t = blockIdx.x * 32 + lane;
  int s = 0;
  if (t < tiles)
    for (int b = w; b < blocks; b += SCAN_WARPS)
      s += hist[(int64_t)b * tiles + t];
  part[w][lane] = s;
  __syncthreads();
  if (w == 0 && t < tiles) {
    for (int j = 1; j < SCAN_WARPS; ++j) s += part[j][lane];
    tile_total[t] = s;
  }
}

// Fold items a tile of c records takes beyond its first: ceil(c / split)
// - 1 (0 for an empty tile).
__device__ __forceinline__ int extras_of(int c, int split) {
  return c > split ? (c - 1) / split : 0;
}

// 3. One block: tile_start [tiles + 1] and extra_start [tiles + 1], the
// exclusive scans of the tile totals and of their extra fold items;
// tile_cur [tiles] = tile_start; for the buckets of BUCKET_TILES tiles,
// bucket_cur [buckets] = their starts and item_start [buckets + 1] the
// exclusive scan of their batches of BATCH rows; overflow[0], the sum of
// the blocks' overflow counts.
__global__ void __launch_bounds__(TILES_THREADS)
segsum_scan_tiles(const int32_t* __restrict__ tile_total, int tiles,
                  const int32_t* __restrict__ ovf_part, int blocks,
                  int split, int32_t* __restrict__ tile_start,
                  int32_t* __restrict__ extra_start,
                  int32_t* __restrict__ tile_cur,
                  int32_t* __restrict__ bucket_cur,
                  int32_t* __restrict__ item_start,
                  int32_t* __restrict__ overflow) {
  const int per = (tiles + blockDim.x - 1) / blockDim.x;
  const int t0 = threadIdx.x * per;
  const int t1 = t0 + per < tiles ? t0 + per : tiles;
  int c = 0, x = 0;
  for (int t = t0; t < t1; ++t) {
    c += tile_total[t];
    x += extras_of(tile_total[t], split);
  }
  int c_all, x_all;
  int c_run = block_scan(c, &c_all);
  int x_run = block_scan(x, &x_all);
  for (int t = t0; t < t1; ++t) {
    tile_start[t] = c_run;
    tile_cur[t] = c_run;
    extra_start[t] = x_run;
    c_run += tile_total[t];
    x_run += extras_of(tile_total[t], split);
  }
  int o = 0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) o += ovf_part[b];
  int o_all;
  block_scan(o, &o_all);
  if (threadIdx.x == 0) {
    tile_start[tiles] = c_all;
    extra_start[tiles] = x_all;
    overflow[0] = o_all;
  }
  __syncthreads();                      // tile_start is read back below
  const int buckets = (tiles + BUCKET_TILES - 1) >> BUCKET_SHIFT;
  int items = 0;
  if ((int)threadIdx.x < buckets) {
    const int first = threadIdx.x << BUCKET_SHIFT;
    const int last = first + BUCKET_TILES < tiles ? first + BUCKET_TILES
                                                  : tiles;
    bucket_cur[threadIdx.x] = tile_start[first];
    items = (tile_start[last] - tile_start[first] + BATCH - 1) / BATCH;
  }
  int i_all;
  const int i_run = block_scan(items, &i_all);
  if ((int)threadIdx.x < buckets) item_start[threadIdx.x] = i_run;
  if (threadIdx.x == 0) item_start[buckets] = i_all;
}

// Stage one batch of rows grouped by destination and write it out: a
// thread's rows carry their group in [0, groups) (or -1: no row) and
// their rank in it (taken from cnt, zeroed before the batch); cur[g] is
// group g's global cursor.  Each group takes its range with one
// atomicAdd; neighbouring threads then write neighbouring rows of a
// group.
template <typename V>
__device__ __forceinline__ void stage_and_write(
    const V (&row)[PART_PER], const int (&grp)[PART_PER],
    const int (&rank)[PART_PER],
    int groups, int32_t* cnt, int32_t* off, int32_t* gbase, V* stage,
    uint8_t* stage_grp, int32_t* __restrict__ cur, V* __restrict__ out) {
  __syncthreads();                       // every rank taken
  int total;
  const int c = (int)threadIdx.x < groups ? cnt[threadIdx.x] : 0;
  const int o = block_scan(c, &total);
  if ((int)threadIdx.x < groups) {
    off[threadIdx.x] = o;
    gbase[threadIdx.x] = c ? atomicAdd(cur + threadIdx.x, c) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PART_PER; ++j) {
    if (grp[j] < 0) continue;
    const int at = off[grp[j]] + rank[j];
    stage[at] = row[j];
    stage_grp[at] = (uint8_t)grp[j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int g = stage_grp[i];
    out[(int64_t)gbase[g] + (i - off[g])] = stage[i];
  }
  __syncthreads();                       // stage and cnt are reused
}

template <typename V>
__device__ __forceinline__ V make_row(const int32_t (&w)[4]);
template <>
__device__ __forceinline__ int2 make_row<int2>(const int32_t (&w)[4]) {
  return make_int2(w[0], w[1]);
}
template <>
__device__ __forceinline__ int4 make_row<int4>(const int32_t (&w)[4]) {
  return make_int4(w[0], w[1], w[2], w[3]);
}

// 4. Records -> rows, in batches of BATCH records, grid-stride.  A batch
// whose tiles all lie in a window of BUCKET_TILES (the sorted runs of a
// merge) goes straight to its final place: rows (local key, values)
// grouped by tile in by_tile.  Any other batch goes to rows (key, values)
// grouped by bucket in by_bucket, for segsum_to_tiles.
template <int D>
__global__ void __launch_bounds__(PART_THREADS)
segsum_to_buckets(const int32_t* __restrict__ keys,
                  const int32_t* __restrict__ values,
                  const uint8_t* __restrict__ valid, int64_t n,
                  int64_t num_keys, int shift, int buckets,
                  int32_t* __restrict__ bucket_cur,
                  int32_t* __restrict__ tile_cur,
                  int32_t* __restrict__ by_bucket,
                  int32_t* __restrict__ by_tile) {
  using V = typename Row<D>::V;
  __shared__ V stage[BATCH];
  __shared__ uint8_t stage_grp[BATCH];
  __shared__ int32_t cnt[MAX_BUCKETS], off[MAX_BUCKETS],
      gbase[MAX_BUCKETS];
  __shared__ int32_t tile_lo, tile_hi;
  const int lane = threadIdx.x & 31;
  const bool vec = aligned(valid, 8) && aligned(keys, 16) &&
                   aligned(values, 16);
  for (int64_t b0 = (int64_t)blockIdx.x * BATCH; b0 < n;
       b0 += (int64_t)gridDim.x * BATCH) {
    const int64_t hi = b0 + BATCH < n ? b0 + BATCH : n;
    const int64_t i0 = b0 + (int64_t)threadIdx.x * PART_PER;
    const Records<PART_PER, D> r =
        load_records<PART_PER, D>(keys, values, valid, i0, hi, vec);
    if ((int)threadIdx.x < MAX_BUCKETS) cnt[threadIdx.x] = 0;
    if (threadIdx.x == 0) {
      tile_lo = INT32_MAX;
      tile_hi = -1;
    }
    // a batch of padding only (a merge's empty bucket tails) ends here
    if (!__syncthreads_or(r.any())) continue;
    int tile[PART_PER];
    int lo = INT32_MAX, top = -1;
#pragma unroll
    for (int j = 0; j < PART_PER; ++j) {
      const int32_t k = r.k[j];
      tile[j] = r.flag(j) && k >= 0 && k < num_keys ? k >> shift : -1;
      if (tile[j] >= 0) {
        lo = min(lo, tile[j]);
        top = max(top, tile[j]);
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(FULL, lo, o));
      top = max(top, __shfl_xor_sync(FULL, top, o));
    }
    if (lane == 0 && top >= 0) {
      atomicMin(&tile_lo, lo);
      atomicMax(&tile_hi, top);
    }
    __syncthreads();
    const int first = tile_lo;
    const bool direct = tile_hi >= 0 && tile_hi - first < BUCKET_TILES;
    V row[PART_PER];
    int grp[PART_PER], rank[PART_PER];
#pragma unroll
    for (int j = 0; j < PART_PER; ++j) {
      int32_t w[4] = {r.k[j], 0, 0, 0};
      grp[j] = -1;
      if (tile[j] >= 0) {
        if (direct) {
          grp[j] = tile[j] - first;
          w[0] -= tile[j] << shift;           // the key within its tile
        } else {
          grp[j] = tile[j] >> BUCKET_SHIFT;
        }
      }
      rank[j] = warp_reserve(cnt, grp[j], lane);
#pragma unroll
      for (int c = 0; c < D; ++c) w[1 + c] = r.v[j * D + c];
      row[j] = make_row<V>(w);
    }
    if (direct)
      stage_and_write<V>(row, grp, rank, tile_hi - first + 1, cnt, off,
                         gbase, stage, stage_grp, tile_cur + first,
                         reinterpret_cast<V*>(by_tile));
    else
      stage_and_write<V>(row, grp, rank, buckets, cnt, off, gbase, stage,
                         stage_grp, bucket_cur,
                         reinterpret_cast<V*>(by_bucket));
  }
}

// 5. Rows of a bucket -> rows (local key, values) grouped by tile.  Item j
// is the q-th batch of BATCH rows of bucket b (item_start[b] + q = j),
// grid-stride; a bucket's rows end where segsum_to_buckets left its
// cursor (rows that went straight to by_tile are not here).
template <int D>
__global__ void __launch_bounds__(PART_THREADS)
segsum_to_tiles(const int32_t* __restrict__ in, int tiles, int shift,
                const int32_t* __restrict__ tile_start,
                const int32_t* __restrict__ item_start,
                const int32_t* __restrict__ bucket_cur, int buckets,
                int32_t* __restrict__ tile_cur, int32_t* __restrict__ out) {
  using V = typename Row<D>::V;
  __shared__ V stage[BATCH];
  __shared__ uint8_t stage_grp[BATCH];
  __shared__ int32_t cnt[BUCKET_TILES], off[BUCKET_TILES],
      gbase[BUCKET_TILES];
  const int lane = threadIdx.x & 31;
  const V* src = reinterpret_cast<const V*>(in);
  const int items = item_start[buckets];
  for (int j = blockIdx.x; j < items; j += gridDim.x) {
    // the bucket whose items cover j: the last b with item_start <= j
    int lo = 0, hi = buckets - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (item_start[mid] <= j) lo = mid; else hi = mid - 1;
    }
    const int b = lo;
    const int first_tile = b << BUCKET_SHIFT;
    const int last_tile = first_tile + BUCKET_TILES < tiles
                              ? first_tile + BUCKET_TILES : tiles;
    const int64_t r0 = tile_start[first_tile] +
                       (int64_t)(j - item_start[b]) * BATCH;
    const int64_t end = bucket_cur[b];
    if (r0 >= end) continue;                       // uniform
    const int64_t r1 = r0 + BATCH < end ? r0 + BATCH : end;
    if ((int)threadIdx.x < BUCKET_TILES) cnt[threadIdx.x] = 0;
    __syncthreads();
    V row[PART_PER];
    int grp[PART_PER], rank[PART_PER];
#pragma unroll
    for (int q = 0; q < PART_PER; ++q) {
      const int64_t i = r0 + q * PART_THREADS + threadIdx.x;
      grp[q] = -1;
      if (i < r1) {
        row[q] = __ldcs(src + i);
        const int tile = row[q].x >> shift;
        row[q].x -= tile << shift;          // the key within its tile
        grp[q] = tile - first_tile;
      }
      rank[q] = warp_reserve(cnt, grp[q], lane);
    }
    stage_and_write<V>(row, grp, rank, last_tile - first_tile, cnt, off,
                       gbase, stage, stage_grp, tile_cur + first_tile,
                       reinterpret_cast<V*>(out));
  }
}

template <typename T>
__device__ __forceinline__ T from_bits(int32_t b);
template <>
__device__ __forceinline__ int32_t from_bits<int32_t>(int32_t b) {
  return b;
}
template <>
__device__ __forceinline__ float from_bits<float>(int32_t b) {
  return __int_as_float(b);
}

// Fold rows [lo, hi) into the shared tile (tab [kb, D] as T, cnt [kb]).
// The loop is uniform over the block, so every lane takes part in the
// warp votes.
template <typename T, int D>
__device__ void fold_rows(const int32_t* __restrict__ rows, int64_t lo,
                          int64_t hi, T* tab, int32_t* cnt) {
  using V = typename Row<D>::V;
  const V* src = reinterpret_cast<const V*>(rows);
  const int lane = threadIdx.x & 31;
  for (int64_t base = lo; base < hi; base += blockDim.x) {
    const int64_t j = base + threadIdx.x;
    const bool ok = j < hi;
    int32_t w[4] = {-1, 0, 0, 0};
    if (ok) {
      const V r = __ldcs(src + j);
      w[0] = r.x; w[1] = r.y;
      if constexpr (D > 1) { w[2] = r.z; w[3] = r.w; }
    }
    const int key = w[0];
    const unsigned act = __ballot_sync(FULL, ok);
    if (act == 0) break;
    const int leader = __ffs(act) - 1;
    const int lk = __shfl_sync(FULL, key, leader);
    const bool mine = ok && key == lk;
    const unsigned same = __ballot_sync(FULL, mine);
    const bool grouped = __popc(same) > 1;          // uniform over the warp
    if (grouped && lane == leader) atomicAdd(cnt + lk, __popc(same));
    if (ok && !(grouped && mine)) atomicAdd(cnt + key, 1);
    // the grouped lanes add one warp sum a column
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const T v = from_bits<T>(w[1 + c]);
      if (grouped) {
        const T s = warp_sum(mine ? v : T(0));
        if (lane == leader) atomicAdd(tab + lk * D + c, s);
        if (ok && !mine) atomicAdd(tab + key * D + c, v);
      } else if (ok) {
        atomicAdd(tab + key * D + c, v);
      }
    }
  }
}

__device__ void zero_words(int32_t* p, int count) {
  if ((count & 3) == 0) {
    int4* q = reinterpret_cast<int4*>(p);
    for (int i = threadIdx.x; i < (count >> 2); i += blockDim.x)
      q[i] = make_int4(0, 0, 0, 0);
  } else {
    for (int i = threadIdx.x; i < count; i += blockDim.x) p[i] = 0;
  }
}

// dst[0, count) = src[0, count), 16 bytes a thread where both are aligned.
__device__ void copy_words(int32_t* __restrict__ dst,
                           const int32_t* __restrict__ src, int64_t count) {
  if (aligned(dst, 16) && aligned(src, 16)) {
    const int64_t quads = count >> 2;
    int4* d4 = reinterpret_cast<int4*>(dst);
    const int4* s4 = reinterpret_cast<const int4*>(src);
    for (int64_t i = threadIdx.x; i < quads; i += blockDim.x) d4[i] = s4[i];
    for (int64_t i = (quads << 2) + threadIdx.x; i < count; i += blockDim.x)
      dst[i] = src[i];
  } else {
    for (int64_t i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
  }
}

// 6. One block a tile: zero it in shared memory, fold its first `split`
// rows, write the whole tile (rows of absent keys hold 0).
template <typename T, int D>
__global__ void __launch_bounds__(FOLD_THREADS)
segsum_fold(const int32_t* __restrict__ rows,
            const int32_t* __restrict__ tile_start, int64_t num_keys,
            int shift, int split, T* __restrict__ table,
            int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) int32_t sm[];
  const int kb = 1 << shift;
  T* tab = reinterpret_cast<T*>(sm);
  int32_t* cnt = sm + kb * D;
  zero_words(sm, kb * (D + 1));
  __syncthreads();
  const int t = blockIdx.x;
  const int64_t lo = tile_start[t];
  const int64_t end = tile_start[t + 1];
  fold_rows<T, D>(rows, lo, lo + split < end ? lo + split : end, tab, cnt);
  __syncthreads();
  const int64_t first = (int64_t)t << shift;
  const int64_t left = num_keys - first;
  const int64_t keys_here = left < kb ? left : kb;
  copy_words(reinterpret_cast<int32_t*>(table) + first * D, sm,
             keys_here * D);
  copy_words(counts + first, cnt, keys_here);
}

// 7. The extra items of hot tiles (item q >= 1 of tile t folds rows
// [start + q * split, ...)), grid-stride; each adds the keys it saw to the
// tile that segsum_fold wrote.
template <typename T, int D>
__global__ void __launch_bounds__(FOLD_THREADS)
segsum_fold_extra(const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ tile_start,
                  const int32_t* __restrict__ extra_start, int tiles,
                  int64_t num_keys, int shift, int split,
                  T* __restrict__ table, int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) int32_t sm[];
  const int kb = 1 << shift;
  T* tab = reinterpret_cast<T*>(sm);
  int32_t* cnt = sm + kb * D;
  const int items = extra_start[tiles];
  for (int j = blockIdx.x; j < items; j += gridDim.x) {
    // the tile whose extra items cover j: the last t with start <= j
    int lo = 0, hi = tiles - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (extra_start[mid] <= j) lo = mid; else hi = mid - 1;
    }
    const int t = lo;
    const int q = j - extra_start[t] + 1;
    const int64_t first_row = (int64_t)tile_start[t] + (int64_t)q * split;
    const int64_t end = tile_start[t + 1];
    zero_words(sm, kb * (D + 1));
    __syncthreads();
    fold_rows<T, D>(rows, first_row,
                    first_row + split < end ? first_row + split : end, tab,
                    cnt);
    __syncthreads();
    const int64_t first = (int64_t)t << shift;
    const int64_t left = num_keys - first;
    const int keys_here = (int)(left < kb ? left : kb);
    for (int r = threadIdx.x; r < keys_here; r += blockDim.x) {
      if (cnt[r] == 0) continue;
      atomicAdd(counts + first + r, cnt[r]);
#pragma unroll
      for (int c = 0; c < D; ++c)
        atomicAdd(table + (first + r) * D + c, tab[r * D + c]);
    }
    __syncthreads();
  }
}

// Scratch ints the binned route needs besides the rows (the wrapper
// allocates them): hist [blocks * tiles], ovf_part [blocks],
// tile_total [tiles], tile_start [tiles + 1], extra_start [tiles + 1],
// tile_cur [tiles], bucket_cur [MAX_BUCKETS], item_start [MAX_BUCKETS + 1].
int meta_ints(int blocks, int tiles) {
  return blocks * tiles + blocks + 4 * tiles + 2 + 2 * MAX_BUCKETS + 1;
}

template <typename T, int D>
int launch_binned(const int32_t* keys, const int32_t* values,
                  const uint8_t* valid, int64_t n, int64_t num_keys,
                  int shift, int split, int max_blocks, int32_t* meta,
                  int32_t* rows, T* table, int32_t* counts,
                  int32_t* overflow, cudaStream_t stream) {
  const int kb = 1 << shift;
  const int tiles = (int)((num_keys + kb - 1) / kb);
  const int buckets = (tiles + BUCKET_TILES - 1) >> BUCKET_SHIFT;
  if (buckets > MAX_BUCKETS) return (int)cudaErrorInvalidValue;
  // the counting pass: contiguous chunks of 128-record multiples, at
  // least 4,096 records each
  int64_t blocks = (n + 4095) / 4096;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  int64_t chunk = (n + blocks - 1) / blocks;
  chunk = (chunk + 127) / 128 * 128;
  blocks = (n + chunk - 1) / chunk;
  int32_t* hist = meta;
  int32_t* ovf_part = hist + blocks * tiles;
  int32_t* tile_total = ovf_part + blocks;
  int32_t* tile_start = tile_total + tiles;
  int32_t* extra_start = tile_start + tiles + 1;
  int32_t* tile_cur = extra_start + tiles + 1;
  int32_t* bucket_cur = tile_cur + tiles;
  int32_t* item_start = bucket_cur + MAX_BUCKETS;
  // the partition's rows: by bucket, then by tile
  constexpr int W = sizeof(typename Row<D>::V) / sizeof(int32_t);
  int32_t* by_bucket = rows;
  int32_t* by_tile = rows + n * W;
  const size_t hist_smem = (size_t)tiles * sizeof(int32_t);
  const size_t tile_smem = (size_t)kb * (D + 1) * sizeof(int32_t);
  // partition and extra-fold blocks: a few an SM, walking their items
  const int64_t grid = 8 * (int64_t)max_blocks;
  int err;
  segsum_bin_count<<<(unsigned)blocks, BIN_THREADS, hist_smem, stream>>>(
      keys, valid, n, chunk, num_keys, shift, tiles, hist, ovf_part);
  if ((err = (int)cudaGetLastError())) return err;
  segsum_tile_totals<<<(tiles + 31) / 32, SCAN_WARPS * 32, 0, stream>>>(
      hist, (int)blocks, tiles, tile_total);
  if ((err = (int)cudaGetLastError())) return err;
  segsum_scan_tiles<<<1, TILES_THREADS, 0, stream>>>(
      tile_total, tiles, ovf_part, (int)blocks, split, tile_start,
      extra_start, tile_cur, bucket_cur, item_start, overflow);
  if ((err = (int)cudaGetLastError())) return err;
  const int64_t batches = (n + BATCH - 1) / BATCH;
  segsum_to_buckets<D><<<(unsigned)(batches < grid ? batches : grid),
                         PART_THREADS, 0, stream>>>(
      keys, values, valid, n, num_keys, shift, buckets, bucket_cur,
      tile_cur, by_bucket, by_tile);
  if ((err = (int)cudaGetLastError())) return err;
  const int64_t items = batches + buckets;   // >= item_start[buckets]
  segsum_to_tiles<D><<<(unsigned)(items < grid ? items : grid),
                       PART_THREADS, 0, stream>>>(
      by_bucket, tiles, shift, tile_start, item_start, bucket_cur, buckets,
      tile_cur, by_tile);
  if ((err = (int)cudaGetLastError())) return err;
  segsum_fold<T, D><<<tiles, FOLD_THREADS, tile_smem, stream>>>(
      by_tile, tile_start, num_keys, shift, split, table, counts);
  if ((err = (int)cudaGetLastError())) return err;
  const int64_t extra = n / split + 1;       // > extra_start[tiles]
  segsum_fold_extra<T, D><<<(unsigned)(extra < grid ? extra : grid),
                            FOLD_THREADS, tile_smem, stream>>>(
      by_tile, tile_start, extra_start, tiles, num_keys, shift, split, table,
      counts);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_binned_d(const void* keys, const void* values, const void* valid,
                    int64_t n, int d, int64_t num_keys, int shift, int split,
                    int max_blocks, void* meta, void* rows, void* table,
                    void* counts, void* overflow, void* stream) {
  if (n <= 0) return 0;
  auto args = [&](auto launch) {
    return launch((const int32_t*)keys, (const int32_t*)values,
                  (const uint8_t*)valid, n, num_keys, shift, split,
                  max_blocks, (int32_t*)meta, (int32_t*)rows, (T*)table,
                  (int32_t*)counts, (int32_t*)overflow,
                  (cudaStream_t)stream);
  };
  switch (d) {
    case 1: return args(launch_binned<T, 1>);
    case 2: return args(launch_binned<T, 2>);
    case 3: return args(launch_binned<T, 3>);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The parent design, kept as the route for what the binned one does not
// take: outputs must arrive zero-filled.
extern "C" int segment_sum_atomic_i32(const void* keys, const void* values,
                                      const void* valid, int64_t n, int d,
                                      int64_t num_keys, void* table,
                                      void* counts, void* overflow,
                                      int blocks, void* stream) {
  return launch_atomic<int32_t>(
      (const int32_t*)keys, (const int32_t*)values, (const uint8_t*)valid, n,
      d, num_keys, (int32_t*)table, (int32_t*)counts, (int32_t*)overflow,
      blocks, (cudaStream_t)stream);
}

extern "C" int segment_sum_atomic_f32(const void* keys, const void* values,
                                      const void* valid, int64_t n, int d,
                                      int64_t num_keys, void* table,
                                      void* counts, void* overflow,
                                      int blocks, void* stream) {
  return launch_atomic<float>(
      (const int32_t*)keys, (const float*)values, (const uint8_t*)valid, n,
      d, num_keys, (float*)table, (int32_t*)counts, (int32_t*)overflow,
      blocks, (cudaStream_t)stream);
}

// The binned route for d in 1..3: key tiles of 2**shift keys (table rows
// and counts within 48 KB of shared memory, at most MAX_BUCKETS *
// BUCKET_TILES tiles), hot tiles folded in items of `split` rows, at most
// max_blocks blocks in the counting pass.  meta holds segsum_meta_ints(max_blocks, tiles) ints and
// rows 2 * n * segsum_row_words(d); the outputs need no initialisation.
extern "C" int segsum_meta_ints(int max_blocks, int tiles) {
  return meta_ints(max_blocks, tiles);
}

extern "C" int segsum_row_words(int d) { return d == 1 ? 2 : 4; }

extern "C" int segment_sum_binned_i32(const void* keys, const void* values,
                                      const void* valid, int64_t n, int d,
                                      int64_t num_keys, int shift, int split,
                                      int max_blocks, void* meta, void* rows,
                                      void* table, void* counts,
                                      void* overflow, void* stream) {
  return launch_binned_d<int32_t>(keys, values, valid, n, d, num_keys, shift,
                                  split, max_blocks, meta, rows, table,
                                  counts, overflow, stream);
}

extern "C" int segment_sum_binned_f32(const void* keys, const void* values,
                                      const void* valid, int64_t n, int d,
                                      int64_t num_keys, int shift, int split,
                                      int max_blocks, void* meta, void* rows,
                                      void* table, void* counts,
                                      void* overflow, void* stream) {
  return launch_binned_d<float>(keys, values, valid, n, d, num_keys, shift,
                                split, max_blocks, meta, rows, table, counts,
                                overflow, stream);
}
