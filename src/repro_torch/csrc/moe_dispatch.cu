// MoE dispatch slotting, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/moe_dispatch/kernel.py:_dispatch_kernel
// (wrapper moe_dispatch_kernel).  It computes the same function:
//   positions[i] = #{ j < i : a[j] == a[i] }      (stable slot in group)
//   counts[g]    = #{ j : a[j] == g }
// for group ids a[i] in [0, G).  An id outside [0, G) matches no group:
// its position is 0 and it is counted nowhere, as in the reference.
//
// The TPU kernel walks the blocks in order and carries the per-group
// running counts in VMEM from one grid step to the next.  Blocks on Hopper
// run in no order, so the carry has to cross blocks some other way.  Two
// routes, picked by the wrapper from n and G alone:
//
// Route `cluster` (n <= CLUSTER_REACH ids, G <= CLUSTER_GROUPS): one
// launch, dispatch_cluster.  One thread-block cluster covers the whole
// input: 16 blocks where the card allows a non-portable cluster of that
// size, else 8, fewer for a short input (up to 4,096 ids take one block,
// launched without a cluster; a decode step's few ids one warp).  Block b
// takes a contiguous slice; each of its warps a contiguous run of
// `items` x 32 ids, which it loads at once (coalesced, kept in registers)
// and ranks 32 at a time.  The lanes holding the same group as a lane are
// those that agree with it on each of the group's log2(G) bits: one
// __ballot_sync a bit (__match_any_sync, which the first version used,
// takes several passes when a step holds many distinct ids, and was the
// largest part of that version's time at a prefill's shape on the card);
// __popc(peers & lanes_below) is a lane's rank among them.  For G <= 32
// lane g keeps the warp's count of group g in a register (read with one
// shuffle, raised by the __popc of its own group's peers); for more
// groups a per-warp [G] histogram in shared memory carries the counts
// from one step to the next.  The block scans its warps' counts group by
// group (each warp's exclusive base, and the block's totals) and pushes
// its totals into the shared memory of every later block of the cluster
// (distributed shared memory stores); after one cluster barrier each
// block sums what the earlier blocks pushed, the last block writes
// counts, and each position is written once.  No global scratch, no
// second read of the ids, no second launch, one cluster barrier (the
// first version pulled the totals after a barrier and needed a second
// one).  Each (cluster or block, G <= 32 or not, ids a lane) shape is its
// own instance, with no more unrolled code than it runs: a kernel this
// short runs from a cold instruction cache, and the first version's one
// instance for 16 ids a lane was slower at a decode step's 32 ids than
// the tiled route's small kernel.
//
// Route `tiled` (longer inputs, or more groups than shared memory holds
// per warp): three passes, the port's first design.
//   1. tile_rank: one warp per tile of 32 * chunks elements, ranked 32
//      at a time by __match_any_sync and a per-warp histogram in shared
//      memory; it writes each element's rank within its tile and the
//      tile's histogram, stored group-major [G, tiles].
//   2. scan_tiles: one block per group turns its row of tile counts into
//      an exclusive prefix and writes the group's total to counts.
//   3. add_base: each element adds its tile's prefix for its group.
// With one tile pass 1 writes counts directly and passes 2 and 3 are
// skipped.  Tiles hold at least G elements, so the [G, tiles] scratch
// never exceeds n + G ints.
//
// Both are exact and do not depend on the order in which blocks run.
//
// What bounds it: bytes.  It must read n ids and write n positions and G
// counts; at a prefill's n = 65,536 that is 0.5 MB, ~0.16 us at 3.35 TB/s,
// so a launch's own latency and the few dependent steps inside it (the
// loads, the cluster barrier, the stores) set its time.
//
// Interface: plain C, loaded with ctypes.  The launchers return
// cudaGetLastError() of their launches (0 = success) and launch nothing
// for n == 0.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <initializer_list>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 256;
constexpr int ADD_THREADS = 256;

// ---------------------------------------------------------------------------
// route cluster
// ---------------------------------------------------------------------------

// The cluster route.  Its reach is what a portable cluster of 8 blocks of
// 32 warps covers at CLUSTER_ITEMS ids a lane; a cluster of 16 blocks
// covers it at half the ids a lane.  CLUSTER_REACH and CLUSTER_GROUPS are
// mirrored by the wrapper (kernels/moe_dispatch/kernel.py).
constexpr int CLUSTER_WARPS = 32;
constexpr int CLUSTER_THREADS = CLUSTER_WARPS * 32;
constexpr int CLUSTER_ITEMS = 16;
constexpr int PORTABLE_CLUSTER = 8;
constexpr int WIDE_CLUSTER = 16;
constexpr int CLUSTER_REACH =
    PORTABLE_CLUSTER * CLUSTER_THREADS * CLUSTER_ITEMS;  // 131,072
constexpr int CLUSTER_GROUPS = 1024;
constexpr int GROUP_BITS = 10;  // a group id below CLUSTER_GROUPS
static_assert(CLUSTER_GROUPS <= (1 << GROUP_BITS) &&
                  CLUSTER_REACH < (1 << (31 - GROUP_BITS)),
              "a rank and a group share one int");
// Ids a block takes before a second block joins the cluster, and a lane
// before a second warp joins the block.
constexpr int CLUSTER_BLOCK_IDS = 4096;
constexpr int CLUSTER_LANE_IDS = 4;
constexpr int MAX_DEVICES = 64;

// Shared memory of a cluster block: a [G] histogram per warp, the block's
// totals and the earlier blocks' sum, and in a cluster the [WIDE_CLUSTER,
// G] totals the earlier blocks push.
inline size_t cluster_smem(int warps, int G, bool clustered) {
  return (size_t)(warps + 2 + (clustered ? WIDE_CLUSTER : 0)) * G *
         sizeof(int);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// One cluster (CLUSTERED) or one block covers a[0, n).  Warp w of block b
// takes ids [(b * warps + w) * items * 32, ...) and holds them, items <=
// ITEMS a lane.  SMALL (G <= 32): lane j keeps the warp's count of group j
// in a register; else the warp's counts live in its shared-memory
// histogram.  ITEMS and SMALL keep each instance's unrolled code no longer
// than its inputs need: a launch of a short kernel runs from a cold
// instruction cache.  See the note at the top.
template <bool CLUSTERED, bool SMALL, int ITEMS>
__global__ void __launch_bounds__(CLUSTER_THREADS)
dispatch_cluster(const int* __restrict__ a, int n, int G, int items,
                 int* __restrict__ pos, int* __restrict__ counts) {
  constexpr int MAX_BITS = SMALL ? 5 : GROUP_BITS;
  extern __shared__ int sm[];
  if (CLUSTERED) cluster_arrive_relaxed();  // this block has started
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* hist = sm + warp * G;        // this warp's counts, then its base
  int* total = sm + warps * G;      // the block's totals
  int* base = total + G;            // the earlier blocks' totals, summed
  int* pushed = base + G;           // [WIDE_CLUSTER, G]: theirs, by block
  if (!SMALL)
    for (int g = lane; g < G; g += 32) hist[g] = 0;
  const int first = (blockIdx.x * warps + warp) * items * 32;
  int id[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = first + i * 32 + lane;
    int g = -1;
    if (i < items && e < n) g = a[e];
    id[i] = g >= 0 && g < G ? g : -1;  // -1: matches no group
  }
  if (!SMALL) __syncwarp();
  // Rank 32 ids a step.  The lanes holding the same group as this lane
  // are those that agree with it on each of the group's bits: one ballot a
  // bit.  id[i] becomes (rank within the warp << GROUP_BITS) | group, or
  // stays -1: one register an id.
  const int bits = 32 - __clz(G - 1);  // 0 for one group
  const unsigned below = (1u << lane) - 1u;
  int count = 0;  // SMALL: the warp's ids of group `lane` so far
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (i < items && first + i * 32 < n) {  // uniform across the warp
      const int g = id[i];
      const unsigned valid = __ballot_sync(FULL, g >= 0);
      unsigned peers = valid, mine = valid;
#pragma unroll
      for (int bit = 0; bit < MAX_BITS; ++bit) {
        if (bit < bits) {
          const unsigned set = __ballot_sync(FULL, (g >> bit) & 1);
          peers &= (g >> bit) & 1 ? set : ~set;
          if (SMALL) mine &= (lane >> bit) & 1 ? set : ~set;
        }
      }
      const int r = __popc(peers & below);
      if (SMALL) {
        const int before = __shfl_sync(FULL, count, g & 31);
        if (g >= 0) id[i] = ((before + r) << GROUP_BITS) | g;
        count += __popc(mine);  // lanes past G see no id: 0
      } else {
        if (g >= 0) id[i] = ((hist[g] + r) << GROUP_BITS) | g;
        __syncwarp();
        if (g >= 0 && r == 0) hist[g] += __popc(peers);  // one lane per id
        __syncwarp();
      }
    }
  }
  if (!CLUSTERED && warps == 1) {
    // one warp: its counts are the counts, its ranks the positions
    if (SMALL) {
      if (lane < G) counts[lane] = count;
    } else {
      __syncwarp();
      for (int g = lane; g < G; g += 32) counts[g] = hist[g];
    }
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int e = first + i * 32 + lane;
      if (i < items && e < n) pos[e] = id[i] >= 0 ? id[i] >> GROUP_BITS : 0;
    }
    return;
  }
  if (SMALL && lane < G) hist[lane] = count;
  __syncthreads();
  const int b = blockIdx.x, nb = gridDim.x;
  if (CLUSTERED) cluster_wait();  // every block has started
  // each warp's histogram -> its exclusive base within the block; the
  // block's totals pushed to every later block of the cluster
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    int run = 0;
    for (int w = 0; w < warps; ++w) {
      const int v = sm[w * G + g];
      sm[w * G + g] = run;
      run += v;
    }
    total[g] = run;
    if (CLUSTERED) {
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      for (int r = b + 1; r < nb; ++r)
        cluster.map_shared_rank(pushed, r)[b * G + g] = run;
    } else {
      base[g] = 0;
      counts[g] = run;
    }
  }
  if (CLUSTERED) {
    namespace cg = cooperative_groups;
    cg::this_cluster().sync();  // every push has landed
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      int before = 0;
      for (int r = 0; r < b; ++r) before += pushed[r * G + g];
      base[g] = before;
      if (b == nb - 1) counts[g] = before + total[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = first + i * 32 + lane;
    if (i < items && e < n) {
      const int v = id[i], g = v & ((1 << GROUP_BITS) - 1);
      pos[e] = v >= 0 ? (v >> GROUP_BITS) + hist[g] + base[g] : 0;
    }
  }
}

// The widest cluster this device runs dispatch_cluster in (16 blocks
// where a non-portable size is allowed, else 8), found once per device;
// the kernel's attributes are set then too.  Returns a negative CUDA
// error on failure.
// The kernel's instances: one block (ITEMS 1, 4, 8 or 16 ids a lane) or
// one cluster (4, 8 or 16), each for G <= 32 (SMALL) or more.
using DispatchKernel = void (*)(const int*, int, int, int, int*, int*);
const DispatchKernel ONE_BLOCK[] = {
    dispatch_cluster<false, true, 1>,  dispatch_cluster<false, true, 4>,
    dispatch_cluster<false, true, 8>,  dispatch_cluster<false, true, 16>,
    dispatch_cluster<false, false, 1>, dispatch_cluster<false, false, 4>,
    dispatch_cluster<false, false, 8>, dispatch_cluster<false, false, 16>};
const DispatchKernel CLUSTERS[] = {
    dispatch_cluster<true, true, 4>,  dispatch_cluster<true, true, 8>,
    dispatch_cluster<true, true, 16>, dispatch_cluster<true, false, 4>,
    dispatch_cluster<true, false, 8>, dispatch_cluster<true, false, 16>};

// The widest cluster this device runs dispatch_cluster in (16 blocks
// where a non-portable size is allowed, else 8), found once per device;
// every instance's attributes are set then too.  Returns a negative CUDA
// error on failure.
int cluster_blocks() {
  static std::atomic<int> known[MAX_DEVICES];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return -err;
  if (dev < MAX_DEVICES) {
    const int got = known[dev].load(std::memory_order_acquire);
    if (got) return got;
  }
  const size_t one = cluster_smem(CLUSTER_WARPS, CLUSTER_GROUPS, false);
  const size_t many = cluster_smem(CLUSTER_WARPS, CLUSTER_GROUPS, true);
  for (DispatchKernel kernel : ONE_BLOCK) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)one);
    if (err) return -err;
  }
  int blocks = WIDE_CLUSTER;
  for (DispatchKernel kernel : CLUSTERS) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)many);
    if (err) return -err;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = WIDE_CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(WIDE_CLUSTER);
    cfg.blockDim = dim3(CLUSTER_THREADS);
    cfg.dynamicSmemBytes = many;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
            cudaSuccess ||
        clusters < 1)
      blocks = PORTABLE_CLUSTER;
  }
  cudaGetLastError();  // a refused query is an answer, not an error
  if (dev < MAX_DEVICES) known[dev].store(blocks, std::memory_order_release);
  return blocks;
}

// One launch of the cluster route in `blocks` blocks (one cluster, or a
// plain block when blocks == 1) of `warps` warps, `items` <= ITEMS ids a
// lane.
template <bool SMALL, int ITEMS>
int launch_shape(const int* a, int n, int G, int blocks, int warps,
                 int items, int* pos, int* counts, cudaStream_t stream) {
  if (blocks == 1) {
    dispatch_cluster<false, SMALL, ITEMS>
        <<<1, warps * 32, cluster_smem(warps, G, false), stream>>>(
            a, n, G, items, pos, counts);
    return (int)cudaGetLastError();
  }
  if constexpr (ITEMS > 1) {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)blocks;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3((unsigned)(warps * 32));
    cfg.dynamicSmemBytes = cluster_smem(warps, G, true);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, dispatch_cluster<true, SMALL, ITEMS>, a, n,
                           G, items, pos, counts);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;  // a cluster's lanes hold > 1 id
}

template <bool SMALL>
int launch_cluster_route(const int* a, int n, int G, int blocks, int warps,
                         int items, int* pos, int* counts,
                         cudaStream_t stream) {
  if (items <= 1 && blocks == 1)
    return launch_shape<SMALL, 1>(a, n, G, blocks, warps, items, pos,
                                  counts, stream);
  if (items <= 4)
    return launch_shape<SMALL, 4>(a, n, G, blocks, warps, items, pos,
                                  counts, stream);
  if (items <= 8)
    return launch_shape<SMALL, 8>(a, n, G, blocks, warps, items, pos,
                                  counts, stream);
  return launch_shape<SMALL, CLUSTER_ITEMS>(a, n, G, blocks, warps, items,
                                            pos, counts, stream);
}

// ---------------------------------------------------------------------------
// route tiled
// ---------------------------------------------------------------------------

__global__ void tile_rank(const int* __restrict__ a, int64_t n, int G,
                          int chunks, int tiles, int warps_per_block,
                          int* __restrict__ pos,
                          int* __restrict__ tile_counts) {
  extern __shared__ int hist_all[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tile = blockIdx.x * warps_per_block + warp;
  if (tile >= tiles) return;  // whole warps leave together
  int* hist = hist_all + (int64_t)warp * G;
  for (int g = lane; g < G; g += 32) hist[g] = 0;
  __syncwarp();
  const unsigned below = (1u << lane) - 1u;
  const int64_t base = (int64_t)tile * chunks * 32;
  for (int c = 0; c < chunks; ++c) {
    const int64_t first = base + (int64_t)c * 32;
    if (first >= n) break;  // uniform across the warp
    const int64_t i = first + lane;
    const bool in = i < n;
    const int g = in ? a[i] : -1;
    const bool ok = in && g >= 0 && g < G;
    const unsigned peers = __match_any_sync(FULL, ok ? g : -1);
    const int rank = __popc(peers & below);
    const int p = ok ? hist[g] + rank : 0;
    __syncwarp();
    if (ok && rank == 0) hist[g] += __popc(peers);  // one lane per id
    __syncwarp();
    if (in) pos[i] = p;
  }
  for (int g = lane; g < G; g += 32)
    tile_counts[(int64_t)g * tiles + tile] = hist[g];
}

// Row g of tile_counts [G, tiles] -> its exclusive prefix, in place;
// counts[g] = the row's total.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_tiles(int* __restrict__ tile_counts, int tiles,
           int* __restrict__ counts) {
  __shared__ int warp_sums[32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int WARPS = SCAN_THREADS / 32;
  int* row = tile_counts + (int64_t)blockIdx.x * tiles;
  int carry = 0;
  for (int start = 0; start < tiles; start += SCAN_THREADS) {
    const int t = start + threadIdx.x;
    const int v = t < tiles ? row[t] : 0;
    int x = v;  // inclusive scan within the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int s = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, s, off);
        if (lane >= off) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
    if (t < tiles) row[t] = carry + before;
    carry += warp_sums[WARPS - 1];
    __syncthreads();  // warp_sums is rewritten by the next round
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(ADD_THREADS)
add_base(const int* __restrict__ a, int64_t n, int G, int64_t tile_elems,
         int tiles, const int* __restrict__ prefix, int* __restrict__ pos) {
  const int64_t i = (int64_t)blockIdx.x * ADD_THREADS + threadIdx.x;
  if (i >= n) return;
  const int g = a[i];
  if (g < 0 || g >= G) return;
  pos[i] += prefix[(int64_t)g * tiles + (int)(i / tile_elems)];
}

}  // namespace

// The cluster route.  a, pos: [n] int32; counts: [G] int32 (every entry
// written).  Takes 1 <= n <= CLUSTER_REACH and 1 <= G <= CLUSTER_GROUPS.
extern "C" int moe_dispatch_cluster_i32(const int* a, int64_t n, int G,
                                        int* pos, int* counts,
                                        void* stream_) {
  if (n == 0) return 0;
  if (n < 0 || n > CLUSTER_REACH || G < 1 || G > CLUSTER_GROUPS)
    return (int)cudaErrorInvalidValue;
  const int widest = cluster_blocks();
  if (widest < 0) return -widest;
  const int ni = (int)n;
  const int blocks =
      std::min(widest, (ni + CLUSTER_BLOCK_IDS - 1) / CLUSTER_BLOCK_IDS);
  const int per_block = (ni + blocks - 1) / blocks;
  const int warps = std::min(
      CLUSTER_WARPS, (per_block + 32 * CLUSTER_LANE_IDS - 1) /
                         (32 * CLUSTER_LANE_IDS));
  const int items = (ni + blocks * warps * 32 - 1) / (blocks * warps * 32);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  return G <= 32 ? launch_cluster_route<true>(a, ni, G, blocks, warps, items,
                                              pos, counts, stream)
                 : launch_cluster_route<false>(a, ni, G, blocks, warps,
                                               items, pos, counts, stream);
}

// The blocks of this device's widest dispatch cluster (16 or 8), or a
// negative CUDA error.
extern "C" int moe_dispatch_cluster_width() { return cluster_blocks(); }

// The tiled route.  a, pos: [n] int32; counts: [G] int32; scratch:
// [G * tiles] int32 with tiles = ceil(n / (32 * chunks)), unused when
// tiles == 1.  The caller picks chunks >= ceil(G / 32) and
// warps_per_block with warps_per_block * G * 4 bytes of shared memory
// within the device's per-block limit.
extern "C" int moe_dispatch_tiled_i32(const int* a, int64_t n, int G,
                                      int chunks, int warps_per_block,
                                      int* pos, int* counts, int* scratch,
                                      void* stream_) {
  if (n == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int64_t tile_elems = (int64_t)chunks * 32;
  const int tiles = (int)((n + tile_elems - 1) / tile_elems);
  const size_t smem = (size_t)warps_per_block * G * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_rank, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int* tile_counts = tiles == 1 ? counts : scratch;
  const int blocks = (tiles + warps_per_block - 1) / warps_per_block;
  tile_rank<<<blocks, warps_per_block * 32, smem, stream>>>(
      a, n, G, chunks, tiles, warps_per_block, pos, tile_counts);
  if (tiles > 1) {
    scan_tiles<<<G, SCAN_THREADS, 0, stream>>>(scratch, tiles, counts);
    add_base<<<(unsigned)((n + ADD_THREADS - 1) / ADD_THREADS), ADD_THREADS,
               0, stream>>>(a, n, G, tile_elems, tiles, scratch, pos);
  }
  return (int)cudaGetLastError();
}
