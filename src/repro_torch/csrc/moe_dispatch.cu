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
// Design.  The TPU kernel walks the blocks in order and carries the
// per-group running counts in VMEM from one grid step to the next.  Blocks
// on Hopper run in no order, so the carry becomes three passes:
//   1. tile_rank: one warp per tile of 32 * chunks elements.  The warp
//      walks its tile 32 elements at a time; __match_any_sync groups the
//      lanes with equal ids, __popc(peers & lanes_below) is a lane's rank
//      among them, and a per-warp histogram in shared memory carries the
//      counts from one 32-element step to the next.  It writes each
//      element's rank within its tile and the tile's histogram, stored
//      group-major [G, tiles].
//   2. scan_tiles: one block per group turns its row of tile counts into
//      an exclusive prefix (the counts of the same group in earlier
//      tiles) and writes the group's total to counts.
//   3. add_base: each element adds its tile's prefix for its group.
// With one tile (a decode step's few ids) pass 1 writes counts directly
// and passes 2 and 3 are skipped.  Tiles hold at least G elements, so the
// [G, tiles] scratch never exceeds n + G ints.  The result is exact and
// does not depend on the order in which blocks run.
//
// What bounds it: bytes.  It must read n ids and write n positions and G
// counts; at a prefill's n = 65,536 that is 0.5 MB, ~0.16 us at 3.35 TB/s,
// so the launches' own latency dominates.
//
// Interface: plain C, loaded with ctypes.  The launcher returns
// cudaGetLastError() of its launches (0 = success) and launches nothing
// for n == 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SCAN_THREADS = 256;
constexpr int ADD_THREADS = 256;

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

// a, pos: [n] int32; counts: [G] int32; scratch: [G * tiles] int32 with
// tiles = ceil(n / (32 * chunks)), unused when tiles == 1.  The caller
// picks chunks >= ceil(G / 32) and warps_per_block with
// warps_per_block * G * 4 bytes of shared memory within the device's
// per-block limit.
extern "C" int moe_dispatch_i32(const int* a, int64_t n, int G, int chunks,
                                int warps_per_block, int* pos, int* counts,
                                int* scratch, void* stream_) {
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
