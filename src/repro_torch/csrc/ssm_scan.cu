// Fused selective scan (the hybrid family's SSM), for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   src/repro/kernels/ssm_scan/kernel.py:_ssm_kernel
// (wrapper ssm_scan_kernel).  It computes the same function:
//   proj[b,t,:] = xc[b,t,:] . x_proj            (f32, columns B | C | dt)
//   dt   = softplus(proj[b,t,2n] + dt_bias[d])
//   a    = exp(-exp(a_log[d,n]) * dt)
//   h    = a * h + (dt * xc[b,t,d]) * B[n]      (h starts at h0[b,d,n])
//   y[b,t,d] = sum_n h * C[n]
// with every product and sum in float32, y and the final h in float32,
// and no d_skip term (the model adds it outside).  xc and x_proj are
// float32 or bfloat16 (both of one type); dt_bias, a_log and h0 float32.
//
// The TPU kernel walks a sequential grid over chunks of T with h[d, n] in
// VMEM.  Hopper has no sequential grid and 132 SMs to fill, so the scan
// is parallel over T as well.  Two routes, chosen by the caller
// (kernels/ssm_scan/kernel.py:route):
//
// The chunked route (T > 1, a prefill): four launches (two for T <= L).
//   1. The projection.  bf16: ssm_proj_mma, on the tensor cores
//      (mma.sync m16n8k16, bf16 x bf16 -> f32, exact products; only the
//      order of the sum over d differs from an f32 product).  A block
//      takes 64 rows of xc ([B*T, d]) and keeps x_proj in shared memory
//      as it lies; two warps share each 16 rows, each taking every other
//      256-wide block of d, their sums added in a fixed order.  float32:
//      ssm_proj_rows (CUDA cores, no TF32), over all of d.  No split of
//      d across blocks, so no summing pass.  Rows go out in the scan's
//      layout: B, C and dt in slots of NS (n rounded up to 4, 8, 16 or
//      32), unused slots zero.
//   2. ssm_chunk_end: T is cut into chunks of L = CHUNK = 128 steps
//      (measured against 32 to 256 on the H100; fixed at compile time, so
//      a chunk's rows sit in static shared memory).  One thread owns one
//      (b, chunk, channel) and all n states of its channel in registers; it
//      scans its chunk from h = 0 and writes the chunk's end state and sum
//      of dt.  A block is one (b, chunk) and 128 neighbouring channels
//      (coalesced x loads); the chunk's B | C | dt rows sit in shared
//      memory, read as float4 broadcasts.  softplus and dt * x are
//      computed once a channel-step, not once a state.
//   3. ssm_chunk_carry: one thread a state carries it across the chunk
//      ends, h_in[c+1] = exp(-A * sum dt[c]) * h_in[c] + h_end[c] from
//      h0: T/L dependent steps, not T.
//   4. ssm_chunk_scan: the blocks of pass 2, all chunks; each thread
//      re-runs its chunk from h_in, writing y (sum_n h * C in the
//      thread: 16 FMAs, no shuffles) and, in the last chunk, the final h.
//   Only exp(-A * (a sum of dt >= 0)) is ever formed, never exp(+A * ..),
//   which overflows float32 within a chunk.  Passes 2 and 3 cover chunks
//   0 .. nc-2 only and are not launched for T <= L.
//
// The step route (T = 1, a decode step): one launch, ssm_step, clusters
// of 4 blocks.  A cluster takes 512 channels of one batch row; each of
// its blocks reduces the 2n+1 projection columns over a quarter of d
// from x_proj rows it stages in shared memory, and the cluster adds the
// four partials through distributed shared memory in a fixed order.
// Each block then updates its 128 channels' states one element a thread
// (coalesced in h0, h_out and a_log).  No scratch, no second launch.
//
// What bounds it.  At hymba's prefill (4 x 2048 x 1600, n = 16) the
// bytes (xc read once, y written once: ~79 MB) take ~24 us at 3.35 TB/s
// and the operations (~2.3 G at the CUDA cores' 67 T/s) ~35 us; but each
// state-step needs one exp and each channel-step a softplus (exp and
// log1p), ~236 M transcendentals on the MUFU units, 16 results a clock
// an SM: ~0.056 ms at 1.98 GHz, and ~0.11 ms here, where pass 4 re-runs
// the state-steps of pass 2.  That MUFU floor, not the 0.036 ms
// operations bound, is what this design can reach; moving part of the
// exps onto the FMA units by a polynomial would lower it.  A decode step
// is latency: a few dependent round trips to L2 and a cluster barrier.
//
// The serial kernel (ssm_scan_states, with its split projection; the
// route until this redesign) stays callable as ssm_scan_serial_* so that
// the two can be timed in turns on one card; the wrapper never takes it.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns the first
// non-zero cudaGetLastError() of its launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include <cooperative_groups.h>

#include "ssm_scan.cuh"

namespace {

constexpr int MAX_COLS = 2 * MAX_STATE + 1;
constexpr int PROJ_ROWS = 64;     // rows of xc per block (pass 1)
constexpr int PROJ_K = 32;        // d-chunk staged in shared memory
constexpr int PROJ_THREADS = 256; // 64 rows x 4 column groups
constexpr int COL_GROUPS = PROJ_THREADS / PROJ_ROWS;
constexpr int COLS_PER_THREAD = (MAX_COLS + COL_GROUPS - 1) / COL_GROUPS;
constexpr int SCAN_THREADS = 128; // the serial scan
constexpr int UNROLL = 8;         // steps whose loads are issued together
// The serial kernel's projection splits d over blocks.y until about this
// many blocks (two an SM of 132) run: 3 slices at hymba's prefill, 50 at a
// decode step.
constexpr int SERIAL_PROJ_BLOCKS = 264;

// Where column c (of 2n+1) of a projection row goes: as it is (ns = 0),
// or B at [0, n), C at [ns, ns + n) and dt at 2 ns (the chunked route's
// rows of 2 ns + 4 floats, 16-byte aligned and read as float4).
__host__ __device__ __forceinline__ int proj_slot(int c, int n, int ns) {
  return ns == 0 ? c : c < n ? c : c < 2 * n ? ns + c - n : 2 * ns;
}

// Zeros the slots of a chunked-route proj row that no column fills (B and
// C past n), so that the scan can run all NS slots without a test: they
// then add 0 to h and to y.  Lane `lane` of `lanes` takes every lanes-th.
__device__ __forceinline__ void zero_unused(float* row, int n, int ns,
                                            int lane, int lanes) {
  for (int z = n + lane; z < ns; z += lanes) row[z] = row[ns + z] = 0.f;
}

// Block (x, y): rows 64x .. 64x + 63, d-slice y of gridDim.y, each slice
// `k_per` wide (a multiple of PROJ_K).  Row r of slice y goes to
// proj[(y * rows + r) * ld + proj_slot(c, n, ns)].
template <typename T>
__global__ void __launch_bounds__(PROJ_THREADS)
ssm_proj_rows(const T* __restrict__ xc, const T* __restrict__ w,
              float* __restrict__ proj, int64_t rows, int d, int n, int ns,
              int ld, int k_per) {
  const int cols = 2 * n + 1;
  __shared__ float xs[PROJ_ROWS][PROJ_K + 1];
  __shared__ float ws[PROJ_K][MAX_COLS];
  const int tid = threadIdx.x;
  const int r = tid % PROJ_ROWS;
  const int cg = tid / PROJ_ROWS;  // one column group per 2 warps
  const int64_t row0 = (int64_t)blockIdx.x * PROJ_ROWS;
  const int k_begin = blockIdx.y * k_per;
  const int k_end = min(d, k_begin + k_per);
  proj += (int64_t)blockIdx.y * rows * ld;

  float acc[COLS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < COLS_PER_THREAD; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += PROJ_K) {
    // a warp loads 32 consecutive elements of one row
    for (int i = tid; i < PROJ_ROWS * PROJ_K; i += PROJ_THREADS) {
      const int rr = i / PROJ_K, kk = i % PROJ_K;
      const int64_t row = row0 + rr;
      const int k = k0 + kk;
      xs[rr][kk] = (row < rows && k < k_end) ? to_f(xc[row * d + k]) : 0.f;
    }
    // x_proj rows k0 .. k0 + 31 lie contiguous: [PROJ_K * cols]
    for (int i = tid; i < PROJ_K * cols; i += PROJ_THREADS) {
      const int kk = i / cols, c = i % cols;
      ws[kk][c] = (k0 + kk < k_end) ? to_f(w[(int64_t)k0 * cols + i]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < PROJ_K; ++kk) {
      const float xv = xs[r][kk];  // stride 33: no bank conflicts
#pragma unroll
      for (int i = 0; i < COLS_PER_THREAD; ++i) {
        const int c = cg + COL_GROUPS * i;  // one c per warp: a broadcast
        if (c < cols) acc[i] = fmaf(xv, ws[kk][c], acc[i]);
      }
    }
    __syncthreads();
  }
  const int64_t row = row0 + r;
  if (row >= rows) return;
#pragma unroll
  for (int i = 0; i < COLS_PER_THREAD; ++i) {
    const int c = cg + COL_GROUPS * i;
    if (c < cols) proj[row * ld + proj_slot(c, n, ns)] = acc[i];
  }
  zero_unused(proj + row * ld, n, ns, cg, COL_GROUPS);
}

// proj[0] += proj[1] + ... + proj[splits - 1], element by element.
__global__ void ssm_proj_sum(float* __restrict__ proj, int64_t count,
                             int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float v = proj[i];
  for (int k = 1; k < splits; ++k) v += proj[k * count + i];
  proj[i] = v;
}

// The serial scan: one thread per state (b, d, n) walks all of T.
// G: lanes per channel, a power of two >= n and <= 32.
template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
ssm_scan_states(const T* __restrict__ xc, const float* __restrict__ proj,
                const float* __restrict__ dt_bias,
                const float* __restrict__ a_log,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_out, int steps, int d, int n, int G) {
  const int lane = threadIdx.x % G;
  const int ch = blockIdx.x * (SCAN_THREADS / G) + threadIdx.x / G;
  const int b = blockIdx.y;
  const bool active = ch < d && lane < n;
  // idle lanes read valid addresses and add 0 to the group's sum
  const int c = min(ch, d - 1);
  const int s = min(lane, n - 1);
  const int cols = 2 * n + 1;

  const float A = expf(a_log[(int64_t)c * n + s]);
  const float bias = dt_bias[c];
  const int64_t state = ((int64_t)b * d + c) * n + s;
  float h = active ? h0[state] : 0.f;
  const T* xb = xc + (int64_t)b * steps * d + c;
  const float* pb = proj + (int64_t)b * steps * cols;
  float* yb = y + (int64_t)b * steps * d + c;
  const bool writes = lane == 0 && ch < d;

  auto step = [&](int t, float x, float bt, float ct, float dr) {
    const float dt = softplus(dr + bias);
    const float a = expf(-A * dt);
    h = a * h + (dt * x) * bt;
    float part = active ? h * ct : 0.f;
    for (int off = G / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (writes) yb[(int64_t)t * d] = part;
  };

  int t = 0;
  for (; t + UNROLL <= steps; t += UNROLL) {
    float xv[UNROLL], bv[UNROLL], cv[UNROLL], dv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float* pr = pb + (int64_t)(t + u) * cols;
      xv[u] = to_f(xb[(int64_t)(t + u) * d]);
      bv[u] = pr[s];
      cv[u] = pr[n + s];
      dv[u] = pr[2 * n];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) step(t + u, xv[u], bv[u], cv[u], dv[u]);
  }
  for (; t < steps; ++t) {
    const float* pr = pb + (int64_t)t * cols;
    step(t, to_f(xb[(int64_t)t * d]), pr[s], pr[n + s], pr[2 * n]);
  }
  if (active) h_out[state] = h;
}

// The d-slices of the serial kernel's projection at rows = b * steps.
inline int serial_splits(int64_t rows, int d) {
  const int64_t row_blocks = (rows + PROJ_ROWS - 1) / PROJ_ROWS;
  const int64_t k_chunks = (d + PROJ_K - 1) / PROJ_K;
  const int64_t want = (SERIAL_PROJ_BLOCKS + row_blocks - 1) / row_blocks;
  return (int)std::max<int64_t>(1, std::min(k_chunks, want));
}

template <typename T>
int launch_serial(const void* xc, const void* x_proj, const float* dt_bias,
                  const float* a_log, const float* h0, float* proj, float* y,
                  float* h_out, int b, int steps, int d, int n,
                  cudaStream_t stream) {
  if (b <= 0 || steps <= 0 || d <= 0 || n <= 0 || n > MAX_STATE)
    return (int)cudaErrorInvalidValue;
  const int64_t rows = (int64_t)b * steps;
  const int k_chunks = (d + PROJ_K - 1) / PROJ_K;
  int splits = serial_splits(rows, d);
  const int cols = 2 * n + 1;
  const int k_per = (k_chunks + splits - 1) / splits * PROJ_K;
  splits = (d + k_per - 1) / k_per;  // rounding may leave fewer slices
  const dim3 proj_grid((unsigned)((rows + PROJ_ROWS - 1) / PROJ_ROWS),
                       (unsigned)splits);
  ssm_proj_rows<T><<<proj_grid, PROJ_THREADS, 0, stream>>>(
      static_cast<const T*>(xc), static_cast<const T*>(x_proj), proj, rows,
      d, n, 0, cols, k_per);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (splits > 1) {
    const int64_t count = rows * cols;
    ssm_proj_sum<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
        proj, count, splits);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  int G = 1;
  while (G < n) G *= 2;
  const int per_block = SCAN_THREADS / G;
  const dim3 grid((unsigned)((d + per_block - 1) / per_block), (unsigned)b);
  ssm_scan_states<T><<<grid, SCAN_THREADS, 0, stream>>>(
      static_cast<const T*>(xc), proj, dt_bias, a_log, h0, y, h_out, steps,
      d, n, G);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The chunked route and the step route
// ---------------------------------------------------------------------------

constexpr int MMA_ROWS = 64;      // rows of xc per block, 16 per warp
constexpr int MMA_KSPLIT = 2;     // warps sharing a row group's k range
constexpr int MMA_THREADS = 128 * MMA_KSPLIT;
constexpr int MMA_KBLOCKS = 8;    // 32-wide blocks of k loaded at a time
constexpr int PROJ_SLAB_BYTES = 128 * 1024;  // x_proj rows staged at once
constexpr int CHUNK_THREADS = 128;  // channels of a chunk block
constexpr int STEP_THREADS = 256;   // threads of a step block
constexpr int STEP_CLUSTER = 4;     // blocks of a step cluster
constexpr int STEP_TILE = 512;      // channels of a step cluster
constexpr int STEP_SLICE = STEP_TILE / STEP_CLUSTER;  // ... of a block
// dynamic shared memory of a step block (the SM's 227 KB, less its
// static arrays)
constexpr size_t STEP_SMEM_BYTES = 216 * 1024;

// D = A (16x16, row) * B (16x8, col) + D, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Starts copying count elements of T from global to shared memory with
// cp.async (16 bytes a copy) where both ends are 16-byte aligned, and
// copies the rest (or all, unaligned) directly; the caller waits with
// async_wait_all() and a barrier before reading dst.  The step kernel
// overlaps its x_proj copy with its other loads this way; the chunk
// passes stage through registers (stage_slab), which measured faster for
// them on the H100.
template <typename T>
__device__ __forceinline__ void stage_slab_async(T* dst, const T* src,
                                                 int count) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    constexpr int PER = 16 / sizeof(T);
    const int packs = count / PER;
    const uint32_t base =
        static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    for (int i = tid; i < packs; i += nt)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       base + 16u * i),
                   "l"(src + (int64_t)i * PER));
    done = packs * PER;
  }
  for (int i = done + tid; i < count; i += nt) dst[i] = src[i];
}

__device__ __forceinline__ void async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// xc[row, k .. k+7] (zeros past rows or d): one 16-byte load where vec.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ xc,
                                       int64_t row, int k, int64_t rows,
                                       int d, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return v;
  const __nv_bfloat16* p = xc + row * d + k;
  if (vec && k + 8 <= d) return *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16 z = __float2bfloat16(0.f);
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = pack2(k + 2 * i < d ? p[2 * i] : z,
                 k + 2 * i + 1 < d ? p[2 * i + 1] : z);
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Rows of x_proj a projection block keeps in shared memory at once (a
// multiple of 32), and the dynamic shared memory that takes.
__host__ __device__ inline int proj_slab_rows(int cols) {
  return (PROJ_SLAB_BYTES / (cols * 2)) / 32 * 32;
}
// The slab's bytes, rounded to 16: the k-split's partial sums follow.
__host__ __device__ inline size_t proj_slab_bytes(int d, int cols) {
  const int rows = (d + 31) / 32 * 32;
  const int slab = proj_slab_rows(cols);
  // + 8: the padding columns of the last n8 tile read past the last row
  return ((size_t)(rows < slab ? rows : slab) * cols + 8) *
             sizeof(__nv_bfloat16) / 16 * 16 + 16;
}
template <int NS>
constexpr size_t proj_red_bytes() {
  return (size_t)(MMA_KSPLIT - 1) * MMA_THREADS / MMA_KSPLIT *
         ((2 * NS + 1 + 7) / 8) * 4 * sizeof(float);
}
template <int NS>
inline size_t proj_smem_bytes(int d, int cols) {
  return proj_slab_bytes(d, cols) + proj_red_bytes<NS>();
}
// The most proj_smem_bytes gives for any d: the slab is at most
// PROJ_SLAB_BYTES, + 16 for its rounding and + 16 after it.
template <int NS>
constexpr size_t proj_smem_max() {
  return PROJ_SLAB_BYTES + 32 + proj_red_bytes<NS>();
}

// proj [rows, cols] = xc [rows, d] . w [d, cols], bf16 on the tensor
// cores (mma.sync m16n8k16, f32 accumulate).  A block takes 64 rows;
// warps w and w + 4 share rows 16w .. 16w + 15, each taking every other
// 256-wide block of k.  x_proj comes into shared memory as it lies ([k,
// cols], a slab of `slab` rows at a time; all of it for hymba), each load
// issued before any is used.  The A fragments come straight from device
// memory: within
// each 32-wide block of k, lane (g, t) loads xc[row g and g + 8, 8t ..
// 8t + 7] as one 16-byte load, and the two k16 steps of the block take
// physical k (8t + 4h + {0, 1}) and (8t + 4h + {2, 3}) as the logical
// pairs (2t, 2t + 1) and (2t + 8, 2t + 9) of step h.  The B fragments
// use the same order, so the product is the same; only the order of the
// sum over d differs.  Eight blocks of k (16 loads a thread) are in
// flight at a time.  Row r goes to proj[r * (2 NS + 4) + proj_slot(c, n,
// NS)].  The n8 tiles cover 2 NS + 1 columns; a column past 2n+1 reads
// whatever lies there and its sum is never stored (a column of an mma
// depends on that column of B alone).
template <int NS>
__global__ void __launch_bounds__(MMA_THREADS)
ssm_proj_mma(const __nv_bfloat16* __restrict__ xc,
             const __nv_bfloat16* __restrict__ w, float* __restrict__ proj,
             int64_t rows, int d, int n, int slab, int vec) {
  constexpr int NT = (2 * NS + 1 + 7) / 8;
  extern __shared__ __align__(16) __nv_bfloat16 wsl[];
  const int cols = 2 * n + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  // warp w: rows 16 (w % 4) .. + 15, the (w / 4)-th of MMA_KSPLIT
  // interleaved shares of the k blocks
  const int group = warp % 4, share = warp / 4;
  const int64_t r0 = (int64_t)blockIdx.x * MMA_ROWS + group * 16 + g;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  // 16-byte loads and every row of the block inside xc
  const bool full = vec && ((int64_t)blockIdx.x + 1) * MMA_ROWS <= rows;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < d; k0 += slab) {
    const int kn = min(slab, d - k0);
    const int kpad = (kn + 31) / 32 * 32;
    stage_slab<__nv_bfloat16>(wsl, w + (int64_t)k0 * cols, kn * cols);
    for (int i = kn * cols + tid; i < kpad * cols; i += MMA_THREADS)
      wsl[i] = zero;  // rows past d: zeros, as the A loads give there
    __syncthreads();
    for (int kb = share * 32 * MMA_KBLOCKS; kb < kpad;
         kb += MMA_KSPLIT * 32 * MMA_KBLOCKS) {
      uint4 a[MMA_KBLOCKS][2];
      if (full) {  // no branch around a load: all 16 go out at once
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int q = 0; q < MMA_KBLOCKS; ++q) {
          const int kk = kb + 32 * q + 8 * tig;
          const __nv_bfloat16* p = xc + r0 * d + k0 + kk;
          a[q][0] = kk < kn ? *reinterpret_cast<const uint4*>(p) : z;
          a[q][1] = kk < kn ? *reinterpret_cast<const uint4*>(p + 8 * d) : z;
        }
      } else {
#pragma unroll
        for (int q = 0; q < MMA_KBLOCKS; ++q) {
          const int k = k0 + kb + 32 * q + 8 * tig;
          a[q][0] = load8(xc, r0, k, rows, d, vec);
          a[q][1] = load8(xc, r0 + 8, k, rows, d, vec);
        }
      }
#pragma unroll
      for (int q = 0; q < MMA_KBLOCKS; ++q) {
        if (kb + 32 * q >= kpad) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t a0 = word(a[q][0], 2 * h), a1 = word(a[q][1], 2 * h);
          const uint32_t a2 = word(a[q][0], 2 * h + 1);
          const uint32_t a3 = word(a[q][1], 2 * h + 1);
          const __nv_bfloat16* p =
              wsl + (kb + 32 * q + 8 * tig + 4 * h) * cols + g;
          uint32_t b0[NT], b1[NT];
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const __nv_bfloat16* pj = p + j * 8;
            b0[j] = pack2(pj[0], pj[cols]);
            b1[j] = pack2(pj[2 * cols], pj[3 * cols]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mma_bf16(acc[j], a0, a1, a2, a3, b0[j], b1[j]);
        }
      }
    }
    __syncthreads();
  }
  // the other shares' sums, added in a fixed order by share 0
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<char*>(wsl) + proj_slab_bytes(d, cols));
  const int slot = (group * 32 + lane) * NT * 4;
  constexpr int SHARE = MMA_THREADS / MMA_KSPLIT * NT * 4;
  for (int sh = 1; sh < MMA_KSPLIT; ++sh) {
    if (share == sh) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[(sh - 1) * SHARE + slot + j * 4 + i] = acc[j][i];
    }
  }
  __syncthreads();
  if (share != 0) return;
  for (int sh = 1; sh < MMA_KSPLIT; ++sh) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[j][i] += red[(sh - 1) * SHARE + slot + j * 4 + i];
  }
  // accumulator: (row g, cols 2 tig, 2 tig + 1), then row g + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t row = r0 + 8 * half;
    if (row >= rows) continue;
    float* pr = proj + row * (2 * NS + 4);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * tig;
      if (c < cols) pr[proj_slot(c, n, NS)] = acc[j][2 * half];
      if (c + 1 < cols) pr[proj_slot(c + 1, n, NS)] = acc[j][2 * half + 1];
    }
    zero_unused(pr, n, NS, tig, 4);
  }
}

// Scan of one chunk's steps [0, len) by one thread, x loads issued four
// steps at a time, a group ahead of their use.  Y: write y (pass 4);
// else only advance h (pass 2).
template <typename T, int NS, bool Y>
__device__ __forceinline__ float chunk_walk(float (&h)[NS],
                                            const float (&A2)[NS],
                                            const float* ps, const T* xb,
                                            float* yb, int len, int d,
                                            float bias) {
  constexpr int R = row_floats<NS>();
  float sum_dt = 0.f;
  int t = 0;
  float xn[4];  // the next four steps' x, loaded a group ahead
  if (len >= 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) xn[u] = to_f(xb[(int64_t)u * d]);
  }
  for (; t + 4 <= len; t += 4) {
    float xv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) xv[u] = xn[u];
    if (t + 8 <= len) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        xn[u] = to_f(xb[(int64_t)(t + 4 + u) * d]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float yv;
      sum_dt += chunk_step<NS, Y>(h, A2, ps + (t + u) * R, xv[u], bias, &yv);
      if (Y) yb[(int64_t)(t + u) * d] = yv;
    }
  }
  for (; t < len; ++t) {
    float yv;
    sum_dt += chunk_step<NS, Y>(h, A2, ps + t * R, to_f(xb[(int64_t)t * d]),
                                bias, &yv);
    if (Y) yb[(int64_t)t * d] = yv;
  }
  return sum_dt;
}

// Pass 2: block (d-tile, chunk c < nc - 1, b).  h_end: [b, nc-1, n, d]
// (channels contiguous, so that the stores here and the carries' loads
// are coalesced); dt_sum: [b, nc-1, d].
template <typename T, int NS>
__global__ void __launch_bounds__(CHUNK_THREADS)
ssm_chunk_end(const T* __restrict__ xc, const float* __restrict__ proj,
              const float* __restrict__ dt_bias,
              const float* __restrict__ a_log, float* __restrict__ h_end,
              float* __restrict__ dt_sum, int steps, int d, int n) {
  constexpr int R = row_floats<NS>();
  __shared__ __align__(16) float ps[CHUNK * R];
  const int c = blockIdx.y, b = blockIdx.z, ncm = gridDim.y;
  const int t0 = c * CHUNK;  // a full chunk: only the last can be short
  const int ch = blockIdx.x * CHUNK_THREADS + threadIdx.x;
  stage_slab<float>(ps, proj + ((int64_t)b * steps + t0) * R, CHUNK * R);
  __syncthreads();
  if (ch >= d) return;
  float A2[NS], h[NS];
  load_decay<NS>(a_log, ch, n, A2);
#pragma unroll
  for (int s = 0; s < NS; ++s) h[s] = 0.f;
  const float sum_dt = chunk_walk<T, NS, false>(
      h, A2, ps, xc + ((int64_t)b * steps + t0) * d + ch, nullptr, CHUNK, d,
      dt_bias[ch]);
  const int64_t at = (int64_t)b * ncm + c;
  dt_sum[at * d + ch] = sum_dt;
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (s < n) h_end[(at * n + s) * d + ch] = h[s];
}

// The carries: thread (s, channel) of batch row b walks the chunk ends
// in order, h_in[j + 1] = exp(-A * sum dt[j]) * h_in[j] + h_end[j] from
// h_in[0] = h0, and overwrites h_end[j] with h_in[j + 1], the state
// entering chunk j + 1.  nc - 1 dependent steps a state; the loads do not
// depend on h, so the unrolled loop issues them ahead.  Grid (d-tiles, n,
// b); channels contiguous, so the h_end and dt_sum traffic is coalesced.
__global__ void __launch_bounds__(CHUNK_THREADS)
ssm_chunk_carry(const float* __restrict__ a_log,
                const float* __restrict__ h0, float* __restrict__ h_end,
                const float* __restrict__ dt_sum, int d, int n, int ends) {
  const int ch = blockIdx.x * CHUNK_THREADS + threadIdx.x;
  const int s = blockIdx.y, b = blockIdx.z;
  if (ch >= d) return;
  const float A2 = -expf(a_log[(int64_t)ch * n + s]) * LOG2E;
  float h = h0[((int64_t)b * d + ch) * n + s];
#pragma unroll 8
  for (int j = 0; j < ends; ++j) {
    const int64_t at = (int64_t)b * ends + j;
    float* e = h_end + (at * n + s) * d + ch;
    h = ex2(A2 * dt_sum[at * d + ch]) * h + *e;
    *e = h;
  }
}

// Pass 4: block (d-tile, chunk c < nc, b): the state entering chunk c (h0,
// or what the carries left in h_end[c - 1]), the chunk re-run from it
// writing y, and the final h from the last chunk.
template <typename T, int NS>
__global__ void __launch_bounds__(CHUNK_THREADS)
ssm_chunk_scan(const T* __restrict__ xc, const float* __restrict__ proj,
               const float* __restrict__ dt_bias,
               const float* __restrict__ a_log,
               const float* __restrict__ h0,
               const float* __restrict__ h_in, float* __restrict__ y,
               float* __restrict__ h_out, int steps, int d, int n) {
  constexpr int R = row_floats<NS>();
  __shared__ __align__(16) float ps[CHUNK * R];
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * CHUNK;
  const int len = min(CHUNK, steps - t0);
  const int ch = blockIdx.x * CHUNK_THREADS + threadIdx.x;
  stage_slab<float>(ps, proj + ((int64_t)b * steps + t0) * R, len * R);
  __syncthreads();
  if (ch >= d) return;
  float A2[NS], h[NS];
  load_decay<NS>(a_log, ch, n, A2);
  const int64_t state = ((int64_t)b * d + ch) * n;
  const int64_t at = (int64_t)b * (nc - 1) + c - 1;
#pragma unroll
  for (int s = 0; s < NS; ++s)
    h[s] = s >= n ? 0.f
                  : c == 0 ? h0[state + s] : h_in[(at * n + s) * d + ch];
  const int64_t off = ((int64_t)b * steps + t0) * d + ch;
  chunk_walk<T, NS, true>(h, A2, ps, xc + off, y + off, len, d,
                          dt_bias[ch]);
  if (c == nc - 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (s < n) h_out[state + s] = h[s];
  }
}

// The step route's work split: a cluster of STEP_CLUSTER blocks takes
// STEP_TILE channels of one batch row.  Block r of the cluster reduces the
// projection over its quarter of d (rows [r kq, (r + 1) kq) of x_proj,
// kq = d / STEP_CLUSTER rounded up to 8) and updates its quarter of the
// tile's channels.
//
// Dynamic shared memory of a step block, in floats: x over its rows of
// x_proj [kq], the partial sums [STEP_THREADS], its states h [STEP_SLICE
// * NS] and their log2 decay rates [STEP_SLICE * NS], the products h * C
// [STEP_SLICE * (NS + 1)]; then a slab of its x_proj rows [slab, 2n+1] of
// xc's type, as many rows as fit below STEP_SMEM_BYTES.  step_slab_rows is
// 0 when not even 8 rows fit.
__host__ __device__ inline int step_rows_per_block(int d) {
  return ((d + STEP_CLUSTER - 1) / STEP_CLUSTER + 7) / 8 * 8;
}
template <int NS>
inline size_t step_fixed_bytes(int d) {
  return ((size_t)step_rows_per_block(d) + STEP_THREADS +
          (size_t)STEP_SLICE * (3 * NS + 1)) * sizeof(float);
}
template <typename T, int NS>
inline int step_slab_rows(int d, int cols) {
  const size_t fixed = step_fixed_bytes<NS>(d);
  if (fixed >= STEP_SMEM_BYTES) return 0;
  const int fit = (int)((STEP_SMEM_BYTES - fixed) / (cols * sizeof(T))) / 8 * 8;
  return std::min(fit, step_rows_per_block(d));
}

// The step route: cluster (tile, b) of STEP_CLUSTER blocks along x.  Each
// block stages its rows of x_proj (cp.async, so the copy overlaps the
// other loads) and x over them, reduces its partial projection, and the
// cluster adds the STEP_CLUSTER partials through distributed shared
// memory in a fixed order, so every block holds the whole projection
// after reading a quarter of x_proj.  The block's states [c0, c0 + rows)
// x n lie contiguous in h0, h_out and a_log: they are loaded, updated and
// stored one element a thread, coalesced.
template <typename T, int NS>
__global__ void __cluster_dims__(STEP_CLUSTER, 1, 1)
__launch_bounds__(STEP_THREADS)
ssm_step(const T* __restrict__ xc, const T* __restrict__ w,
         const float* __restrict__ dt_bias, const float* __restrict__ a_log,
         const float* __restrict__ h0, float* __restrict__ y,
         float* __restrict__ h_out, int d, int n, int slab) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float sm[];
  __shared__ float kpart[2 * NS + 1];
  __shared__ float pcol[2 * NS + 1];
  __shared__ float dts[STEP_SLICE], dxs[STEP_SLICE];
  const int b = blockIdx.y, tid = threadIdx.x, cols = 2 * n + 1;
  const int rank = (int)cluster.block_rank();
  const int kq = step_rows_per_block(d);
  const int k_lo = min(d, rank * kq), k_hi = min(d, k_lo + kq);
  const int c0 = (blockIdx.x / STEP_CLUSTER) * STEP_TILE + rank * STEP_SLICE;
  const int rows = max(0, min(STEP_SLICE, d - c0));
  const int count = rows * n;  // the block's states
  float* xk = sm;
  float* part = xk + kq;
  float* hs = part + STEP_THREADS;
  float* rate = hs + STEP_SLICE * NS;
  float* prod = rate + STEP_SLICE * NS;
  T* ws = reinterpret_cast<T*>(prod + STEP_SLICE * (NS + 1));
  const T* xb = xc + (int64_t)b * d;
  // the first slab of this block's x_proj rows starts coming in first
  stage_slab_async<T>(ws, w + (int64_t)k_lo * cols,
                      min(slab, k_hi - k_lo) * cols);
  {  // x over the block's rows, its states' h0 and a_log: 8 loads each
    constexpr int U = 8;
    const float* hb = h0 + ((int64_t)b * d + c0) * n;
    const float* ab = a_log + (int64_t)c0 * n;
    const int nk = k_hi - k_lo, span = max(nk, count);
    for (int base = 0; base < span; base += U * STEP_THREADS) {
      float xv[U], hv[U], av[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * STEP_THREADS + tid;
        xv[u] = i < nk ? to_f(xb[k_lo + i]) : 0.f;
        hv[u] = i < count ? hb[i] : 0.f;
        av[u] = i < count ? ab[i] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * STEP_THREADS + tid;
        if (i < nk) xk[i] = xv[u];
        if (i < count) {
          hs[i] = hv[u];
          rate[i] = -expf(av[u]) * LOG2E;
        }
      }
    }
  }
  if (tid < rows) dxs[tid] = to_f(xb[c0 + tid]);
  // column tid % cols over slab rows tid / cols, + reps, ...: consecutive
  // threads read consecutive elements of the slab
  const int reps = STEP_THREADS / cols;
  const int c = tid % cols;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = k_lo; k0 < k_hi; k0 += slab) {
    const int kn = min(slab, k_hi - k0);
    if (k0 > k_lo) stage_slab_async<T>(ws, w + (int64_t)k0 * cols, kn * cols);
    async_wait_all();
    __syncthreads();
    const float* xr = xk + (k0 - k_lo);
    if (tid < reps * cols) {
      int k = tid / cols;
      for (; k + 3 * reps < kn; k += 4 * reps) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[u] = fmaf(xr[k + u * reps],
                        to_f(ws[(k + u * reps) * cols + c]), acc[u]);
      }
      for (; k < kn; k += reps)
        acc[0] = fmaf(xr[k], to_f(ws[k * cols + c]), acc[0]);
    }
    __syncthreads();
  }
  part[tid] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  __syncthreads();
  if (tid < cols) {
    float sum = 0.f;
    for (int r = 0; r < reps; ++r) sum += part[r * cols + tid];
    kpart[tid] = sum;
  }
  cluster.sync();  // every block's partial projection is in place
  if (tid < cols) {
    float sum = 0.f;
    for (int r = 0; r < STEP_CLUSTER; ++r)
      sum += cluster.map_shared_rank(kpart, r)[tid];
    pcol[tid] = sum;
  }
  cluster.sync();  // no block leaves while another reads its kpart
  if (tid < rows) {
    const float dt = softplus(pcol[2 * n] + dt_bias[c0 + tid]);
    dts[tid] = dt;
    dxs[tid] *= dt;
  }
  __syncthreads();
  float* hb = h_out + ((int64_t)b * d + c0) * n;
  for (int e = tid; e < count; e += STEP_THREADS) {
    const int ci = e / n, s = e - ci * n;
    const float h = ex2(rate[e] * dts[ci]) * hs[e] + dxs[ci] * pcol[s];
    hb[e] = h;
    prod[ci * (n + 1) + s] = h * pcol[n + s];
  }
  __syncthreads();
  if (tid < rows) {
    float yv = 0.f;
    for (int s = 0; s < n; ++s) yv += prod[tid * (n + 1) + s];
    y[(int64_t)b * d + c0 + tid] = yv;
  }
}

template <int NS>
int project(const float* xc, const float* w, float* proj, int64_t rows,
            int d, int n, cudaStream_t stream) {
  const int k_per = (d + PROJ_K - 1) / PROJ_K * PROJ_K;  // all of d
  ssm_proj_rows<float>
      <<<(unsigned)((rows + PROJ_ROWS - 1) / PROJ_ROWS), PROJ_THREADS, 0,
         stream>>>(xc, w, proj, rows, d, n, NS, 2 * NS + 4, k_per);
  return (int)cudaGetLastError();
}

template <int NS>
int project(const __nv_bfloat16* xc, const __nv_bfloat16* w, float* proj,
            int64_t rows, int d, int n, cudaStream_t stream) {
  const int cols = 2 * n + 1;
  const int vec = d % 8 == 0 && reinterpret_cast<uintptr_t>(xc) % 16 == 0;
  const size_t smem = proj_smem_bytes<NS>(d, cols);
  static std::atomic<bool> done[MAX_DEVICES];
  const int err = allow_smem(ssm_proj_mma<NS>, proj_smem_max<NS>(), done);
  if (err) return err;
  ssm_proj_mma<NS>
      <<<(unsigned)((rows + MMA_ROWS - 1) / MMA_ROWS), MMA_THREADS, smem,
         stream>>>(xc, w, proj, rows, d, n, proj_slab_rows(cols), vec);
  return (int)cudaGetLastError();
}

template <typename T, int NS>
int launch_chunk_passes(const T* xc, const T* x_proj, const float* dt_bias,
                        const float* a_log, const float* h0, float* proj,
                        float* h_end, float* dt_sum, float* y, float* h_out,
                        int b, int steps, int d, int n, cudaStream_t stream) {
  const int nc = (steps + CHUNK - 1) / CHUNK;
  const unsigned tiles = (unsigned)((d + CHUNK_THREADS - 1) / CHUNK_THREADS);
  int err = project<NS>(xc, x_proj, proj, (int64_t)b * steps, d, n, stream);
  if (err) return err;
  if (nc > 1) {
    ssm_chunk_end<T, NS>
        <<<dim3(tiles, (unsigned)(nc - 1), (unsigned)b), CHUNK_THREADS, 0,
           stream>>>(xc, proj, dt_bias, a_log, h_end, dt_sum, steps, d, n);
    err = (int)cudaGetLastError();
    if (err) return err;
    ssm_chunk_carry<<<dim3(tiles, (unsigned)n, (unsigned)b), CHUNK_THREADS,
                      0, stream>>>(a_log, h0, h_end, dt_sum, d, n, nc - 1);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  ssm_chunk_scan<T, NS>
      <<<dim3(tiles, (unsigned)nc, (unsigned)b), CHUNK_THREADS, 0,
         stream>>>(xc, proj, dt_bias, a_log, h0, h_end, y, h_out, steps, d,
                   n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chunked(const void* xc_, const void* x_proj_,
                   const float* dt_bias, const float* a_log, const float* h0,
                   float* proj, float* h_end, float* dt_sum, float* y,
                   float* h_out, int b, int steps, int d, int n,
                   cudaStream_t stream) {
  if (b <= 0 || b > 65535 || steps <= 0 || d <= 0 || n <= 0 ||
      n > MAX_STATE || (steps + CHUNK - 1) / CHUNK > 65535)
    return (int)cudaErrorInvalidValue;
  const T* xc = static_cast<const T*>(xc_);
  const T* x_proj = static_cast<const T*>(x_proj_);
#define SSM_PASSES(NS)                                                    \
  launch_chunk_passes<T, NS>(xc, x_proj, dt_bias, a_log, h0, proj, h_end, \
                             dt_sum, y, h_out, b, steps, d, n, stream)
  if (n <= 4) return SSM_PASSES(4);
  if (n <= 8) return SSM_PASSES(8);
  if (n <= 16) return SSM_PASSES(16);
  return SSM_PASSES(32);
#undef SSM_PASSES
}

template <typename T, int NS>
int launch_step_ns(const T* xc, const T* w, const float* dt_bias,
                   const float* a_log, const float* h0, float* y,
                   float* h_out, int b, int d, int n, cudaStream_t stream) {
  const int cols = 2 * n + 1;
  const int slab = step_slab_rows<T, NS>(d, cols);
  if (slab < 8) return (int)cudaErrorInvalidValue;  // d past shared memory
  const size_t smem = step_fixed_bytes<NS>(d) + (size_t)slab * cols * sizeof(T);
  // step_slab_rows keeps smem within STEP_SMEM_BYTES
  static std::atomic<bool> done[MAX_DEVICES];
  const int err = allow_smem(ssm_step<T, NS>, STEP_SMEM_BYTES, done);
  if (err) return err;
  const dim3 grid((unsigned)((d + STEP_TILE - 1) / STEP_TILE * STEP_CLUSTER),
                  (unsigned)b);
  ssm_step<T, NS><<<grid, STEP_THREADS, smem, stream>>>(
      xc, w, dt_bias, a_log, h0, y, h_out, d, n, slab);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_step(const void* xc_, const void* x_proj, const float* dt_bias,
                const float* a_log, const float* h0, float* y, float* h_out,
                int b, int d, int n, cudaStream_t stream) {
  if (b <= 0 || b > 65535 || d <= 0 || n <= 0 || n > MAX_STATE)
    return (int)cudaErrorInvalidValue;
  const T* xc = static_cast<const T*>(xc_);
  const T* w = static_cast<const T*>(x_proj);
#define SSM_STEP(NS) \
  launch_step_ns<T, NS>(xc, w, dt_bias, a_log, h0, y, h_out, b, d, n, stream)
  if (n <= 4) return SSM_STEP(4);
  if (n <= 8) return SSM_STEP(8);
  if (n <= 16) return SSM_STEP(16);
  return SSM_STEP(32);
#undef SSM_STEP
}


// ---------------------------------------------------------------------------
// The dt route: dt a channel, B and C given (the published Mamba-1 mixer)
// ---------------------------------------------------------------------------
//
// The published Mamba mixer (Jamba's) takes dt from a low-rank projection
// after a norm, one a channel and step, and norms B and C before the scan,
// so the projection the routes above fuse lies outside.  The caller gives
//   u [b, T, d], dt [b, T, d] (before dt_bias and softplus), B and C
//   [b, T, n], all of one type (float32 or bfloat16),
// and the route computes, in float32 from h0,
//   dt' = softplus(dt + dt_bias[d]);  a = exp(-exp(a_log[d,n]) * dt')
//   h = a * h + (dt' * u) * B;        y = sum_n h * C
// writing y [b, T, d] and the final h [b, d, n] as the routes above.
//
// Chunked (T > 1): the fused route's passes 2-4 with the projection pass
// gone.  ssm_dt_chunk_end and ssm_dt_chunk_scan stage a chunk's B and C
// rows from the inputs into shared memory (rows of 2 NS floats: B at [0,
// n), C at [NS, NS + n), zeros past n, read as float4 broadcasts) and load
// dt a channel-step as they load u, coalesced over the block's channels;
// the carries are ssm_chunk_carry's, unchanged.  Step (T = 1):
// ssm_dt_step, one thread a state (b, d, n), G lanes a channel (n rounded
// up to a power of two), y summed over the lanes by shuffles; h0, h_out
// and a_log are read and written coalesced.
//
// What bounds it: u and dt read twice (passes 2 and 4) and y written once
// are ~6.4 GB at Jamba's 65,536 x 8,192 prefill (~1.9 ms at 3.35 TB/s);
// the two passes' exp a state-step, ~17 G on the MUFU units (16 a clock
// an SM), ~4.1 ms: the same MUFU floor as the fused route's.

constexpr int DT_STEP_THREADS = 256;

// Rows t in [0, len) of B and C ([len, n] each, of type T) into ps as rows
// of 2 NS floats: B at [0, n), C at [NS, NS + n), zeros past n.
template <typename T, int NS>
__device__ __forceinline__ void stage_bc(float* ps, const T* __restrict__ bm,
                                         const T* __restrict__ cm, int len,
                                         int n) {
  for (int i = threadIdx.x; i < len * NS; i += blockDim.x) {
    const int t = i / NS, s = i - t * NS;
    const bool in = s < n;
    ps[t * 2 * NS + s] = in ? to_f(bm[(int64_t)t * n + s]) : 0.f;
    ps[t * 2 * NS + NS + s] = in ? to_f(cm[(int64_t)t * n + s]) : 0.f;
  }
}

// One step of a channel's states: dt from its own raw value, B and C from
// the shared-memory row pr; returns dt and sets *y = sum_n h * C when Y.
// Past n, A2, B and C are 0, so h stays 0 there.
template <int NS, bool Y>
__device__ __forceinline__ float dt_step(float (&h)[NS], const float (&A2)[NS],
                                         const float* pr, float x, float dr,
                                         float bias, float* y) {
  const float dt = softplus(dr + bias);
  const float dx = dt * x;
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < NS / 4; ++q) {
    const float4 b4 = *reinterpret_cast<const float4*>(pr + 4 * q);
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
    float cv[4] = {0.f, 0.f, 0.f, 0.f};
    if (Y) {
      const float4 c4 = *reinterpret_cast<const float4*>(pr + NS + 4 * q);
      cv[0] = c4.x, cv[1] = c4.y, cv[2] = c4.z, cv[3] = c4.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = 4 * q + j;
      h[s] = ex2(A2[s] * dt) * h[s] + dx * bv[j];
      if (Y) acc = fmaf(h[s], cv[j], acc);
    }
  }
  if (Y) *y = acc;
  return dt;
}

// A chunk's steps [0, len) by one thread, u and dt loaded four steps at a
// time.  Y: write y (pass 4); else only advance h (pass 2).
template <typename T, int NS, bool Y>
__device__ __forceinline__ float dt_walk(float (&h)[NS], const float (&A2)[NS],
                                         const float* ps, const T* ub,
                                         const T* db, float* yb, int len,
                                         int d, float bias) {
  constexpr int R = 2 * NS;
  float sum_dt = 0.f;
  int t = 0;
  for (; t + 4 <= len; t += 4) {
    float xv[4], dv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xv[u] = to_f(ub[(int64_t)(t + u) * d]);
      dv[u] = to_f(db[(int64_t)(t + u) * d]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float yv;
      sum_dt += dt_step<NS, Y>(h, A2, ps + (t + u) * R, xv[u], dv[u], bias,
                               &yv);
      if (Y) yb[(int64_t)(t + u) * d] = yv;
    }
  }
  for (; t < len; ++t) {
    float yv;
    sum_dt += dt_step<NS, Y>(h, A2, ps + t * R, to_f(ub[(int64_t)t * d]),
                             to_f(db[(int64_t)t * d]), bias, &yv);
    if (Y) yb[(int64_t)t * d] = yv;
  }
  return sum_dt;
}

// Pass 2 of the dt route: block (d-tile, chunk c < nc - 1, b); h_end and
// dt_sum as ssm_chunk_end's.
template <typename T, int NS>
__global__ void __launch_bounds__(CHUNK_THREADS)
ssm_dt_chunk_end(const T* __restrict__ u, const T* __restrict__ dtr,
                 const T* __restrict__ bm, const T* __restrict__ cm,
                 const float* __restrict__ dt_bias,
                 const float* __restrict__ a_log, float* __restrict__ h_end,
                 float* __restrict__ dt_sum, int steps, int d, int n) {
  __shared__ __align__(16) float ps[CHUNK * 2 * NS];
  const int c = blockIdx.y, b = blockIdx.z, ncm = gridDim.y;
  const int ch = blockIdx.x * CHUNK_THREADS + threadIdx.x;
  const int64_t row0 = (int64_t)b * steps + (int64_t)c * CHUNK;
  stage_bc<T, NS>(ps, bm + row0 * n, cm + row0 * n, CHUNK, n);
  __syncthreads();
  if (ch >= d) return;
  float A2[NS], h[NS];
  load_decay<NS>(a_log, ch, n, A2);
#pragma unroll
  for (int s = 0; s < NS; ++s) h[s] = 0.f;
  const float sum_dt = dt_walk<T, NS, false>(
      h, A2, ps, u + row0 * d + ch, dtr + row0 * d + ch, nullptr, CHUNK, d,
      dt_bias[ch]);
  const int64_t at = (int64_t)b * ncm + c;
  dt_sum[at * d + ch] = sum_dt;
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (s < n) h_end[(at * n + s) * d + ch] = h[s];
}

// Pass 4 of the dt route: block (d-tile, chunk c < nc, b), as
// ssm_chunk_scan.
template <typename T, int NS>
__global__ void __launch_bounds__(CHUNK_THREADS)
ssm_dt_chunk_scan(const T* __restrict__ u, const T* __restrict__ dtr,
                  const T* __restrict__ bm, const T* __restrict__ cm,
                  const float* __restrict__ dt_bias,
                  const float* __restrict__ a_log,
                  const float* __restrict__ h0, const float* __restrict__ h_in,
                  float* __restrict__ y, float* __restrict__ h_out, int steps,
                  int d, int n) {
  __shared__ __align__(16) float ps[CHUNK * 2 * NS];
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int t0 = c * CHUNK;
  const int len = min(CHUNK, steps - t0);
  const int ch = blockIdx.x * CHUNK_THREADS + threadIdx.x;
  const int64_t row0 = (int64_t)b * steps + t0;
  stage_bc<T, NS>(ps, bm + row0 * n, cm + row0 * n, len, n);
  __syncthreads();
  if (ch >= d) return;
  float A2[NS], h[NS];
  load_decay<NS>(a_log, ch, n, A2);
  const int64_t state = ((int64_t)b * d + ch) * n;
  const int64_t at = (int64_t)b * (nc - 1) + c - 1;
#pragma unroll
  for (int s = 0; s < NS; ++s)
    h[s] = s >= n ? 0.f
                  : c == 0 ? h0[state + s] : h_in[(at * n + s) * d + ch];
  const int64_t off = row0 * d + ch;
  dt_walk<T, NS, true>(h, A2, ps, u + off, dtr + off, y + off, len, d,
                       dt_bias[ch]);
  if (c == nc - 1) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (s < n) h_out[state + s] = h[s];
  }
}

// The dt route's step: thread (channel, lane) of batch row b, G lanes a
// channel; lanes past n add 0 to y and store nothing.
template <typename T>
__global__ void __launch_bounds__(DT_STEP_THREADS)
ssm_dt_step(const T* __restrict__ u, const T* __restrict__ dtr,
            const T* __restrict__ bm, const T* __restrict__ cm,
            const float* __restrict__ dt_bias, const float* __restrict__ a_log,
            const float* __restrict__ h0, float* __restrict__ y,
            float* __restrict__ h_out, int d, int n, int G) {
  const int lane = threadIdx.x % G;
  const int ch = blockIdx.x * (DT_STEP_THREADS / G) + threadIdx.x / G;
  const int b = blockIdx.y;
  const bool active = ch < d && lane < n;
  // idle lanes read valid addresses
  const int c = min(ch, d - 1), s = min(lane, n - 1);
  const int64_t at = (int64_t)b * d + c;
  const float dt = softplus(to_f(dtr[at]) + dt_bias[c]);
  const float dx = dt * to_f(u[at]);
  const int64_t state = at * n + s;
  const float A2 = -expf(a_log[(int64_t)c * n + s]) * LOG2E;
  const float h =
      ex2(A2 * dt) * h0[state] + dx * to_f(bm[(int64_t)b * n + s]);
  float part = active ? h * to_f(cm[(int64_t)b * n + s]) : 0.f;
  for (int off = G / 2; off > 0; off >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, off);
  if (active) h_out[state] = h;
  if (lane == 0 && ch < d) y[(int64_t)b * d + ch] = part;
}

template <typename T, int NS>
int launch_dt_passes(const T* u, const T* dtr, const T* bm, const T* cm,
                     const float* dt_bias, const float* a_log,
                     const float* h0, float* h_end, float* dt_sum, float* y,
                     float* h_out, int b, int steps, int d, int n,
                     cudaStream_t stream) {
  const int nc = (steps + CHUNK - 1) / CHUNK;
  const unsigned tiles = (unsigned)((d + CHUNK_THREADS - 1) / CHUNK_THREADS);
  int err = 0;
  if (nc > 1) {
    ssm_dt_chunk_end<T, NS>
        <<<dim3(tiles, (unsigned)(nc - 1), (unsigned)b), CHUNK_THREADS, 0,
           stream>>>(u, dtr, bm, cm, dt_bias, a_log, h_end, dt_sum, steps, d,
                     n);
    err = (int)cudaGetLastError();
    if (err) return err;
    ssm_chunk_carry<<<dim3(tiles, (unsigned)n, (unsigned)b), CHUNK_THREADS,
                      0, stream>>>(a_log, h0, h_end, dt_sum, d, n, nc - 1);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  ssm_dt_chunk_scan<T, NS>
      <<<dim3(tiles, (unsigned)nc, (unsigned)b), CHUNK_THREADS, 0,
         stream>>>(u, dtr, bm, cm, dt_bias, a_log, h0, h_end, y, h_out, steps,
                   d, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dt_chunked(const void* u_, const void* dt_, const void* bm_,
                      const void* cm_, const float* dt_bias,
                      const float* a_log, const float* h0, float* h_end,
                      float* dt_sum, float* y, float* h_out, int b, int steps,
                      int d, int n, cudaStream_t stream) {
  if (b <= 0 || b > 65535 || steps <= 0 || d <= 0 || n <= 0 ||
      n > MAX_STATE || (steps + CHUNK - 1) / CHUNK > 65535)
    return (int)cudaErrorInvalidValue;
  const T* u = static_cast<const T*>(u_);
  const T* dtr = static_cast<const T*>(dt_);
  const T* bm = static_cast<const T*>(bm_);
  const T* cm = static_cast<const T*>(cm_);
#define SSM_DT_PASSES(NS)                                                  \
  launch_dt_passes<T, NS>(u, dtr, bm, cm, dt_bias, a_log, h0, h_end, dt_sum, \
                          y, h_out, b, steps, d, n, stream)
  if (n <= 4) return SSM_DT_PASSES(4);
  if (n <= 8) return SSM_DT_PASSES(8);
  if (n <= 16) return SSM_DT_PASSES(16);
  return SSM_DT_PASSES(32);
#undef SSM_DT_PASSES
}

template <typename T>
int launch_dt_step(const void* u, const void* dt, const void* bm,
                   const void* cm, const float* dt_bias, const float* a_log,
                   const float* h0, float* y, float* h_out, int b, int d,
                   int n, cudaStream_t stream) {
  if (b <= 0 || b > 65535 || d <= 0 || n <= 0 || n > MAX_STATE)
    return (int)cudaErrorInvalidValue;
  int G = 1;
  while (G < n) G *= 2;
  const int per_block = DT_STEP_THREADS / G;
  const dim3 grid((unsigned)((d + per_block - 1) / per_block), (unsigned)b);
  ssm_dt_step<T><<<grid, DT_STEP_THREADS, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const T*>(bm), static_cast<const T*>(cm), dt_bias, a_log,
      h0, y, h_out, d, n, G);
  return (int)cudaGetLastError();
}

}  // namespace

// xc: [b, steps, d] contiguous; x_proj: [d, 2n+1] of xc's type; dt_bias:
// [d]; a_log: [d, n]; h0, h_out: [b, d, n]; y: [b, steps, d].  All
// float32 but xc and x_proj; 1 <= n <= 32.

// The chunked route.  Scratch: proj [b * steps, 2 ns + 4] (ns: n rounded
// up to 4, 8, 16 or 32; 16-byte aligned); h_end [b, nc-1, n, d] and dt_sum
// [b, nc-1, d], nc = ceil(steps / 128).
#define SSM_CHUNKED_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* xc, const void* x_proj,                   \
                      const void* dt_bias, const void* a_log,               \
                      const void* h0, void* proj, void* h_end,              \
                      void* dt_sum, void* y, void* h_out, int b, int steps, \
                      int d, int n, void* stream) {                         \
    return launch_chunked<T>(                                               \
        xc, x_proj, static_cast<const float*>(dt_bias),                     \
        static_cast<const float*>(a_log), static_cast<const float*>(h0),    \
        static_cast<float*>(proj), static_cast<float*>(h_end),              \
        static_cast<float*>(dt_sum), static_cast<float*>(y),                \
        static_cast<float*>(h_out), b, steps, d, n,                         \
        static_cast<cudaStream_t>(stream));                                 \
  }
SSM_CHUNKED_ENTRY(ssm_scan_chunked_f32, float)
SSM_CHUNKED_ENTRY(ssm_scan_chunked_bf16, __nv_bfloat16)

// The step route: steps = 1, one launch, no scratch.
#define SSM_STEP_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void* xc, const void* x_proj,                  \
                      const void* dt_bias, const void* a_log,              \
                      const void* h0, void* y, void* h_out, int b, int d,  \
                      int n, void* stream) {                               \
    return launch_step<T>(                                                 \
        xc, x_proj, static_cast<const float*>(dt_bias),                    \
        static_cast<const float*>(a_log), static_cast<const float*>(h0),   \
        static_cast<float*>(y), static_cast<float*>(h_out), b, d, n,       \
        static_cast<cudaStream_t>(stream));                                \
  }
SSM_STEP_ENTRY(ssm_scan_step_f32, float)
SSM_STEP_ENTRY(ssm_scan_step_bf16, __nv_bfloat16)

// The serial kernel, kept for timing beside the routes above.  proj:
// [ssm_scan_serial_splits(b, steps, d), b * steps, 2n+1] scratch.
extern "C" int ssm_scan_serial_splits(int b, int steps, int d) {
  return serial_splits((int64_t)b * steps, d);
}
#define SSM_SERIAL_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* xc, const void* x_proj,                   \
                      const void* dt_bias, const void* a_log,               \
                      const void* h0, void* proj, void* y, void* h_out,     \
                      int b, int steps, int d, int n, void* stream) {       \
    return launch_serial<T>(                                                \
        xc, x_proj, static_cast<const float*>(dt_bias),                     \
        static_cast<const float*>(a_log), static_cast<const float*>(h0),    \
        static_cast<float*>(proj), static_cast<float*>(y),                  \
        static_cast<float*>(h_out), b, steps, d, n,                         \
        static_cast<cudaStream_t>(stream));                                 \
  }
SSM_SERIAL_ENTRY(ssm_scan_serial_f32, float)
SSM_SERIAL_ENTRY(ssm_scan_serial_bf16, __nv_bfloat16)

// The dt route.  u, dt: [b, steps, d]; B, C: [b, steps, n], all of one
// type; dt_bias [d], a_log [d, n], h0 and h_out [b, d, n], y [b, steps,
// d] float32.  Chunked scratch: h_end [b, nc-1, n, d] and dt_sum [b, nc-1,
// d], nc = ceil(steps / 128).
#define SSM_DT_CHUNKED_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* u, const void* dt, const void* bm,        \
                      const void* cm, const void* dt_bias,                  \
                      const void* a_log, const void* h0, void* h_end,       \
                      void* dt_sum, void* y, void* h_out, int b, int steps, \
                      int d, int n, void* stream) {                         \
    return launch_dt_chunked<T>(                                            \
        u, dt, bm, cm, static_cast<const float*>(dt_bias),                  \
        static_cast<const float*>(a_log), static_cast<const float*>(h0),    \
        static_cast<float*>(h_end), static_cast<float*>(dt_sum),            \
        static_cast<float*>(y), static_cast<float*>(h_out), b, steps, d, n, \
        static_cast<cudaStream_t>(stream));                                 \
  }
SSM_DT_CHUNKED_ENTRY(ssm_scan_dt_chunked_f32, float)
SSM_DT_CHUNKED_ENTRY(ssm_scan_dt_chunked_bf16, __nv_bfloat16)

// The dt route's step: steps = 1, one launch, no scratch.
#define SSM_DT_STEP_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* u, const void* dt, const void* bm,       \
                      const void* cm, const void* dt_bias,                 \
                      const void* a_log, const void* h0, void* y,          \
                      void* h_out, int b, int d, int n, void* stream) {    \
    return launch_dt_step<T>(                                              \
        u, dt, bm, cm, static_cast<const float*>(dt_bias),                 \
        static_cast<const float*>(a_log), static_cast<const float*>(h0),   \
        static_cast<float*>(y), static_cast<float*>(h_out), b, d, n,       \
        static_cast<cudaStream_t>(stream));                                \
  }
SSM_DT_STEP_ENTRY(ssm_scan_dt_step_f32, float)
SSM_DT_STEP_ENTRY(ssm_scan_dt_step_bf16, __nv_bfloat16)
