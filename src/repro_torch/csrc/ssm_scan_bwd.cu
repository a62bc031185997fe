// The selective scan's gradient, for Hopper (sm_90a).
//
// The port's own kernel: the reference has no backward for its Pallas
// kernel src/repro/kernels/ssm_scan/kernel.py:_ssm_kernel (wrapper
// ssm_scan_kernel); it trains through XLA's autodiff of the chunked
// lax.scan in src/repro/models/ssm.py:ssm_scan.  Given the forward's
// inputs (ssm_scan.cu's function: proj = xc . x_proj -> B | C | dtr,
// dt = softplus(dtr + dt_bias), a = exp(-A dt) with A = exp(a_log),
// h_t = a h_{t-1} + dt x B, y = sum_n h C), the cotangents dy [b, T, d]
// and dh [b, d, n] of y and the final h, and what the forward's chunked
// route saved (its projection rows and the states entering chunks 1 ..
// nc-1), it computes
//   lam_t = dy_t C_t + a_{t+1} lam_{t+1}, from dh at T;  dh0 = a_1 lam_1
//   dB_t = sum_d lam_t dt x,  dC_t = sum_d dy_t h_t,  dx += dt sum_n lam B
//   ddt = x sum_n lam B - sum_n A lam a h_{t-1},  ddtr = sum_d ddt sig(z)
//   ddt_bias = sum_{b,t} ddt sig(z),  da_log = -A sum_{b,t} lam a h dt
//   dxc = dx + [dB | dC | ddtr] . x_proj^T,  dx_proj = xc^T . [dB|dC|ddtr]
// all in float32; dxc and dx_proj in xc's type (float32 or bfloat16).
//
// Design (a first, simple one).  Threads own one (b, chunk, channel) and
// the channel's n states in registers, as the forward's chunk passes do,
// over the forward's chunks of CHUNK = 128 steps:
//   1. ssm_bwd_chunk_end: chunks 1 .. nc-1 each run their reverse
//      recurrence from lam = 0 and write the carry leaving their first
//      step (a_first lam_first) and their sum of dt.
//   2. ssm_bwd_carry: one thread a state walks the chunks from the last,
//      G[c-1] = exp(-A sum dt[c]) G[c] + local[c] from G[nc-1] = dh: the
//      gradient reaching each chunk's last state.  Only exp(-A s) of a sum
//      s >= 0 is formed, never exp(+A ..), as in the forward.
//   3. ssm_bwd_chunk: each chunk re-runs its forward from the saved
//      entering state (the forward's own chunk_step, so h is the
//      forward's bit for bit), writing h_t to device memory, then walks
//      back from G[c] reading it.  The sums over the block's 128 channels
//      of dB, dC and ddtr (2n + 1 a step) go through shared memory, GROUP
//      steps at a time, one thread a column summing in channel order, into
//      per-tile partial rows; dA and ddt_bias build up in registers over
//      the chunk and go out as per-(b, chunk) partials.
//   4. ssm_bwd_proj_sum: the tiles' partial rows summed in tile order:
//      dproj [b * T, 2n + 1].
//   5. ssm_bwd_proj: a block takes 128 channels and SLICE_ROWS rows: dxc
//      = dx + dproj . x_proj^T (x_proj's row in registers), and the slice's
//      partial of dx_proj = xc^T . dproj.
//   6. ssm_bwd_params: dx_proj, da_log and ddt_bias, each partial set
//      summed in a fixed order.
// No float atomics anywhere: two launches give the same bytes (the
// trainer's restart is bit-equal).  Passes 1 and 2 are not launched for
// T <= CHUNK.
//
// What bounds it.  At hymba's training shape (4 x 2048 x 1600, n = 16,
// bf16 xc) the bytes every design must move (xc, dy, the saved rows and
// states read once, dxc written once: ~112 MB) take ~33 us at 3.35 TB/s;
// the operations (the forward's 7 a state-step re-run, ~15 a state-step
// back, 4 (2n + 1) a channel-step for dxc and dx_proj: ~6.5 G at the CUDA
// cores' 67 T/s) ~98 us.  This design adds two costs to that: the states
// h_t, written in pass 3 and read back (0.84 GB each way, ~0.50 ms at
// 3.35 TB/s, the largest), and its transcendentals (an exp a state-step
// in each of passes 1 and 3's two walks, ~3 x 236 M on the MUFU units,
// ~0.17 ms).  Keeping a chunk's states on chip instead (sub-chunks
// re-run from checkpoints in shared memory) is a later redesign.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns the first
// non-zero cudaGetLastError() of its launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ssm_scan.cuh"

namespace {

constexpr int BWD_THREADS = 128;  // channels of a block
constexpr int GROUP = 2;          // steps whose sums over d are staged at once
constexpr int RED_LD = BWD_THREADS + 1;  // a staged row, padded: no conflicts
constexpr int SLICE_ROWS = 128;   // rows (b, t) of a dx_proj partial
constexpr int SUM_THREADS = 256;  // pass 4
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// B and C of a staged projection row (slots past n are zero).
template <int NS>
__device__ __forceinline__ void load_bc(const float* pr, float (&bv)[NS],
                                        float (&cv)[NS]) {
#pragma unroll
  for (int q = 0; q < NS / 4; ++q) {
    const float4 b4 = *reinterpret_cast<const float4*>(pr + 4 * q);
    const float4 c4 = *reinterpret_cast<const float4*>(pr + NS + 4 * q);
    bv[4 * q] = b4.x, bv[4 * q + 1] = b4.y;
    bv[4 * q + 2] = b4.z, bv[4 * q + 3] = b4.w;
    cv[4 * q] = c4.x, cv[4 * q + 1] = c4.y;
    cv[4 * q + 2] = c4.z, cv[4 * q + 3] = c4.w;
  }
}

// The scratch of one call, carved from one float buffer (each piece
// 16-byte aligned).  nc = ceil(T / CHUNK) chunks, tiles of BWD_THREADS
// channels, slices of SLICE_ROWS rows.
struct Scratch {
  float* lam;        // [b, nc-1, n, d] local carries, then G
  float* dt_sum;     // [b, nc-1, d]
  float* hs;         // [b, T, n, d] h_t of pass 3
  float* dxd;        // [b, T, d] dt sum_n lam B
  float* part_proj;  // [b * T, tiles, 2n + 1]
  float* dproj;      // [b * T, 2n + 1]
  float* part_a;     // [b * nc, n, d] sum lam a h_{t-1} dt over a chunk
  float* part_bias;  // [b * nc, d]
  float* part_w;     // [slices, 2n + 1, d]
};

inline int64_t round4(int64_t v) { return (v + 3) / 4 * 4; }

// Fills s from base (when not null) and returns the floats it takes.
inline int64_t carve(float* base, int b, int steps, int d, int n,
                     Scratch* s) {
  const int64_t nc = (steps + CHUNK - 1) / CHUNK;
  const int64_t tiles = (d + BWD_THREADS - 1) / BWD_THREADS;
  const int64_t rows = (int64_t)b * steps, cols = 2 * n + 1;
  const int64_t slices = (rows + SLICE_ROWS - 1) / SLICE_ROWS;
  const int64_t sizes[9] = {
      b * (nc - 1) * n * d, b * (nc - 1) * d, rows * n * d, rows * d,
      rows * tiles * cols,  rows * cols,      b * nc * n * d, b * nc * d,
      slices * cols * d};
  float** slots[9] = {&s->lam,   &s->dt_sum, &s->hs,
                      &s->dxd,   &s->part_proj, &s->dproj,
                      &s->part_a, &s->part_bias, &s->part_w};
  int64_t at = 0;
  for (int i = 0; i < 9; ++i) {
    if (base) *slots[i] = base + at;
    at += round4(sizes[i]);
  }
  return at;
}

// Pass 1: block (d-tile, chunk c - 1, b) for chunks c = 1 .. nc - 1.
template <int NS>
__global__ void __launch_bounds__(BWD_THREADS)
ssm_bwd_chunk_end(const float* __restrict__ proj,
                  const float* __restrict__ dt_bias,
                  const float* __restrict__ a_log,
                  const float* __restrict__ dy, float* __restrict__ lam,
                  float* __restrict__ dt_sum, int steps, int d, int n) {
  constexpr int R = row_floats<NS>();
  __shared__ __align__(16) float ps[CHUNK * R];
  const int c = blockIdx.y + 1, b = blockIdx.z, ends = gridDim.y;
  const int t0 = c * CHUNK;
  const int len = min(CHUNK, steps - t0);
  const int ch = blockIdx.x * BWD_THREADS + threadIdx.x;
  stage_slab<float>(ps, proj + ((int64_t)b * steps + t0) * R, len * R);
  __syncthreads();
  if (ch >= d) return;
  float A2[NS], g[NS];
  load_decay<NS>(a_log, ch, n, A2);
#pragma unroll
  for (int s = 0; s < NS; ++s) g[s] = 0.f;
  const float bias = dt_bias[ch];
  const float* dyb = dy + ((int64_t)b * steps + t0) * d + ch;
  float sum_dt = 0.f;
#pragma unroll 4
  for (int t = len - 1; t >= 0; --t) {
    const float* pr = ps + t * R;
    const float dt = softplus(pr[2 * NS] + bias);
    const float yv = dyb[(int64_t)t * d];
    float bv[NS], cv[NS];
    load_bc<NS>(pr, bv, cv);
    sum_dt += dt;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      g[s] = ex2(A2[s] * dt) * fmaf(yv, cv[s], g[s]);
  }
  const int64_t at = (int64_t)b * ends + c - 1;
  dt_sum[at * d + ch] = sum_dt;
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (s < n) lam[(at * n + s) * d + ch] = g[s];
}

// Pass 2: thread (channel, s) of batch row b; lam[j] becomes the gradient
// reaching the last state of chunk j (j = nc - 2 .. 0).
__global__ void __launch_bounds__(BWD_THREADS)
ssm_bwd_carry(const float* __restrict__ a_log, const float* __restrict__ dh,
              float* __restrict__ lam, const float* __restrict__ dt_sum,
              int d, int n, int ends) {
  const int ch = blockIdx.x * BWD_THREADS + threadIdx.x;
  const int s = blockIdx.y, b = blockIdx.z;
  if (ch >= d) return;
  const float A2 = -expf(a_log[(int64_t)ch * n + s]) * LOG2E;
  float g = dh[((int64_t)b * d + ch) * n + s];
#pragma unroll 8
  for (int j = ends - 1; j >= 0; --j) {
    const int64_t at = (int64_t)b * ends + j;
    float* e = lam + (at * n + s) * d + ch;
    g = ex2(A2 * dt_sum[at * d + ch]) * g + *e;
    *e = g;
  }
}

// Pass 3: block (d-tile, chunk c, b).  Dynamic shared memory: the chunk's
// projection rows [CHUNK * R], then GROUP steps of staged columns [GROUP *
// (2n + 1)][RED_LD].  Threads past d run on the last channel's values
// (valid addresses) but read no stored state (another thread's, maybe not
// written yet), store nothing and stage zeros.
template <typename T, int NS>
__global__ void __launch_bounds__(BWD_THREADS)
ssm_bwd_chunk(const T* __restrict__ xc, const float* __restrict__ proj,
              const float* __restrict__ dt_bias,
              const float* __restrict__ a_log, const float* __restrict__ h0,
              const float* __restrict__ h_in, const float* __restrict__ dy,
              const float* __restrict__ dh, const float* __restrict__ lam,
              float* __restrict__ hs, float* __restrict__ dxd,
              float* __restrict__ part_proj, float* __restrict__ part_a,
              float* __restrict__ part_bias, float* __restrict__ dh0,
              int steps, int d, int n) {
  constexpr int R = row_floats<NS>();
  extern __shared__ __align__(16) float sm[];
  float* ps = sm;
  float* red = sm + CHUNK * R;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tiles = gridDim.x, tile = blockIdx.x;
  const int t0 = c * CHUNK;
  const int len = min(CHUNK, steps - t0);
  const int tid = threadIdx.x;
  const int ch = tile * BWD_THREADS + tid;
  const bool active = ch < d;
  const int cc = min(ch, d - 1);
  const int cols = 2 * n + 1;
  const int64_t ends = nc - 1;
  stage_slab<float>(ps, proj + ((int64_t)b * steps + t0) * R, len * R);
  __syncthreads();

  float A2[NS], h[NS];
  load_decay<NS>(a_log, cc, n, A2);
  const int64_t state = ((int64_t)b * d + cc) * n;
  const float* in = c == 0 ? h0 + state
                           : h_in + ((int64_t)b * ends + c - 1) * n * d + cc;
  const int64_t in_ld = c == 0 ? 1 : d;  // h0 [b, d, n]; h_in [.., n, d]
#pragma unroll
  for (int s = 0; s < NS; ++s) h[s] = s < n ? in[s * in_ld] : 0.f;
  const float bias = dt_bias[cc];
  const int64_t off = ((int64_t)b * steps + t0) * d + cc;
  const T* xb = xc + off;
  // h_t of the chunk's steps 0 .. len - 2 ([b, T, n, d]); the last stays
  // in registers
  float* hb = hs + ((int64_t)b * steps + t0) * n * d + cc;
  for (int t = 0; t < len; ++t) {
    chunk_step<NS, false>(h, A2, ps + t * R, to_f(xb[(int64_t)t * d]), bias,
                          nullptr);
    if (active && t + 1 < len) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        if (s < n) hb[((int64_t)t * n + s) * d] = h[s];
    }
  }

  float g[NS], dacc[NS];
  const float* gin = c == nc - 1
                         ? dh + state
                         : lam + ((int64_t)b * ends + c) * n * d + cc;
  const int64_t gin_ld = c == nc - 1 ? 1 : d;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    g[s] = s < n ? gin[s * gin_ld] : 0.f;
    dacc[s] = 0.f;
  }
  float dbias = 0.f;
  const float* dyb = dy + off;
  for (int t = len - 1; t >= 0; --t) {
    float prev[NS];  // h_{t-1}
#pragma unroll
    for (int s = 0; s < NS; ++s)
      prev[s] = s >= n || !active ? 0.f
                : t > 0 ? hb[((int64_t)(t - 1) * n + s) * d]
                        : in[s * in_ld];
    const float* pr = ps + t * R;
    const float z = pr[2 * NS] + bias;
    const float e = expf(-fabsf(z));
    const float dt = log1pf(e) + fmaxf(z, 0.f);  // softplus(z), as forward
    const float sig = z >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
    const float x = to_f(xb[(int64_t)t * d]);
    const float yv = dyb[(int64_t)t * d];
    const float dx = dt * x;
    float bv[NS], cv[NS];
    load_bc<NS>(pr, bv, cv);
    const int slot = (len - 1 - t) % GROUP;
    float* col = red + slot * cols * RED_LD + tid;
    float lb = 0.f, qa = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float l = fmaf(yv, cv[s], g[s]);
      const float a = ex2(A2[s] * dt);
      const float q = l * a * prev[s];
      g[s] = a * l;
      dacc[s] = fmaf(q, dt, dacc[s]);
      lb = fmaf(l, bv[s], lb);
      qa = fmaf(q, A2[s], qa);  // sum_n q A = -LN2 qa
      if (s < n) {
        col[s * RED_LD] = active ? l * dx : 0.f;
        col[(n + s) * RED_LD] = active ? yv * h[s] : 0.f;
      }
      h[s] = prev[s];
    }
    const float dz = fmaf(x, lb, qa * LN2) * sig;
    col[2 * n * RED_LD] = active ? dz : 0.f;
    dbias += dz;
    if (active) dxd[off + (int64_t)t * d] = dt * lb;
    if (slot == GROUP - 1 || t == 0) {
      __syncthreads();
      // thread r sums staged row r over the block's channels, in order;
      // slot k holds step t + slot - k
      const int rows = (slot + 1) * cols;
      for (int r = tid; r < rows; r += BWD_THREADS) {
        const float* row = red + r * RED_LD;
        float sum = 0.f;
        for (int k = 0; k < BWD_THREADS; ++k) sum += row[k];
        const int tt = t + slot - r / cols;
        part_proj[(((int64_t)b * steps + t0 + tt) * tiles + tile) * cols +
                  r % cols] = sum;
      }
      __syncthreads();
    }
  }
  if (!active) return;
  const int64_t bc = (int64_t)b * nc + c;
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (s < n) part_a[(bc * n + s) * d + ch] = dacc[s];
  part_bias[bc * d + ch] = dbias;
  if (c == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (s < n) dh0[state + s] = g[s];
  }
}

// Pass 4: dproj[row, col] = sum over tiles of part_proj, in tile order.
__global__ void __launch_bounds__(SUM_THREADS)
ssm_bwd_proj_sum(const float* __restrict__ part, float* __restrict__ dproj,
                 int64_t count, int cols, int tiles) {
  const int64_t i = (int64_t)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= count) return;
  const int64_t row = i / cols;
  const float* p = part + row * tiles * cols + (i - row * cols);
  float sum = 0.f;
  for (int k = 0; k < tiles; ++k) sum += p[(int64_t)k * cols];
  dproj[i] = sum;
}

// Pass 5: block (d-tile, slice of SLICE_ROWS rows).  dxc = dxd + dproj .
// x_proj^T and the slice's xc^T . dproj, columns in order.
template <typename T, int NS>
__global__ void __launch_bounds__(BWD_THREADS)
ssm_bwd_proj(const T* __restrict__ xc, const T* __restrict__ w,
             const float* __restrict__ dproj, const float* __restrict__ dxd,
             T* __restrict__ dxc, float* __restrict__ part_w, int64_t rows,
             int d, int n) {
  constexpr int NCOL = 2 * NS + 1;
  __shared__ __align__(16) float dp[SLICE_ROWS * NCOL];
  const int cols = 2 * n + 1;
  const int64_t r0 = (int64_t)blockIdx.y * SLICE_ROWS;
  const int nr = rows - r0 < SLICE_ROWS ? (int)(rows - r0) : SLICE_ROWS;
  stage_slab<float>(dp, dproj + r0 * cols, nr * cols);
  __syncthreads();
  const int ch = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (ch >= d) return;
  float wv[NCOL], acc[NCOL];
#pragma unroll
  for (int j = 0; j < NCOL; ++j) {
    wv[j] = j < cols ? to_f(w[(int64_t)ch * cols + j]) : 0.f;
    acc[j] = 0.f;
  }
  for (int r = 0; r < nr; ++r) {
    const int64_t at = (r0 + r) * d + ch;
    const float x = to_f(xc[at]);
    const float* row = dp + r * cols;
    float sum = dxd[at];
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      if (j < cols) {
        sum = fmaf(row[j], wv[j], sum);
        acc[j] = fmaf(x, row[j], acc[j]);
      }
    }
    store(dxc + at, sum);
  }
#pragma unroll
  for (int j = 0; j < NCOL; ++j)
    if (j < cols) part_w[((int64_t)blockIdx.y * cols + j) * d + ch] = acc[j];
}

// Pass 6: block (d-tile, y): y < 2n + 1 sums column y of dx_proj over the
// slices, y < 3n + 1 state y - (2n + 1) of da_log over (b, chunk), the last
// ddt_bias over (b, chunk); each in order.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
ssm_bwd_params(const float* __restrict__ part_w,
               const float* __restrict__ part_a,
               const float* __restrict__ part_bias,
               const float* __restrict__ a_log, T* __restrict__ dx_proj,
               float* __restrict__ ddt_bias, float* __restrict__ da_log,
               int slices, int chunks, int d, int n) {
  const int ch = blockIdx.x * BWD_THREADS + threadIdx.x;
  const int y = blockIdx.y, cols = 2 * n + 1;
  if (ch >= d) return;
  float sum = 0.f;
  if (y < cols) {
    for (int k = 0; k < slices; ++k)
      sum += part_w[((int64_t)k * cols + y) * d + ch];
    store(dx_proj + (int64_t)ch * cols + y, sum);
  } else if (y < cols + n) {
    const int s = y - cols;
    for (int k = 0; k < chunks; ++k)
      sum += part_a[((int64_t)k * n + s) * d + ch];
    da_log[(int64_t)ch * n + s] = -expf(a_log[(int64_t)ch * n + s]) * sum;
  } else {
    for (int k = 0; k < chunks; ++k) sum += part_bias[(int64_t)k * d + ch];
    ddt_bias[ch] = sum;
  }
}

template <int NS>
constexpr size_t chunk_smem_bytes() {
  return ((size_t)CHUNK * row_floats<NS>() +
          (size_t)GROUP * (2 * NS + 1) * RED_LD) * sizeof(float);
}

template <typename T, int NS>
int launch_bwd_ns(const T* xc, const T* w, const float* dt_bias,
                  const float* a_log, const float* h0, const float* proj,
                  const float* h_in, const float* dy, const float* dh,
                  float* scratch, T* dxc, T* dx_proj, float* ddt_bias,
                  float* da_log, float* dh0, int b, int steps, int d, int n,
                  cudaStream_t stream) {
  Scratch s;
  carve(scratch, b, steps, d, n, &s);
  const int nc = (steps + CHUNK - 1) / CHUNK;
  const unsigned tiles = (unsigned)((d + BWD_THREADS - 1) / BWD_THREADS);
  const int64_t rows = (int64_t)b * steps;
  const int cols = 2 * n + 1;
  const int64_t slices = (rows + SLICE_ROWS - 1) / SLICE_ROWS;
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  int err = 0;
  if (nc > 1) {
    ssm_bwd_chunk_end<NS>
        <<<dim3(tiles, (unsigned)(nc - 1), (unsigned)b), BWD_THREADS, 0,
           stream>>>(proj, dt_bias, a_log, dy, s.lam, s.dt_sum, steps, d, n);
    if ((err = (int)cudaGetLastError())) return err;
    ssm_bwd_carry<<<dim3(tiles, (unsigned)n, (unsigned)b), BWD_THREADS, 0,
                    stream>>>(a_log, dh, s.lam, s.dt_sum, d, n, nc - 1);
    if ((err = (int)cudaGetLastError())) return err;
  }
  static std::atomic<bool> done[MAX_DEVICES];
  constexpr size_t smem = chunk_smem_bytes<NS>();
  if ((err = allow_smem(ssm_bwd_chunk<T, NS>, smem, done))) return err;
  ssm_bwd_chunk<T, NS>
      <<<dim3(tiles, (unsigned)nc, (unsigned)b), BWD_THREADS, smem,
         stream>>>(xc, proj, dt_bias, a_log, h0, h_in, dy, dh, s.lam, s.hs,
                   s.dxd, s.part_proj, s.part_a, s.part_bias, dh0, steps, d,
                   n);
  if ((err = (int)cudaGetLastError())) return err;
  const int64_t count = rows * cols;
  ssm_bwd_proj_sum<<<(unsigned)((count + SUM_THREADS - 1) / SUM_THREADS),
                     SUM_THREADS, 0, stream>>>(s.part_proj, s.dproj, count,
                                               cols, (int)tiles);
  if ((err = (int)cudaGetLastError())) return err;
  ssm_bwd_proj<T, NS><<<dim3(tiles, (unsigned)slices), BWD_THREADS, 0,
                        stream>>>(xc, w, s.dproj, s.dxd, dxc, s.part_w, rows,
                                  d, n);
  if ((err = (int)cudaGetLastError())) return err;
  ssm_bwd_params<T><<<dim3(tiles, (unsigned)(cols + n + 1)), BWD_THREADS, 0,
                      stream>>>(s.part_w, s.part_a, s.part_bias, a_log,
                                dx_proj, ddt_bias, da_log, (int)slices,
                                b * nc, d, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* xc, const void* x_proj, const float* dt_bias,
               const float* a_log, const float* h0, const float* proj,
               const float* h_in, const float* dy, const float* dh,
               float* scratch, void* dxc, void* dx_proj, float* ddt_bias,
               float* da_log, float* dh0, int b, int steps, int d, int n,
               cudaStream_t stream) {
  if (b <= 0 || b > 65535 || steps <= 0 || d <= 0 || n <= 0 ||
      n > MAX_STATE || (steps + CHUNK - 1) / CHUNK > 65535)
    return (int)cudaErrorInvalidValue;
#define SSM_BWD(NS)                                                         \
  launch_bwd_ns<T, NS>(static_cast<const T*>(xc),                           \
                       static_cast<const T*>(x_proj), dt_bias, a_log, h0,   \
                       proj, h_in, dy, dh, scratch, static_cast<T*>(dxc),   \
                       static_cast<T*>(dx_proj), ddt_bias, da_log, dh0, b,  \
                       steps, d, n, stream)
  if (n <= 4) return SSM_BWD(4);
  if (n <= 8) return SSM_BWD(8);
  if (n <= 16) return SSM_BWD(16);
  return SSM_BWD(32);
#undef SSM_BWD
}

}  // namespace

// Floats of the scratch buffer a call at these sizes takes, into *floats.
extern "C" int ssm_scan_bwd_scratch_floats(int b, int steps, int d, int n,
                                           int64_t* floats) {
  Scratch s;
  *floats = carve(nullptr, b, steps, d, n, &s);
  return 0;
}

// xc: [b, steps, d]; x_proj: [d, 2n+1] of xc's type; dt_bias [d], a_log
// [d, n], h0 [b, d, n] float32; proj [b * steps, 2 ns + 4] and h_in [b,
// nc-1, n, d], the forward's chunked route's scratch after its launch (ns:
// n rounded up to 4, 8, 16 or 32; nc = ceil(steps / 128)); dy [b, steps,
// d] and dh [b, d, n] float32; scratch: ssm_scan_bwd_scratch_floats
// floats, 16-byte aligned.  Writes dxc [b, steps, d] and dx_proj [d, 2n+1]
// in xc's type, ddt_bias [d], da_log [d, n] and dh0 [b, d, n] in float32.
#define SSM_BWD_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* xc, const void* x_proj,                    \
                      const void* dt_bias, const void* a_log,                \
                      const void* h0, const void* proj, const void* h_in,    \
                      const void* dy, const void* dh, void* scratch,         \
                      void* dxc, void* dx_proj, void* ddt_bias,              \
                      void* da_log, void* dh0, int b, int steps, int d,      \
                      int n, void* stream) {                                 \
    return launch_bwd<T>(                                                    \
        xc, x_proj, static_cast<const float*>(dt_bias),                      \
        static_cast<const float*>(a_log), static_cast<const float*>(h0),     \
        static_cast<const float*>(proj), static_cast<const float*>(h_in),    \
        static_cast<const float*>(dy), static_cast<const float*>(dh),        \
        static_cast<float*>(scratch), dxc, dx_proj,                          \
        static_cast<float*>(ddt_bias), static_cast<float*>(da_log),          \
        static_cast<float*>(dh0), b, steps, d, n,                            \
        static_cast<cudaStream_t>(stream));                                  \
  }
SSM_BWD_ENTRY(ssm_scan_bwd_f32, float)
SSM_BWD_ENTRY(ssm_scan_bwd_bf16, __nv_bfloat16)
