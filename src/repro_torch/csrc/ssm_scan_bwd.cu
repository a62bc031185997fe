// The selective scan's gradient, for Hopper (sm_90a).
//
// The port's own kernel: it replaces no Pallas kernel.  The reference has
// no backward for its Pallas kernel src/repro/kernels/ssm_scan/kernel.py:
// _ssm_kernel (wrapper ssm_scan_kernel), and jax.grad through it raises; it
// trains through XLA's autodiff of the chunked lax.scan in
// src/repro/models/ssm.py:ssm_scan.  Training the port on the card needs
// the gradient of its forward kernel (ssm_scan.cu), so it has one.  Given
// the forward's inputs (proj = xc . x_proj -> B | C | dtr, dt =
// softplus(dtr + dt_bias), a = exp(-A dt) with A = exp(a_log), h_t = a
// h_{t-1} + dt x B, y = sum_n h C), the cotangents dy [b, T, d] and dh
// [b, d, n] of y and the final h, and what the forward's chunked route
// saved (its projection rows and the states entering chunks 1 .. nc-1),
// it computes
//   lam_t = dy_t C_t + a_{t+1} lam_{t+1}, from dh at T;  dh0 = a_1 lam_1
//   dB_t = sum_d lam_t dt x,  dC_t = sum_d dy_t h_t,  dx += dt sum_n lam B
//   ddt = x sum_n lam B - sum_n A lam a h_{t-1},  ddtr = sum_d ddt sig(z)
//   ddt_bias = sum_{b,t} ddt sig(z),  da_log = -A sum_{b,t} lam a h dt
//   dxc = dx + [dB | dC | ddtr] . x_proj^T,  dx_proj = xc^T . [dB|dC|ddtr]
// all in float32; dxc and dx_proj in xc's type (float32 or bfloat16).
//
// What bounds it.  At hymba's training shape (4 x 2048 x 1600, n = 16,
// bf16 xc) the bytes every design must move (xc, dy, the saved rows and
// states read once, dxc written once: ~112 MB) take ~33 us at 3.35 TB/s;
// the operations (the forward's 7 a state-step re-run, ~15 a state-step
// back, 4 (2n + 1) a channel-step for dxc and dx_proj: ~6.5 G at the CUDA
// cores' 67 T/s) ~98 us.  The transcendentals of this design, one exp2 a
// state-step (one a serves both scans) and a softplus and a sigmoid a
// channel-step, take ~0.06 ms on the MUFU units.
//
// Design: time-parallel scans, a chunk's states never leave the chip.
//   1. ssm_bwd_scan: a block takes one batch row and GROUP_CH = 28
//      neighbouring channels (7 warps of 4; 58 groups x 4 rows = 232
//      blocks at the training shape, two an SM) and walks the spans of
//      SPAN = CHUNK = 128 steps from the last to the first.  Per span it
//      stages the projection rows, x, dy, dt and dt x of its channels in
//      shared memory, laid out so that a lane reads its 8 steps as two
//      16-byte runs.  A half-warp takes a channel, 16 lanes of ITEMS = 8
//      consecutive steps, two channels a warp at once, two pairs one after
//      the other; states outer, channels inner.  For each (state,
//      channel): a = exp2(A2 dt) once a step for both scans (a lane's
//      product of a's is exp2(A2 times its sum of dt)); each lane folds its
//      steps into a map h -> P h + H, the state entering the span (the
//      forward's saved state, or h0) is folded into lane 0's, the maps are
//      scanned over the 16 lanes with shuffles and each lane walks its
//      steps forward (h_t and h_{t-1} stay in registers); then the same
//      from the right for g -> a (dy C + g), with the gradient leaving the
//      next span's first step folded into lane 15's map, and the walk back
//      gives lam_t and every sum.  Products of a's may underflow to 0,
//      which is right; no a is ever divided by.  The reverse carries stay
//      in shared memory from one span to the next, so no carry pass runs
//      and nothing of size b T n d is written.  Sums over states (dx, ddt)
//      stay in registers per (channel, step); dB and dC build up in
//      registers over the lane's two channels, the halves add theirs with
//      one shuffle and the 7 warps' rows are added in warp order through
//      shared memory, one barrier a state; ddtr the same once a span;
//      da_log's and ddt_bias's sums over steps are halved across lanes and
//      added per span in a fixed order.  The block writes its group's
//      partial rows of [dB | dC | ddtr] and dxd = dt sum_n lam B.
//   2. ssm_bwd_group_sum: the groups' partial rows summed in group order:
//      dproj [b * T, 2n + 1], rows padded to 4 floats.
//   3. ssm_bwd_dxc: dxc = dxd + dproj . x_proj^T, a thread a channel with
//      x_proj's row in registers, 8 rows at once (f32, CUDA cores).
//   4. ssm_bwd_dw: each slice's partial of dx_proj = xc^T . dproj, a thread
//      a channel, 16 rows at once (f32, CUDA cores).
//   5. ssm_bwd_params: dx_proj, da_log and ddt_bias, each partial set
//      summed in a fixed order.
// No float atomics anywhere: two launches give the same bytes (the
// trainer's restart is bit-equal).  The recomputed h is the forward's up
// to rounding, not bit for bit: the scans compose the steps in another
// order than the forward's chunk walk.  One call at the training shape
// allocates ~0.16 GB (outputs; scratch: dxd, the group partials, dproj,
// the dx_proj slices).  ptxas (-Xptxas -v, sm_90a), ssm_bwd_scan<bf16, 16>:
// 128 registers, 56 bytes of spill stores, 64 of loads; 98,064 bytes of
// dynamic shared memory.  ssm_bwd_dxc 96 registers, ssm_bwd_dw 100; none
// spills.
//
// The first design stays callable as ssm_scan_bwd_rerun_{f32,bf16}, timed
// beside this one; no wrapper takes it.  Threads own one (b, chunk,
// channel) and its n states in registers: the chunks' reverse walks from
// zero (ssm_bwd_chunk_end), the carries between chunks (ssm_bwd_carry),
// each chunk re-run from its saved state writing h_t to device memory and
// walked back reading it (ssm_bwd_chunk; 0.84 GB each way at the training
// shape), per-tile partial rows summed in tile order (ssm_bwd_proj_sum),
// dxc and the dx_proj partials a row at a time (ssm_bwd_proj), then pass 5
// above.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns the first
// non-zero cudaGetLastError() of its launches (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "ssm_scan.cuh"

namespace {

constexpr int BWD_THREADS = 128;  // threads (channels) of a d-tile's block
constexpr int SLICE_ROWS = 128;   // rows (b, t) of a dx_proj partial
constexpr int SUM_THREADS = 256;  // the partial rows' sums
constexpr float LN2 = 0.6931471805599453f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// The scan design
// ---------------------------------------------------------------------------

constexpr int ITEMS = 8;                        // consecutive steps a lane
constexpr int LANES = 16;                       // lanes of a channel's scan
constexpr int SPAN = LANES * ITEMS;             // steps a scan covers
constexpr int SCAN_WARPS = 7;
constexpr int SCAN_THREADS = 32 * SCAN_WARPS;
constexpr int SCAN_BLOCKS = 2;                  // blocks an SM (registers)
constexpr int WARP_CH = 4;                      // channels a warp, 2 at once
constexpr int GROUP_CH = SCAN_WARPS * WARP_CH;  // channels a block
// a staged row (a channel's or a projection column's steps), padded so
// that stores across channels or columns spread over the banks
constexpr int ROW_LD = SPAN + 4;
static_assert(SPAN == CHUNK, "a span starts where the forward saved h");
static_assert(ITEMS == 8 && LANES == 16 && WARP_CH == 4,
              "slot(), the half-warp sums and the two channels at once");

// Shared memory of ssm_bwd_scan, in floats: the span's B, C (NS rows each)
// and dtr rows; x, dy (then dxd), dt and dt x of the block's channels; the
// channels' decays, entering states, reverse carries and da sums; two
// buffers of the warps' dB and dC rows.
template <int NS>
constexpr size_t scan_smem_floats() {
  return (size_t)(2 * NS + 1) * ROW_LD + (size_t)4 * GROUP_CH * ROW_LD +
         (size_t)4 * GROUP_CH * NS + (size_t)2 * SCAN_WARPS * 2 * SPAN;
}

// Where step t of a span sits in a staged row: lane l's steps 8l .. 8l+3
// at 4l and 8l+4 .. 8l+7 at 64 + 4l, so that a channel's 16 lanes read
// their items as two runs of 256 contiguous bytes.
__device__ __forceinline__ int slot(int t) {
  return ((t & 4) << 4) | ((t >> 3) << 2) | (t & 3);
}

// Lane l's 8 items of a staged row, and back.
__device__ __forceinline__ void ld8(const float* row, int l,
                                    float (&v)[ITEMS]) {
  const float4 lo = ld4(row + 4 * l), hi = ld4(row + SPAN / 2 + 4 * l);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

__device__ __forceinline__ void st8(float* row, int l,
                                    const float (&v)[ITEMS]) {
  *reinterpret_cast<float4*>(row + 4 * l) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
  *reinterpret_cast<float4*>(row + SPAN / 2 + 4 * l) =
      make_float4(v[4], v[5], v[6], v[7]);
}

// v[ci] summed over the 16 lanes of each half-warp, in a fixed order: one
// exchange halves them (lane bit 3 keeps ci), three more add the rest.
// Lane 16 hf + 8 ci returns the sum of its half's v[ci].
__device__ __forceinline__ float half_sum2(const float (&v)[2], int lane) {
  const bool up = lane & 8;
  float s = (up ? v[1] : v[0]) + __shfl_xor_sync(FULL, up ? v[0] : v[1], 8);
  s += __shfl_xor_sync(FULL, s, 4);
  s += __shfl_xor_sync(FULL, s, 2);
  s += __shfl_xor_sync(FULL, s, 1);
  return s;
}

// Pass 1: block (channel group, b).  Half-warp hf of warp w takes channels
// 4w + hf and 4w + 2 + hf of the group, one after the other.  Channels
// past d and steps past T run on zeros (dt = 0, so a = 1: they change no
// state and add nothing) and store nothing.
template <typename T, int NS>
__global__ void __launch_bounds__(SCAN_THREADS, SCAN_BLOCKS)
ssm_bwd_scan(const T* __restrict__ xc, const float* __restrict__ proj,
             const float* __restrict__ dt_bias,
             const float* __restrict__ a_log, const float* __restrict__ h0,
             const float* __restrict__ h_in, const float* __restrict__ dy,
             const float* __restrict__ dh, float* __restrict__ dxd,
             float* __restrict__ part, float* __restrict__ part_a,
             float* __restrict__ part_bias, float* __restrict__ dh0,
             int steps, int d, int n) {
  constexpr int R = row_floats<NS>();
  extern __shared__ __align__(16) float sm[];
  float* rows_s = sm;  // B [NS][ROW_LD], C, dtr [ROW_LD], by slot
  float* xs = rows_s + (2 * NS + 1) * ROW_LD;  // [GROUP_CH][ROW_LD]
  float* ys = xs + GROUP_CH * ROW_LD;       // dy, then dxd
  float* ts = ys + GROUP_CH * ROW_LD;       // dt
  float* ws = ts + GROUP_CH * ROW_LD;       // dt x
  float* a2s = ws + GROUP_CH * ROW_LD;      // [GROUP_CH][NS]
  float* hin = a2s + GROUP_CH * NS;
  float* carry = hin + GROUP_CH * NS;
  float* da = carry + GROUP_CH * NS;
  float* ex = da + GROUP_CH * NS;            // [2][SCAN_WARPS][2][SPAN]
  const float* dtr = rows_s + 2 * NS * ROW_LD;
  const int b = blockIdx.y, ch0 = blockIdx.x * GROUP_CH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hf = lane >> 4, l = lane & 15;
  const int jw = warp * WARP_CH + hf;        // channel of ci: jw + 2 ci
  const int cols = 2 * n + 1;
  const int64_t rows = (int64_t)gridDim.y * steps;
  const int nsp = (steps + SPAN - 1) / SPAN;
  const int64_t ends = nsp - 1;              // saved states a batch row
  float* part_g = part + (int64_t)blockIdx.x * cols * rows;
  for (int i = tid; i < GROUP_CH * NS; i += SCAN_THREADS) {
    const int j = i / NS, s = i - j * NS, ch = ch0 + j;
    const bool ok = ch < d && s < n;
    a2s[i] = ok ? -expf(a_log[(int64_t)ch * n + s]) * LOG2E : 0.f;
    carry[i] = ok ? dh[((int64_t)b * d + ch) * n + s] : 0.f;
    da[i] = 0.f;
  }
  float bias[2];
#pragma unroll
  for (int ci = 0; ci < 2; ++ci)
    bias[ci] = ch0 + jw + 2 * ci < d ? dt_bias[ch0 + jw + 2 * ci] : 0.f;
  // lane 16 hf + 8 ci: the sum of dz of channel jw + 2 ci
  float dbias = 0.f;

  for (int sp = nsp - 1; sp >= 0; --sp) {
    const int t0 = sp * SPAN, len = min(SPAN, steps - t0);
    const int64_t r0 = (int64_t)b * steps + t0;  // the span's first row
    __syncthreads();  // the last span's tiles are read
    {
      // every load of the span in flight at once, then every store.  The
      // projection rows are contiguous: read as float4s, 4 columns of one
      // step each.  x, dy and dt: a thread takes 4 consecutive steps of
      // one channel (loads coalesced over channels, one 16-byte store a
      // tile).  The states entering the span, coalesced over channels.
      constexpr int Q = R / 4, RQ = SPAN * Q;  // float4s a row, a slab
      constexpr int RI = (RQ + SCAN_THREADS - 1) / SCAN_THREADS;
      constexpr int TQ = SCAN_THREADS / GROUP_CH;  // step quads a pass
      constexpr int PASSES = SPAN / (4 * TQ);
      constexpr int HI = (GROUP_CH * NS + SCAN_THREADS - 1) / SCAN_THREADS;
      static_assert(TQ * GROUP_CH == SCAN_THREADS && PASSES * 4 * TQ == SPAN,
                    "whole tiles");
      const float4* slab = reinterpret_cast<const float4*>(proj + r0 * R);
      const int j = tid % GROUP_CH, ch = ch0 + j;  // the thread's channel
      const float bias_j = ch < d ? dt_bias[ch] : 0.f;
      float4 rv[RI];
      float xv[PASSES][4], yv[PASSES][4], zv[PASSES][4], hv[HI];
#pragma unroll
      for (int it = 0; it < RI; ++it) {
        const int i = tid + it * SCAN_THREADS;
        rv[it] = i < RQ && i / Q < len ? slab[i]
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 4 * (tid / GROUP_CH + pass * TQ) + e;
          const bool ok = t < len && ch < d;
          const int64_t at = (r0 + t) * d + ch;
          xv[pass][e] = ok ? to_f(xc[at]) : 0.f;
          yv[pass][e] = ok ? dy[at] : 0.f;
          zv[pass][e] = ok ? proj[(r0 + t) * R + 2 * NS] : 0.f;
        }
#pragma unroll
      for (int it = 0; it < HI; ++it) {
        const int i = tid + it * SCAN_THREADS;
        const int s = i / GROUP_CH, cc = ch0 + i - s * GROUP_CH;
        hv[it] = 0.f;
        if (i < GROUP_CH * NS && cc < d && s < n)
          hv[it] = sp == 0 ? h0[((int64_t)b * d + cc) * n + s]
                           : h_in[(((int64_t)b * ends + sp - 1) * n + s) * d +
                                  cc];
      }
#pragma unroll
      for (int it = 0; it < RI; ++it) {
        const int i = tid + it * SCAN_THREADS, t = i / Q, c0 = 4 * (i % Q);
        const float v[4] = {rv[it].x, rv[it].y, rv[it].z, rv[it].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i < RQ && c0 + e <= 2 * NS)
            rows_s[(c0 + e) * ROW_LD + slot(t)] = v[e];
      }
#pragma unroll
      for (int pass = 0; pass < PASSES; ++pass) {
        const int t = 4 * (tid / GROUP_CH + pass * TQ);
        const int at = j * ROW_LD + slot(t);  // slots t .. t + 3
        float dt[4], dtx[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dt[e] = t + e < len && ch < d ? softplus(zv[pass][e] + bias_j)
                                        : 0.f;  // as the forward
          dtx[e] = dt[e] * xv[pass][e];
        }
        *reinterpret_cast<float4*>(xs + at) =
            make_float4(xv[pass][0], xv[pass][1], xv[pass][2], xv[pass][3]);
        *reinterpret_cast<float4*>(ys + at) =
            make_float4(yv[pass][0], yv[pass][1], yv[pass][2], yv[pass][3]);
        *reinterpret_cast<float4*>(ts + at) =
            make_float4(dt[0], dt[1], dt[2], dt[3]);
        *reinterpret_cast<float4*>(ws + at) =
            make_float4(dtx[0], dtx[1], dtx[2], dtx[3]);
      }
#pragma unroll
      for (int it = 0; it < HI; ++it) {
        const int i = tid + it * SCAN_THREADS, s = i / GROUP_CH;
        if (i < GROUP_CH * NS) hin[(i - s * GROUP_CH) * NS + s] = hv[it];
      }
    }
    __syncthreads();
    // each lane's sum of dt over its steps: its product of a's is
    // exp2(A2 sdt), one exp a state
    float sdt[2];
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      float dt[ITEMS];
      ld8(ts + (jw + 2 * ci) * ROW_LD, l, dt);
      sdt[ci] = 0.f;
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) sdt[ci] += dt[k];
    }

    float lb[2][ITEMS], qa[2][ITEMS];  // sum_n lam B, sum_n lam a h A2
#pragma unroll
    for (int ci = 0; ci < 2; ++ci)
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) lb[ci][k] = qa[ci][k] = 0.f;
    for (int s = 0; s < n; ++s) {
      const float* brow = rows_s + s * ROW_LD;
      const float* crow = rows_s + (NS + s) * ROW_LD;
      float bv[ITEMS], cv[ITEMS], db[ITEMS], dc[ITEMS], ds[2];
      ld8(brow, l, bv);  // B and C of the state: the same for both pairs
      ld8(crow, l, cv);
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) db[k] = dc[k] = 0.f;
#pragma unroll
      for (int ci = 0; ci < 2; ++ci) {
        const int j = jw + 2 * ci;
        const float* yr = ys + j * ROW_LD;
        const float* tr = ts + j * ROW_LD;
        const float* wr = ws + j * ROW_LD;
        const float A2 = a2s[j * NS + s];
        // a = exp2(A2 dt) once a step, for both scans; dt and dt x kept
        // for the walk back
        float a[ITEMS], h[ITEMS], dt[ITEMS], dtx[ITEMS];
        ld8(tr, l, dt);
        ld8(wr, l, dtx);
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
          a[k] = ex2(A2 * dt[k]);
          h[k] = dtx[k] * bv[k];  // dt x B, then h_t
        }
        // forward: the lane's map h -> P h + H, lane 0's from the state
        // entering the span, scanned over the channel's 16 lanes
        const float p_loc = ex2(A2 * sdt[ci]);
        float P = p_loc, H = h[0];
#pragma unroll
        for (int k = 1; k < ITEMS; ++k) H = fmaf(a[k], H, h[k]);
        float h_span = 0.f;
        if (l == 0) {
          h_span = hin[j * NS + s];
          H = fmaf(P, h_span, H);
        }
#pragma unroll
        for (int off = 1; off < LANES; off *= 2) {
          const float hu = __shfl_up_sync(FULL, H, off, LANES);
          const float pu =
              off < LANES / 2 ? __shfl_up_sync(FULL, P, off, LANES) : 1.f;
          if (l >= off) {
            H = fmaf(P, hu, H);
            P *= pu;
          }
        }
        float hp = __shfl_up_sync(FULL, H, 1, LANES);
        if (l == 0) hp = h_span;
        const float h_first = hp;  // h_{t-1} of the lane's first step
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) h[k] = hp = fmaf(a[k], hp, h[k]);
        // reverse: g -> a (dy C + g), lane 15's from the carry, scanned
        // from the right
        float yv[ITEMS];
        ld8(yr, l, yv);
        float G = a[ITEMS - 1] * yv[ITEMS - 1] * cv[ITEMS - 1];
#pragma unroll
        for (int k = ITEMS - 2; k >= 0; --k) G = a[k] * fmaf(yv[k], cv[k], G);
        float g_span = 0.f;
        if (l == LANES - 1) {
          g_span = carry[j * NS + s];
          G = fmaf(p_loc, g_span, G);
        }
        P = p_loc;
#pragma unroll
        for (int off = 1; off < LANES; off *= 2) {
          const float gd = __shfl_down_sync(FULL, G, off, LANES);
          const float pd =
              off < LANES / 2 ? __shfl_down_sync(FULL, P, off, LANES) : 1.f;
          if (l + off < LANES) {
            G = fmaf(P, gd, G);
            P *= pd;
          }
        }
        float g = __shfl_down_sync(FULL, G, 1, LANES);
        if (l == LANES - 1) g = g_span;
        float dsum = 0.f;
#pragma unroll
        for (int k = ITEMS - 1; k >= 0; --k) {
          const float lam = fmaf(yv[k], cv[k], g);
          g = a[k] * lam;
          const float q = g * (k ? h[k - 1] : h_first);  // lam a h_{t-1}
          lb[ci][k] = fmaf(lam, bv[k], lb[ci][k]);
          qa[ci][k] = fmaf(q, A2, qa[ci][k]);  // sum_n q A = -LN2 qa
          dsum = fmaf(q, dt[k], dsum);
          db[k] = fmaf(lam, dtx[k], db[k]);
          dc[k] = fmaf(yv[k], h[k], dc[k]);
        }
        // the gradient leaving the span's first step: the next span's carry
        // (lane 15 read the old one before the shuffles lane 0's g needs)
        if (l == 0) carry[j * NS + s] = g;
        ds[ci] = dsum;
      }
      const float da_sum = half_sum2(ds, lane);
      if ((lane & 7) == 0) da[(jw + 2 * ((lane >> 3) & 1)) * NS + s] += da_sum;
      // the halves' channels added (half 0 keeps dB, half 1 dC), then the
      // warps' rows added in warp order
      float keep[ITEMS];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k)
        keep[k] = (hf ? dc[k] : db[k]) +
                  __shfl_xor_sync(FULL, hf ? db[k] : dc[k], 16);
      float* buf = ex + (s & 1) * SCAN_WARPS * 2 * SPAN;
      st8(buf + (warp * 2 + hf) * SPAN, l, keep);
      __syncthreads();
      for (int i = tid; i < 2 * SPAN; i += SCAN_THREADS) {
        const int which = i / SPAN, t = i - which * SPAN;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < SCAN_WARPS; ++w)
          v += buf[(w * 2 + which) * SPAN + slot(t)];
        if (t < len) part_g[(int64_t)(which * n + s) * rows + r0 + t] = v;
      }
    }

    // per (channel, step): dz = ddt sig(z) and dxd; ddtr over channels,
    // ddt_bias over steps
    float z[ITEMS], dz_rows[ITEMS], dz_ch[2];
    ld8(dtr, l, z);
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) dz_rows[k] = 0.f;
#pragma unroll
    for (int ci = 0; ci < 2; ++ci) {
      const int j = jw + 2 * ci;
      float x[ITEMS], dt[ITEMS], out[ITEMS], sum = 0.f;
      ld8(xs + j * ROW_LD, l, x);
      ld8(ts + j * ROW_LD, l, dt);
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        const float zz = z[k] + bias[ci];
        const float e = expf(-fabsf(zz));
        const float sig = __fdividef(zz >= 0.f ? 1.f : e, 1.f + e);
        float dz = fmaf(x[k], lb[ci][k], qa[ci][k] * LN2) * sig;
        if (ITEMS * l + k >= len) dz = 0.f;
        out[k] = dt[k] * lb[ci][k];
        dz_rows[k] += dz;
        sum += dz;
      }
      st8(ys + j * ROW_LD, l, out);  // dxd over dy (read)
      dz_ch[ci] = sum;
    }
    const float bsum = half_sum2(dz_ch, lane);
    if ((lane & 7) == 0) dbias += bsum;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      dz_rows[k] += __shfl_xor_sync(FULL, dz_rows[k], 16);
    // the buffer the last state did not use
    float* buf = ex + (n & 1) * SCAN_WARPS * 2 * SPAN;
    if (hf == 0) st8(buf + warp * 2 * SPAN, l, dz_rows);
    __syncthreads();
    for (int t = tid; t < SPAN; t += SCAN_THREADS) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < SCAN_WARPS; ++w) v += buf[w * 2 * SPAN + slot(t)];
      if (t < len) part_g[(int64_t)(2 * n) * rows + r0 + t] = v;
    }
    {
      // dxd out, 4 steps of one channel a thread (coalesced over channels)
      const int j = tid % GROUP_CH, ch = ch0 + j;
      for (int t = 4 * (tid / GROUP_CH); t < SPAN;
           t += 4 * (SCAN_THREADS / GROUP_CH)) {
        const float4 v4 = ld4(ys + j * ROW_LD + slot(t));
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t + e < len && ch < d) dxd[(r0 + t + e) * d + ch] = v[e];
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < GROUP_CH * NS; i += SCAN_THREADS) {
    const int j = i / NS, s = i - j * NS, ch = ch0 + j;
    if (ch < d && s < n) {
      dh0[((int64_t)b * d + ch) * n + s] = carry[i];
      part_a[((int64_t)b * n + s) * d + ch] = da[i];
    }
  }
  const int jb = jw + 2 * ((lane >> 3) & 1);
  if ((lane & 7) == 0 && ch0 + jb < d)
    part_bias[(int64_t)b * d + ch0 + jb] = dbias;
}

// Pass 2: dproj[row, col] = sum over groups of part[group, col, row], in
// group order (thread i = col * rows + row reads coalesced); dproj's rows
// are padded to ld floats with zeros, so that passes 3 and 4 copy a slice
// with 16-byte loads.
__global__ void __launch_bounds__(SUM_THREADS)
ssm_bwd_group_sum(const float* __restrict__ part, float* __restrict__ dproj,
                  int64_t rows, int cols, int ld, int groups) {
  const int64_t i = (int64_t)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= rows * ld) return;
  const int64_t col = i / rows, row = i - col * rows;
  float sum = 0.f;
  if (col < cols)
    for (int g = 0; g < groups; ++g)
      sum += part[(int64_t)g * cols * rows + i];
  dproj[row * ld + col] = sum;
}

// A slice's dproj rows [ROWS][LD] (LD: 2 NS + 1 rounded up to 4), rows
// past the slice (nr of them are) zero.
template <int ROWS, int LD>
__device__ __forceinline__ void stage_dproj(float* dp,
                                            const float* __restrict__ dproj,
                                            int64_t r0, int nr) {
  stage_slab<float>(dp, dproj + r0 * LD, nr * LD);
  for (int i = nr * LD + threadIdx.x; i < ROWS * LD; i += blockDim.x)
    dp[i] = 0.f;
}

// Pass 3: dxc = dxd + dproj . x_proj^T.  Block (slice of DXC_ROWS rows,
// 128 channels), a thread a channel with x_proj's row in registers,
// DXC_STEP rows at once so that their loads are in flight together.
constexpr int DXC_ROWS = 32;
constexpr int DXC_STEP = 8;

template <typename T, int NS>
__global__ void __launch_bounds__(BWD_THREADS)
ssm_bwd_dxc(const T* __restrict__ w, const float* __restrict__ dproj,
            const float* __restrict__ dxd, T* __restrict__ dxc,
            int64_t rows, int d, int n) {
  constexpr int LD = (2 * NS + 1 + 3) / 4 * 4;
  __shared__ __align__(16) float dp[DXC_ROWS * LD];
  const int cols = 2 * n + 1;
  const int64_t r0 = (int64_t)blockIdx.x * DXC_ROWS;
  const int nr = rows - r0 < DXC_ROWS ? (int)(rows - r0) : DXC_ROWS;
  stage_dproj<DXC_ROWS, LD>(dp, dproj, r0, nr);
  __syncthreads();
  const int ch = blockIdx.y * BWD_THREADS + threadIdx.x;
  if (ch >= d) return;
  float wv[LD];
#pragma unroll
  for (int j = 0; j < LD; ++j)
    wv[j] = j < cols ? to_f(w[(int64_t)ch * cols + j]) : 0.f;
#pragma unroll
  for (int r = 0; r < DXC_ROWS; r += DXC_STEP) {
    float sum[DXC_STEP];
#pragma unroll
    for (int u = 0; u < DXC_STEP; ++u)
      sum[u] = r + u < nr ? dxd[(r0 + r + u) * d + ch] : 0.f;
#pragma unroll
    for (int u = 0; u < DXC_STEP; ++u)
#pragma unroll
      for (int q = 0; q < LD / 4; ++q) {
        const float4 p = ld4(dp + (r + u) * LD + 4 * q);
        sum[u] = fmaf(p.x, wv[4 * q], sum[u]);
        sum[u] = fmaf(p.y, wv[4 * q + 1], sum[u]);
        sum[u] = fmaf(p.z, wv[4 * q + 2], sum[u]);
        sum[u] = fmaf(p.w, wv[4 * q + 3], sum[u]);
      }
#pragma unroll
    for (int u = 0; u < DXC_STEP; ++u)
      if (r + u < nr) store(dxc + (r0 + r + u) * d + ch, sum[u]);
  }
}

// Pass 4: the slice's partial of dx_proj = xc^T . dproj, columns in order.
// Block (d-tile, slice of SLICE_ROWS rows), a thread a channel, DW_STEP
// rows at once, their loads in flight together.
constexpr int DW_STEP = 16;

template <typename T, int NS>
__global__ void __launch_bounds__(BWD_THREADS)
ssm_bwd_dw(const T* __restrict__ xc, const float* __restrict__ dproj,
           float* __restrict__ part_w, int64_t rows, int d, int n) {
  constexpr int LD = (2 * NS + 1 + 3) / 4 * 4;
  __shared__ __align__(16) float dp[SLICE_ROWS * LD];
  const int cols = 2 * n + 1;
  const int64_t r0 = (int64_t)blockIdx.y * SLICE_ROWS;
  const int nr = rows - r0 < SLICE_ROWS ? (int)(rows - r0) : SLICE_ROWS;
  stage_dproj<SLICE_ROWS, LD>(dp, dproj, r0, nr);
  __syncthreads();
  const int ch = blockIdx.x * BWD_THREADS + threadIdx.x;
  if (ch >= d) return;
  float acc[LD];
#pragma unroll
  for (int j = 0; j < LD; ++j) acc[j] = 0.f;
  for (int r = 0; r < nr; r += DW_STEP) {
    float x[DW_STEP];
#pragma unroll
    for (int u = 0; u < DW_STEP; ++u)  // past nr: zero rows of dp
      x[u] = r + u < nr ? to_f(xc[(r0 + r + u) * d + ch]) : 0.f;
#pragma unroll
    for (int u = 0; u < DW_STEP; ++u)
#pragma unroll
      for (int q = 0; q < LD / 4; ++q) {
        const float4 p = ld4(dp + (r + u) * LD + 4 * q);
        acc[4 * q] = fmaf(x[u], p.x, acc[4 * q]);
        acc[4 * q + 1] = fmaf(x[u], p.y, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(x[u], p.z, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(x[u], p.w, acc[4 * q + 3]);
      }
  }
#pragma unroll
  for (int j = 0; j < LD; ++j)
    if (j < cols) part_w[((int64_t)blockIdx.y * cols + j) * d + ch] = acc[j];
}

// ---------------------------------------------------------------------------
// Passes both designs share
// ---------------------------------------------------------------------------

// Block (d-tile, y): y < 2n + 1 sums column y of dx_proj over the slices,
// y < 3n + 1 state y - (2n + 1) of da_log over its `chunks` partial sets,
// the last ddt_bias over the same sets; each in order.
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

inline int64_t round4(int64_t v) { return (v + 3) / 4 * 4; }

// Carves `count` pieces of the given sizes from one float buffer (each
// 16-byte aligned) into slots, when base is not null; returns the floats
// they take.
template <int N>
int64_t carve(float* base, const int64_t (&sizes)[N], float** (&slots)[N]) {
  int64_t at = 0;
  for (int i = 0; i < N; ++i) {
    if (base) *slots[i] = base + at;
    at += round4(sizes[i]);
  }
  return at;
}

// Floats of a padded dproj row: 2 ns + 1 rounded up to 4, where ns is n
// rounded up to the state slots the launcher picks (4, 8, 16 or 32).
inline int64_t padded_row(int n) {
  const int ns = n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
  return (2 * ns + 1 + 3) / 4 * 4;
}

// The scan design's scratch: groups of GROUP_CH channels, slices of
// SLICE_ROWS rows.
struct ScanScratch {
  float* dxd;        // [b * T, d] dt sum_n lam B
  float* part;       // [groups, 2n + 1, b * T] the groups' partial rows
  float* dproj;      // [b * T, ld]: 2n + 1 columns, zero-padded to ld
  float* part_a;     // [b, n, d] sum over the row's steps of lam a h dt
  float* part_bias;  // [b, d]
  float* part_w;     // [slices, 2n + 1, d]
};

inline int64_t carve_scan(float* base, int b, int steps, int d, int n,
                          ScanScratch* s) {
  const int64_t groups = (d + GROUP_CH - 1) / GROUP_CH;
  const int64_t rows = (int64_t)b * steps, cols = 2 * n + 1;
  const int64_t slices = (rows + SLICE_ROWS - 1) / SLICE_ROWS;
  const int64_t sizes[6] = {rows * d,      groups * cols * rows,
                            rows * padded_row(n), (int64_t)b * n * d,
                            (int64_t)b * d, slices * cols * d};
  float** slots[6] = {&s->dxd,    &s->part,      &s->dproj,
                      &s->part_a, &s->part_bias, &s->part_w};
  return carve(base, sizes, slots);
}

template <typename T, int NS>
int launch_scan_ns(const T* xc, const T* w, const float* dt_bias,
                   const float* a_log, const float* h0, const float* proj,
                   const float* h_in, const float* dy, const float* dh,
                   float* scratch, T* dxc, T* dx_proj, float* ddt_bias,
                   float* da_log, float* dh0, int b, int steps, int d, int n,
                   cudaStream_t stream) {
  ScanScratch s;
  carve_scan(scratch, b, steps, d, n, &s);
  const unsigned groups = (unsigned)((d + GROUP_CH - 1) / GROUP_CH);
  const unsigned tiles = (unsigned)((d + BWD_THREADS - 1) / BWD_THREADS);
  const int64_t rows = (int64_t)b * steps;
  const int cols = 2 * n + 1;
  const int64_t slices = (rows + SLICE_ROWS - 1) / SLICE_ROWS;
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  static std::atomic<bool> done[MAX_DEVICES];
  constexpr size_t smem = scan_smem_floats<NS>() * sizeof(float);
  int err = 0;
  if ((err = allow_smem(ssm_bwd_scan<T, NS>, smem, done))) return err;
  ssm_bwd_scan<T, NS><<<dim3(groups, (unsigned)b), SCAN_THREADS, smem,
                        stream>>>(xc, proj, dt_bias, a_log, h0, h_in, dy, dh,
                                  s.dxd, s.part, s.part_a, s.part_bias, dh0,
                                  steps, d, n);
  if ((err = (int)cudaGetLastError())) return err;
  constexpr int LD = (2 * NS + 1 + 3) / 4 * 4;  // a padded dproj row
  const int64_t count = rows * LD;
  ssm_bwd_group_sum<<<(unsigned)((count + SUM_THREADS - 1) / SUM_THREADS),
                      SUM_THREADS, 0, stream>>>(s.part, s.dproj, rows, cols,
                                                LD, (int)groups);
  if ((err = (int)cudaGetLastError())) return err;
  const int64_t dxc_slices = (rows + DXC_ROWS - 1) / DXC_ROWS;
  ssm_bwd_dxc<T, NS><<<dim3((unsigned)dxc_slices, tiles), BWD_THREADS, 0,
                       stream>>>(w, s.dproj, s.dxd, dxc, rows, d, n);
  if ((err = (int)cudaGetLastError())) return err;
  ssm_bwd_dw<T, NS><<<dim3(tiles, (unsigned)slices), BWD_THREADS, 0,
                      stream>>>(xc, s.dproj, s.part_w, rows, d, n);
  if ((err = (int)cudaGetLastError())) return err;
  ssm_bwd_params<T><<<dim3(tiles, (unsigned)(cols + n + 1)), BWD_THREADS, 0,
                      stream>>>(s.part_w, s.part_a, s.part_bias, a_log,
                                dx_proj, ddt_bias, da_log, (int)slices, b, d,
                                n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The first design: chunk-local reverse walks, carries, the re-run through
// device memory
// ---------------------------------------------------------------------------

constexpr int GROUP = 2;                  // steps whose sums over d are staged
constexpr int RED_LD = BWD_THREADS + 1;   // a staged row, padded: no conflicts

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

// The re-run design's scratch.  nc = ceil(T / CHUNK) chunks, tiles of
// BWD_THREADS channels, slices of SLICE_ROWS rows.
struct RerunScratch {
  float* lam;        // [b, nc-1, n, d] local carries, then G
  float* dt_sum;     // [b, nc-1, d]
  float* hs;         // [b, T, n, d] h_t of the re-run
  float* dxd;        // [b, T, d] dt sum_n lam B
  float* part_proj;  // [b * T, tiles, 2n + 1]
  float* dproj;      // [b * T, 2n + 1]
  float* part_a;     // [b * nc, n, d] sum lam a h_{t-1} dt over a chunk
  float* part_bias;  // [b * nc, d]
  float* part_w;     // [slices, 2n + 1, d]
};

inline int64_t carve_rerun(float* base, int b, int steps, int d, int n,
                           RerunScratch* s) {
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
  return carve(base, sizes, slots);
}

// Block (d-tile, chunk c - 1, b) for chunks c = 1 .. nc - 1: each chunk's
// reverse recurrence from lam = 0; writes the carry leaving its first step
// and its sum of dt.
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

// Thread (channel, s) of batch row b; lam[j] becomes the gradient reaching
// the last state of chunk j (j = nc - 2 .. 0).  Only exp(-A s) of a sum
// s >= 0 is formed.
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

// Block (d-tile, chunk c, b): the chunk re-run from its saved state (the
// forward's own chunk_step) writing h_t, then walked back reading it.
// Dynamic shared memory: the chunk's projection rows [CHUNK * R], then
// GROUP steps of staged columns [GROUP * (2n + 1)][RED_LD].  Threads past
// d run on the last channel's values (valid addresses) but read no stored
// state (another thread's, maybe not written yet), store nothing and stage
// zeros.
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

// Block (d-tile, slice of SLICE_ROWS rows): dxc = dxd + dproj . x_proj^T
// and the slice's xc^T . dproj, columns in order, a row at a time.
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

// dproj[row, col] = sum over tiles of part_proj, in tile order.
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

template <int NS>
constexpr size_t chunk_smem_bytes() {
  return ((size_t)CHUNK * row_floats<NS>() +
          (size_t)GROUP * (2 * NS + 1) * RED_LD) * sizeof(float);
}

template <typename T, int NS>
int launch_rerun_ns(const T* xc, const T* w, const float* dt_bias,
                    const float* a_log, const float* h0, const float* proj,
                    const float* h_in, const float* dy, const float* dh,
                    float* scratch, T* dxc, T* dx_proj, float* ddt_bias,
                    float* da_log, float* dh0, int b, int steps, int d, int n,
                    cudaStream_t stream) {
  RerunScratch s;
  carve_rerun(scratch, b, steps, d, n, &s);
  const int nc = (steps + CHUNK - 1) / CHUNK;
  const unsigned tiles = (unsigned)((d + BWD_THREADS - 1) / BWD_THREADS);
  const int64_t rows = (int64_t)b * steps;
  const int cols = 2 * n + 1;
  const int64_t slices = (rows + SLICE_ROWS - 1) / SLICE_ROWS;
  if (slices > 65535 || nc > 65535) return (int)cudaErrorInvalidValue;
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

// ---------------------------------------------------------------------------
// Entry points
// ---------------------------------------------------------------------------

// Checks the sizes and picks the state slots NS for n: the scan design
// when RERUN is false, the first design's when it is true.
template <typename T, bool RERUN>
int launch_bwd(const void* xc, const void* x_proj, const float* dt_bias,
               const float* a_log, const float* h0, const float* proj,
               const float* h_in, const float* dy, const float* dh,
               float* scratch, void* dxc, void* dx_proj, float* ddt_bias,
               float* da_log, float* dh0, int b, int steps, int d, int n,
               cudaStream_t stream) {
  if (b <= 0 || b > 65535 || steps <= 0 || d <= 0 || n <= 0 ||
      n > MAX_STATE)
    return (int)cudaErrorInvalidValue;
#define SSM_BWD(NS)                                                         \
  (RERUN ? launch_rerun_ns<T, NS> : launch_scan_ns<T, NS>)(                 \
      static_cast<const T*>(xc), static_cast<const T*>(x_proj), dt_bias,    \
      a_log, h0, proj, h_in, dy, dh, scratch, static_cast<T*>(dxc),         \
      static_cast<T*>(dx_proj), ddt_bias, da_log, dh0, b, steps, d, n,      \
      stream)
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
  ScanScratch s;
  *floats = carve_scan(nullptr, b, steps, d, n, &s);
  return 0;
}

// The same for the first design.
extern "C" int ssm_scan_bwd_rerun_scratch_floats(int b, int steps, int d,
                                                 int n, int64_t* floats) {
  RerunScratch s;
  *floats = carve_rerun(nullptr, b, steps, d, n, &s);
  return 0;
}

// xc: [b, steps, d]; x_proj: [d, 2n+1] of xc's type; dt_bias [d], a_log
// [d, n], h0 [b, d, n] float32; proj [b * steps, 2 ns + 4] and h_in [b,
// nc-1, n, d], the forward's chunked route's scratch after its launch (ns:
// n rounded up to 4, 8, 16 or 32; nc = ceil(steps / 128)); dy [b, steps,
// d] and dh [b, d, n] float32; scratch: the design's *_scratch_floats
// floats, 16-byte aligned.  Writes dxc [b, steps, d] and dx_proj [d, 2n+1]
// in xc's type, ddt_bias [d], da_log [d, n] and dh0 [b, d, n] in float32.
#define SSM_BWD_ENTRY(NAME, T, RERUN)                                        \
  extern "C" int NAME(const void* xc, const void* x_proj,                    \
                      const void* dt_bias, const void* a_log,                \
                      const void* h0, const void* proj, const void* h_in,    \
                      const void* dy, const void* dh, void* scratch,         \
                      void* dxc, void* dx_proj, void* ddt_bias,              \
                      void* da_log, void* dh0, int b, int steps, int d,      \
                      int n, void* stream) {                                 \
    return launch_bwd<T, RERUN>(                                             \
        xc, x_proj, static_cast<const float*>(dt_bias),                      \
        static_cast<const float*>(a_log), static_cast<const float*>(h0),     \
        static_cast<const float*>(proj), static_cast<const float*>(h_in),    \
        static_cast<const float*>(dy), static_cast<const float*>(dh),        \
        static_cast<float*>(scratch), dxc, dx_proj,                          \
        static_cast<float*>(ddt_bias), static_cast<float*>(da_log),          \
        static_cast<float*>(dh0), b, steps, d, n,                            \
        static_cast<cudaStream_t>(stream));                                  \
  }
SSM_BWD_ENTRY(ssm_scan_bwd_f32, float, false)
SSM_BWD_ENTRY(ssm_scan_bwd_bf16, __nv_bfloat16, false)
SSM_BWD_ENTRY(ssm_scan_bwd_rerun_f32, float, true)
SSM_BWD_ENTRY(ssm_scan_bwd_rerun_bf16, __nv_bfloat16, true)
