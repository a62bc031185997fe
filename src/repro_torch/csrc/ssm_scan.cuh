// Device helpers shared by the selective scan's forward (ssm_scan.cu) and
// backward (ssm_scan_bwd.cu): the chunk length, the float conversions, the
// softplus and exp2 the recurrence takes, the staging of a chunk's
// projection rows, one step of a channel's states and the dynamic shared
// memory opt-in.  One copy, so the backward recomputes the forward's h
// bit for bit; KernelLibrary (kernels/build.py) hashes this header with
// each source that includes it.
//
// Included at file scope; everything sits in an unnamed namespace, so each
// library keeps its own copy and exports none.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_STATE = 32;
constexpr int CHUNK = 128;          // steps a chunk of the chunked route
constexpr int MAX_DEVICES = 64;     // devices whose smem limits are cached
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// jax.nn.softplus: logaddexp(x, 0)
__device__ __forceinline__ float softplus(float x) {
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.f);
}

// 2^x on the MUFU unit (relative error ~2^-22; subnormal results -> 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Copies count elements of T from global to shared memory, U batched
// loads a thread in flight (16 bytes each where both ends are aligned).
template <typename T, int U = 16>
__device__ __forceinline__ void stage_slab(T* dst, const T* src, int count) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    constexpr int PER = 16 / sizeof(T);
    const int packs = count / PER;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int base = 0; base < packs; base += U * nt) {
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * nt + tid;
        if (i < packs) v[u] = s4[i];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * nt + tid;
        if (i < packs) d4[i] = v[u];
      }
    }
    done = packs * PER;
  }
  for (int base = done; base < count; base += U * nt) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * nt + tid;
      if (i < count) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = base + u * nt + tid;
      if (i < count) dst[i] = v[u];
    }
  }
}

// A row of the chunked route's proj (one step): B at [0, n), C at [NS,
// NS + n), dt at 2NS, padded to 2NS + 4 floats so that every row starts
// 16-byte aligned (proj_slot with ns = NS).
template <int NS>
__host__ __device__ constexpr int row_floats() { return 2 * NS + 4; }

// State (b, d) of a chunk: A2[s] = -exp(a_log) * log2(e), so that
// a = 2^(A2 * dt) = exp(-A * dt).
template <int NS>
__device__ __forceinline__ void load_decay(const float* a_log, int ch, int n,
                                           float (&A2)[NS]) {
#pragma unroll
  for (int s = 0; s < NS; ++s)
    A2[s] = s < n ? -expf(a_log[(int64_t)ch * n + s]) * LOG2E : 0.f;
}

// One step of a channel's states from its shared-memory row; returns dt
// and sets *y = sum_n h * C when Y.  All NS slots run: past n, A2 is 0
// and B, C are 0 (zero_unused), so h stays 0 there.
template <int NS, bool Y>
__device__ __forceinline__ float chunk_step(float (&h)[NS],
                                            const float (&A2)[NS],
                                            const float* pr, float x,
                                            float bias, float* y) {
  const float dt = softplus(pr[2 * NS] + bias);
  const float dx = dt * x;
  float bv[NS], cv[NS];
#pragma unroll
  for (int q = 0; q < NS / 4; ++q) {
    const float4 b4 = *reinterpret_cast<const float4*>(pr + 4 * q);
    bv[4 * q] = b4.x, bv[4 * q + 1] = b4.y;
    bv[4 * q + 2] = b4.z, bv[4 * q + 3] = b4.w;
    if (Y) {
      const float4 c4 = *reinterpret_cast<const float4*>(pr + NS + 4 * q);
      cv[4 * q] = c4.x, cv[4 * q + 1] = c4.y;
      cv[4 * q + 2] = c4.z, cv[4 * q + 3] = c4.w;
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    h[s] = ex2(A2[s] * dt) * h[s] + dx * bv[s];
    if (Y) acc = fmaf(h[s], cv[s], acc);
  }
  if (Y) *y = acc;
  return dt;
}

// Raises a kernel's dynamic shared memory limit to `bytes` (the most any
// of its launches takes) once for each device: `done` is the calling
// launcher's own, one for each kernel instance.  cudaFuncSetAttribute is
// a driver call, and the step route launches once a layer of a decode
// step.
template <typename K>
int allow_smem(K kernel, size_t bytes,
               std::atomic<bool> (&done)[MAX_DEVICES]) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < MAX_DEVICES && done[dev].load(std::memory_order_acquire))
    return 0;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (!err && dev < MAX_DEVICES)
    done[dev].store(true, std::memory_order_release);
  return err;
}


}  // namespace
