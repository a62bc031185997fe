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
// The outputs must arrive zero-filled (the Python wrapper allocates them
// with torch.zeros); invalid slots are skipped, never multiplied by zero,
// because padding may hold NaN.
//
// Design.  The TPU kernel re-expresses the scatter as a one-hot matmul on
// its matrix unit over key tiles resident in VMEM.  On Hopper that would
// be both wasteful (records x key_block multiply-adds per record block)
// and inexact for int32 sums above 2^24 in the tensor cores, so this
// kernel scatters directly: one thread per record (grid-stride), one
// atomicAdd per value column plus one for the count.  Integer atomics are
// exact; float32 atomics add in a run-dependent order.
//
// What bounds it: bytes.  Each record reads 4 (key) + 1 (valid) + 4*d
// (values) bytes once; the table (num_keys * d * 4 B) and counts
// (num_keys * 4 B) are written through L2 atomics.  At 4**12 keys the
// table plus counts are 134 MB for d = 1 — larger than the 50 MB L2 — so
// the random atomics miss L2 and each costs a DRAM sector round trip;
// that, not arithmetic, is where the time goes.  A later version can
// privatise hot key ranges in shared memory or sort keys first.
//
// Interface: plain C, loaded with ctypes.  Each launcher returns
// cudaGetLastError() of its launch (0 = success) and launches nothing for
// n == 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
int launch(const int32_t* keys, const T* values, const uint8_t* valid,
           int64_t n, int d, int64_t num_keys, T* table, int32_t* counts,
           int32_t* overflow, int blocks, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int64_t need = (n + threads - 1) / threads;
  const int grid = (int)(need < blocks ? need : blocks);
  segment_sum_kernel<T><<<grid, threads, 0, stream>>>(
      keys, values, valid, n, d, num_keys, table, counts, overflow);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int segment_sum_i32(const void* keys, const void* values,
                               const void* valid, int64_t n, int d,
                               int64_t num_keys, void* table, void* counts,
                               void* overflow, int blocks, void* stream) {
  return launch<int32_t>((const int32_t*)keys, (const int32_t*)values,
                         (const uint8_t*)valid, n, d, num_keys,
                         (int32_t*)table, (int32_t*)counts,
                         (int32_t*)overflow, blocks, (cudaStream_t)stream);
}

extern "C" int segment_sum_f32(const void* keys, const void* values,
                               const void* valid, int64_t n, int d,
                               int64_t num_keys, void* table, void* counts,
                               void* overflow, int blocks, void* stream) {
  return launch<float>((const int32_t*)keys, (const float*)values,
                       (const uint8_t*)valid, n, d, num_keys, (float*)table,
                       (int32_t*)counts, (int32_t*)overflow, blocks,
                       (cudaStream_t)stream);
}
