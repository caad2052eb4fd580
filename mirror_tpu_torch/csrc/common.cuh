// Shared helpers of the kernel library (plain C entry points, loaded with
// ctypes from mirror_tpu_torch/ops/_common.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define MIRROR_EXPORT extern "C" __attribute__((visibility("default")))

// Round a float to bf16 and back: the rounding point of a bf16 result.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Byte offsets of shared-memory sub-buffers, each aligned to 128 bytes
// (ldmatrix rows and 16-byte vector accesses need aligned pointers).
__host__ __device__ constexpr size_t smem_align(size_t bytes) {
  return (bytes + 127) & ~size_t(127);
}

// Allow `bytes` of dynamic shared memory for `kernel` (needed above 48 KB).
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// 16-byte asynchronous copy global -> shared (cp.async, sm_80 and later).
// With valid false nothing is read and the 16 bytes are zero-filled; gmem
// must still be a mapped address (pass the tensor's base).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

namespace {

// out[j] = sum over p of parts[p * count + j] for j < count, in a fixed
// order, so the result is the same from run to run: a block of 32 x 8
// threads takes 32 columns, lane j a column, warp w the rows w, w + 8, ...
// in order; then the 8 warp sums are added in order. Launch with
// column_sum_blocks(count) blocks of dim3(32, 8).
template <typename T>
__global__ void __launch_bounds__(256)
    column_sum_kernel(const float* __restrict__ parts, int nparts, long long count,
                      T* __restrict__ out) {
  __shared__ float sums[8][32];
  const long long j = (long long)blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (j < count)
    for (int p = threadIdx.y; p < nparts; p += 8) acc += parts[(size_t)p * count + j];
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < count) {
    float total = 0.f;
    for (int w = 0; w < 8; ++w) total += sums[w][threadIdx.x];
    if constexpr (sizeof(T) == sizeof(float))
      out[j] = total;
    else
      out[j] = __float2bfloat16(total);
  }
}

inline unsigned column_sum_blocks(long long count) { return (unsigned)((count + 31) / 32); }

}  // namespace

