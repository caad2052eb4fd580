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
// (wmma loads and stores need 32-byte aligned pointers).
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
