// Shared helpers of the kernel library (plain C entry points, loaded with
// ctypes from mirror_tpu_torch/ops/_common.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;
typedef __half f16;

#define MIRROR_EXPORT extern "C" __attribute__((visibility("default")))

// Round a float to bf16 and back: the rounding point of a bf16 result.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// The element types of the Nystrom path's kernels (the landmark softmax,
// the pinv, the softmax attention, PPEG, the conv): the compute type of the
// JAX package's Pallas kernels, bf16, float16 or float32. Every product and
// sum is accumulated in fp32; a result is rounded to T where the bf16
// kernel rounds (in float32 that rounding is the identity). Conversions go
// through the intrinsics only. kCode is the type code of the C entries
// (ops/_common.py::type_code).
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  static constexpr int kCode = 0;
  __device__ static float to_float(bf16 x) { return __bfloat162float(x); }
  __device__ static bf16 from_float(float x) { return __float2bfloat16(x); }
  __device__ static float2 unpack(unsigned u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
  __device__ static unsigned pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
    return *reinterpret_cast<unsigned*>(&v);
  }
};

template <>
struct Elem<f16> {
  static constexpr int kCode = 1;
  __device__ static float to_float(f16 x) { return __half2float(x); }
  __device__ static f16 from_float(float x) { return __float2half_rn(x); }
  __device__ static float2 unpack(unsigned u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
  __device__ static unsigned pack(float lo, float hi) {
    __half2 v = __float22half2_rn(make_float2(lo, hi));
    return *reinterpret_cast<unsigned*>(&v);
  }
};

template <>
struct Elem<float> {
  static constexpr int kCode = 2;
  __device__ static float to_float(float x) { return x; }
  __device__ static float from_float(float x) { return x; }
};

// elements of T in one 16-byte load or store
template <typename T>
__host__ __device__ constexpr int vec16() { return 16 / (int)sizeof(T); }

// x rounded to T and back (the identity for float)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Elem<T>::to_float(Elem<T>::from_float(x));
}

// Two adjacent elements of T as floats (p 4-byte aligned for 16-bit T, 8
// for float).
template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  if constexpr (std::is_same_v<T, float>)
    return *reinterpret_cast<const float2*>(p);
  else
    return Elem<T>::unpack(*reinterpret_cast<const unsigned*>(p));
}

// Store (lo, hi) rounded to T at p and p + 1 (aligned as for load2).
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  if constexpr (std::is_same_v<T, float>)
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  else
    *reinterpret_cast<unsigned*>(p) = Elem<T>::pack(lo, hi);
}

// Type code -> element type: f(T()) for the C entries' dtype argument;
// cudaErrorInvalidValue for a code no kernel takes.
template <class F>
cudaError_t by_type(int dtype, F&& f) {
  switch (dtype) {
    case 0: return f(bf16());
    case 1: return f(f16());
    case 2: return f(float());
    default: return cudaErrorInvalidValue;
  }
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

// The fixed-order column sum, the second pass of every kernel that reduces
// over blocks without float atomics: out[j] = sum over p < nparts of
// parts[p * count + j] (fp32 parts, fp32 or bf16 out). Its callers: the
// conv backward's dkern (conv1d.cu, also kernel 4b's conv), PPEG's dk / db
// (ppeg.cu, 5b), and gw, gs / gb of the fused LN + q/k/v backward
// (ln_qkv.cu, 10b); the probe exp_conv_parts times it alone.
//
// The order, the same from run to run (and emulated bit for bit in plain
// torch by ops/conv1d.py::column_sum_in_order): the parts are cut into G
// contiguous groups of per = ceil(nparts / G) parts (the last ones may be
// short or empty); each group is summed in part order from 0; then the G
// group sums are added as a pairwise tree, s[w] += s[w + 1], then s[w] +=
// s[w + 2], ... (w a multiple of twice the stride), and s[0] is rounded
// once to T. G is a power of two from column_sum_groups(nparts, count).
//
// What bounds it: the bytes of the parts (53 MB at 10b's gw, 7 parts of
// [768, 2304], 16 us) or, for a few hundred columns over hundreds of parts
// (the conv's dkern, gs / gb), the chain of dependent reads of one thread.
// Two regimes from one rule:
// - wide (gw, 5b): a thread owns 4 adjacent columns (a float4 when count %
//   4 == 0 and the pointers are aligned, else 4 scalars that stop at
//   count, never reading across rows) and walks its group's parts with
//   eight loads in flight before it adds them in order; G grows from 1 only
//   until the blocks fill 2 waves of the card's 132 SMs.
// - tall (a few hundred columns): the 256 threads of a block split into G
//   groups of 256 / G column quads; G grows to 64 (each group at least 4
//   parts), so a thread's chain is nparts / G reads, and the tree takes
//   log2 G shared-memory steps.
// The design it replaced gave one fp32 column to a thread, 32 to a block
// and 8 warps over the parts: 9 blocks at 264 columns, 144 dependent reads
// a warp over 1152 parts (0.0321 ms against sum(0)'s 0.0092), and 4-byte
// loads with one warp of 8 idle at gw (0.0557 ms).
constexpr int kColumnSumThreads = 256;
constexpr int kColumnSumMaxGroups = 64;
constexpr int kColumnSumMinParts = 4;     // parts a group has at least, once split
constexpr int kColumnSumTargetBlocks = 264;  // 2 waves of one block a SM on 132 SMs
constexpr int kColumnSumAhead = 8;        // loads a thread has in flight

// G, the number of part groups (a power of two): doubled from 1 while the
// grid is under the target, each group would keep kColumnSumMinParts parts
// and G is under kColumnSumMaxGroups.
inline int column_sum_groups(int nparts, long long count) {
  const long long quads = (count + 3) / 4;
  int groups = 1;
  while (groups < kColumnSumMaxGroups &&
         2LL * groups * kColumnSumMinParts <= nparts &&
         (quads + kColumnSumThreads / groups - 1) / (kColumnSumThreads / groups) <
             kColumnSumTargetBlocks)
    groups *= 2;
  return groups;
}

template <bool kVec>
__device__ __forceinline__ float4 load_quad(const float* p, long long left) {
  if constexpr (kVec) return __ldg(reinterpret_cast<const float4*>(p));
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  x.x = __ldg(p);
  if (left > 1) x.y = __ldg(p + 1);
  if (left > 2) x.z = __ldg(p + 2);
  if (left > 3) x.w = __ldg(p + 3);
  return x;
}

__device__ __forceinline__ void add_quad(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_quad(T* p, const float4& x, long long left) {
  if constexpr (kVec && sizeof(T) == sizeof(float)) {
    *reinterpret_cast<float4*>(p) = x;
  } else if constexpr (kVec) {
    uint2 u;
    u.x = Elem<T>::pack(x.x, x.y);
    u.y = Elem<T>::pack(x.z, x.w);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    const float v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < left) {
        p[e] = Elem<T>::from_float(v[e]);
      }
    }
  }
}

// One block: 256 / groups column quads x groups part groups (see above).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kColumnSumThreads)
    column_sum_kernel(const float* __restrict__ parts, int nparts, long long count, int groups,
                      T* __restrict__ out) {
  __shared__ float4 sums[kColumnSumThreads];
  const int quads = kColumnSumThreads / groups;
  const int q = threadIdx.x % quads, w = threadIdx.x / quads;
  const long long j = ((long long)blockIdx.x * quads + q) * 4;
  const int per = (nparts + groups - 1) / groups;
  const int p0 = min(nparts, w * per), p1 = min(nparts, p0 + per);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j < count) {
    const float* src = parts + j;
    for (int p = p0; p < p1; p += kColumnSumAhead) {
      float4 x[kColumnSumAhead];
#pragma unroll
      for (int u = 0; u < kColumnSumAhead; ++u)
        if (p + u < p1) x[u] = load_quad<kVec>(src + (size_t)(p + u) * count, count - j);
#pragma unroll
      for (int u = 0; u < kColumnSumAhead; ++u)
        if (p + u < p1) add_quad(acc, x[u]);
    }
  }
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int step = 1; step < groups; step *= 2) {
    if (w % (2 * step) == 0) add_quad(sums[threadIdx.x], sums[threadIdx.x + step * quads]);
    __syncthreads();
  }
  if (w == 0 && j < count) store_quad<T, kVec>(out + j, sums[q], count - j);
}

// Launch the column sum of `parts` [nparts, count] into `out` [count] on
// `stream`: the one launcher every caller goes through.
template <typename T>
cudaError_t launch_column_sum(const float* parts, int nparts, long long count, T* out,
                              cudaStream_t stream) {
  if (nparts <= 0 || count <= 0) return cudaErrorInvalidValue;
  const int groups = column_sum_groups(nparts, count);
  const long long quads = kColumnSumThreads / groups;
  const unsigned blocks = (unsigned)(((count + 3) / 4 + quads - 1) / quads);
  const bool vec = count % 4 == 0 && reinterpret_cast<uintptr_t>(parts) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  if (vec)
    column_sum_kernel<T, true><<<blocks, kColumnSumThreads, 0, stream>>>(parts, nparts, count,
                                                                       groups, out);
  else
    column_sum_kernel<T, false><<<blocks, kColumnSumThreads, 0, stream>>>(parts, nparts, count,
                                                                        groups, out);
  return cudaGetLastError();
}

}  // namespace
