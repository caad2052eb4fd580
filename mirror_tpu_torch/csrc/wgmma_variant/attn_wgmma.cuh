// Tensor-core building blocks of the wgmma variant of the Nystrom softmax
// attention kernels (wgmma_variant/softmax_attn.cu, softmax_attn_bwd.cu;
// the shipped kernels use ../attn_mma.cuh): warpgroup products on wgmma
// (sm_90a) with fp32 accumulators in registers, operands in shared memory
// or, for A, in registers, and the cp.async loads of their tiles.
//
// A block is one warpgroup (4 warps) and owns 64 rows (or columns): every
// product is a wgmma m64nNk16 over them, N = 64 (a walked tile) or dh.
// Fragment layouts (PTX ISA, wgmma .m64nNk16): warp w of the warpgroup holds
// rows 16 w .. 16 w + 15; lane = 4 g + t.
// - The accumulator: per 8 columns n, d[n][0], d[n][1] at row g, columns
//   8 n + 2t, 8 n + 2t + 1; d[n][2], d[n][3] at row g + 8. A 64-column tile
//   is `float acc[8][4]`: each thread holds 16 values of two rows, so a
//   row's max or sum takes two shuffles within the quad.
// - The A operand from registers, one k-step of 16: a[0] (row g, k 2t,
//   2t + 1), a[1] (row g + 8), a[2] (row g, k 8 + 2t), a[3] (row g + 8, k
//   8 + 2t). Columns 16 kk .. 16 kk + 15 of an accumulator are exactly the A
//   operand of step kk (to_a_frags), so a probability tile becomes the next
//   product's A without leaving registers.
//
// Shared-memory tiles use wgmma's layout without swizzle: a [rows, dh] bf16
// tile is stored as 8 x 8 core matrices of 128 contiguous bytes (row r,
// column c at cm(r, c)), row groups dh * 16 bytes apart. One tile serves
// both operand majors: as a K-major operand (q, k rows against each other:
// S = q k^T; the reduction axis is dh) and as an MN-major one (w, k, g or q
// walked along their rows, the reduction axis of P w, dsim k, P^T g and
// dsim^T q), with the two core-matrix strides swapped in the descriptor.
// The layout fits every dh that is a multiple of 8, so one template serves
// dh 16..128 with no swizzle atom to divide dh.
#pragma once

#include "common.cuh"

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;  // one warpgroup
constexpr int BM = 64;  // rows (or columns) a block owns: 16 a warp
constexpr int BN = 64;  // rows of a walked tile
constexpr int kStages = 2;  // the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;

// element offset of (r, c) in a core-matrix tile with DH columns
template <int DH>
__device__ __forceinline__ int cm(int r, int c) {
  return (r >> 3) * (DH * 8) + (c >> 3) * 64 + (r & 7) * 8 + (c & 7);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float fast_exp2(float x) {  // ex2.approx(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<unsigned*>(&v);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// A wgmma shared-memory descriptor, no swizzle: the start address, the
// leading-dimension byte offset (between core matrices along K for a
// K-major operand, along K too for an MN-major one) and the stride byte
// offset (between core matrices along M or N), all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(const bf16* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// a tile as a K-major operand (its rows are M or N, dh the reduction axis)
template <int DH>
__device__ __forceinline__ uint64_t desc_k(const bf16* p) {
  return make_desc(p, 128, DH * 16);
}

// a tile as an MN-major operand (its rows are the reduction axis)
template <int DH>
__device__ __forceinline__ uint64_t desc_mn(const bf16* p) {
  return make_desc(p, DH * 16, 128);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulator registers at this point of the program: the compiler
// sees wgmma as synchronous, so reads of its results must not move above
// the wait, nor writes of its inputs below the issue.
template <int NT>
__device__ __forceinline__ void fence_regs(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[n][e])::"memory");
}

template <int KT>
__device__ __forceinline__ void fence_regs(unsigned (&a)[KT][4]) {
#pragma unroll
  for (int k = 0; k < KT; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

// Writes of shared memory by cp.async (the generic proxy) made visible to
// wgmma's reads (the async proxy); before the block barrier that publishes
// a tile.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both from shared memory, K-major;
// the accumulator is kept (scale_d 1) or overwritten (0)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 16 DT] += A[64 x 16] B[16 x 16 DT]: A from registers, B from shared
// memory, MN-major
template <int DT>
__device__ __forceinline__ void wgmma_rs(float (&d)[2 * DT][4], const unsigned (&a)[4],
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<1>(float (&d)[2][4], const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<2>(float (&d)[4][4], const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<3>(float (&d)[6][4], const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<4>(float (&d)[8][4], const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<5>(float (&d)[10][4], const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<6>(float (&d)[12][4], const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<7>(float (&d)[14][4], const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[16][4], const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]),
        "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]),
        "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]),
        "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]),
        "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// acc[64 x 64] = A[64 x DH] B[64 x DH]^T: the block's 64 rows of tile a
// against the 64 rows of tile b, both core-matrix tiles with DH = 16 DT
// columns (S = q k^T, dP = g w^T and their transposes).
template <int DT>
__device__ __forceinline__ void gemm_nt(float (&acc)[8][4], const bf16* a, const bf16* b) {
  constexpr int DH = 16 * DT;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DT; ++kk)
    wgmma_ss_n64(acc, desc_k<DH>(a + 128 * kk), desc_k<DH>(b + 128 * kk), kk > 0);
  wgmma_commit_wait();
  fence_regs(acc);
}

// acc[64 x DH] += A[64 x 16 KT] B[16 KT x DH]: A from registers (to_a_frags,
// each warp its 16 rows), B the first 16 KT rows of a core-matrix tile with
// DH = 16 DT columns (P w, dsim k, P^T g, dsim^T q).
template <int KT, int DT>
__device__ __forceinline__ void gemm_rs(float (&acc)[2 * DT][4], unsigned (&a)[KT][4],
                                        const bf16* b) {
  constexpr int DH = 16 * DT;
  fence_regs(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) wgmma_rs<DT>(acc, a[kk], desc_mn<DH>(b + 16 * DH * kk));
  wgmma_commit_wait();
  fence_regs(acc);
}

// The bf16 A operand of a product over the 64 columns of a 64 x 64 fp32 tile.
__device__ __forceinline__ void to_a_frags(unsigned (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// cp.async rows [row0, row0 + rows) of a [n, DH] bf16 matrix into a
// core-matrix tile, 16 bytes a thread (rows a multiple of 8); rows outside
// [0, n) are zero-filled (the ragged edge and the conv's SAME padding).
// 8 neighbouring threads take one 16-byte column of 8 rows: a warp writes
// 4 whole core matrices, 512 contiguous bytes.
template <int DH>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src, int row0, int rows,
                                                int n) {
  constexpr int chunks = DH / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = (idx / (8 * chunks)) * 8 + (idx & 7), c = ((idx >> 3) % chunks) * 8;
    const int gr = row0 + r;
    const bool ok = gr >= 0 && gr < n;
    cp_async16(dst + cm<DH>(r, c), ok ? src + (size_t)gr * DH + c : src, ok);
  }
}

// cp.async entries [row0, row0 + BN) of an fp32 vector of n entries, 4
// bytes a thread; entries past n are zero-filled.
__device__ __forceinline__ void load_vec_async(float* dst, const float* src, int row0, int n) {
  for (int i = threadIdx.x; i < BN; i += kThreads) {
    const bool ok = row0 + i < n;
    const unsigned d = smem_u32(dst + i);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(ok ? src + row0 + i : src), "r"(ok ? 4 : 0));
  }
}

// Write this warp's 16 rows of a 64 x DH accumulator, rows g and g + 8
// scaled by s_lo and s_hi, as bf16 into the core-matrix tile `stage`.
template <int DT>
__device__ __forceinline__ void stage_bf16(bf16* stage, const float (&acc)[2 * DT][4],
                                           float s_lo, float s_hi) {
  constexpr int DH = 16 * DT;
  const int lane = threadIdx.x % 32, row = (threadIdx.x / 32) * 16 + lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < 2 * DT; ++n) {
    *reinterpret_cast<unsigned*>(stage + cm<DH>(row, 8 * n + 2 * t)) =
        pack_bf16(acc[n][0] * s_lo, acc[n][1] * s_lo);
    *reinterpret_cast<unsigned*>(stage + cm<DH>(row + 8, 8 * n + 2 * t)) =
        pack_bf16(acc[n][2] * s_hi, acc[n][3] * s_hi);
  }
}

// Copy this warp's 16 staged rows (16 w ..) to rows row0 + 16 w .. of a
// [n, DH] bf16 matrix, 16 bytes a lane; rows past n are skipped.
// Synchronises the warp around it.
template <int DH>
__device__ __forceinline__ void store_staged(bf16* dst, const bf16* stage, int row0, int n) {
  constexpr int chunks = DH / 8;
  const int lane = threadIdx.x % 32, r0 = (threadIdx.x / 32) * 16;
  __syncwarp();
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int r = r0 + idx / chunks, c = (idx % chunks) * 8;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * DH + c) =
          *reinterpret_cast<const uint4*>(stage + cm<DH>(r, c));
  }
  __syncwarp();
}

}  // namespace attn
