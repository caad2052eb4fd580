// Tensor-core building blocks of the Nystrom softmax attention kernels
// (softmax_attn.cu, softmax_attn_bwd.cu), the landmark softmax's
// (landmark.cu, landmark_bwd.cu) and the ViT attention's: warp-level bf16
// products on mma.sync m16n8k16 with fp32 accumulators in registers, fed by
// ldmatrix from padded shared-memory tiles, and the cp.async tile loads of
// their rings.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
// - The accumulator of a 16 x 8 tile: c[0], c[1] at row g, columns 2t and
//   2t + 1; c[2], c[3] at row g + 8, the same columns. A warp's 16 x 64
//   tile is 8 of them, `float acc[8][4]`, so each thread holds 16 values of
//   two rows: a row's max or sum takes two shuffles within the quad.
// - The A operand of a 16 x 16 step: a[0] (row g, k 2t, 2t+1), a[1] (row
//   g + 8), a[2] (row g, k 8 + 2t), a[3] (row g + 8, k 8 + 2t). Columns
//   16 kk .. 16 kk + 15 of an accumulator are exactly the A operand of step
//   kk (to_a_frags), so a probability tile becomes the next product's A
//   without leaving registers (FlashAttention-2's layout).
// - The B operand of a 16 x 8 step: b[0] (k 2t, 2t+1; column g), b[1]
//   (k 8 + 2t). A matrix stored [n][k] (k contiguous: k and w rows against
//   q, or q rows against k) loads with ldmatrix; one stored [k][n] (n
//   contiguous: w, k, g or q walked along their rows as the reduction axis)
//   loads with ldmatrix.trans.
//
// Tiles live in shared memory with a row stride of dh + 8 elements (16
// bytes of padding): the 8 rows of an ldmatrix 8 x 8 matrix then fall in 8
// different 16-byte bank groups at every dh in 16..128, so no swizzle is
// needed and one layout serves every instance.
#pragma once

#include "common.cuh"

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 64;  // rows (or columns) a block owns: 16 a warp
constexpr int BN = 64;  // rows of a walked tile
constexpr int kStages = 2;  // the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float fast_exp2(float x) {  // ex2.approx(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b on one 16 x 8 x 16 step, bf16 in, fp32 accumulator
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// acc[16 x 8 NT] += A[16 x 16 KT] B[8 NT x 16 KT]^T: A's 16 rows at `a`, B's
// 8 NT rows at `b`, both k-contiguous with stride ld (S = q k^T, dP = g w^T
// and their transposes).
template <int KT, int NT>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4], const bf16* a, const bf16* b,
                                       int ld) {
  static_assert(NT % 2 == 0, "n-subtiles come in pairs");
  const int lane = threadIdx.x % 32;
  const bf16* pa = a + (lane % 16) * ld + (lane / 16) * 8;
  const bf16* pb = b + ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    unsigned fa[4];
    ldsm_x4(fa, pa + 16 * kk);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned fb[4];
      ldsm_x4(fb, pb + 16 * np * ld + 16 * kk);
      mma16816(acc[2 * np], fa, fb[0], fb[1]);
      mma16816(acc[2 * np + 1], fa, fb[2], fb[3]);
    }
  }
}

// The A operand of a warp's 16 rows at `a` (k-contiguous, stride ld), all
// 16 KT columns, into registers once (ldmatrix), for mma_nt_ra.
template <int KT>
__device__ __forceinline__ void load_a_frags(unsigned (&a)[KT][4], const bf16* p, int ld) {
  const int lane = threadIdx.x % 32;
  const bf16* pa = p + (lane % 16) * ld + (lane / 16) * 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) ldsm_x4(a[kk], pa + 16 * kk);
}

// mma_nt with A already in registers (load_a_frags): the landmark softmax's
// S = q_l k_l^T and S^T = k_l q_l^T, whose owned rows are multiplied by
// every walked tile.
template <int KT, int NT>
__device__ __forceinline__ void mma_nt_ra(float (&acc)[NT][4], const unsigned (&a)[KT][4],
                                          const bf16* b, int ld) {
  static_assert(NT % 2 == 0, "n-subtiles come in pairs");
  const int lane = threadIdx.x % 32;
  const bf16* pb = b + ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      unsigned fb[4];
      ldsm_x4(fb, pb + 16 * np * ld + 16 * kk);
      mma16816(acc[2 * np], a[kk], fb[0], fb[1]);
      mma16816(acc[2 * np + 1], a[kk], fb[2], fb[3]);
    }
  }
}

// acc[16 x 8 NT] += A[16 x 16] B[16 x 8 NT], one k-step: A from registers,
// B stored [k][n] (n contiguous) at `b` with stride ld.
template <int NT>
__device__ __forceinline__ void mma_rs_step(float (&acc)[NT][4], const unsigned (&a)[4],
                                            const bf16* b, int ld) {
  static_assert(NT % 2 == 0, "n-subtiles come in pairs");
  const int lane = threadIdx.x % 32;
  const bf16* pb = b + ((lane % 8) + ((lane / 8) % 2) * 8) * ld + (lane / 16) * 8;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    unsigned fb[4];
    ldsm_x4_t(fb, pb + 16 * np);
    mma16816(acc[2 * np], a, fb[0], fb[1]);
    mma16816(acc[2 * np + 1], a, fb[2], fb[3]);
  }
}

// acc[16 x 8 NT] += A[16 x 16 KT] B[16 KT x 8 NT]: A from registers (to_a_frags),
// B stored [k][n] at `b` (P w, dsim k, P^T g, dsim^T q).
template <int KT, int NT>
__device__ __forceinline__ void mma_rs(float (&acc)[NT][4], const unsigned (&a)[KT][4],
                                       const bf16* b, int ld) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) mma_rs_step<NT>(acc, a[kk], b + 16 * kk * ld, ld);
}

// The bf16 A operand of a product over the 64 columns of a 16 x 64 fp32 tile.
__device__ __forceinline__ void to_a_frags(unsigned (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[kk][1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[kk][2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// cp.async rows [row0, row0 + rows) of a [n, dh] bf16 matrix into shared
// memory with stride ld, 16 bytes a thread; rows outside [0, n) are
// zero-filled (the ragged edge and the conv's SAME padding).
template <int DH>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld, const bf16* src, int row0,
                                                int rows, int n) {
  constexpr int chunks = DH / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    const int gr = row0 + r;
    const bool ok = gr >= 0 && gr < n;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)gr * DH + c : src, ok);
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

// Write a warp's 16 x 8 NT accumulator, each row scaled (rows g and g + 8 by
// s_lo and s_hi), as bf16 into its 16 staging rows `stage` (stride ld).
template <int NT>
__device__ __forceinline__ void stage_bf16(bf16* stage, int ld, const float (&acc)[NT][4],
                                           float s_lo, float s_hi) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<unsigned*>(stage + g * ld + 8 * n + 2 * t) =
        pack_bf16(acc[n][0] * s_lo, acc[n][1] * s_lo);
    *reinterpret_cast<unsigned*>(stage + (g + 8) * ld + 8 * n + 2 * t) =
        pack_bf16(acc[n][2] * s_hi, acc[n][3] * s_hi);
  }
}

// Copy a warp's 16 staged rows to rows row0.. of a [n, dh] bf16 matrix, 16
// bytes a lane; rows past n are skipped. Synchronises the warp around it.
template <int DH>
__device__ __forceinline__ void store_staged(bf16* dst, const bf16* stage, int ld, int row0,
                                             int n) {
  constexpr int chunks = DH / 8;
  const int lane = threadIdx.x % 32;
  __syncwarp();
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * DH + c) =
          *reinterpret_cast<const uint4*>(stage + r * ld + c);
  }
  __syncwarp();
}

}  // namespace attn
