// Tensor-core building blocks of the Nystrom softmax attention kernels
// (softmax_attn.cu, softmax_attn_bwd.cu), the landmark softmax's
// (landmark.cu, landmark_bwd.cu), the pinv's GEMM (gemm_mma.cuh), the conv
// (conv1d.cu) and the ViT attention's (last in this file): warp-level
// products on mma.sync with fp32 accumulators in registers, fed by ldmatrix
// from padded shared-memory tiles, and the cp.async tile loads of their
// rings.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
// - The accumulator of a 16 x 8 tile: c[0], c[1] at row g, columns 2t and
//   2t + 1; c[2], c[3] at row g + 8, the same columns. A warp's 16 x 64
//   tile is 8 of them, `float acc[8][4]`, so each thread holds 16 values of
//   two rows: a row's max or sum takes two shuffles within the quad.
// - The A operand of a 16 x 16 step: a[0] (row g, k 2t, 2t+1), a[1] (row
//   g + 8), a[2] (row g, k 8 + 2t), a[3] (row g + 8, k 8 + 2t). Columns
//   16 kk .. 16 kk + 15 of an accumulator are exactly the A operand of step
//   kk (afrag_from_acc), so a probability tile becomes the next product's A
//   without leaving registers (FlashAttention-2's layout).
// - The B operand of a 16 x 8 step: b[0] (k 2t, 2t+1; column g), b[1]
//   (k 8 + 2t). A matrix stored [n][k] (k contiguous: k and w rows against
//   q, or q rows against k) loads with ldmatrix; one stored [k][n] (n
//   contiguous: w, k, g or q walked along their rows as the reduction axis)
//   loads with ldmatrix.trans.
//
// Tiles live in shared memory with a row stride of dh + 8 elements (16
// bytes of padding; dh rounded up to 16, or a 128-column chunk above 128):
// the 8 rows of an ldmatrix 8 x 8 matrix then fall in 8 different 16-byte
// bank groups at every such width, so no swizzle is needed and one layout
// serves every instance.
//
// Element types (the second half of this file). The Nystrom path's kernels
// take the JAX package's compute type T: bf16, float16 or float32. The
// fragment helpers below (AFrag, BFrag, mma_step and the loaders) hide the
// type, so one kernel body serves all three:
// - bf16 and float16: mma.sync m16n8k16 with .bf16 or .f16 operands, the
//   same ldmatrix addressing (both are 16-bit), packs by the intrinsics.
//   The bf16 instances issue the instructions they issued before the types
//   were added, in the same order.
// - float32: mma.sync m16n8k8 .tf32 in the 3xTF32 split. Each operand x
//   is hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and a b is summed as
//   a_lo b_hi + a_hi b_lo + a_hi b_hi into the fp32 accumulator (a_lo b_lo,
//   below 2^-22 relative, is dropped): about 21 bits of each product, where
//   one TF32 pass keeps 11 (tests/test_torch_port_dtypes.py emulates the
//   split in numpy and holds it to float64). A 16-deep step of
//   the other types is two k8 steps. Their fragments (a0 (g, t), a1 (g + 8,
//   t), a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g))
//   are read with a permuted k: logical k t is the tile's column 2 t and k
//   t + 4 its column 2 t + 1 (A and B alike, so the sum is the same), which
//   makes a0 / a2 and b0 / b1 adjacent in a k-contiguous row (one 8-byte
//   load) and an accumulator's (c0, c1) pair exactly an A pair: an fp32 S
//   tile is P w's A operand with no shuffle, as in the 16-bit types. Tiles
//   stored n- or m-contiguous (ldmatrix.trans in the 16-bit types) are read
//   with 4-byte loads. fp32 tiles keep the dh + 8 row stride (32 bytes of
//   padding): the 8-byte loads of a half-warp then cover the 32 banks once.
#pragma once

#include "common.cuh"

namespace attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 64;  // rows (or columns) a block owns: 16 a warp
constexpr int BN = 64;  // rows of a walked tile
constexpr int kStages = 2;  // the cp.async ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxKeyTiles = 16;  // attend_rows: n <= 256, the key tiles a score row holds

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float fast_exp2(float x) {  // ex2.approx(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
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

// ---- The element-type generic fragments (see the head of this file) ----

// d += a b on one 16 x 8 x 16 step, float16 in, fp32 accumulator
__device__ __forceinline__ void mma16816_f16(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b on one 16 x 8 x 8 step, tf32 in, fp32 accumulator
__device__ __forceinline__ void mma1688_tf32(float (&d)[4], const unsigned (&a)[4],
                                             unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits, to nearest, ties away), as a b32
__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// the 3xTF32 split of x: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The A operand of one 16 x 16 step: 16-bit types as mma.m16n8k16 takes it
// (a[0..3] of the head of this file); float as two k8 steps, r[4 h + i] the
// fp32 value of a_i in k-half h, with the permuted k.
template <typename T>
struct AFrag {
  unsigned r[4];
};
template <>
struct AFrag<float> {
  float r[8];
};

// The B operand of one 16 x 8 step (an n8 tile, 16 deep): r[2 h + i] = b_i
// of k-half h for float.
template <typename T>
struct BFrag {
  unsigned r[2];
};
template <>
struct BFrag<float> {
  float r[4];
};

// An A operand ready for the tensor cores: for float its hi / lo split,
// made once a step and used against every n tile.
template <typename T>
struct AOp {
  unsigned r[4];
};
template <>
struct AOp<float> {
  unsigned hi[8], lo[8];
};

template <typename T>
__device__ __forceinline__ AOp<T> prepare(const AFrag<T>& a) {
  AOp<T> op;
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int i = 0; i < 8; ++i) split_tf32(a.r[i], op.hi[i], op.lo[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) op.r[i] = a.r[i];
  }
  return op;
}

// d[16 x 8] += a b over one 16-deep step
template <typename T>
__device__ __forceinline__ void mma_step(float (&d)[4], const AOp<T>& a, const BFrag<T>& b) {
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned bh[2], bl[2];
      split_tf32(b.r[2 * h], bh[0], bl[0]);
      split_tf32(b.r[2 * h + 1], bh[1], bl[1]);
      const unsigned ah[4] = {a.hi[4 * h], a.hi[4 * h + 1], a.hi[4 * h + 2], a.hi[4 * h + 3]};
      const unsigned al[4] = {a.lo[4 * h], a.lo[4 * h + 1], a.lo[4 * h + 2], a.lo[4 * h + 3]};
      // the small terms first, then the large one
      mma1688_tf32(d, al, bh[0], bh[1]);
      mma1688_tf32(d, ah, bl[0], bl[1]);
      mma1688_tf32(d, ah, bh[0], bh[1]);
    }
  } else if constexpr (std::is_same_v<T, f16>) {
    mma16816_f16(d, a.r, b.r[0], b.r[1]);
  } else {
    mma16816(d, a.r, b.r[0], b.r[1]);
  }
}

// The A operand of a 16 x 16 block given by f(row, col), row and col in
// [0, 16), rounded to T (the conv's band, from its taps).
template <typename T, class F>
__device__ __forceinline__ AFrag<T> afrag_from(F&& f) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  AFrag<T> a;
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      a.r[4 * h] = f(g, 8 * h + 2 * t);
      a.r[4 * h + 1] = f(g + 8, 8 * h + 2 * t);
      a.r[4 * h + 2] = f(g, 8 * h + 2 * t + 1);
      a.r[4 * h + 3] = f(g + 8, 8 * h + 2 * t + 1);
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e & 1), col = 8 * (e / 2) + 2 * t;
      a.r[e] = Elem<T>::pack(f(row, col), f(row, col + 1));
    }
  }
  return a;
}

// The A operand of a product over columns 16 kk .. 16 kk + 15 of an fp32
// 16 x 8 NT accumulator tile (its n8 tiles x0 = 2 kk and x1 = 2 kk + 1),
// rounded to T: P, dsim and their transposes as the next product's A.
template <typename T>
__device__ __forceinline__ AFrag<T> afrag_from_acc(const float (&x0)[4], const float (&x1)[4]) {
  AFrag<T> a;
  if constexpr (std::is_same_v<T, float>) {
    a.r[0] = x0[0], a.r[1] = x0[2], a.r[2] = x0[1], a.r[3] = x0[3];
    a.r[4] = x1[0], a.r[5] = x1[2], a.r[6] = x1[1], a.r[7] = x1[3];
  } else {
    a.r[0] = Elem<T>::pack(x0[0], x0[1]);
    a.r[1] = Elem<T>::pack(x0[2], x0[3]);
    a.r[2] = Elem<T>::pack(x1[0], x1[1]);
    a.r[3] = Elem<T>::pack(x1[2], x1[3]);
  }
  return a;
}

// The A operand of a 16 x 16 block stored [row][k] (k contiguous):
// row(r) points at row r's first column of the block.
template <typename T, class Row>
__device__ __forceinline__ AFrag<T> load_a(Row&& row) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  AFrag<T> a;
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 lo = *reinterpret_cast<const float2*>(row(g) + 8 * h + 2 * t);
      const float2 hi = *reinterpret_cast<const float2*>(row(g + 8) + 8 * h + 2 * t);
      a.r[4 * h] = lo.x, a.r[4 * h + 1] = hi.x, a.r[4 * h + 2] = lo.y, a.r[4 * h + 3] = hi.y;
    }
  } else {
    ldsm_x4(a.r, row(lane % 16) + (lane / 16) * 8);
  }
  return a;
}

// The A operand of a 16 x 16 block stored [k][row] (rows contiguous, read
// transposed): krow(r) points at k row r's first element of the block.
template <typename T, class Row>
__device__ __forceinline__ AFrag<T> load_a_t(Row&& krow) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  AFrag<T> a;
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* k0 = krow(8 * h + 2 * t);
      const float* k1 = krow(8 * h + 2 * t + 1);
      a.r[4 * h] = k0[g], a.r[4 * h + 1] = k0[g + 8], a.r[4 * h + 2] = k1[g];
      a.r[4 * h + 3] = k1[g + 8];
    }
  } else {
    ldsm_x4_t(a.r, krow((lane % 8) + (lane / 16) * 8) + ((lane / 8) % 2) * 8);
  }
  return a;
}

// The B operands of two n8 tiles (16 columns) of a 16-deep step, B stored
// [n][k] (k contiguous): nrow(c) points at column c's first k.
template <typename T, class Row>
__device__ __forceinline__ void load_b_nk(BFrag<T> (&b)[2], Row&& nrow) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = *reinterpret_cast<const float2*>(nrow(8 * j + g) + 8 * h + 2 * t);
        b[j].r[2 * h] = v.x, b[j].r[2 * h + 1] = v.y;
      }
  } else {
    unsigned f[4];
    ldsm_x4(f, nrow((lane % 8) + (lane / 16) * 8) + ((lane / 8) % 2) * 8);
    b[0].r[0] = f[0], b[0].r[1] = f[1], b[1].r[0] = f[2], b[1].r[1] = f[3];
  }
}

// The same, B stored [k][n] (n contiguous): krow(r) points at k row r's
// first column of the two tiles.
template <typename T, class Row>
__device__ __forceinline__ void load_b_kn(BFrag<T> (&b)[2], Row&& krow) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* kr = krow(8 * h + 2 * t + i);
        b[0].r[2 * h + i] = kr[g];
        b[1].r[2 * h + i] = kr[8 + g];
      }
  } else {
    unsigned f[4];
    ldsm_x4_t(f, krow((lane % 8) + ((lane / 8) % 2) * 8) + (lane / 16) * 8);
    b[0].r[0] = f[0], b[0].r[1] = f[1], b[1].r[0] = f[2], b[1].r[1] = f[3];
  }
}

// acc[16 x 8 NT] += A[16 x 16 KT] B[8 NT x 16 KT]^T: A's 16 rows at `a`, B's
// 8 NT rows at `b`, both k-contiguous with stride ld (S = q k^T, dP = g w^T
// and their transposes).
template <int KT, int NT, typename T>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4], const T* a, const T* b, int ld) {
  static_assert(NT % 2 == 0, "n-subtiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const AOp<T> fa = prepare(load_a<T>([&](int r) { return a + r * ld + 16 * kk; }));
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      BFrag<T> fb[2];
      load_b_nk<T>(fb, [&](int c) { return b + (16 * np + c) * ld + 16 * kk; });
      mma_step(acc[2 * np], fa, fb[0]);
      mma_step(acc[2 * np + 1], fa, fb[1]);
    }
  }
}

// The A operand of a warp's 16 rows at `p` (k-contiguous, stride ld), all
// 16 KT columns, into registers once, for mma_nt_ra.
template <int KT, typename T>
__device__ __forceinline__ void load_a_frags(AFrag<T> (&a)[KT], const T* p, int ld) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) a[kk] = load_a<T>([&](int r) { return p + r * ld + 16 * kk; });
}

// mma_nt with A already in registers (load_a_frags): the landmark softmax's
// S = q_l k_l^T and S^T = k_l q_l^T, whose owned rows are multiplied by
// every walked tile.
template <int KT, int NT, typename T>
__device__ __forceinline__ void mma_nt_ra(float (&acc)[NT][4], const AFrag<T> (&a)[KT],
                                          const T* b, int ld) {
  static_assert(NT % 2 == 0, "n-subtiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const AOp<T> fa = prepare(a[kk]);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      BFrag<T> fb[2];
      load_b_nk<T>(fb, [&](int c) { return b + (16 * np + c) * ld + 16 * kk; });
      mma_step(acc[2 * np], fa, fb[0]);
      mma_step(acc[2 * np + 1], fa, fb[1]);
    }
  }
}

// acc[16 x 8 NT] += A[16 x 16] B[16 x 8 NT], one k-step: A from registers,
// B stored [k][n] (n contiguous) at `b` with stride ld.
template <int NT, typename T>
__device__ __forceinline__ void mma_rs_step(float (&acc)[NT][4], const AFrag<T>& a, const T* b,
                                            int ld) {
  static_assert(NT % 2 == 0, "n-subtiles come in pairs");
  const AOp<T> fa = prepare(a);
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    BFrag<T> fb[2];
    load_b_kn<T>(fb, [&](int r) { return b + r * ld + 16 * np; });
    mma_step(acc[2 * np], fa, fb[0]);
    mma_step(acc[2 * np + 1], fa, fb[1]);
  }
}

// acc[16 x 8 NT] += bf(X)[16 x 16 KT] B[16 KT x 8 NT]: X an fp32 16 x 16 KT
// accumulator tile (P, dsim or their transposes), rounded to T a k-step at a
// time in registers as the A operand; B stored [k][n] at `b` (P w, dsim k,
// P^T g, dsim^T q).
template <int KT, int NT, typename T>
__device__ __forceinline__ void mma_pv(float (&acc)[NT][4], const float (&x)[2 * KT][4],
                                       const T* b, int ld) {
  if constexpr (std::is_same_v<T, float>) {  // each step's fp32 A as it is used
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      mma_rs_step<NT>(acc, afrag_from_acc<T>(x[2 * kk], x[2 * kk + 1]), b + 16 * kk * ld, ld);
  } else {  // the 16-bit A operands packed first, as the bf16 kernels always did
    AFrag<T> a[KT];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) a[kk] = afrag_from_acc<T>(x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) mma_rs_step<NT>(acc, a[kk], b + 16 * kk * ld, ld);
  }
}

// cp.async rows [row0, row0 + rows) of a [n, dh] matrix of T into shared
// memory with stride ld, 16 bytes a thread; rows outside [0, n) are
// zero-filled (the ragged edge and the conv's SAME padding).
template <int DH, typename T>
__device__ __forceinline__ void load_rows_async(T* dst, int ld, const T* src, int row0,
                                                int rows, int n) {
  constexpr int V = vec16<T>(), chunks = DH / V;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx % chunks) * V;
    const int gr = row0 + r;
    const bool ok = gr >= 0 && gr < n;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)gr * DH + c : src, ok);
  }
}

// Write a warp's 16 x 8 NT accumulator, each row scaled (rows g and g + 8 by
// s_lo and s_hi), rounded to T into its 16 staging rows `stage` (stride ld).
template <int NT, typename T>
__device__ __forceinline__ void stage_rows(T* stage, int ld, const float (&acc)[NT][4],
                                           float s_lo, float s_hi) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    store2(stage + g * ld + 8 * n + 2 * t, acc[n][0] * s_lo, acc[n][1] * s_lo);
    store2(stage + (g + 8) * ld + 8 * n + 2 * t, acc[n][2] * s_hi, acc[n][3] * s_hi);
  }
}

// Copy a warp's 16 staged rows to rows row0.. of a [n, dh] matrix of T, 16
// bytes a lane; rows past n are skipped. Synchronises the warp around it.
template <int DH, typename T>
__device__ __forceinline__ void store_staged(T* dst, const T* stage, int ld, int row0, int n) {
  constexpr int V = vec16<T>(), chunks = DH / V;
  const int lane = threadIdx.x % 32;
  __syncwarp();
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int r = idx / chunks, c = (idx % chunks) * V;
    if (row0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * DH + c) =
          *reinterpret_cast<const uint4*>(stage + r * ld + c);
  }
  __syncwarp();
}

// ---- Any head dim (the forward kernels 1, 3, 3b, 4 since they take every dh) ----
//
// A tile of W columns (W a multiple of 16) holds columns [col0, col0 + W)
// of a [n, dh] matrix; the columns at or past dh are zero in shared memory,
// so they add nothing to a product over dh, and are never stored. Rows
// whose 16-byte pieces are aligned (dh a multiple of vec16<T>(), col0 a
// multiple of it) move by cp.async and 16-byte stores, as load_rows_async
// and store_staged move them; any other dh moves element by element (a
// synchronous load: the caller's ring still orders it, since a stage is
// only written after the __syncthreads that frees it).

constexpr int kLoadAhead = 8;  // element loads a thread keeps in flight

template <typename T>
__device__ __forceinline__ bool rows_aligned(int dh) {
  return dh % vec16<T>() == 0;
}

// Rows [row0, row0 + rows) of columns [col0, col0 + W) of a [n, dh] matrix
// into shared memory with stride ld; rows outside [0, n) and columns at or
// past dh are zero.
template <int W, typename T>
__device__ __forceinline__ void load_cols(T* dst, int ld, const T* src, int dh, int col0,
                                          int row0, int rows, int n) {
  static_assert(W % 16 == 0, "tiles are whole 16-column k steps");
  if (rows_aligned<T>(dh)) {
    constexpr int V = vec16<T>(), chunks = W / V;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
      const int r = idx / chunks, c = (idx % chunks) * V;
      const int gr = row0 + r;
      const bool ok = gr >= 0 && gr < n && col0 + c < dh;
      cp_async16(dst + r * ld + c, ok ? src + (size_t)gr * dh + col0 + c : src, ok);
    }
  } else {  // kLoadAhead loads in flight a thread, then their stores
    const T zero = Elem<T>::from_float(0.f);
    for (int first = threadIdx.x; first < rows * W; first += kLoadAhead * kThreads) {
      T x[kLoadAhead];
#pragma unroll
      for (int u = 0; u < kLoadAhead; ++u) {
        const int idx = first + u * kThreads, r = idx / W, c = idx % W, gr = row0 + r;
        x[u] = idx < rows * W && gr >= 0 && gr < n && col0 + c < dh
                   ? src[(size_t)gr * dh + col0 + c] : zero;
      }
#pragma unroll
      for (int u = 0; u < kLoadAhead; ++u) {
        const int idx = first + u * kThreads;
        if (idx < rows * W) dst[(idx / W) * ld + idx % W] = x[u];
      }
    }
  }
}

// Copy a warp's 16 staged rows (W columns) to columns [col0, col0 + W) of
// rows row0.. of a [n, dh] matrix; rows past n and columns at or past dh
// are skipped. Synchronises the warp around it.
template <int W, typename T>
__device__ __forceinline__ void store_cols(T* dst, const T* stage, int ld, int row0, int n,
                                           int dh, int col0) {
  const int lane = threadIdx.x % 32;
  __syncwarp();
  if (rows_aligned<T>(dh)) {
    constexpr int V = vec16<T>(), chunks = W / V;
    for (int idx = lane; idx < 16 * chunks; idx += 32) {
      const int r = idx / chunks, c = (idx % chunks) * V;
      if (row0 + r < n && col0 + c < dh)
        *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * dh + col0 + c) =
            *reinterpret_cast<const uint4*>(stage + r * ld + c);
    }
  } else {
    for (int idx = lane; idx < 16 * W; idx += 32) {
      const int r = idx / W, c = idx % W;
      if (row0 + r < n && col0 + c < dh) dst[(size_t)(row0 + r) * dh + col0 + c] = stage[r * ld + c];
    }
  }
  __syncwarp();
}

// mma_nt over the first kt of KT k-steps (kt at run time, a tile's live
// columns of dh): S summed over a chunk of dh.
template <int KT, int NT, typename T>
__device__ __forceinline__ void mma_nt_kt(float (&acc)[NT][4], const T* a, const T* b, int ld,
                                          int kt) {
  static_assert(NT % 2 == 0, "n-subtiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (kk < kt) {
      const AOp<T> fa = prepare(load_a<T>([&](int r) { return a + r * ld + 16 * kk; }));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        BFrag<T> fb[2];
        load_b_nk<T>(fb, [&](int c) { return b + (16 * np + c) * ld + 16 * kk; });
        mma_step(acc[2 * np], fa, fb[0]);
        mma_step(acc[2 * np + 1], fa, fb[1]);
      }
    }
  }
}

// mma_pv over the first nt of NT / 2 n-tile pairs (nt at run time, a
// slice's live columns of dh); the pairs past nt keep their zeros.
template <int KT, int NT, typename T>
__device__ __forceinline__ void mma_pv_nt(float (&acc)[NT][4], const float (&x)[2 * KT][4],
                                          const T* b, int ld, int nt) {
  static_assert(NT % 2 == 0, "n-subtiles come in pairs");
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const AOp<T> fa = prepare(afrag_from_acc<T>(x[2 * kk], x[2 * kk + 1]));
    const T* bk = b + 16 * kk * ld;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (np < nt) {
        BFrag<T> fb[2];
        load_b_kn<T>(fb, [&](int r) { return bk + r * ld + 16 * np; });
        mma_step(acc[2 * np], fa, fb[0]);
        mma_step(acc[2 * np + 1], fa, fb[1]);
      }
    }
  }
}

// The exact softmax attention of one warp's 16 query rows against kt key
// tiles of 16 (at most kMaxKeyTiles: n <= 256), the body of the ViT
// attention (csrc/vit_attn.cu, kernel 8) and of the fused attention
// sub-layer (csrc/vit_fused.cu): S = q K^T held in registers (2 kt n8-tiles
// x 4 = 128 fp32 a thread at kt 16), columns past n at -inf; the exact row
// max and sum by two quad shuffles each; exp2 of the log2(e)-scaled scores
// on ex2.approx; the normalised probabilities rounded to bf16, as P V's A
// operand against V through ldmatrix.trans, so neither S nor P touches
// shared memory. q16: the warp's 16 query rows; sK, sV: the key and value
// rows (rows past n zeros); all bf16 in shared memory with row stride ld.
// c = scale log2(e). o: the fp32 16 x DH output tile in the accumulator
// layout.
template <int DH>
__device__ __forceinline__ void attend_rows(float (&o)[DH / 8][4], const bf16* q16,
                                            const bf16* sK, const bf16* sV, int ld, int n,
                                            int kt, float c) {
  const int lane = threadIdx.x % 32, t = lane % 4;
  // S = q K^T over the kt key tiles. The arrays are indexed with
  // constants only (unrolled to kMaxKeyTiles, predicated on kt), so they
  // stay in registers.
  float s[2 * kMaxKeyTiles][4];
#pragma unroll
  for (int j = 0; j < 2 * kMaxKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  const bf16* pa = q16 + (lane % 16) * ld + (lane / 16) * 8;
  const bf16* pb = sK + ((lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    unsigned fa[4];
    ldsm_x4(fa, pa + 16 * kk);
#pragma unroll
    for (int np = 0; np < kMaxKeyTiles; ++np) {
      if (np < kt) {
        unsigned fb[4];
        ldsm_x4(fb, pb + 16 * np * ld + 16 * kk);
        mma16816(s[2 * np], fa, fb[0], fb[1]);
        mma16816(s[2 * np + 1], fa, fb[2], fb[3]);
      }
    }
  }

  // the exact softmax of rows g (s[.][0..1]) and g + 8 (s[.][2..3]): columns
  // past n are -inf, the max and the sum two quad shuffles each
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2 * kMaxKeyTiles; ++j) {
    if (j < 2 * kt) {
      const int col = 8 * j + 2 * t;
      if (col >= n) s[j][0] = s[j][2] = -INFINITY;
      if (col + 1 >= n) s[j][1] = s[j][3] = -INFINITY;
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  const float b0 = m0 * c, b1 = m1 * c;
  float l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int j = 0; j < 2 * kMaxKeyTiles; ++j) {
    if (j < 2 * kt) {
      s[j][0] = fast_exp2(fmaf(s[j][0], c, -b0));
      s[j][1] = fast_exp2(fmaf(s[j][1], c, -b0));
      s[j][2] = fast_exp2(fmaf(s[j][2], c, -b1));
      s[j][3] = fast_exp2(fmaf(s[j][3], c, -b1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float r0 = 1.f / l0, r1 = 1.f / l1;

  // the normalised probabilities, rounded to bf16: P V's A operand (key
  // tile kk is score n8-tiles 2 kk and 2 kk + 1)
  AFrag<bf16> p[kMaxKeyTiles];
#pragma unroll
  for (int kk = 0; kk < kMaxKeyTiles; ++kk) {
    if (kk < kt) {
      p[kk].r[0] = pack_bf16(s[2 * kk][0] * r0, s[2 * kk][1] * r0);
      p[kk].r[1] = pack_bf16(s[2 * kk][2] * r1, s[2 * kk][3] * r1);
      p[kk].r[2] = pack_bf16(s[2 * kk + 1][0] * r0, s[2 * kk + 1][1] * r0);
      p[kk].r[3] = pack_bf16(s[2 * kk + 1][2] * r1, s[2 * kk + 1][3] * r1);
    }
  }
  zero(o);
#pragma unroll
  for (int kk = 0; kk < kMaxKeyTiles; ++kk)
    if (kk < kt) mma_rs_step<DH / 8>(o, p[kk], sV + 16 * kk * ld, ld);
}

// S = q K^T for the warp's 16 rows against key tile `tile` (16 keys: two
// n8 tiles), q's A fragments in registers; columns past n at -inf.
template <int DH>
__device__ __forceinline__ void score_tile(float (&s)[2][4], const AFrag<bf16> (&qa)[DH / 16],
                                           const bf16* sK, int ld, int tile, int n) {
  const int lane = threadIdx.x % 32, t = lane % 4;
  const bf16* pb =
      sK + (16 * tile + (lane % 8) + (lane / 16) * 8) * ld + ((lane / 8) % 2) * 8;
  zero(s);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    unsigned fb[4];
    ldsm_x4(fb, pb + 16 * kk);
    mma16816(s[0], qa[kk].r, fb[0], fb[1]);
    mma16816(s[1], qa[kk].r, fb[2], fb[3]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = 16 * tile + 8 * j + 2 * t;
    if (col >= n) s[j][0] = s[j][2] = -INFINITY;
    if (col + 1 >= n) s[j][1] = s[j][3] = -INFINITY;
  }
}

// attend_rows in two passes over the key tiles, for a caller that cannot
// give the attention 128 registers of scores: the first pass takes each
// row's max and sum online (the sum rescaled by exp2 of the change of max
// at each tile), the second recomputes each tile's scores and forms the
// normalised probabilities as attend_rows does, exp2(s c - m c) / l rounded
// to bf16, into P V. The same rounding points; the sum is taken in
// another order (one fp32 rounding of a rescale a tile). The tile loops
// stay nearly rolled, so a tile's 8 scores and its operands are all they
// hold.
template <int DH>
__device__ __forceinline__ void attend_rows_two_pass(float (&o)[DH / 8][4], const bf16* q16,
                                                     const bf16* sK, const bf16* sV, int ld,
                                                     int n, int kt, float c) {
  AFrag<bf16> qa[DH / 16];
  load_a_frags<DH / 16>(qa, q16, ld);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll 2
  for (int tile = 0; tile < kt; ++tile) {
    float s[2][4];
    score_tile<DH>(s, qa, sK, ld, tile, n);
    float x0 = fmaxf(m0, fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1])));
    float x1 = fmaxf(m1, fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3])));
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
      x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
    }
    // (tile 0 holds column 0 < n, so the max is finite from there on)
    l0 *= fast_exp2((m0 - x0) * c);
    l1 *= fast_exp2((m1 - x1) * c);
    m0 = x0;
    m1 = x1;
    const float b0 = m0 * c, b1 = m1 * c;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      l0 += fast_exp2(fmaf(s[j][0], c, -b0)) + fast_exp2(fmaf(s[j][1], c, -b0));
      l1 += fast_exp2(fmaf(s[j][2], c, -b1)) + fast_exp2(fmaf(s[j][3], c, -b1));
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float r0 = 1.f / l0, r1 = 1.f / l1, b0 = m0 * c, b1 = m1 * c;
  zero(o);
#pragma unroll 2
  for (int tile = 0; tile < kt; ++tile) {
    float s[2][4];
    score_tile<DH>(s, qa, sK, ld, tile, n);
    AFrag<bf16> p;
    p.r[0] = pack_bf16(fast_exp2(fmaf(s[0][0], c, -b0)) * r0, fast_exp2(fmaf(s[0][1], c, -b0)) * r0);
    p.r[1] = pack_bf16(fast_exp2(fmaf(s[0][2], c, -b1)) * r1, fast_exp2(fmaf(s[0][3], c, -b1)) * r1);
    p.r[2] = pack_bf16(fast_exp2(fmaf(s[1][0], c, -b0)) * r0, fast_exp2(fmaf(s[1][1], c, -b0)) * r0);
    p.r[3] = pack_bf16(fast_exp2(fmaf(s[1][2], c, -b1)) * r1, fast_exp2(fmaf(s[1][3], c, -b1)) * r1);
    mma_rs_step<DH / 8>(o, p, sV + 16 * tile * ld, ld);
  }
}

}  // namespace attn
