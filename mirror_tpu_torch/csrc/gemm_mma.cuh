// A batched GEMM mainloop on mma.sync, fed by a cp.async ring: P = op(A)
// op(B) with fp32 accumulators left in registers for the caller's epilogue.
// The operands are of one type T: bf16 (the sentences below), float16 (the
// same design with .f16 operands) or float32 (3xTF32 on m16n8k8, through
// attn_mma.cuh's fragment helpers, with 4- and 8-byte shared-memory loads
// where the 16-bit types use ldmatrix; a k step of 32, so that its 3
// stages take 123 KB, where 64 would take 221 KB).
//
// Operand layouts: op(A) is [M, K], stored [M][K] (k contiguous) or, with
// TA, [K][M] (read transposed); op(B) is [K, N], stored [K][N] or, with TB,
// [N][K]. No transpose is materialised: each shared-memory tile keeps its
// global layout, so the 16-byte loads run along the contiguous axis, and
// the fragment loads pick ldmatrix or ldmatrix.trans to match:
// - A stored [m][k]: ldmatrix (the fragment's rows are the tile's rows);
// - A stored [k][m]: ldmatrix.trans (an 8 x 8 block of k rows, transposed,
//   is the fragment's m rows);
// - B stored [k][n]: ldmatrix.trans; B stored [n][k]: ldmatrix.
// attn_mma.cuh's mma_nt and mma_rs_step load B the same two ways.
//
// The ring: STAGES shared-memory stages of one BM x BK tile of A and one
// BK x BN tile of B. Before the loop STAGES - 1 k tiles are requested; at
// each k step a thread waits until its copies of this step's tile have
// landed (cp.async.wait_group STAGES - 2), one barrier makes every thread's
// copies visible and frees the stage read at the step before, and the copy
// of k tile kt + STAGES - 1 into that stage is issued before this step's
// products, so STAGES - 1 tiles are in flight while the tensor cores run.
// One barrier a k step.
//
// Bank conflicts: every tile row is padded by 8 elements (16 bytes). A row
// of 32 + 8 bf16 is 20 words, one of 64 + 8 is 36 and one of 128 + 8 is
// 68; the 8 rows that one ldmatrix 8 x 8 matrix reads then start 20 or 4
// banks apart (mod 32), in 8 disjoint groups of 4 of the 32 banks. No
// swizzle.
//
// VEC: every row stride (M, N, K) is a multiple of 8, so each 16-byte chunk
// of a tile row is wholly inside or wholly outside the matrix and is copied
// by cp.async.cg (L1 bypassed), zero-filled outside. Otherwise the tile is
// staged element by element with plain predicated loads (any M, N, K).
#pragma once

#include "attn_mma.cuh"

namespace gemm_mma {

constexpr int PAD = 8;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The block tile: 128 x 128 on 2 x 4 warps of 64 x 32, k steps of 64 (32
// in float32) through 3 stages (110 KB of shared memory, one block an SM;
// 123 KB in float32). 128 divides m 384 with no ragged edge. Fixed until a
// second kernel needs another shape.
template <typename T>
struct Tile {
  static constexpr int BM = 128, BN = 128, BK = sizeof(T) == 4 ? 32 : 64, STAGES = 3;
  static constexpr int WARPS_M = 2, WARPS_N = 4;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;  // a warp's tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;  // its 16 x 8 accumulator tiles
  // elements of one stage's tile of A and of B, in either stored layout
  static constexpr int kTileA = cmax(BM * (BK + PAD), BK * (BM + PAD));
  static constexpr int kTileB = cmax(BN * (BK + PAD), BK * (BN + PAD));
  static constexpr size_t kSmemBytes = (size_t)STAGES * (kTileA + kTileB) * sizeof(T);
  static_assert(WTM % 16 == 0 && WTN % 16 == 0 && BK % 16 == 0, "whole mma tiles");
};

// Copy rows [r0, r0 + ROWS) x columns [c0, c0 + COLS) of a row-major
// `rows` x `cols` matrix with row stride ld into dst (row stride COLS +
// PAD), zeros outside the matrix.
template <int ROWS, int COLS, int THREADS, bool VEC, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int r0, int c0,
                                          int rows, int cols, int ld) {
  constexpr int LD = COLS + PAD;
  if constexpr (VEC) {
    constexpr int V = vec16<T>(), CH = COLS / V;
    static_assert((ROWS * CH) % THREADS == 0, "whole chunks a thread");
#pragma unroll
    for (int i = 0; i < ROWS * CH / THREADS; ++i) {
      const int idx = threadIdx.x + i * THREADS;
      const int r = idx / CH, c = (idx % CH) * V;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rows && gc < cols;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)gr * ld + gc : src, ok);
    }
  } else {  // attn::kLoadAhead loads in flight a thread, then their stores
    constexpr int U = attn::kLoadAhead, PER = ROWS * COLS / THREADS;
    static_assert((ROWS * COLS) % THREADS == 0 && PER % U == 0, "whole elements a thread");
    for (int i0 = 0; i0 < PER; i0 += U) {
      T x[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = threadIdx.x + (i0 + u) * THREADS;
        const int gr = r0 + idx / COLS, gc = c0 + idx % COLS;
        x[u] = gr < rows && gc < cols ? src[(size_t)gr * ld + gc] : Elem<T>::from_float(0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int idx = threadIdx.x + (i0 + u) * THREADS;
        dst[(idx / COLS) * LD + idx % COLS] = x[u];
      }
    }
  }
}

// acc += op(A)[m0.., :] op(B)[:, n0..] over all of K, for this thread's
// fragments of the block tile (m0, n0). A and B point at one batch entry;
// smem holds Tile<T>::kSmemBytes.
template <bool TA, bool TB, bool VEC, typename T>
__device__ __forceinline__ void mainloop(float (&acc)[Tile<T>::MT][Tile<T>::NT][4], T* smem,
                                         const T* __restrict__ A, const T* __restrict__ B,
                                         int M, int N, int K, int m0, int n0) {
  using Tl = Tile<T>;
  T* sa = smem;
  T* sb = smem + Tl::STAGES * Tl::kTileA;
  auto request = [&](int stage, int k0) {
    if constexpr (TA)
      load_tile<Tl::BK, Tl::BM, Tl::kThreads, VEC>(sa + stage * Tl::kTileA, A, k0, m0, K, M, M);
    else
      load_tile<Tl::BM, Tl::BK, Tl::kThreads, VEC>(sa + stage * Tl::kTileA, A, m0, k0, M, K, K);
    if constexpr (TB)
      load_tile<Tl::BN, Tl::BK, Tl::kThreads, VEC>(sb + stage * Tl::kTileB, B, n0, k0, N, K, K);
    else
      load_tile<Tl::BK, Tl::BN, Tl::kThreads, VEC>(sb + stage * Tl::kTileB, B, k0, n0, K, N, N);
  };
  constexpr int LDA = TA ? Tl::BM + PAD : Tl::BK + PAD;
  constexpr int LDB = TB ? Tl::BK + PAD : Tl::BN + PAD;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / Tl::WARPS_N) * Tl::WTM, wn = (warp % Tl::WARPS_N) * Tl::WTN;

  const int KT = (K + Tl::BK - 1) / Tl::BK;
#pragma unroll
  for (int s = 0; s < Tl::STAGES - 1; ++s) {
    if (s < KT) request(s, s * Tl::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<Tl::STAGES - 2>();
    __syncthreads();  // k tile kt has landed everywhere; the stage of kt - 1 is free
    const int next = kt + Tl::STAGES - 1;
    if (next < KT) request(next % Tl::STAGES, next * Tl::BK);
    cp_async_commit();  // an empty group past the end keeps the count in step
    const T* a = sa + (kt % Tl::STAGES) * Tl::kTileA;
    const T* b = sb + (kt % Tl::STAGES) * Tl::kTileB;
#pragma unroll
    for (int kk = 0; kk < Tl::BK; kk += 16) {
      attn::AOp<T> fa[Tl::MT];
#pragma unroll
      for (int i = 0; i < Tl::MT; ++i) {
        // op(A)'s 16 rows wm + 16 i.. at k kk..: stored [m][k], or [k][m] read transposed
        if constexpr (TA)
          fa[i] = attn::prepare(attn::load_a_t<T>(
              [&](int r) { return a + (kk + r) * LDA + wm + 16 * i; }));
        else
          fa[i] = attn::prepare(attn::load_a<T>(
              [&](int r) { return a + (wm + 16 * i + r) * LDA + kk; }));
      }
#pragma unroll
      for (int np = 0; np < Tl::NT / 2; ++np) {
        attn::BFrag<T> fb[2];
        if constexpr (TB)
          attn::load_b_nk<T>(fb, [&](int c) { return b + (wn + 16 * np + c) * LDB + kk; });
        else
          attn::load_b_kn<T>(fb, [&](int r) { return b + (kk + r) * LDB + wn + 16 * np; });
#pragma unroll
        for (int i = 0; i < Tl::MT; ++i) {
          attn::mma_step(acc[i][2 * np], fa[i], fb[0]);
          attn::mma_step(acc[i][2 * np + 1], fa[i], fb[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Call f(k, row, col, p[col], p[col + 1]) for each pair of adjacent
// columns that this thread's accumulators hold: k numbers the pairs 0 ..
// kPairs - 1, row and col are in the whole matrix (the block tile at m0,
// n0); col is even.
template <typename T>
constexpr int kPairs = 2 * Tile<T>::MT * Tile<T>::NT;

template <typename T, class F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[Tile<T>::MT][Tile<T>::NT][4],
                                              int m0, int n0, F&& f) {
  using Tl = Tile<T>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + (warp / Tl::WARPS_N) * Tl::WTM + lane / 4;
  const int col0 = n0 + (warp % Tl::WARPS_N) * Tl::WTN + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT; ++j) {
      const int k = 2 * (i * Tl::NT + j);
      f(k, row0 + 16 * i, col0 + 8 * j, acc[i][j][0], acc[i][j][1]);
      f(k + 1, row0 + 16 * i + 8, col0 + 8 * j, acc[i][j][2], acc[i][j][3]);
    }
}

}  // namespace gemm_mma
