// A block-tile GEMM mainloop on the tensor cores, for products that differ
// only in how they load their operands and what they do with the result.
//
// C [M, N] = A [M, K] B [K, N]: a block of 8 warps (2 x 4, a warp 64 x 32)
// owns a 128 x 128 tile of C and walks its K range in steps of 32 through a
// 4-stage cp.async ring; WMMA 16x16x16 bf16 with fp32 accumulators. Each
// finished 16 x 16 fragment goes through the warp's fp32 staging tile, and
// the epilogue gets 8 consecutive columns of one row at a time.
//
// The caller's Ops type says where the operands are and what the epilogue
// does:
//   static constexpr bool kAKContig;  // A's tile stored [m][k], else [k][m]
//   static constexpr bool kBNContig;  // B's tile stored [k][n], else [n][k]
//   static constexpr bool kPrologue;  // transform each A chunk once it lands
//   const bf16* base() const;             // a mapped address (zero-filled chunks)
//   const bf16* a_chunk(int m, int k) const;  // 8 elements of A from (m, k)
//   const bf16* b_chunk(int k, int n) const;  // 8 elements of B from (k, n)
//   void prologue(float* v, int m, int k) const;  // the 8 values of A's chunk
//   void store(int m, int n, const float* v) const;  // C[m, n .. n + 7]
// A chunk runs along the operand's contiguous axis (k for a [m][k] tile, m
// for a [k][m] one; n or k for B). M, N and the chunk starts of K are
// multiples of 8 wherever a chunk is read.
//
// Used by csrc/ln_qkv.cu. csrc/vit_gemm.cu and csrc/pinv.cu still carry
// their own copies of this loop (ROADMAP: the GEMM redesign moves them here).
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace wmma_gemm {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int WM = 64, WN = 32;  // a warp's share of the tile: 2 x 4 warps
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int kStages = 4;
constexpr int kChunks = 2;   // 16-byte chunks of each operand a thread copies per K step
constexpr int LDK = BK + 8;   // stride of a tile stored K-contiguous ([128][32])
constexpr int LDMN = BM + 8;  // stride of a tile stored M- or N-contiguous ([32][128])
constexpr int kTileElems = BM * LDK;  // the larger of the two layouts
constexpr int LDE = 16 + 4;

struct __align__(128) Smem {
  bf16 a[kStages][kTileElems];
  bf16 b[kStages][kTileElems];
  float e[kWarps][16 * LDE];
};

__device__ __forceinline__ uint4 pack_bf16x8(const float* v) {
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
  for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
  return out;
}

__device__ __forceinline__ void unpack_bf16x8(uint4 in, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&in);
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(h[t]);
    v[2 * t] = f.x;
    v[2 * t + 1] = f.y;
  }
}

// (outer, inner) of chunk idx of a tile stored [128][32] (contiguous along
// K) or [32][128]
__device__ __forceinline__ void chunk_pos(int idx, bool kcontig, int& outer, int& inner) {
  outer = kcontig ? idx / (BK / 8) : idx / (BM / 8);
  inner = kcontig ? (idx % (BK / 8)) * 8 : (idx % (BM / 8)) * 8;
}

// The block's tile of C at (m0, n0), summed over K in [k_begin, k_end).
template <class Ops>
__device__ __forceinline__ void gemm_tile(const Ops& ops, Smem& sm, int M, int N, int m0, int n0,
                                          int k_begin, int k_end) {
  constexpr bool AK = Ops::kAKContig, BNC = Ops::kBNContig;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;

  // start copying K step kt into stage st (zero-filled outside the operands)
  auto copy_stage = [&](int st, int kt) {
    const int k0 = k_begin + kt * BK;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int idx = tid + i * kThreads;
      int o, in;
      chunk_pos(idx, AK, o, in);
      const int am = AK ? m0 + o : m0 + in, ak = AK ? k0 + in : k0 + o;
      const bool a_ok = am < M && ak < k_end;
      cp_async16(sm.a[st] + (AK ? o * LDK + in : o * LDMN + in),
                 a_ok ? ops.a_chunk(am, ak) : ops.base(), a_ok);
      chunk_pos(idx, !BNC, o, in);
      const int bk = BNC ? k0 + o : k0 + in, bn = BNC ? n0 + in : n0 + o;
      const bool b_ok = bk < k_end && bn < N;
      cp_async16(sm.b[st] + (BNC ? o * LDMN + in : o * LDK + in),
                 b_ok ? ops.b_chunk(bk, bn) : ops.base(), b_ok);
    }
  };

  // the prologue on the A chunks this thread copied into stage st
  auto prologue = [&](int st, int kt) {
    const int k0 = k_begin + kt * BK;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      int o, in;
      chunk_pos(tid + i * kThreads, AK, o, in);
      const int am = AK ? m0 + o : m0 + in, ak = AK ? k0 + in : k0 + o;
      if (am >= M || ak >= k_end) continue;
      uint4* p = reinterpret_cast<uint4*>(sm.a[st] + (AK ? o * LDK + in : o * LDMN + in));
      float v[8];
      unpack_bf16x8(*p, v);
      ops.prologue(v, am, ak);
      *p = pack_bf16x8(v);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  using ALayout = typename std::conditional<AK, wmma::row_major, wmma::col_major>::type;
  using BLayout = typename std::conditional<BNC, wmma::row_major, wmma::col_major>::type;
  const int ksteps = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ksteps) copy_stage(st, st);
    cp_async_commit();  // one group per step, empty or not, so the count holds
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    const int st = ks % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of step ks have landed
    if constexpr (Ops::kPrologue) prologue(st, ks);
    __syncthreads();  // everyone's have; and step ks - 1's stage is free again
    if (ks + kStages - 1 < ksteps) copy_stage((ks + kStages - 1) % kStages, ks + kStages - 1);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int m = wm + 16 * i;
        wmma::load_matrix_sync(fa[i], sm.a[st] + (AK ? m * LDK + kk : kk * LDMN + m),
                               AK ? LDK : LDMN);
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        const int nn = wn + 16 * j;
        wmma::load_matrix_sync(fb[j], sm.b[st] + (BNC ? kk * LDMN + nn : nn * LDK + kk),
                               BNC ? LDMN : LDK);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: a lane owns 8 consecutive columns of one row of a fragment
  float* stage_e = sm.e[warp];
  const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage_e, acc[i][j], LDE, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm + 16 * i + er, gc = n0 + wn + 16 * j + ec;
      if (gr < M && gc < N) ops.store(gr, gc, stage_e + er * LDE + ec);
      __syncwarp();
    }
  }
}

}  // namespace wmma_gemm
