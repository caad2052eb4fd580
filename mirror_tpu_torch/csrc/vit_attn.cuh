// The attention of one warp's 16 query rows against one head's K and V in
// shared memory, the body that the fused ViT sub-layer kernels
// (csrc/vit_fused.cu, k5 and k8) share. Kernel 8 (csrc/vit_attn.cu) no
// longer runs it: since its redesign it keeps S and P in registers on
// mma.sync (attn_mma.cuh); this WMMA body waits for the fused kernels'
// redesign (ROADMAP R7).
//
// S = q K^T (WMMA 16x16x16 bf16, fp32 sums) over all npad key columns, an
// exact two-pass softmax of S * scale per row in registers (columns past n
// weigh 0), the probabilities normalised and rounded to bf16 over the first
// half of the same score rows, then O = P V with fp32 sums, left in the
// score rows for the caller to round and store.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace vit_attn {

using namespace nvcuda;

constexpr int kMaxCols = 256;   // the most key columns a score row holds
constexpr int kMaxDhTiles = 8;  // dh <= 128

// fp32 stride of a warp's score rows: a row also holds the fp32 output row
// (dh) and the staged bf16 q row, so it is at least dh + 4
__host__ __device__ inline int score_stride(int npad, int dh) {
  return (npad > dh ? npad : dh) + 4;
}

// q16: the warp's 16 query rows (bf16, row stride ldq), read into registers
// before wS is written, so they may lie inside wS. sK, sV: npad key rows
// (row stride ldk, rows past n zeros). wS: the warp's 16 score rows (fp32
// stride ls). rows: how many of the 16 are real (1..16); rows past it are
// not normalised, and their q rows are zeros. On return wS[r * ls + c],
// c < dh, holds the fp32 output of row r.
__device__ __forceinline__ void attend_warp(const bf16* q16, int ldq, const bf16* sK,
                                            const bf16* sV, int ldk, float* wS, int ls, int n,
                                            int npad, int dh, float scale, int rows) {
  const int lane = threadIdx.x % 32;
  const int dtiles = dh / 16;
  bf16* wP = reinterpret_cast<bf16*>(wS);  // the probabilities, bf16 stride 2 ls
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[kMaxDhTiles];
  // the fragment arrays are indexed with constants only (unrolled to
  // kMaxDhTiles, predicated on dtiles), so they stay in registers
#pragma unroll
  for (int t = 0; t < kMaxDhTiles; ++t)
    if (t < dtiles) wmma::load_matrix_sync(fq[t], q16 + 16 * t, ldq);
  __syncwarp();

  // S = q k^T over all npad columns (the pad rows of K are zeros)
  for (int j = 0; j < npad / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int t = 0; t < kMaxDhTiles; ++t) {
      if (t >= dtiles) break;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fk;
      wmma::load_matrix_sync(fk, sK + (size_t)(16 * j) * ldk + 16 * t, ldk);
      wmma::mma_sync(acc, fq[t], fk, acc);
    }
    wmma::store_matrix_sync(wS + 16 * j, acc, ls, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax(S * scale) row by row, lanes over columns; the whole row is read
  // into registers before its probabilities overwrite it
  // (rows past n are skipped: their q rows are zeros, so their scores, read
  // as bf16 probabilities, are zeros too)
  constexpr int kPer = kMaxCols / 32;
  for (int r = 0; r < 16 && r < rows; ++r) {
    float e[kPer];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      e[i] = c < n ? wS[(size_t)r * ls + c] * scale : -INFINITY;
      m = fmaxf(m, e[i]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      e[i] = c < n ? expf(e[i] - m) : 0.f;
      sum += e[i];
    }
    sum = warp_sum(sum);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < npad) wP[(size_t)r * 2 * ls + c] = __float2bfloat16(e[i] / sum);
    }
  }
  __syncwarp();

  // O = P v, fp32 accumulators
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[kMaxDhTiles];
#pragma unroll
  for (int t = 0; t < kMaxDhTiles; ++t) wmma::fill_fragment(acc_o[t], 0.0f);
  for (int kk = 0; kk < npad / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
    wmma::load_matrix_sync(fp, wP + 16 * kk, 2 * ls);
#pragma unroll
    for (int t = 0; t < kMaxDhTiles; ++t) {
      if (t >= dtiles) break;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fv;
      wmma::load_matrix_sync(fv, sV + (size_t)(16 * kk) * ldk + 16 * t, ldk);
      wmma::mma_sync(acc_o[t], fp, fv, acc_o[t]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kMaxDhTiles; ++t)
    if (t < dtiles) wmma::store_matrix_sync(wS + 16 * t, acc_o[t], ls, wmma::mem_row_major);
  __syncwarp();
}

}  // namespace vit_attn
