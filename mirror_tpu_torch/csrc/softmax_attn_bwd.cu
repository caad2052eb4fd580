// Backward of the row softmax attention of the Nystrom attention (K3c), with
// the fused 33-tap residual conv's backward (WITH_CONV, K4b).
//
// Replaces: mirror_tpu/ops/nystrom_pallas.py::fused_softmax_attn's backward
// pallas_call (_bwd_call, reached through softmax_matmul_landmark_kv) and
// ::fused_softmax_attn_conv's backward pallas_call (_bwd_conv_call). Both
// TPU kernels share _attn_bwd_math, and so do the two first kernels here.
//
// What it computes, per (batch, head), with attn = softmax over the c
// columns plus `pad` virtual columns of logit 0 (their w rows are 0):
//   dw   = bf16(attn)^T g                       (fp32 sum, rounded)
//   dsim = bf16(attn * (g w^T) - attn * D),  D = rowsum(attn * (g w^T))
//   dq   = dsim k,   dk = dsim^T q              (fp32 sums, rounded)
// and WITH_CONV, for out += sum_t kern[h, t] v[i + t - K/2]:
//   dv[j]      = sum_t kern[h, t] g[j - t + K/2]    (the flipped conv of g)
//   dkern[h,t] = sum_b sum_i sum_d g[i, d] v[i + t - K/2, d]   (fp32)
//
// What bounds it on the H100: tensor-core FLOPs and exponentials, as in the
// forward. At the slice's shape each call does 4 products of r x c x dh in
// each of two passes (the softmax and g w^T are recomputed, never stored):
// about 10 x 2 x 128 x 2117 x 384 x 96 = 200 GFLOP a call.
//
// Design, FlashAttention-2 style: the TPU kept the whole [r, c] fp32 score
// block of a (batch, head) in VMEM (2117 x 384 x 4 = 3.25 MB); a Hopper block
// has 227 KB, so the scores are recomputed tile by tile in two kernels.
// (1) rows: a block owns 64 rows of q and g. A first sweep over the column
// tiles takes the row statistics online (running max, clamped at 0 when
// pad > 0, and the denominator started at `pad`, the closed form of the pad
// columns; and the running sum of e * dattn, so D comes from fp32 values,
// never from the rounded output). A second sweep forms dsim per tile and
// accumulates dq = dsim k in registers (WMMA, fp32). The statistics go to
// device memory for (2) cols: a block owns 64 columns of k and w and walks
// the row tiles, forming P and dsim for its columns from the statistics and
// accumulating dw = P^T g and dk = dsim^T q in registers. Every sum is
// taken inside one block in a fixed order, so the result is deterministic.
// WITH_CONV adds the standalone conv's backward (csrc/conv1d.cu, through
// conv1d.cuh): dv from a window of g, and dkern from fixed-order partials
// per (batch, row tile) and tap (no float atomics).
#include <mma.h>

#include "common.cuh"
#include "conv1d.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64;  // rows per tile
constexpr int BN = 64;  // columns per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int LDS = BN + 4;  // fp32 stride of S and dP tiles
constexpr int LDP = BN + 8;  // bf16 stride of P and dsim tiles

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

struct Layout {
  int ldb, ldo;  // bf16 stride of q/k/w/g rows, fp32 stride of staged outputs
  size_t a0, a1, b0, b1, s, dp, p, ds, stat, stage, total;
};

// a0/a1: the tiles a block owns (q, g rows; or k, w columns); b0/b1: the
// tiles it walks (k, w; or q, g). ds is used by the cols kernel only.
__host__ __device__ inline Layout make_layout(int dh) {
  Layout L;
  L.ldb = dh + 8;
  L.ldo = dh + 4;
  size_t off = 0;
  const size_t tile = smem_align((size_t)BM * L.ldb * sizeof(bf16));
  L.a0 = off; off += tile;
  L.a1 = off; off += tile;
  L.b0 = off; off += tile;
  L.b1 = off; off += tile;
  L.s = off; off += smem_align((size_t)BM * LDS * sizeof(float));
  L.dp = off; off += smem_align((size_t)BM * LDS * sizeof(float));
  L.p = off; off += smem_align((size_t)BM * LDP * sizeof(bf16));
  L.ds = off; off += smem_align((size_t)BM * LDP * sizeof(bf16));
  L.stat = off; off += smem_align((size_t)4 * BM * sizeof(float));
  L.stage = off; off += smem_align((size_t)BM * L.ldo * sizeof(float));
  L.total = off;
  return L;
}

// Copy rows [row0, row0 + rows) of a [n, dh] bf16 matrix into shared memory
// with stride ldb, 16 bytes a thread; rows outside [0, n) become zeros.
__device__ inline void load_rows(bf16* dst, const bf16* src, int row0, int rows, int n,
                                 int dh, int ldb) {
  const int chunks = dh / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    const int gr = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < n) val = *reinterpret_cast<const uint4*>(src + (size_t)gr * dh + c);
    *reinterpret_cast<uint4*>(dst + r * ldb + c) = val;
  }
}

// C[16 x 16] = A[16 rows, dh] . B[16 rows, dh]^T (both row-major bf16 in
// shared memory with stride ldb), stored fp32 to `out` with stride LDS.
template <int DT>
__device__ inline void tile_nt(const bf16* a, const bf16* b, int ldb, float* out) {
  AccFrag acc;
  wmma::fill_fragment(acc, 0.0f);
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
    wmma::load_matrix_sync(fa, a + 16 * t, ldb);
    wmma::load_matrix_sync(fb, b + 16 * t, ldb);
    wmma::mma_sync(acc, fa, fb, acc);
  }
  wmma::store_matrix_sync(out, acc, LDS, wmma::mem_row_major);
}

// Write a [rows, dh] fp32 accumulator (fragments of 16 rows) as bf16 rows
// row0.. of `dst`, through the warp's 16-row slice of the staging buffer.
template <int DT>
__device__ inline void store_rows(AccFrag (&acc)[DT], float* stage, int ldo, bf16* dst,
                                  int row0, int n, int dh, int lane) {
#pragma unroll
  for (int t = 0; t < DT; ++t)
    wmma::store_matrix_sync(stage + 16 * t, acc[t], ldo, wmma::mem_row_major);
  __syncwarp();
  for (int idx = lane; idx < 16 * dh; idx += 32) {
    const int r = idx / dh, d = idx % dh;
    if (row0 + r < n) dst[(size_t)(row0 + r) * dh + d] = __float2bfloat16(stage[r * ldo + d]);
  }
}

// (1) rows: statistics, then dq. One block per 64 rows of one (batch, head).
template <int DT>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ w, const bf16* __restrict__ g,
                         bf16* __restrict__ dq, float* __restrict__ stats, int R, int C,
                         int pad) {
  constexpr int dh = 16 * DT;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(dh);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.a0);
  bf16* sG = reinterpret_cast<bf16*>(smem + L.a1);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.b0);
  bf16* sW = reinterpret_cast<bf16*>(smem + L.b1);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sDP = reinterpret_cast<float*>(smem + L.dp);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L.p);
  float* sMax = reinterpret_cast<float*>(smem + L.stat);
  float* sSum = sMax + BM;
  float* sDot = sSum + BM;
  float* sD = sDot + BM;
  float* stage = reinterpret_cast<float*>(smem + L.stage);

  const int bh = blockIdx.y, r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ldb = L.ldb, wrow = warp * 16;
  load_rows(sQ, q + (size_t)bh * R * dh, r0, BM, R, dh, ldb);
  load_rows(sG, g + (size_t)bh * R * dh, r0, BM, R, dh, ldb);
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    // the pad columns, seen first: logit 0 (max 0, sum pad), dattn 0
    sMax[i] = pad > 0 ? 0.f : -INFINITY;
    sSum[i] = (float)pad;
    sDot[i] = 0.f;
  }
  const bf16* kb = k + (size_t)bh * C * dh;
  const bf16* wb = w + (size_t)bh * C * dh;

  // sweep 1: row max, denominator and sum of e * dattn, online
  for (int c0 = 0; c0 < C; c0 += BN) {
    load_rows(sK, kb, c0, BN, C, dh, ldb);
    load_rows(sW, wb, c0, BN, C, dh, ldb);
    __syncthreads();
    for (int j = 0; j < BN / 16; ++j) {
      tile_nt<DT>(sQ + wrow * ldb, sK + 16 * j * ldb, ldb, sS + wrow * LDS + 16 * j);
      tile_nt<DT>(sG + wrow * ldb, sW + 16 * j * ldb, ldb, sDP + wrow * LDS + 16 * j);
    }
    __syncwarp();
    const bool v0 = c0 + lane < C, v1 = c0 + lane + 32 < C;
    for (int rr = 0; rr < 16; ++rr) {
      const int row = wrow + rr;
      const float s0 = v0 ? sS[row * LDS + lane] : -INFINITY;
      const float s1 = v1 ? sS[row * LDS + lane + 32] : -INFINITY;
      const float m_old = sMax[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float e0 = v0 ? expf(s0 - m_new) : 0.f;
      const float e1 = v1 ? expf(s1 - m_new) : 0.f;
      const float esum = warp_sum(e0 + e1);
      const float edot = warp_sum(e0 * sDP[row * LDS + lane] + e1 * sDP[row * LDS + lane + 32]);
      const float alpha = expf(m_old - m_new);  // 0 when m_old is -inf
      __syncwarp();
      if (lane == 0) {
        sMax[row] = m_new;
        sSum[row] = sSum[row] * alpha + esum;
        sDot[row] = sDot[row] * alpha + edot;
      }
      __syncwarp();
    }
    __syncthreads();  // every warp is done with sK / sW before the next tile
  }
  float* st = stats + (size_t)bh * R * 3;
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    sD[i] = sDot[i] / sSum[i];
    if (r0 + i < R) {
      st[(size_t)(r0 + i) * 3 + 0] = sMax[i];
      st[(size_t)(r0 + i) * 3 + 1] = sSum[i];
      st[(size_t)(r0 + i) * 3 + 2] = sD[i];
    }
  }
  __syncthreads();

  // sweep 2: dsim per tile, dq += dsim k
  AccFrag acc[DT];
#pragma unroll
  for (int t = 0; t < DT; ++t) wmma::fill_fragment(acc[t], 0.0f);
  for (int c0 = 0; c0 < C; c0 += BN) {
    load_rows(sK, kb, c0, BN, C, dh, ldb);
    load_rows(sW, wb, c0, BN, C, dh, ldb);
    __syncthreads();
    for (int j = 0; j < BN / 16; ++j) {
      tile_nt<DT>(sQ + wrow * ldb, sK + 16 * j * ldb, ldb, sS + wrow * LDS + 16 * j);
      tile_nt<DT>(sG + wrow * ldb, sW + 16 * j * ldb, ldb, sDP + wrow * LDS + 16 * j);
    }
    __syncwarp();
    for (int idx = lane; idx < 16 * BN; idx += 32) {
      const int row = wrow + idx / BN, col = idx % BN;
      float ds = 0.f;
      if (c0 + col < C) {
        const float p = expf(sS[row * LDS + col] - sMax[row]) / sSum[row];
        ds = p * sDP[row * LDS + col] - p * sD[row];
      }
      sDS[row * LDP + col] = __float2bfloat16(ds);
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sDS + wrow * LDP + 16 * kk, LDP);
        wmma::load_matrix_sync(fb, sK + 16 * kk * ldb + 16 * t, ldb);
        wmma::mma_sync(acc[t], fa, fb, acc[t]);
      }
    }
    __syncthreads();
  }
  store_rows<DT>(acc, stage + wrow * L.ldo, L.ldo, dq + (size_t)bh * R * dh, r0 + wrow, R,
                 dh, lane);
}

// (2) cols: dk and dw. One block per 64 columns of one (batch, head); warp w
// owns columns 16w..16w+15 of the tile, so P and dsim never cross warps.
template <int DT>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ w, const bf16* __restrict__ g,
                         const float* __restrict__ stats, bf16* __restrict__ dk,
                         bf16* __restrict__ dw, int R, int C) {
  constexpr int dh = 16 * DT;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(dh);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.a0);
  bf16* sW = reinterpret_cast<bf16*>(smem + L.a1);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.b0);
  bf16* sG = reinterpret_cast<bf16*>(smem + L.b1);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sDP = reinterpret_cast<float*>(smem + L.dp);
  bf16* sP = reinterpret_cast<bf16*>(smem + L.p);
  bf16* sDS = reinterpret_cast<bf16*>(smem + L.ds);
  float* sMax = reinterpret_cast<float*>(smem + L.stat);
  float* sSum = sMax + BM;
  float* sD = sSum + BM;
  float* stage = reinterpret_cast<float*>(smem + L.stage);

  const int bh = blockIdx.y, c0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ldb = L.ldb, wcol = warp * 16;
  load_rows(sK, k + (size_t)bh * C * dh, c0, BN, C, dh, ldb);
  load_rows(sW, w + (size_t)bh * C * dh, c0, BN, C, dh, ldb);
  const bf16* qb = q + (size_t)bh * R * dh;
  const bf16* gb = g + (size_t)bh * R * dh;
  const float* st = stats + (size_t)bh * R * 3;

  AccFrag acc_dk[DT], acc_dw[DT];
#pragma unroll
  for (int t = 0; t < DT; ++t) {
    wmma::fill_fragment(acc_dk[t], 0.0f);
    wmma::fill_fragment(acc_dw[t], 0.0f);
  }
  for (int r0 = 0; r0 < R; r0 += BM) {
    load_rows(sQ, qb, r0, BM, R, dh, ldb);
    load_rows(sG, gb, r0, BM, R, dh, ldb);
    for (int i = threadIdx.x; i < BM; i += kThreads) {
      const bool ok = r0 + i < R;
      sMax[i] = ok ? st[(size_t)(r0 + i) * 3 + 0] : 0.f;
      sSum[i] = ok ? st[(size_t)(r0 + i) * 3 + 1] : 1.f;
      sD[i] = ok ? st[(size_t)(r0 + i) * 3 + 2] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < BM / 16; ++i) {
      tile_nt<DT>(sQ + 16 * i * ldb, sK + wcol * ldb, ldb, sS + 16 * i * LDS + wcol);
      tile_nt<DT>(sG + 16 * i * ldb, sW + wcol * ldb, ldb, sDP + 16 * i * LDS + wcol);
    }
    __syncwarp();
    for (int idx = lane; idx < BM * 16; idx += 32) {
      const int row = idx / 16, col = wcol + idx % 16;
      float p = 0.f, ds = 0.f;
      if (r0 + row < R && c0 + col < C) {
        p = expf(sS[row * LDS + col] - sMax[row]) / sSum[row];
        ds = p * sDP[row * LDS + col] - p * sD[row];
      }
      sP[row * LDP + col] = __float2bfloat16(p);
      sDS[row * LDP + col] = __float2bfloat16(ds);
    }
    __syncwarp();
    // dw[cols] += P^T g ; dk[cols] += dsim^T q  (A read column-major: A^T)
#pragma unroll
    for (int t = 0; t < DT; ++t) {
      for (int kk = 0; kk < BM / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fp, fds;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fg, fq;
        wmma::load_matrix_sync(fp, sP + 16 * kk * LDP + wcol, LDP);
        wmma::load_matrix_sync(fg, sG + 16 * kk * ldb + 16 * t, ldb);
        wmma::mma_sync(acc_dw[t], fp, fg, acc_dw[t]);
        wmma::load_matrix_sync(fds, sDS + 16 * kk * LDP + wcol, LDP);
        wmma::load_matrix_sync(fq, sQ + 16 * kk * ldb + 16 * t, ldb);
        wmma::mma_sync(acc_dk[t], fds, fq, acc_dk[t]);
      }
    }
    __syncthreads();
  }
  float* wstage = stage + wcol * L.ldo;
  store_rows<DT>(acc_dw, wstage, L.ldo, dw + (size_t)bh * C * dh, c0 + wcol, C, dh, lane);
  __syncwarp();
  store_rows<DT>(acc_dk, wstage, L.ldo, dk + (size_t)bh * C * dh, c0 + wcol, C, dh, lane);
}

template <int DT>
cudaError_t launch_attn(const bf16* q, const bf16* k, const bf16* w, const bf16* g, bf16* dq,
                        bf16* dk, bf16* dw, float* stats, int bh, int R, int C, int pad,
                        cudaStream_t stream) {
  const size_t smem = make_layout(16 * DT).total;
  cudaError_t err = allow_smem(attn_bwd_rows_kernel<DT>, smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_cols_kernel<DT>, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_rows_kernel<DT><<<dim3((R + BM - 1) / BM, bh), kThreads, smem, stream>>>(
      q, k, w, g, dq, stats, R, C, pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_cols_kernel<DT><<<dim3((C + BN - 1) / BN, bh), kThreads, smem, stream>>>(
      q, k, w, g, stats, dk, dw, R, C);
  return cudaGetLastError();
}

}  // namespace

// ksize == 0: no conv (v, kern, dv, dkern and partial unused, may be null).
// stats: fp32 [bh, r, 3] scratch; partial: fp32 scratch of
// mirror_conv1d_bwd_partial_elems(bh, r, ksize) elements.
MIRROR_EXPORT int mirror_softmax_attn_bwd(const void* q, const void* k, const void* w,
                                          const void* v, const void* kern, const void* g,
                                          void* dq, void* dk, void* dw, void* dv,
                                          void* dkern, void* stats, void* partial, int bh,
                                          int heads, int r, int c, int dh, int pad,
                                          int ksize, cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* gp = static_cast<const bf16*>(g);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dwp = static_cast<bf16*>(dw);
  float* sp = static_cast<float*>(stats);
  cudaError_t err;
  switch (dh / 16) {
    case 1: err = launch_attn<1>(qp, kp, wp, gp, dqp, dkp, dwp, sp, bh, r, c, pad, stream); break;
    case 2: err = launch_attn<2>(qp, kp, wp, gp, dqp, dkp, dwp, sp, bh, r, c, pad, stream); break;
    case 3: err = launch_attn<3>(qp, kp, wp, gp, dqp, dkp, dwp, sp, bh, r, c, pad, stream); break;
    case 4: err = launch_attn<4>(qp, kp, wp, gp, dqp, dkp, dwp, sp, bh, r, c, pad, stream); break;
    case 5: err = launch_attn<5>(qp, kp, wp, gp, dqp, dkp, dwp, sp, bh, r, c, pad, stream); break;
    case 6: err = launch_attn<6>(qp, kp, wp, gp, dqp, dkp, dwp, sp, bh, r, c, pad, stream); break;
    case 7: err = launch_attn<7>(qp, kp, wp, gp, dqp, dkp, dwp, sp, bh, r, c, pad, stream); break;
    case 8: err = launch_attn<8>(qp, kp, wp, gp, dqp, dkp, dwp, sp, bh, r, c, pad, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || ksize == 0) return (int)err;
  return (int)conv1d_bwd(static_cast<const bf16*>(v), static_cast<const bf16*>(kern), gp,
                         static_cast<bf16*>(dv), static_cast<float*>(dkern),
                         static_cast<float*>(partial), bh, heads, r, dh, ksize, stream);
}
