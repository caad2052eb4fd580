// The projection GEMMs of the ViT half-block kernels (K6 attn_block's q|k|v
// and output projections, K7 mlp_block's fc1 and fc2), each with an optional
// LayerNorm prologue and a fused epilogue, and the LayerNorm row statistics
// they read.
//
// Replaces: the products inside mirror_tpu/ops/vit_attn_pallas.py::
// _attn_block_kernel (q, k, v = LN(x) W + b; x + att W_o + b_o) and
// ::_mlp_block_kernel (h = GELU(LN(x) W_1 + b_1); x + h W_2 + b_2), the
// pallas_calls of attn_block and mlp_block. The attention between the two
// projections of K6 is csrc/vit_attn.cu.
//
// What it computes: C[M, N] = epilogue(A'[M, K] B[K, N]) in bf16 with an fp32
// accumulator, where
// - A' = A, or with the LN prologue A' = bf16((A - mu) * rstd * s + b) per
//   row (mu, rstd from vit_ln_stats_kernel, fp32, two-pass variance as
//   _ln_f32 takes it), rounded once as the TPU kernel rounds y;
// - B is [K, N] row-major (W_q | W_k | W_v side by side for the fused q|k|v
//   product);
// - the epilogue, in fp32 with one rounding at the end: + bias (q|k|v),
//   + bias then exact GELU 0.5 h (1 + erf(h / sqrt 2)) (fc1), or + bias then
//   + the residual row (out projection, fc2).
//
// What bounds it on the H100: tensor-core FLOPs. At Phikon's batch of 256
// (M = 256 x 197 = 50432 rows, d 768, MLP 3072) the four products of one
// block are 2 M d (3d + d + 2 x 4d) = 7.1e11 FLOP against ~0.9 GB of
// operand and result traffic (0.72 ms at 989 TFLOP/s vs 0.27 ms at 3.35 TB/s).
//
// Design, and why not the TPU's: the Pallas kernels keep every weight resident
// in VMEM (4.7 MB for attn_block, 9.4 MB for mlp_block) and loop over 2
// images per program; a Hopper block has 227 KB. So each product here is a
// tiled GEMM that streams the weights: a block of 8 warps owns a 128 x 128
// tile of C and walks K in steps of 32 through a 4-stage cp.async ring in
// shared memory (three K steps of loads in flight while the tensor cores,
// WMMA 16x16x16 bf16 with fp32 accumulation, work on the fourth; 86 KB and
// at most 128 registers a thread, so two blocks share an SM). The LN is
// applied in shared memory when a stage lands, each thread to the chunks it
// copied, so y never reaches device memory. Each warp's 64 x 32 result goes
// through a 16 x 16 fp32 staging tile for the epilogue and leaves as 16-byte
// stores. The q|k|v and the GELU hidden streams do go through device memory
// here (on the TPU they stay in VMEM); keeping them on chip is later work.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int WM = 64, WN = 32;  // a warp's share of the tile: 2 x 4 warps
constexpr int FM = WM / 16, FN = WN / 16;
constexpr int LDA = BK + 8;  // bf16 row strides, multiples of 8 for wmma
constexpr int LDB = BN + 8;
constexpr int LDE = 16 + 4;  // fp32 stride of a warp's epilogue staging tile
constexpr int kChunks = 2;   // 16-byte chunks of A (and of B) a thread copies per K step
constexpr int kStages = 4;   // the cp.async ring

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

struct __align__(128) GemmSmem {
  bf16 a[kStages][BM * LDA];
  bf16 b[kStages][BK * LDB];
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

// Per-row mean and 1 / sqrt(var + eps) of x [rows, d] (bf16), one warp a row,
// as _ln_f32 takes them: the mean first, then the mean of the squared
// deviations.
__global__ void __launch_bounds__(kThreads)
    vit_ln_stats_kernel(const bf16* __restrict__ x, float* __restrict__ mu,
                        float* __restrict__ rstd, int rows, int d, float eps) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  float v[8], sum = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    unpack_bf16x8(*reinterpret_cast<const uint4*>(xr + c), v);
    for (int t = 0; t < 8; ++t) sum += v[t];
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
  for (int c = lane * 8; c < d; c += 256) {
    unpack_bf16x8(*reinterpret_cast<const uint4*>(xr + c), v);
    for (int t = 0; t < 8; ++t) sq += (v[t] - mean) * (v[t] - mean);
  }
  const float var = warp_sum(sq) / d;
  if (lane == 0) {
    mu[row] = mean;
    rstd[row] = rsqrtf(var + eps);
  }
}

template <bool LN, int EPI>
__global__ void __launch_bounds__(kThreads, 2)
    vit_gemm_kernel(const bf16* __restrict__ A, const float* __restrict__ mu,
                    const float* __restrict__ rstd, const float* __restrict__ ln_s,
                    const float* __restrict__ ln_b, const bf16* __restrict__ B,
                    const float* __restrict__ bias, const bf16* __restrict__ R,
                    bf16* __restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  GemmSmem& sm = *reinterpret_cast<GemmSmem*>(smem_raw);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / (BN / WN)) * WM, wn = (warp % (BN / WN)) * WN;

  // the rows and columns this thread copies, the same at every K step
  int a_row[kChunks], a_col[kChunks], b_row[kChunks], b_col[kChunks];
  float a_mu[kChunks], a_rstd[kChunks];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int idx = tid + i * kThreads;
    a_row[i] = idx / (BK / 8);
    a_col[i] = (idx % (BK / 8)) * 8;
    b_row[i] = idx / (BN / 8);
    b_col[i] = (idx % (BN / 8)) * 8;
    const int gr = m0 + a_row[i];
    a_mu[i] = (LN && gr < M) ? mu[gr] : 0.f;
    a_rstd[i] = (LN && gr < M) ? rstd[gr] : 0.f;
  }

  // start copying K step kt into stage st (zero-filled past M, N or K)
  auto copy_stage = [&](int st, int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int gr = m0 + a_row[i], gc = k0 + a_col[i];
      const bool a_ok = gr < M && gc < K;
      cp_async16(sm.a[st] + a_row[i] * LDA + a_col[i], a_ok ? A + (size_t)gr * K + gc : A, a_ok);
      const int kr = k0 + b_row[i], nc = n0 + b_col[i];
      const bool b_ok = kr < K && nc < N;
      cp_async16(sm.b[st] + b_row[i] * LDB + b_col[i], b_ok ? B + (size_t)kr * N + nc : B, b_ok);
    }
  };
  // the LN prologue on the A chunks this thread copied into stage st
  auto layer_norm = [&](int st, int kt) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int gr = m0 + a_row[i], gc = kt * BK + a_col[i];
      if (gr >= M || gc >= K) continue;
      uint4* p = reinterpret_cast<uint4*>(sm.a[st] + a_row[i] * LDA + a_col[i]);
      float v[8];
      unpack_bf16x8(*p, v);
      for (int t = 0; t < 8; ++t)
        v[t] = (v[t] - a_mu[i]) * a_rstd[i] * ln_s[gc + t] + ln_b[gc + t];
      *p = pack_bf16x8(v);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int ksteps = (K + BK - 1) / BK;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < ksteps) copy_stage(st, st);
    cp_async_commit();  // one group per step, empty or not, so the count holds
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    const int st = ks % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of step ks have landed
    if (LN) layer_norm(st, ks);
    __syncthreads();  // everyone's have; and step ks - 1's stage is free again
    if (ks + kStages - 1 < ksteps) copy_stage((ks + kStages - 1) % kStages, ks + kStages - 1);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], sm.a[st] + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], sm.b[st] + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // epilogue: each 16 x 16 fragment through the warp's fp32 staging tile;
  // a lane owns 8 consecutive columns of one row
  float* stage_e = sm.e[warp];
  const int er = lane / 2, ec = (lane % 2) * 8;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(stage_e, acc[i][j], LDE, wmma::mem_row_major);
      __syncwarp();
      const int gr = m0 + wm + 16 * i + er, gc = n0 + wn + 16 * j + ec;
      if (gr < M && gc < N) {
        float v[8];
        for (int t = 0; t < 8; ++t) v[t] = stage_e[er * LDE + ec + t] + bias[gc + t];
        if (EPI == kBiasGelu)
          for (int t = 0; t < 8; ++t) v[t] = 0.5f * v[t] * (1.0f + erff(v[t] * 0.70710678118654752f));
        if (EPI == kBiasResidual) {
          float r[8];
          unpack_bf16x8(*reinterpret_cast<const uint4*>(R + (size_t)gr * N + gc), r);
          for (int t = 0; t < 8; ++t) v[t] = r[t] + v[t];
        }
        *reinterpret_cast<uint4*>(C + (size_t)gr * N + gc) = pack_bf16x8(v);
      }
      __syncwarp();
    }
  }
}

template <bool LN, int EPI>
cudaError_t launch_gemm(const bf16* a, const float* mu, const float* rstd, const float* ln_s,
                        const float* ln_b, const bf16* b, const float* bias, const bf16* r,
                        bf16* c, int M, int N, int K, cudaStream_t stream) {
  const cudaError_t err = allow_smem(vit_gemm_kernel<LN, EPI>, sizeof(GemmSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  vit_gemm_kernel<LN, EPI><<<grid, kThreads, sizeof(GemmSmem), stream>>>(
      a, mu, rstd, ln_s, ln_b, b, bias, r, c, M, N, K);
  return cudaGetLastError();
}

}  // namespace

MIRROR_EXPORT int mirror_vit_ln_stats(const void* x, void* mu, void* rstd, int rows, int d,
                                      float eps, cudaStream_t stream) {
  vit_ln_stats_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<float*>(mu), static_cast<float*>(rstd), rows,
      d, eps);
  return (int)cudaGetLastError();
}

// C[M, N] = epilogue(A' B), in the three forms the half-blocks use: the LN
// prologue with the bias epilogue (q|k|v) or the GELU one (fc1), and no
// prologue with the residual one (out projection, fc2); mu is null exactly
// when there is no prologue. b is [K, N]; resid [M, N] is read by the
// residual epilogue only. K and N are multiples of 8; every pointer is
// 16-byte aligned.
MIRROR_EXPORT int mirror_vit_gemm(const void* a, const void* mu, const void* rstd,
                                  const void* ln_s, const void* ln_b, const void* b,
                                  const void* bias, const void* resid, void* c, int M, int N,
                                  int K, int epilogue, cudaStream_t stream) {
  const bf16* ap = static_cast<const bf16*>(a);
  const float* mup = static_cast<const float*>(mu);
  const float* rp = static_cast<const float*>(rstd);
  const float* sp = static_cast<const float*>(ln_s);
  const float* lbp = static_cast<const float*>(ln_b);
  const bf16* wp = static_cast<const bf16*>(b);
  const float* bp = static_cast<const float*>(bias);
  const bf16* resp = static_cast<const bf16*>(resid);
  bf16* cp = static_cast<bf16*>(c);
  const bool ln = mu != nullptr;
  if (ln && epilogue == kBias)
    return (int)launch_gemm<true, kBias>(ap, mup, rp, sp, lbp, wp, bp, resp, cp, M, N, K, stream);
  if (ln && epilogue == kBiasGelu)
    return (int)launch_gemm<true, kBiasGelu>(ap, mup, rp, sp, lbp, wp, bp, resp, cp, M, N, K,
                                             stream);
  if (!ln && epilogue == kBiasResidual)
    return (int)launch_gemm<false, kBiasResidual>(ap, mup, rp, sp, lbp, wp, bp, resp, cp, M, N,
                                                  K, stream);
  return (int)cudaErrorInvalidValue;
}
