// Row softmax attention of the Nystrom attention, with an optional fused
// 33-tap depthwise residual conv (K3; WITH_CONV is K4).
//
// Replaces: mirror_tpu/ops/nystrom_pallas.py::fused_softmax_attn (forward
// pallas_call in _fwd_call; reached through softmax_matmul_landmark_kv and
// softmax_matmul_landmark_q) and ::fused_softmax_attn_conv (forward
// pallas_call in _fwd_conv_call). Both TPU kernels share one body
// (_attn_fwd_math), and so do these.
//
// What it computes, per (batch, head): out = softmax(q k^T) w over the c
// columns plus `pad` virtual columns whose logit is 0 and whose w row is 0
// (the Nystrom front pad; _softmax_pad on the TPU), with fp32 statistics
// and an fp32 accumulator for the P w product, rounded once. WITH_CONV adds
// sum_t kern[h, t] v[i + t - K/2, :] (zero SAME padding, one filter per head
// shared across dh, no bias) to the fp32 tile before that rounding.
//
// What bounds it on the H100: tensor-core FLOPs and the exp of every logit.
// At the slice's shape each call is 4 x 128 x 2117 x 384 x 96 = 40 GFLOP and
// 104 M exponentials, against 2 x 52 MB of q/k/v traffic.
//
// Design: flash-attention style, so the [r, c] attention matrix never
// reaches device memory (the TPU kept it in VMEM). A block of 4 warps owns
// 64 rows of q (16 a warp) and walks the columns in tiles of 64: S = q k^T
// on the tensor cores (WMMA bf16, fp32 accumulation), an online softmax of
// the tile in fp32 (running max and sum per row), P rounded to bf16, and
// O += P w accumulated in fp32 in shared memory after rescaling its rows.
// The pad's closed form costs nothing: the running max starts at 0 and the
// running sum at `pad`, exactly as if the pad columns had been seen first.
// The conv is a direct loop over the K taps on a window of v rows (the
// block's rows plus K/2 on each side) in shared memory, not the TPU's banded
// matmul: on Hopper the 33 taps are 6 MFLOP a block against 1.6 GFLOP of
// attention, and the window read is the only extra traffic.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64;  // rows of q per block
constexpr int BN = 64;  // columns of k / w per tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int LDS = BN + 4;  // fp32 stride of S
constexpr int LDP = BN + 8;  // bf16 stride of P

struct Layout {
  int ldb, ldo;  // bf16 stride of q/k/w/v rows, fp32 stride of O
  size_t q, k, w, s, p, o, stat, v, tap, total;
};

__host__ __device__ inline Layout make_layout(int dh, int ksize) {
  Layout L;
  L.ldb = dh + 8;
  L.ldo = dh + 4;
  size_t off = 0;
  L.q = off; off += smem_align((size_t)BM * L.ldb * sizeof(bf16));
  L.k = off; off += smem_align((size_t)BN * L.ldb * sizeof(bf16));
  L.w = off; off += smem_align((size_t)BN * L.ldb * sizeof(bf16));
  L.s = off; off += smem_align((size_t)BM * LDS * sizeof(float));
  L.p = off; off += smem_align((size_t)BM * LDP * sizeof(bf16));
  L.o = off; off += smem_align((size_t)BM * L.ldo * sizeof(float));
  L.stat = off; off += smem_align((size_t)3 * BM * sizeof(float));
  L.v = off;
  L.tap = off;
  if (ksize > 0) {
    off += smem_align((size_t)(BM + ksize - 1) * L.ldb * sizeof(bf16));
    L.tap = off;
    off += smem_align((size_t)ksize * sizeof(float));
  }
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

template <bool WITH_CONV>
__global__ void __launch_bounds__(kThreads)
    softmax_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ w, const bf16* __restrict__ v,
                        const bf16* __restrict__ kern, bf16* __restrict__ out, int heads,
                        int R, int C, int dh, int pad, int ksize) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(dh, WITH_CONV ? ksize : 0);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sW = reinterpret_cast<bf16*>(smem + L.w);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  bf16* sP = reinterpret_cast<bf16*>(smem + L.p);
  float* sO = reinterpret_cast<float*>(smem + L.o);
  float* sMax = reinterpret_cast<float*>(smem + L.stat);
  float* sSum = sMax + BM;
  float* sAlpha = sSum + BM;

  const int bh = blockIdx.y;
  const int r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ldb = L.ldb, ldo = L.ldo;
  const int dtiles = dh / 16;

  load_rows(sQ, q + (size_t)bh * R * dh, r0, BM, R, dh, ldb);
  for (int idx = threadIdx.x; idx < BM * ldo; idx += kThreads) sO[idx] = 0.f;
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    // the pad columns, seen first: logit 0, so max 0 and sum pad * exp(0)
    sMax[i] = pad > 0 ? 0.f : -INFINITY;
    sSum[i] = (float)pad;
  }

  const bf16* kb = k + (size_t)bh * C * dh;
  const bf16* wb = w + (size_t)bh * C * dh;
  const int wrow = warp * 16;  // this warp's first row in the block
  for (int c0 = 0; c0 < C; c0 += BN) {
    load_rows(sK, kb, c0, BN, C, dh, ldb);
    load_rows(sW, wb, c0, BN, C, dh, ldb);
    __syncthreads();

    // S = q k^T for the warp's 16 rows and the tile's 64 columns
    for (int j = 0; j < BN / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s_acc;
      wmma::fill_fragment(s_acc, 0.0f);
      for (int t = 0; t < dtiles; ++t) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + wrow * ldb + 16 * t, ldb);
        wmma::load_matrix_sync(fb, sK + (16 * j) * ldb + 16 * t, ldb);
        wmma::mma_sync(s_acc, fa, fb, s_acc);
      }
      wmma::store_matrix_sync(sS + wrow * LDS + 16 * j, s_acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of the tile, one row at a time, lanes over columns
    const bool v0 = c0 + lane < C, v1 = c0 + lane + 32 < C;
    for (int rr = 0; rr < 16; ++rr) {
      const int row = wrow + rr;
      const float s0 = v0 ? sS[row * LDS + lane] : -INFINITY;
      const float s1 = v1 ? sS[row * LDS + lane + 32] : -INFINITY;
      const float m_old = sMax[row];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      const float tile_sum = warp_sum(p0 + p1);
      const float alpha = expf(m_old - m_new);  // 0 when m_old is -inf
      sP[row * LDP + lane] = __float2bfloat16(p0);
      sP[row * LDP + lane + 32] = __float2bfloat16(p1);
      __syncwarp();
      if (lane == 0) {
        sMax[row] = m_new;
        sSum[row] = sSum[row] * alpha + tile_sum;
        sAlpha[row] = alpha;
      }
      __syncwarp();
    }

    // O = alpha * O, then O += P w on the tensor cores (fp32 accumulator)
    for (int idx = lane; idx < 16 * dh; idx += 32) {
      const int row = wrow + idx / dh, d = idx % dh;
      sO[row * ldo + d] *= sAlpha[row];
    }
    __syncwarp();
    for (int t = 0; t < dtiles; ++t) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o_acc;
      wmma::load_matrix_sync(o_acc, sO + wrow * ldo + 16 * t, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fw;
        wmma::load_matrix_sync(fp, sP + wrow * LDP + 16 * kk, LDP);
        wmma::load_matrix_sync(fw, sW + (16 * kk) * ldb + 16 * t, ldb);
        wmma::mma_sync(o_acc, fp, fw, o_acc);
      }
      wmma::store_matrix_sync(sO + wrow * ldo + 16 * t, o_acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();  // every warp is done with sK / sW before the next tile
  }

  float* sTap = nullptr;
  bf16* sV = nullptr;
  const int half = ksize / 2;
  if (WITH_CONV) {
    sV = reinterpret_cast<bf16*>(smem + L.v);
    sTap = reinterpret_cast<float*>(smem + L.tap);
    load_rows(sV, v + (size_t)bh * R * dh, r0 - half, BM + ksize - 1, R, dh, ldb);
    const int head = bh % heads;
    for (int t = threadIdx.x; t < ksize; t += kThreads)
      sTap[t] = __bfloat162float(kern[head * ksize + t]);
    __syncthreads();
  }

  bf16* ob = out + (size_t)bh * R * dh;
  for (int idx = threadIdx.x; idx < BM * dh; idx += kThreads) {
    const int i = idx / dh, d = idx % dh;
    if (r0 + i >= R) continue;
    float val = sO[i * ldo + d] / sSum[i];
    if (WITH_CONV) {
      float conv = 0.f;
      for (int t = 0; t < ksize; ++t) conv = fmaf(sTap[t], __bfloat162float(sV[(i + t) * ldb + d]), conv);
      val += conv;
    }
    ob[(size_t)(r0 + i) * dh + d] = __float2bfloat16(val);
  }
}

template <bool WITH_CONV>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* w, const bf16* v,
                   const bf16* kern, bf16* out, int bh, int heads, int R, int C, int dh,
                   int pad, int ksize, cudaStream_t stream) {
  const size_t smem = make_layout(dh, WITH_CONV ? ksize : 0).total;
  cudaError_t err = allow_smem(softmax_attn_kernel<WITH_CONV>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + BM - 1) / BM, bh);
  softmax_attn_kernel<WITH_CONV><<<grid, kThreads, smem, stream>>>(
      q, k, w, v, kern, out, heads, R, C, dh, pad, ksize);
  return cudaGetLastError();
}

}  // namespace

// ksize == 0: no conv (v and kern unused, may be null).
MIRROR_EXPORT int mirror_softmax_attn(const void* q, const void* k, const void* w,
                                      const void* v, const void* kern, void* out, int bh,
                                      int heads, int r, int c, int dh, int pad, int ksize,
                                      cudaStream_t stream) {
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* wp = static_cast<const bf16*>(w);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* kernp = static_cast<const bf16*>(kern);
  bf16* op = static_cast<bf16*>(out);
  if (ksize > 0)
    return (int)launch<true>(qp, kp, wp, vp, kernp, op, bh, heads, r, c, dh, pad, ksize, stream);
  return (int)launch<false>(qp, kp, wp, vp, kernp, op, bh, heads, r, c, dh, pad, 0, stream);
}
