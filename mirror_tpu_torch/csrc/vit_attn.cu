// Multi-head attention on the natural [b, n, d] layout of the ViT (K8, and
// the middle launch of K6).
//
// Replaces: mirror_tpu/ops/vit_attn_pallas.py::mha_natural (the pallas_call
// of _mha_natural, kernel body _kernel) and the per-head attention inside
// ::_attn_block_kernel.
//
// What it computes, per image and head h: out[:, h dh:(h+1) dh] =
// bf16(bf16(softmax(q_h k_h^T * dh^-0.5)) v_h), where q_h is columns
// [h dh, (h+1) dh) of q's rows (row stride ld_in: d for separate q, k, v, 3d
// for the fused q|k|v buffer of attn_block). The scores, the softmax
// statistics and both products' sums are fp32; the normalised probabilities
// are rounded to bf16 before P v, and each head's output once, at the TPU
// kernel's rounding points. Columns past n are -inf logits (weight 0): unlike
// the Nystrom kernels' pad, they are not part of the softmax.
//
// What bounds it on the H100: device-memory bytes. At Phikon's batch of 256
// (n 197, 12 heads, dh 64) q, k, v and out are 4 x 77.5 MB (0.093 ms at
// 3.35 TB/s) against 3.0e10 FLOP of products (0.031 ms at 989 TFLOP/s).
//
// Design: the TPU program holds 2-4 whole images in VMEM and loops over the
// heads; here a block of 4 warps owns (image, head, 64 queries), so the grid
// is b x heads x ceil(n / 64) and no transpose to a head-major layout is ever
// made. K_h and V_h (n rounded up to 16 rows, zero-filled) are copied into
// shared memory with cp.async; each warp computes the full fp32 score rows of
// its 16 queries with WMMA (16x16x16 bf16), takes an exact two-pass softmax
// per row in registers, writes the bf16 probabilities over the first half of
// the same score rows, and multiplies them by V_h. At n 197 the block holds
// 114 KB, so two blocks share an SM. n is at most 256 (the registers of a
// score row).
//
// For the probe scripts/exp_vit_attn_kernel.py (K11c; make_headmajor :101,
// make_natural :149): a head-major [b h, n, dh] tensor is the same call with
// b h images of one head and ld_in = ld_out = dh; with `group` G > 1 a
// second kernel lets a block walk G consecutive (image, head) pairs in turn,
// reusing its shared memory (G = N heads is N whole images).
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BQ = 64;  // queries per block, 16 a warp
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCols = 256;  // the most key columns a score row holds
constexpr int kMaxDhTiles = 8;  // dh <= 128

struct Layout {
  int npad, ldk, ls;  // n rounded up to 16; bf16 stride of K, V; fp32 stride of S
  size_t k, v, s, total;
};

__host__ __device__ inline Layout make_layout(int n, int dh) {
  Layout L;
  L.npad = (n + 15) / 16 * 16;
  L.ldk = dh + 8;
  // a score row also holds the warp's staged q row (bf16) and its fp32
  // output row, so it is at least dh + 4 wide
  L.ls = (L.npad > dh ? L.npad : dh) + 4;
  size_t off = 0;
  L.k = off; off += smem_align((size_t)L.npad * L.ldk * sizeof(bf16));
  L.v = off; off += smem_align((size_t)L.npad * L.ldk * sizeof(bf16));
  L.s = off; off += smem_align((size_t)BQ * L.ls * sizeof(float));
  L.total = off;
  return L;
}

// Start copying rows [0, rows) of head columns [0, dh) of a matrix with row
// stride ld to shared memory with stride lds (bf16 elements), 16 bytes a
// thread per step with cp.async, so every load of the block is in flight at
// once; rows >= valid are zero-filled.
__device__ inline void load_head_rows(bf16* dst, const bf16* src, int rows, int valid, int dh,
                                      int ld, int lds) {
  const int chunks = dh / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    const bool ok = r < valid;
    cp_async16(dst + (size_t)r * lds + c, ok ? src + (size_t)r * ld + c : src, ok);
  }
}

// The block's 64 queries of one (image, head) pair: K_h, V_h and the queries
// into shared memory (every thread reaches the one block barrier), then each
// warp's 16 rows.
__device__ __forceinline__ void attend(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                       const bf16* __restrict__ v, bf16* __restrict__ out,
                                       int n, int dh, int ld_in, int ld_out, float scale,
                                       int img, int head) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(n, dh);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L.v);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  const int ldk = L.ldk, ls = L.ls, npad = L.npad;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int dtiles = dh / 16;

  const size_t base = (size_t)img * n * ld_in + (size_t)head * dh;
  load_head_rows(sK, k + base, npad, n, dh, ld_in, ldk);
  load_head_rows(sV, v + base, npad, n, dh, ld_in, ldk);
  // q row i is staged at the start of score row i (bf16 stride 2 ls), so a
  // warp's queries lie in its own score rows
  load_head_rows(reinterpret_cast<bf16*>(sS), q + base + (size_t)q0 * ld_in, BQ, n - q0, dh,
                 ld_in, 2 * ls);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // the last block of an image holds n mod 64 queries (5 at n 197): a warp
  // whose 16 rows all lie past n has nothing more to do
  const int rows = n - (q0 + warp * 16);
  if (rows <= 0) return;

  float* wS = sS + (size_t)warp * 16 * ls;  // this warp's 16 score rows
  bf16* wP = reinterpret_cast<bf16*>(wS);   // its probabilities, bf16 stride 2 ls
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fq[kMaxDhTiles];
  // the fragment arrays are indexed with constants only (unrolled to
  // kMaxDhTiles, predicated on dtiles), so they stay in registers
#pragma unroll
  for (int t = 0; t < kMaxDhTiles; ++t)
    if (t < dtiles) wmma::load_matrix_sync(fq[t], wP + 16 * t, 2 * ls);
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
  // as bf16 probabilities, are zeros too, and they are never stored)
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

  // the warp's 16 rows, 8 columns a lane per step, rounded once
  const int chunks = dh / 8;
  for (int idx = lane; idx < 16 * chunks; idx += 32) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    if (r >= rows) continue;
    const int row = q0 + warp * 16 + r;
    uint4 val;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
    const float* src = wS + (size_t)r * ls + c;
    for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(src[2 * t], src[2 * t + 1]);
    *reinterpret_cast<uint4*>(out + ((size_t)img * n + row) * ld_out + (size_t)head * dh + c) =
        val;
  }
}

__global__ void __launch_bounds__(kThreads)
    vit_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int n, int dh,
                    int ld_in, int ld_out, float scale) {
  attend(q, k, v, out, n, dh, ld_in, ld_out, scale, blockIdx.z, blockIdx.y);
}

// A block walks `group` consecutive (image, head) pairs of `pairs` in turn;
// the barrier after each keeps the next pair's loads off the tiles in use.
__global__ void __launch_bounds__(kThreads)
    vit_attn_grouped_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, int pairs,
                            int heads, int group, int n, int dh, int ld_in, int ld_out,
                            float scale) {
  const int first = (int)blockIdx.y * group, last = min(pairs, first + group);
  for (int pair = first; pair < last; ++pair) {
    attend(q, k, v, out, n, dh, ld_in, ld_out, scale, pair / heads, pair % heads);
    __syncthreads();
  }
}

}  // namespace

// q, k, v: [b, n, *] bf16 with row stride ld_in, head h at columns
// [h dh, (h+1) dh); out: [b, n, *] with row stride ld_out. n <= 256,
// dh a multiple of 16 up to 128, ld_in and ld_out multiples of 8. A block
// takes `group` consecutive (image, head) pairs (1 on the model's path).
MIRROR_EXPORT int mirror_vit_attn(const void* q, const void* k, const void* v, void* out,
                                  int b, int n, int heads, int dh, int ld_in, int ld_out,
                                  int group, float scale, cudaStream_t stream) {
  if (n > kMaxCols || dh % 16 != 0 || dh / 16 > kMaxDhTiles || group <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout(n, dh).total;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  auto* ob = static_cast<bf16*>(out);
  cudaError_t err;
  if (group == 1) {
    err = allow_smem(vit_attn_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n + BQ - 1) / BQ, heads, b);
    vit_attn_kernel<<<grid, kThreads, smem, stream>>>(qb, kb, vb, ob, n, dh, ld_in, ld_out,
                                                      scale);
    return (int)cudaGetLastError();
  }
  const int pairs = b * heads, blocks = (pairs + group - 1) / group;
  if (blocks > 65535) return (int)cudaErrorInvalidValue;
  err = allow_smem(vit_attn_grouped_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  vit_attn_grouped_kernel<<<dim3((n + BQ - 1) / BQ, blocks), kThreads, smem, stream>>>(
      qb, kb, vb, ob, pairs, heads, group, n, dh, ld_in, ld_out, scale);
  return (int)cudaGetLastError();
}
