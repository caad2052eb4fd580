// Landmark means and landmark softmax of the Nystrom attention (K1).
//
// Replaces: mirror_tpu/ops/landmark_pallas.py::landmark_softmax (forward
// pallas_call in _fwd_call).
//
// What it computes, per (batch, head): q_l, k_l = means over contiguous
// groups of l rows of the virtually FRONT-PADDED sequence (real row i lies
// in group (i + pad) / l, the divisor is always l, groups made only of pad
// rows are exactly 0), rounded to bf16; then attn2 = softmax(q_l k_l^T)
// with fp32 statistics, rounded to bf16.
//
// What bounds it on the H100: bytes. At the slice's shape it reads q and k
// once (2 x 16x8x2117x96 bf16 = 52 MB) and does ~1.8 GFLOP for the m x m
// similarity, far below the tensor-core line.
//
// Design: two launches in one entry point. The TPU program keeps the q/k
// rows, the group means and the whole [m, m] softmax of one (batch, head) in
// VMEM at once; a Hopper block cannot hold k_l and the q rows together with
// the similarity rows, and one block per (batch, head) would leave most of
// the 132 SMs idle. (1) the means kernel gives one thread per (group,
// feature) and reads each real row once, coalesced along dh; (2) the rows
// kernel gives a block of 4 warps 64 q_l rows: it walks k_l in tiles of 64
// rows through shared memory, forms the [64, m] similarity on the tensor
// cores (WMMA bf16, fp32 sums) into shared memory, and each warp then takes
// max and sum of its 16 rows with shuffles and writes each row once.
//
// Backward (K1b; replaces the backward pallas_call in _bwd_call): four
// launches. The means are recomputed (kernel 1), then the rows kernel
// recomputes the softmax rows and writes dsim = bf16(p ga2 - p rowsum(p ga2))
// to a [bh, m, m] bf16 scratch (37.7 MB at the slice's shape; dk_l needs
// dsim^T q_l, a reduction over all m rows, which the scratch turns into a
// plain tile read), then one tensor-core kernel, launched for dq and for
// dk, forms dq_l = dsim k_l + gql or dk_l = dsim^T q_l + gkl with fp32
// sums, scales by 1/l, rounds, and writes each group's value to its l real
// rows: the TPU's G^T broadcast, never built. Groups made only of front pad
// own no real row and write nothing.
// Bytes bound it too: it reads q and k once (52 MB) and writes dq and dk
// (52 MB), against 3.6 GFLOP.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

__global__ void landmark_means_kernel(const bf16* __restrict__ q,
                                      const bf16* __restrict__ k,
                                      bf16* __restrict__ q_l,
                                      bf16* __restrict__ k_l,
                                      int n, int dh, int m, int l, int pad) {
  const int g = blockIdx.x;    // landmark group
  const int bh = blockIdx.y;   // batch * heads + head
  const float inv_l = 1.0f / (float)l;
  const size_t in_base = (size_t)bh * n * dh;
  const size_t out_base = ((size_t)bh * m + g) * dh;
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float sq = 0.f, sk = 0.f;
    for (int j = 0; j < l; ++j) {
      const int row = g * l - pad + j;  // pad rows (row < 0) are zeros
      if (row >= 0 && row < n) {
        sq += __bfloat162float(q[in_base + (size_t)row * dh + d]);
        sk += __bfloat162float(k[in_base + (size_t)row * dh + d]);
      }
    }
    q_l[out_base + d] = __float2bfloat16(sq * inv_l);
    k_l[out_base + d] = __float2bfloat16(sk * inv_l);
  }
}

// Copy the [rows, cols] tile at (row0, col0) of a row-major [nr, nc] bf16
// matrix into shared memory with stride ld, 16 bytes a thread; outside the
// matrix, zeros. nc and col0 are multiples of 8.
__device__ inline void load_tile(bf16* dst, const bf16* src, int row0, int col0, int rows,
                                 int cols, int nr, int nc, int ld) {
  const int chunks = cols / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = (idx % chunks) * 8;
    const int gr = row0 + r, gc = col0 + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gr < nr && gc < nc) val = *reinterpret_cast<const uint4*>(src + (size_t)gr * nc + gc);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// The rows kernel: p = softmax(q_l k_l^T) for 64 rows of one (batch, head),
// then (BWD false) attn2 = bf16(p), or (BWD true) the backward's step 2,
// dsim = bf16(p * ga2 - p * rowsum(p * ga2)).
constexpr int kRows = 64, kRowThreads = 128;

__host__ __device__ constexpr int rows_lds(int m) { return (m + 63) / 64 * 64 + 4; }

template <int DT>
__host__ __device__ constexpr size_t rows_smem(int m) {
  return 2 * smem_align((size_t)kRows * (16 * DT + 8) * sizeof(bf16)) +
         (size_t)kRows * rows_lds(m) * sizeof(float);
}

template <int DT, bool BWD>
__global__ void __launch_bounds__(kRowThreads)
    landmark_rows_kernel(const bf16* __restrict__ q_l, const bf16* __restrict__ k_l,
                         const bf16* __restrict__ ga2, bf16* __restrict__ out, int m) {
  constexpr int dh = 16 * DT, ldb = dh + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const size_t tile = smem_align((size_t)kRows * ldb * sizeof(bf16));
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + tile);
  float* sS = reinterpret_cast<float*>(smem + 2 * tile);
  const int lds = rows_lds(m);

  const int bh = blockIdx.y, r0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wrow = warp * 16;
  const bf16* kb = k_l + (size_t)bh * m * dh;
  load_tile(sQ, q_l + (size_t)bh * m * dh, r0, 0, kRows, dh, m, dh, ldb);
  for (int c0 = 0; c0 < m; c0 += kRows) {
    load_tile(sK, kb, c0, 0, kRows, dh, m, dh, ldb);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + wrow * ldb + 16 * t, ldb);
        wmma::load_matrix_sync(fb, sK + 16 * j * ldb + 16 * t, ldb);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + wrow * lds + c0 + 16 * j, acc, lds, wmma::mem_row_major);
    }
    __syncthreads();  // every warp is done with sK before the next tile
  }

  // each warp: the softmax of its own 16 rows, lanes over the columns
  for (int rr = 0; rr < 16; ++rr) {
    const int row = r0 + wrow + rr;
    if (row >= m) break;
    float* srow = sS + (wrow + rr) * lds;
    float mx = -INFINITY;
    for (int j = lane; j < m; j += 32) mx = fmaxf(mx, srow[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float e = expf(srow[j] - mx);
      srow[j] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    const size_t base = ((size_t)bh * m + row) * m;
    if constexpr (!BWD) {
      for (int j = lane; j < m; j += 32) out[base + j] = __float2bfloat16(srow[j] * inv);
    } else {
      float dot = 0.f;
      for (int j = lane; j < m; j += 32) {
        srow[j] *= inv;
        dot += srow[j] * __bfloat162float(ga2[base + j]);
      }
      dot = warp_sum(dot);
      for (int j = lane; j < m; j += 32) {
        const float pj = srow[j];
        out[base + j] = __float2bfloat16(pj * __bfloat162float(ga2[base + j]) - pj * dot);
      }
    }
  }
}

template <int DT, bool BWD>
cudaError_t launch_rows(const bf16* q_l, const bf16* k_l, const bf16* ga2, bf16* out, int bh,
                        int m, cudaStream_t stream) {
  const size_t smem = rows_smem<DT>(m);
  const cudaError_t err = allow_smem(landmark_rows_kernel<DT, BWD>, smem);
  if (err != cudaSuccess) return err;
  landmark_rows_kernel<DT, BWD><<<dim3((m + kRows - 1) / kRows, bh), kRowThreads, smem,
                                  stream>>>(q_l, k_l, ga2, out, m);
  return cudaGetLastError();
}

template <bool BWD>
cudaError_t rows(const bf16* q_l, const bf16* k_l, const bf16* ga2, bf16* out, int bh, int m,
                 int dh, cudaStream_t stream) {
  switch (dh / 16) {
    case 1: return launch_rows<1, BWD>(q_l, k_l, ga2, out, bh, m, stream);
    case 2: return launch_rows<2, BWD>(q_l, k_l, ga2, out, bh, m, stream);
    case 3: return launch_rows<3, BWD>(q_l, k_l, ga2, out, bh, m, stream);
    case 4: return launch_rows<4, BWD>(q_l, k_l, ga2, out, bh, m, stream);
    case 5: return launch_rows<5, BWD>(q_l, k_l, ga2, out, bh, m, stream);
    case 6: return launch_rows<6, BWD>(q_l, k_l, ga2, out, bh, m, stream);
    case 7: return launch_rows<7, BWD>(q_l, k_l, ga2, out, bh, m, stream);
    case 8: return launch_rows<8, BWD>(q_l, k_l, ga2, out, bh, m, stream);
    default: return cudaErrorInvalidValue;
  }
}

// a [64, m] fp32 similarity and two bf16 tiles must fit a block's 227 KB
inline bool shape_ok(int dh, int m) {
  return dh % 16 == 0 && dh <= 128 && m % 8 == 0 && m > 0 &&
         rows_smem<8>(m) <= 227 * 1024;
}

// Backward, step 3: dX_l = A B + gX_l, with A = dsim and B = k_l for dq
// (TRANS false) or A = dsim^T and B = q_l for dk (TRANS true), on the tensor
// cores (WMMA bf16, fp32 sums); then times 1/l, rounded, and written to the
// l real rows of each group: row i gets group (i + pad) / l, so the groups
// made only of pad rows write nothing. A block of 4 warps owns 64 groups
// (16 a warp) and all dh features of one (batch, head), and walks the m
// landmarks in tiles of 64 through shared memory: the tile of dsim is
// staged row-major either way, and dsim^T is the same tile read as a
// column-major fragment.
constexpr int kGM = 64, kGK = 64, kGemmThreads = 128;
constexpr int kLdA = kGK + 8;  // bf16 stride of the staged dsim tile

template <int DT>
constexpr size_t grad_smem() {
  // the dsim and B tiles, then (after the loop, over them) the fp32 stage
  const size_t tiles = smem_align((size_t)kGK * kLdA * sizeof(bf16)) +
                       (size_t)kGK * (16 * DT + 8) * sizeof(bf16);
  const size_t stage = (size_t)kGM * (16 * DT + 4) * sizeof(float);
  return tiles > stage ? tiles : stage;
}

template <int DT, bool TRANS>
__global__ void __launch_bounds__(kGemmThreads)
    landmark_grad_kernel(const bf16* __restrict__ dsim, const bf16* __restrict__ b_mat,
                         const bf16* __restrict__ gadd, bf16* __restrict__ out, int n, int m,
                         int l, int pad) {
  constexpr int dh = 16 * DT, ldb = dh + 8, ldo = dh + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = reinterpret_cast<bf16*>(smem + smem_align((size_t)kGK * kLdA * sizeof(bf16)));
  float* stage = reinterpret_cast<float*>(smem);

  const int bh = blockIdx.y, g0 = blockIdx.x * kGM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wrow = warp * 16;
  const bf16* ds = dsim + (size_t)bh * m * m;
  const bf16* bb = b_mat + (size_t)bh * m * dh;
  using ALayout = typename std::conditional<TRANS, wmma::col_major, wmma::row_major>::type;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[DT];
#pragma unroll
  for (int t = 0; t < DT; ++t) wmma::fill_fragment(acc[t], 0.0f);
  for (int i0 = 0; i0 < m; i0 += kGK) {
    if constexpr (TRANS) load_tile(sA, ds, i0, g0, kGK, kGM, m, m, kLdA);  // rows i, cols g
    else load_tile(sA, ds, g0, i0, kGM, kGK, m, m, kLdA);        // rows g, cols i
    load_tile(sB, bb, i0, 0, kGK, dh, m, dh, ldb);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa;
      if constexpr (TRANS) wmma::load_matrix_sync(fa, sA + 16 * kk * kLdA + wrow, kLdA);
      else wmma::load_matrix_sync(fa, sA + wrow * kLdA + 16 * kk, kLdA);
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sB + 16 * kk * ldb + 16 * t, ldb);
        wmma::mma_sync(acc[t], fa, fb, acc[t]);
      }
    }
    __syncthreads();  // every warp is done with the tiles before they change
  }

  float* wstage = stage + wrow * ldo;
#pragma unroll
  for (int t = 0; t < DT; ++t)
    wmma::store_matrix_sync(wstage + 16 * t, acc[t], ldo, wmma::mem_row_major);
  __syncwarp();
  const float inv_l = 1.0f / (float)l;
  const bf16* ga = gadd + (size_t)bh * m * dh;
  bf16* ob = out + (size_t)bh * n * dh;
  for (int idx = lane; idx < 16 * dh; idx += 32) {
    const int r = idx / dh, d = idx % dh, grp = g0 + wrow + r;
    if (grp >= m) continue;
    const float full = wstage[r * ldo + d] + __bfloat162float(ga[(size_t)grp * dh + d]);
    const bf16 val = __float2bfloat16(full * inv_l);
    for (int j = 0; j < l; ++j) {
      const int row = grp * l - pad + j;
      if (row >= 0 && row < n) ob[(size_t)row * dh + d] = val;
    }
  }
}

template <int DT>
cudaError_t launch_grad(const bf16* dsim, const bf16* q_l, const bf16* k_l, const bf16* gql,
                        const bf16* gkl, bf16* dq, bf16* dk, int bh, int n, int m, int l,
                        int pad, cudaStream_t stream) {
  const dim3 grid((m + kGM - 1) / kGM, bh);
  landmark_grad_kernel<DT, false><<<grid, kGemmThreads, grad_smem<DT>(), stream>>>(
      dsim, k_l, gql, dq, n, m, l, pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  landmark_grad_kernel<DT, true><<<grid, kGemmThreads, grad_smem<DT>(), stream>>>(
      dsim, q_l, gkl, dk, n, m, l, pad);
  return cudaGetLastError();
}

}  // namespace

MIRROR_EXPORT int mirror_landmark_softmax(const void* q, const void* k, void* q_l,
                                          void* k_l, void* attn2, int bh, int n,
                                          int dh, int m, int l, int pad,
                                          cudaStream_t stream) {
  if (!shape_ok(dh, m)) return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  bf16* qlp = static_cast<bf16*>(q_l);
  bf16* klp = static_cast<bf16*>(k_l);
  landmark_means_kernel<<<dim3(m, bh), 128, 0, stream>>>(qp, kp, qlp, klp, n, dh, m,
                                                          l, pad);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)rows<false>(qlp, klp, nullptr, static_cast<bf16*>(attn2), bh, m, dh, stream);
}

// Backward: q_l, k_l [bh, m, dh] and dsim [bh, m, m] are scratch the caller
// allocates; every row of dq and dk is written.
MIRROR_EXPORT int mirror_landmark_softmax_bwd(const void* q, const void* k, const void* gql,
                                              const void* gkl, const void* ga2, void* dq,
                                              void* dk, void* q_l, void* k_l, void* dsim,
                                              int bh, int n, int dh, int m, int l, int pad,
                                              cudaStream_t stream) {
  if (!shape_ok(dh, m)) return (int)cudaErrorInvalidValue;
  bf16* qlp = static_cast<bf16*>(q_l);
  bf16* klp = static_cast<bf16*>(k_l);
  bf16* dsp = static_cast<bf16*>(dsim);
  landmark_means_kernel<<<dim3(m, bh), 128, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), qlp, klp, n, dh, m, l, pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = rows<true>(qlp, klp, static_cast<const bf16*>(ga2), dsp, bh, m, dh, stream);
  if (err != cudaSuccess) return (int)err;

  const bf16* gqp = static_cast<const bf16*>(gql);
  const bf16* gkp = static_cast<const bf16*>(gkl);
  bf16* dqp = static_cast<bf16*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  switch (dh / 16) {
    case 1: return (int)launch_grad<1>(dsp, qlp, klp, gqp, gkp, dqp, dkp, bh, n, m, l, pad, stream);
    case 2: return (int)launch_grad<2>(dsp, qlp, klp, gqp, gkp, dqp, dkp, bh, n, m, l, pad, stream);
    case 3: return (int)launch_grad<3>(dsp, qlp, klp, gqp, gkp, dqp, dkp, bh, n, m, l, pad, stream);
    case 4: return (int)launch_grad<4>(dsp, qlp, klp, gqp, gkp, dqp, dkp, bh, n, m, l, pad, stream);
    case 5: return (int)launch_grad<5>(dsp, qlp, klp, gqp, gkp, dqp, dkp, bh, n, m, l, pad, stream);
    case 6: return (int)launch_grad<6>(dsp, qlp, klp, gqp, gkp, dqp, dkp, bh, n, m, l, pad, stream);
    case 7: return (int)launch_grad<7>(dsp, qlp, klp, gqp, gkp, dqp, dkp, bh, n, m, l, pad, stream);
    case 8: return (int)launch_grad<8>(dsp, qlp, klp, gqp, gkp, dqp, dkp, bh, n, m, l, pad, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
