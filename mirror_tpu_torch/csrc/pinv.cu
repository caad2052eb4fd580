// Moore-Penrose pseudo-inverse iteration of the Nystrom attention (K2).
//
// Replaces: mirror_tpu/ops/pinv_pallas.py::moore_penrose_pinv_pallas
// (forward pallas_call in _fwd_call).
//
// What it computes: 6 iterations of z <- 0.25 z (13I - xz (15I - xz (7I - xz)))
// on [b, h, m, m] bf16, from z0 = bf16(x^T / s). Every product is accumulated
// in fp32 and rounded to bf16, and every "cI - P" is rounded to bf16 again,
// at the same points as the TPU kernel (_dot and _iter_body there). The
// global scale s = max(rowsum|x|) * max(colsum|x|) over the WHOLE tensor is
// reduced by torch outside the kernel and read here from device memory.
//
// What bounds it on the H100: tensor-core FLOPs. 4 products of [m, m] per
// iteration: 24 x 2 x 384^3 x 128 (batch x heads) = 348 GFLOP a call at the
// slice's shape, against ~7 MB of traffic per product.
//
// Design, and why not the TPU's: one bf16 [384, 384] matrix is 288 KB, and a
// block has at most 227 KB of shared memory, so the TPU program (x, z and two
// temporaries resident for all 6 iterations) does not carry over. A thread
// block cluster could hold x and z in the distributed shared memory of
// several SMs, but would pin a whole iteration chain of one (batch, head) to
// one cluster and synchronise it 24 times. This port instead runs a batched
// bf16 GEMM (WMMA 16x16x16 tiles on the tensor cores, fp32 accumulation)
// with a fused epilogue out = bf16(c0 I + c1 bf16(A B)) and an optional
// second output out2 = bf16(d0 I + d1 out), which the wrapper launches 4
// times per iteration (x z, xz t1, xz t3, z a), plus one transpose-and-scale
// launch for z0. Each launch spreads (m/64)^2 x b x h blocks over the card,
// and the products of one iteration stay in the 50 MB L2 (x, z, xz and the
// temporaries are 38 MB at the slice's shape).
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDA = BK + 8;  // bf16 row strides, multiples of 8 for wmma
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // fp32 row stride, multiple of 4 for wmma
constexpr int kThreads = 128;  // 4 warps, each a 32 x 32 quarter of the tile

struct __align__(32) GemmSmem {
  bf16 a[BM * LDA];
  bf16 b[BK * LDB];
  float c[BM * LDC];
};

__global__ void __launch_bounds__(kThreads)
    pinv_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                     bf16* __restrict__ C, bf16* __restrict__ C2, int M, int N,
                     int K, float c0, float c1, float d0, float d1) {
  __shared__ GemmSmem sm;
  const int batch = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* Ab = A + (size_t)batch * M * K;
  const bf16* Bb = B + (size_t)batch * K * N;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const bf16 zero = __float2bfloat16(0.0f);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += kThreads) {
      const int r = idx / BK, c = idx % BK;
      const int gr = m0 + r, gc = k0 + c;
      sm.a[r * LDA + c] = (gr < M && gc < K) ? Ab[(size_t)gr * K + gc] : zero;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += kThreads) {
      const int r = idx / BN, c = idx % BN;
      const int gr = k0 + r, gc = n0 + c;
      sm.b[r * LDB + c] = (gr < K && gc < N) ? Bb[(size_t)gr * N + gc] : zero;
    }
    __syncthreads();
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], sm.a + (wm + 16 * i) * LDA + kk, LDA);
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sm.b + kk * LDB + wn + 16 * j, LDB);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sm.c + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  bf16* Cb = C + (size_t)batch * M * N;
  bf16* C2b = C2 ? C2 + (size_t)batch * M * N : nullptr;
  for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const float eye = (gr == gc) ? 1.0f : 0.0f;
    const float prod = round_bf16(sm.c[r * LDC + c]);
    const bf16 out = __float2bfloat16(c0 * eye + c1 * prod);
    Cb[(size_t)gr * N + gc] = out;
    if (C2b) C2b[(size_t)gr * N + gc] = __float2bfloat16(d0 * eye + d1 * __bfloat162float(out));
  }
}

// z0 = bf16(x^T / s), through a 32 x 32 shared-memory tile.
__global__ void pinv_init_kernel(const bf16* __restrict__ x, const float* __restrict__ s,
                                 bf16* __restrict__ z, int m) {
  __shared__ float tile[32][33];
  const size_t base = (size_t)blockIdx.z * m * m;
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int gi = i0 + r, gj = j0 + threadIdx.x;
    if (gi < m && gj < m) tile[r][threadIdx.x] = __bfloat162float(x[base + (size_t)gi * m + gj]);
  }
  __syncthreads();
  const float scale = *s;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int gi = j0 + r, gj = i0 + threadIdx.x;  // z[gi][gj] = x[gj][gi] / s
    if (gi < m && gj < m) z[base + (size_t)gi * m + gj] = __float2bfloat16(tile[threadIdx.x][r] / scale);
  }
}

}  // namespace

MIRROR_EXPORT int mirror_pinv_init(const void* x, const void* s, void* z, int bh, int m,
                                   cudaStream_t stream) {
  const dim3 grid((m + 31) / 32, (m + 31) / 32, bh);
  pinv_init_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(s), static_cast<bf16*>(z), m);
  return (int)cudaGetLastError();
}

MIRROR_EXPORT int mirror_pinv_gemm(const void* a, const void* b, void* c, void* c2, int bh,
                                   int M, int N, int K, float c0, float c1, float d0,
                                   float d1, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, bh);
  pinv_gemm_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c),
      static_cast<bf16*>(c2), M, N, K, c0, c1, d0, d1);
  return (int)cudaGetLastError();
}
