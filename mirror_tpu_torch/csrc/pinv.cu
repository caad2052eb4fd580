// Moore-Penrose pseudo-inverse iteration of the Nystrom attention: the
// forward (K2) and its exact backward (K2b).
//
// Replaces: mirror_tpu/ops/pinv_pallas.py::moore_penrose_pinv_pallas
// (forward pallas_call in _fwd_call, :151) and, for grad="exact", the
// backward pallas_call in _bwd_call (:171, body _bwd_kernel at :76); and
// the probe scripts/exp_pinv_stash.py (make_variant._bwd_call, :99), whose
// variants keep z (and x z) of the replay and recompute the rest: the same
// launches of this file's GEMM, ordered by ops/pinv.py (K11d).
//
// What the forward computes: 6 iterations of
// z <- 0.25 z (13I - xz (15I - xz (7I - xz))) on [b, h, m, m] bf16, from
// z0 = bf16(x^T / s). Every product is accumulated in fp32 and rounded to
// bf16, and every "cI - P" is rounded to bf16 again, at the same points as
// the TPU kernel (_dot and _iter_body there). The global scale
// s = max(rowsum|x|) * max(colsum|x|) over the WHOLE tensor is reduced by
// torch outside the kernel and read here from device memory.
//
// What the backward computes (per (b, h), g = dL/dz of the last iterate):
// replay the forward from z0, stashing z_t, B_t = x z_t, t3_t and A_t; then
// sweep t = iters-1 .. 0:
//   gA = 0.25 z^T g                 gz' = 0.25 g A^T
//   gB = -gA t3^T + (B^T gA) t1^T - B^T (B^T gA)     (t1 = 7I - B)
//   gx += gB z^T   (fp32, unrounded)                 gz = bf16(gz' + x^T gB)
// and finish with gx += gz^T / s, gs = -sum(gz * z0) / s. The rounding
// points are the Pallas body's: each _dot / _dot_nt / _dot_tn rounds its
// fp32 sum to bf16, "gb + _dot_nt(..)", "gb - gt1" and "gz' + _dot_tn(..)"
// round in bf16, and gx stays fp32 until its final cast.
//
// What bounds it on the H100: tensor-core FLOPs. The forward is 4 products
// of [m, m] per iteration: 24 x 2 x 384^3 x 128 (batch x heads) = 348 GFLOP
// a call at the slice's shape, against ~7 MB of traffic per product. The
// backward is 4 (replay, the last z product skipped) + 8 (sweep) products
// per iteration: 71 x 2 x 384^3 x 128 = 1.03 TFLOP a call.
//
// Design, and why not the TPU's: one bf16 [384, 384] matrix is 288 KB, and a
// block has at most 227 KB of shared memory, so the TPU programs (x, z and
// the temporaries resident for all 6 iterations; the backward's 24-matrix
// replay stash, ~7 MB of VMEM) do not carry over. A thread block cluster
// could hold x and z in the distributed shared memory of several SMs, but
// would pin a whole iteration chain of one (batch, head) to one cluster and
// synchronise it dozens of times. This port instead runs one batched bf16
// GEMM (WMMA 16x16x16 tiles on the tensor cores, fp32 accumulation) whose
// operands may each be read transposed (A^T B and A B^T, so no transpose is
// ever materialised: the shared-memory tile keeps the global layout, for
// coalesced loads, and the WMMA fragment takes it as column-major), with
// three fused epilogues:
//   EYE:   out = bf16(c0 I + c1 bf16(P)), optionally out2 = bf16(d0 I + d1 out)
//   ADD:   out = bf16(prev + c1 bf16(P))      (prev may be out itself)
//   ACC32: acc += P, fp32, no rounding        (the backward's gx)
// The wrapper (ops/pinv.py) launches it 4 times per forward iteration and
// 12 times per backward iteration (the replay's last z product is skipped:
// the sweep never reads it). The replay stash (4 x iters x [b, h, m, m]
// bf16, 0.9 GB at the slice's shape) lives in device memory for the call;
// gs is reduced per (b, h) in a fixed order by one block each and the
// partials are summed by torch, so the result is the same from run to run.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDC = BN + 4;  // fp32 row stride, multiple of 4 for wmma
constexpr int kThreads = 128;  // 4 warps, each a 32 x 32 quarter of the tile
// bf16 tile buffers, row strides multiples of 8 for wmma: A as [BM][BK + 8]
// (or [BK][BM + 8] when read transposed), B as [BK][BN + 8] (or [BN][BK + 8])
constexpr int kTileA = (BM * (BK + 8) > BK * (BM + 8)) ? BM * (BK + 8) : BK * (BM + 8);
constexpr int kTileB = (BK * (BN + 8) > BN * (BK + 8)) ? BK * (BN + 8) : BN * (BK + 8);

enum Layout { NN = 0, NT = 1, TN = 2 };
enum Epilogue { EPI_EYE = 0, EPI_ADD = 1, EPI_ACC32 = 2 };

struct __align__(32) GemmSmem {
  bf16 a[kTileA];
  bf16 b[kTileB];
  float c[BM * LDC];
};

// P = op(A) op(B) per batch entry, op(A) [M, K], op(B) [K, N]. TA: A is
// stored [K, M] (op(A) = A^T); TB: B is stored [N, K] (op(B) = B^T).
template <bool TA, bool TB, int EPI>
__global__ void __launch_bounds__(kThreads)
    pinv_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* C,
                     bf16* __restrict__ C2, const bf16* prev, float* __restrict__ acc,
                     int M, int N, int K, float c0, float c1, float d0, float d1) {
  __shared__ GemmSmem sm;
  constexpr int LDA = TA ? BM + 8 : BK + 8;
  constexpr int LDB = TB ? BK + 8 : BN + 8;
  using LayoutA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using LayoutB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
  const int batch = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bf16* Ab = A + (size_t)batch * M * K;
  const bf16* Bb = B + (size_t)batch * K * N;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> frag_c[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(frag_c[i][j], 0.0f);

  const bf16 zero = __float2bfloat16(0.0f);
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += kThreads) {
      if constexpr (TA) {  // tile row r = k, column c = i: A[k][i]
        const int r = idx / BM, c = idx % BM;
        const int gk = k0 + r, gi = m0 + c;
        sm.a[r * LDA + c] = (gi < M && gk < K) ? Ab[(size_t)gk * M + gi] : zero;
      } else {  // tile row r = i, column c = k: A[i][k]
        const int r = idx / BK, c = idx % BK;
        const int gi = m0 + r, gk = k0 + c;
        sm.a[r * LDA + c] = (gi < M && gk < K) ? Ab[(size_t)gi * K + gk] : zero;
      }
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += kThreads) {
      if constexpr (TB) {  // tile row r = j, column c = k: B[j][k]
        const int r = idx / BK, c = idx % BK;
        const int gj = n0 + r, gk = k0 + c;
        sm.b[r * LDB + c] = (gk < K && gj < N) ? Bb[(size_t)gj * K + gk] : zero;
      } else {  // tile row r = k, column c = j: B[k][j]
        const int r = idx / BN, c = idx % BN;
        const int gk = k0 + r, gj = n0 + c;
        sm.b[r * LDB + c] = (gk < K && gj < N) ? Bb[(size_t)gk * N + gj] : zero;
      }
    }
    __syncthreads();
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LayoutA> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb[2];
      for (int i = 0; i < 2; ++i) {
        const int row = wm + 16 * i;  // element (row, kk) of op(A)
        wmma::load_matrix_sync(fa[i], TA ? sm.a + kk * LDA + row : sm.a + row * LDA + kk, LDA);
      }
      for (int j = 0; j < 2; ++j) {
        const int col = wn + 16 * j;  // element (kk, col) of op(B)
        wmma::load_matrix_sync(fb[j], TB ? sm.b + col * LDB + kk : sm.b + kk * LDB + col, LDB);
      }
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(frag_c[i][j], fa[i], fb[j], frag_c[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sm.c + (wm + 16 * i) * LDC + wn + 16 * j, frag_c[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  const size_t base = (size_t)batch * M * N;
  for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int gr = m0 + r, gc = n0 + c;
    if (gr >= M || gc >= N) continue;
    const size_t o = base + (size_t)gr * N + gc;
    const float p = sm.c[r * LDC + c];
    if constexpr (EPI == EPI_ACC32) {
      acc[o] += p;
    } else if constexpr (EPI == EPI_ADD) {
      C[o] = __float2bfloat16(__bfloat162float(prev[o]) + c1 * round_bf16(p));
    } else {
      const float eye = (gr == gc) ? 1.0f : 0.0f;
      const bf16 out = __float2bfloat16(c0 * eye + c1 * round_bf16(p));
      C[o] = out;
      if (C2) C2[o] = __float2bfloat16(d0 * eye + d1 * __bfloat162float(out));
    }
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

// out = bf16(c0 I + c1 in) over bh [m, m] matrices (the backward's
// t1 = 7I - B, recomputed from the stash as the TPU kernel does).
__global__ void pinv_eye_axpby_kernel(const bf16* __restrict__ in, bf16* __restrict__ out,
                                      size_t total, int m, float c0, float c1) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i % ((size_t)m * m);
    const float eye = (e / m == e % m) ? 1.0f : 0.0f;
    out[i] = __float2bfloat16(c0 * eye + c1 * __bfloat162float(in[i]));
  }
}

// gx = bf16(gx32 + gz^T / s), through a 32 x 32 shared-memory tile of gz.
__global__ void pinv_bwd_finish_kernel(const float* __restrict__ gx32,
                                       const bf16* __restrict__ gz,
                                       const float* __restrict__ s, bf16* __restrict__ gx,
                                       int m) {
  __shared__ float tile[32][33];
  const size_t base = (size_t)blockIdx.z * m * m;
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {  // gz rows j0.., columns i0..
    const int gj = j0 + r, gi = i0 + threadIdx.x;
    if (gi < m && gj < m) tile[r][threadIdx.x] = __bfloat162float(gz[base + (size_t)gj * m + gi]);
  }
  __syncthreads();
  const float scale = *s;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int gi = i0 + r, gj = j0 + threadIdx.x;  // gx[gi][gj] += gz[gj][gi] / s
    if (gi < m && gj < m) {
      const size_t o = base + (size_t)gi * m + gj;
      gx[o] = __float2bfloat16(gx32[o] + tile[threadIdx.x][r] / scale);
    }
  }
}

// partial[bh] = -sum(gz * z0) / s over one [m, m] matrix: one block per
// (b, h), each thread a fixed strided subset, then a fixed tree.
constexpr int kGsThreads = 256;

__global__ void __launch_bounds__(kGsThreads)
    pinv_bwd_gs_kernel(const bf16* __restrict__ gz, const bf16* __restrict__ z0,
                       const float* __restrict__ s, float* __restrict__ partial, int m) {
  __shared__ float warp_sums[kGsThreads / 32];
  const size_t base = (size_t)blockIdx.x * m * m;
  const size_t total = (size_t)m * m;
  float sum = 0.0f;
  for (size_t i = threadIdx.x; i < total; i += kGsThreads)
    sum += __bfloat162float(gz[base + i]) * __bfloat162float(z0[base + i]);
  sum = warp_sum(sum);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kGsThreads / 32; ++w) t += warp_sums[w];
    partial[blockIdx.x] = -t / *s;
  }
}

template <bool TA, bool TB, int EPI>
cudaError_t launch_gemm(const void* a, const void* b, void* c, void* c2, const void* prev,
                        void* acc, int bh, int M, int N, int K, float c0, float c1,
                        float d0, float d1, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, bh);
  pinv_gemm_kernel<TA, TB, EPI><<<grid, kThreads, 0, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c),
      static_cast<bf16*>(c2), static_cast<const bf16*>(prev), static_cast<float*>(acc), M, N,
      K, c0, c1, d0, d1);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_gemm_layout(int layout, const void* a, const void* b, void* c, void* c2,
                               const void* prev, void* acc, int bh, int M, int N, int K,
                               float c0, float c1, float d0, float d1, cudaStream_t stream) {
  switch (layout) {
    case NN:
      return launch_gemm<false, false, EPI>(a, b, c, c2, prev, acc, bh, M, N, K, c0, c1, d0,
                                            d1, stream);
    case NT:
      return launch_gemm<false, true, EPI>(a, b, c, c2, prev, acc, bh, M, N, K, c0, c1, d0,
                                           d1, stream);
    case TN:
      return launch_gemm<true, false, EPI>(a, b, c, c2, prev, acc, bh, M, N, K, c0, c1, d0,
                                           d1, stream);
    default:
      return cudaErrorInvalidValue;
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

// c = op(a) op(b) with an epilogue. layout: 0 a b, 1 a b^T, 2 a^T b.
// epilogue: 0 EYE, c = bf16(c0 I + c1 bf16(P)) and (c2 not null)
// c2 = bf16(d0 I + d1 c); 1 ADD, c = bf16(prev + c1 bf16(P)); 2 ACC32,
// acc += P in fp32.
MIRROR_EXPORT int mirror_pinv_gemm(const void* a, const void* b, void* c, void* c2,
                                   const void* prev, void* acc, int bh, int M, int N, int K,
                                   int layout, int epilogue, float c0, float c1, float d0,
                                   float d1, cudaStream_t stream) {
  switch (epilogue) {
    case EPI_EYE:
      return (int)launch_gemm_layout<EPI_EYE>(layout, a, b, c, c2, prev, acc, bh, M, N, K,
                                              c0, c1, d0, d1, stream);
    case EPI_ADD:
      return (int)launch_gemm_layout<EPI_ADD>(layout, a, b, c, c2, prev, acc, bh, M, N, K,
                                              c0, c1, d0, d1, stream);
    case EPI_ACC32:
      return (int)launch_gemm_layout<EPI_ACC32>(layout, a, b, c, c2, prev, acc, bh, M, N, K,
                                                c0, c1, d0, d1, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

MIRROR_EXPORT int mirror_pinv_eye_axpby(const void* in, void* out, int bh, int m, float c0,
                                        float c1, cudaStream_t stream) {
  const size_t total = (size_t)bh * m * m;
  const int blocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256 : 8192);
  pinv_eye_axpby_kernel<<<blocks, 256, 0, stream>>>(static_cast<const bf16*>(in),
                                                    static_cast<bf16*>(out), total, m, c0, c1);
  return (int)cudaGetLastError();
}

MIRROR_EXPORT int mirror_pinv_bwd_finish(const void* gx32, const void* gz, const void* z0,
                                         const void* s, void* gx, void* gs_partial, int bh,
                                         int m, cudaStream_t stream) {
  const dim3 grid((m + 31) / 32, (m + 31) / 32, bh);
  pinv_bwd_finish_kernel<<<grid, dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(gx32), static_cast<const bf16*>(gz),
      static_cast<const float*>(s), static_cast<bf16*>(gx), m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pinv_bwd_gs_kernel<<<bh, kGsThreads, 0, stream>>>(
      static_cast<const bf16*>(gz), static_cast<const bf16*>(z0),
      static_cast<const float*>(s), static_cast<float*>(gs_partial), m);
  return (int)cudaGetLastError();
}
