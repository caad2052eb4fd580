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
// What bounds it on the H100. The function: its products, 24 (forward)
// and 71 (backward) of 2 m^3 FLOP per (b, h): at b 16, h 8, m 384, 348
// GFLOP (0.352 ms at 989 TFLOP/s bf16) and 1.03 TFLOP (1.04 ms). This
// design, one batched GEMM launch a product: each launch reads its two
// operands from device memory and writes its output, 3 x 37.7 MB = 113 MB
// at bh 128, m 384 (0.034 ms at 3.35 TB/s) against 14.5 GFLOP (0.015 ms),
// so every launch is bound by bytes. A forward iteration moves 13 such
// tensors (x z also writes t1 = 7I - xz), 491 MB; the 24 launches and z0,
// 3.0 GB, 0.90 ms. The backward (replay, the t1 pass, the sweep, gx in
// fp32) moves about 10.5 GB, 3.1 ms. Going under those floors needs one
// (b, h)'s chain kept on chip, which a block cannot do (below).
//
// Design, and why not the TPU's: one bf16 [384, 384] matrix is 288 KB, and a
// block has at most 227 KB of shared memory, so the TPU programs (x, z and
// the temporaries resident for all 6 iterations; the backward's 24-matrix
// replay stash, ~7 MB of VMEM) do not carry over. A thread block cluster
// could hold x and z in the distributed shared memory of several SMs, but
// would pin a whole iteration chain of one (batch, head) to one cluster and
// synchronise it dozens of times. This port instead runs one batched bf16
// GEMM (gemm_mma.cuh: mma.sync m16n8k16 from ldmatrix fragments, fp32
// accumulators in registers, a 3-stage ring of 16-byte cp.async tiles)
// whose operands may each be read transposed (A^T B and A B^T: the
// shared-memory tile keeps the global layout and ldmatrix.trans reads it,
// so no transpose is ever materialised), with three epilogues applied from
// the accumulator registers, two adjacent columns at a time
// (__nv_bfloat162 stores, float2 for ACC32; the identity term is
// row == col):
//   EYE:   out = bf16(c0 I + c1 bf16(P)), optionally out2 = bf16(d0 I + d1 out)
//   ADD:   out = bf16(prev + c1 bf16(P))      (prev may be out itself)
//   ACC32: acc += P, fp32, no rounding        (the backward's gx)
// A block owns a 128 x 128 output tile (8 warps of 64 x 32; m 384 is 3 x 3
// tiles, no ragged edge) and walks K in steps of 64 through 3 stages (110
// KB of shared memory); the grid keeps a
// matrix's 9 tiles together (batch slowest), so the blocks that share an A
// row panel or B column panel find it in L2. One block a tile, no split-K
// and no atomics: every output, ACC32's gx included, is the same from run
// to run. The wrapper (ops/pinv.py) launches it 4 times per forward
// iteration and 12 times per backward iteration (the replay's last z
// product is skipped: the sweep never reads it). The replay stash (4 x
// iters x [b, h, m, m] bf16, 0.9 GB at the slice's shape) lives in device
// memory for the call; gs is reduced per (b, h) in a fixed order by one
// block each and the partials are summed by torch, so the result is the
// same from run to run.
#include "gemm_mma.cuh"

namespace {

using gemm_mma::Tile;

enum Layout { NN = 0, NT = 1, TN = 2 };
enum Epilogue { EPI_EYE = 0, EPI_ADD = 1, EPI_ACC32 = 2 };

// Two bf16 values at dst: one 4-byte store (VEC: N is even, so the pair
// is aligned and whole), else element by element, the second only if `two`.
template <bool VEC>
__device__ __forceinline__ void store2(bf16* dst, __nv_bfloat162 v, bool two) {
  if (VEC) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = v;
    return;
  }
  dst[0] = v.x;
  if (two) dst[1] = v.y;
}

// P = op(A) op(B) per batch entry, op(A) [M, K], op(B) [K, N]. TA: A is
// stored [K, M] (op(A) = A^T); TB: B is stored [N, K] (op(B) = B^T). VEC:
// M, N and K are multiples of 8 (16-byte staging and pair stores).
template <bool TA, bool TB, int EPI, bool VEC>
__global__ void __launch_bounds__(Tile::kThreads, 1)
    pinv_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* C,
                     bf16* __restrict__ C2, const bf16* prev, float* __restrict__ acc,
                     int M, int N, int K, float c0, float c1, float d0, float d1) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int batch = blockIdx.z;
  const int m0 = blockIdx.y * Tile::BM, n0 = blockIdx.x * Tile::BN;
  float p[Tile::MT][Tile::NT][4];
#pragma unroll
  for (int i = 0; i < Tile::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tile::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[i][j][e] = 0.f;
  gemm_mma::mainloop<TA, TB, VEC>(p, reinterpret_cast<bf16*>(smem_raw),
                                     A + (size_t)batch * M * K, B + (size_t)batch * K * N, M,
                                     N, K, m0, n0);

  const size_t base = (size_t)batch * M * N;
  // ADD and ACC32 first read every term they add to, all loads in flight
  // at once: prev may alias C, so the compiler may not move a load of prev
  // above a store to C, and loads interleaved with stores would each wait
  // for device memory in turn
  float2 q[EPI == EPI_EYE ? 1 : gemm_mma::kPairs];
  if constexpr (EPI != EPI_EYE) {
    gemm_mma::for_each_pair(p, m0, n0, [&](int k, int r, int c, float, float) {
      q[k] = make_float2(0.f, 0.f);
      if (r >= M || c >= N) return;
      const size_t o = base + (size_t)r * N + c;
      if constexpr (EPI == EPI_ACC32) {
        if (VEC) {
          q[k] = *reinterpret_cast<const float2*>(acc + o);
        } else {
          q[k].x = acc[o];
          if (c + 1 < N) q[k].y = acc[o + 1];
        }
      } else {
        if (VEC) {
          q[k] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(prev + o));
        } else {
          q[k].x = __bfloat162float(prev[o]);
          if (c + 1 < N) q[k].y = __bfloat162float(prev[o + 1]);
        }
      }
    });
  }
  gemm_mma::for_each_pair(p, m0, n0, [&](int k, int r, int c, float p0, float p1) {
    if (r >= M || c >= N) return;
    const size_t o = base + (size_t)r * N + c;
    const bool two = c + 1 < N;  // always, when N is even
    if constexpr (EPI == EPI_ACC32) {
      if (VEC) {
        *reinterpret_cast<float2*>(acc + o) = make_float2(q[k].x + p0, q[k].y + p1);
      } else {
        acc[o] = q[k].x + p0;
        if (two) acc[o + 1] = q[k].y + p1;
      }
      return;
    }
    const float start0 = EPI == EPI_ADD ? q[k].x : c0 * (r == c ? 1.f : 0.f);
    const float start1 = EPI == EPI_ADD ? q[k].y : c0 * (r == c + 1 ? 1.f : 0.f);
    const __nv_bfloat162 out =
        __floats2bfloat162_rn(start0 + c1 * round_bf16(p0), start1 + c1 * round_bf16(p1));
    store2<VEC>(C + o, out, two);
    if (EPI == EPI_EYE && C2 != nullptr)
      store2<VEC>(C2 + o,
                  __floats2bfloat162_rn(d0 * (r == c ? 1.f : 0.f) + d1 * __low2float(out),
                                        d0 * (r == c + 1 ? 1.f : 0.f) + d1 * __high2float(out)),
                  two);
  });
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

template <bool TA, bool TB, int EPI, bool VEC>
cudaError_t launch_gemm_vec(const void* a, const void* b, void* c, void* c2, const void* prev,
                            void* acc, int bh, int M, int N, int K, float c0, float c1,
                            float d0, float d1, cudaStream_t stream) {
  auto kernel = pinv_gemm_kernel<TA, TB, EPI, VEC>;
  const cudaError_t err = allow_smem(kernel, Tile::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + Tile::BN - 1) / Tile::BN, (M + Tile::BM - 1) / Tile::BM, bh);
  kernel<<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c),
      static_cast<bf16*>(c2), static_cast<const bf16*>(prev), static_cast<float*>(acc), M, N,
      K, c0, c1, d0, d1);
  return cudaGetLastError();
}

template <bool TA, bool TB, int EPI>
cudaError_t launch_gemm(const void* a, const void* b, void* c, void* c2, const void* prev,
                        void* acc, int bh, int M, int N, int K, float c0, float c1,
                        float d0, float d1, cudaStream_t stream) {
  if (M % 8 == 0 && N % 8 == 0 && K % 8 == 0)
    return launch_gemm_vec<TA, TB, EPI, true>(a, b, c, c2, prev, acc, bh, M, N, K, c0, c1,
                                              d0, d1, stream);
  return launch_gemm_vec<TA, TB, EPI, false>(a, b, c, c2, prev, acc, bh, M, N, K, c0, c1, d0,
                                             d1, stream);
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
