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
//
// Element types: the iterates, x and the gradients are of the compute type
// T, bf16 in the sentences above, float16 or float32 (the Pallas kernel's
// `x.dtype`); every product accumulates in fp32 and rounds to T where the
// bf16 instance rounds (in float32 that is the identity, so the iterations
// run in float32 throughout, as pinv_pallas.py:40 does). The GEMM's float32
// instance is 3xTF32 with k steps of 32 (gemm_mma.cuh).
#include "gemm_mma.cuh"

namespace {

using gemm_mma::Tile;

enum Layout { NN = 0, NT = 1, TN = 2 };
enum Epilogue { EPI_EYE = 0, EPI_ADD = 1, EPI_ACC32 = 2 };

// Two values rounded to T at dst: one store (VEC: N is even, so the pair
// is aligned and whole), else element by element, the second only if `two`.
template <bool VEC, typename T>
__device__ __forceinline__ void store2v(T* dst, float lo, float hi, bool two) {
  if (VEC) {
    store2(dst, lo, hi);
    return;
  }
  dst[0] = Elem<T>::from_float(lo);
  if (two) dst[1] = Elem<T>::from_float(hi);
}

// P = op(A) op(B) per batch entry, op(A) [M, K], op(B) [K, N]. TA: A is
// stored [K, M] (op(A) = A^T); TB: B is stored [N, K] (op(B) = B^T). VEC:
// M, N and K are multiples of 8 (16-byte staging and pair stores).
template <typename T, bool TA, bool TB, int EPI, bool VEC>
__global__ void __launch_bounds__(Tile<T>::kThreads, 1)
    pinv_gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* C,
                     T* __restrict__ C2, const T* prev, float* __restrict__ acc, int M, int N,
                     int K, float c0, float c1, float d0, float d1) {
  using Tl = Tile<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int batch = blockIdx.z;
  const int m0 = blockIdx.y * Tl::BM, n0 = blockIdx.x * Tl::BN;
  float p[Tl::MT][Tl::NT][4];
#pragma unroll
  for (int i = 0; i < Tl::MT; ++i)
#pragma unroll
    for (int j = 0; j < Tl::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[i][j][e] = 0.f;
  gemm_mma::mainloop<TA, TB, VEC>(p, reinterpret_cast<T*>(smem_raw), A + (size_t)batch * M * K,
                                  B + (size_t)batch * K * N, M, N, K, m0, n0);

  const size_t base = (size_t)batch * M * N;
  // ADD and ACC32 first read every term they add to, all loads in flight
  // at once: prev may alias C, so the compiler may not move a load of prev
  // above a store to C, and loads interleaved with stores would each wait
  // for device memory in turn
  float2 q[EPI == EPI_EYE ? 1 : gemm_mma::kPairs<T>];
  if constexpr (EPI != EPI_EYE) {
    gemm_mma::for_each_pair<T>(p, m0, n0, [&](int k, int r, int c, float, float) {
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
          q[k] = load2(prev + o);
        } else {
          q[k].x = Elem<T>::to_float(prev[o]);
          if (c + 1 < N) q[k].y = Elem<T>::to_float(prev[o + 1]);
        }
      }
    });
  }
  gemm_mma::for_each_pair<T>(p, m0, n0, [&](int k, int r, int c, float p0, float p1) {
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
    // the product rounded to T, then the sum rounded to T (the identity in float32)
    const float out0 = round_to<T>(start0 + c1 * round_to<T>(p0));
    const float out1 = round_to<T>(start1 + c1 * round_to<T>(p1));
    store2v<VEC>(C + o, out0, out1, two);
    if (EPI == EPI_EYE && C2 != nullptr)
      store2v<VEC>(C2 + o, d0 * (r == c ? 1.f : 0.f) + d1 * out0,
                   d0 * (r == c + 1 ? 1.f : 0.f) + d1 * out1, two);
  });
}

// z0 = x^T / s rounded to T, through a 32 x 32 shared-memory tile.
template <typename T>
__global__ void pinv_init_kernel(const T* __restrict__ x, const float* __restrict__ s,
                                 T* __restrict__ z, int m) {
  __shared__ float tile[32][33];
  const size_t base = (size_t)blockIdx.z * m * m;
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int gi = i0 + r, gj = j0 + threadIdx.x;
    if (gi < m && gj < m) tile[r][threadIdx.x] = Elem<T>::to_float(x[base + (size_t)gi * m + gj]);
  }
  __syncthreads();
  const float scale = *s;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int gi = j0 + r, gj = i0 + threadIdx.x;  // z[gi][gj] = x[gj][gi] / s
    if (gi < m && gj < m)
      z[base + (size_t)gi * m + gj] = Elem<T>::from_float(tile[threadIdx.x][r] / scale);
  }
}

// out = c0 I + c1 in, rounded to T, over bh [m, m] matrices (the backward's
// t1 = 7I - B, recomputed from the stash as the TPU kernel does).
template <typename T>
__global__ void pinv_eye_axpby_kernel(const T* __restrict__ in, T* __restrict__ out,
                                      size_t total, int m, float c0, float c1) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i % ((size_t)m * m);
    const float eye = (e / m == e % m) ? 1.0f : 0.0f;
    out[i] = Elem<T>::from_float(c0 * eye + c1 * Elem<T>::to_float(in[i]));
  }
}

// gx = gx32 + gz^T / s rounded to T, through a 32 x 32 shared-memory tile of gz.
template <typename T>
__global__ void pinv_bwd_finish_kernel(const float* __restrict__ gx32, const T* __restrict__ gz,
                                       const float* __restrict__ s, T* __restrict__ gx, int m) {
  __shared__ float tile[32][33];
  const size_t base = (size_t)blockIdx.z * m * m;
  const int i0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {  // gz rows j0.., columns i0..
    const int gj = j0 + r, gi = i0 + threadIdx.x;
    if (gi < m && gj < m) tile[r][threadIdx.x] = Elem<T>::to_float(gz[base + (size_t)gj * m + gi]);
  }
  __syncthreads();
  const float scale = *s;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int gi = i0 + r, gj = j0 + threadIdx.x;  // gx[gi][gj] += gz[gj][gi] / s
    if (gi < m && gj < m) {
      const size_t o = base + (size_t)gi * m + gj;
      gx[o] = Elem<T>::from_float(gx32[o] + tile[threadIdx.x][r] / scale);
    }
  }
}

// partial[bh] = -sum(gz * z0) / s over one [m, m] matrix: one block per
// (b, h), each thread a fixed strided subset, then a fixed tree.
constexpr int kGsThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kGsThreads)
    pinv_bwd_gs_kernel(const T* __restrict__ gz, const T* __restrict__ z0,
                       const float* __restrict__ s, float* __restrict__ partial, int m) {
  __shared__ float warp_sums[kGsThreads / 32];
  const size_t base = (size_t)blockIdx.x * m * m;
  const size_t total = (size_t)m * m;
  float sum = 0.0f;
  for (size_t i = threadIdx.x; i < total; i += kGsThreads)
    sum += Elem<T>::to_float(gz[base + i]) * Elem<T>::to_float(z0[base + i]);
  sum = warp_sum(sum);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < kGsThreads / 32; ++w) t += warp_sums[w];
    partial[blockIdx.x] = -t / *s;
  }
}

template <typename T, bool TA, bool TB, int EPI, bool VEC>
cudaError_t launch_gemm_vec(const void* a, const void* b, void* c, void* c2, const void* prev,
                            void* acc, int bh, int M, int N, int K, float c0, float c1,
                            float d0, float d1, cudaStream_t stream) {
  using Tl = Tile<T>;
  auto kernel = pinv_gemm_kernel<T, TA, TB, EPI, VEC>;
  const cudaError_t err = allow_smem(kernel, Tl::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + Tl::BN - 1) / Tl::BN, (M + Tl::BM - 1) / Tl::BM, bh);
  kernel<<<grid, Tl::kThreads, Tl::kSmemBytes, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      static_cast<T*>(c2), static_cast<const T*>(prev), static_cast<float*>(acc), M, N, K, c0,
      c1, d0, d1);
  return cudaGetLastError();
}

template <typename T, bool TA, bool TB, int EPI>
cudaError_t launch_gemm(const void* a, const void* b, void* c, void* c2, const void* prev,
                        void* acc, int bh, int M, int N, int K, float c0, float c1,
                        float d0, float d1, cudaStream_t stream) {
  if (M % 8 == 0 && N % 8 == 0 && K % 8 == 0)
    return launch_gemm_vec<T, TA, TB, EPI, true>(a, b, c, c2, prev, acc, bh, M, N, K, c0, c1,
                                                 d0, d1, stream);
  return launch_gemm_vec<T, TA, TB, EPI, false>(a, b, c, c2, prev, acc, bh, M, N, K, c0, c1,
                                                d0, d1, stream);
}

template <typename T, int EPI>
cudaError_t launch_gemm_layout(int layout, const void* a, const void* b, void* c, void* c2,
                               const void* prev, void* acc, int bh, int M, int N, int K,
                               float c0, float c1, float d0, float d1, cudaStream_t stream) {
  switch (layout) {
    case NN:
      return launch_gemm<T, false, false, EPI>(a, b, c, c2, prev, acc, bh, M, N, K, c0, c1, d0,
                                               d1, stream);
    case NT:
      return launch_gemm<T, false, true, EPI>(a, b, c, c2, prev, acc, bh, M, N, K, c0, c1, d0,
                                              d1, stream);
    case TN:
      return launch_gemm<T, true, false, EPI>(a, b, c, c2, prev, acc, bh, M, N, K, c0, c1, d0,
                                              d1, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Every entry below takes the type code dtype (common.cuh's Elem) of its
// [m, m] matrices; s, acc, gx32 and gs_partial are fp32.

MIRROR_EXPORT int mirror_pinv_init(const void* x, const void* s, void* z, int bh, int m,
                                   int dtype, cudaStream_t stream) {
  const dim3 grid((m + 31) / 32, (m + 31) / 32, bh);
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    pinv_init_kernel<T><<<grid, dim3(32, 8), 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(s), static_cast<T*>(z), m);
    return cudaGetLastError();
  });
}

// c = op(a) op(b) with an epilogue. layout: 0 a b, 1 a b^T, 2 a^T b.
// epilogue: 0 EYE, c = T(c0 I + c1 T(P)) and (c2 not null)
// c2 = T(d0 I + d1 c); 1 ADD, c = T(prev + c1 T(P)); 2 ACC32,
// acc += P in fp32 (T(.): rounded to T).
MIRROR_EXPORT int mirror_pinv_gemm(const void* a, const void* b, void* c, void* c2,
                                   const void* prev, void* acc, int bh, int M, int N, int K,
                                   int layout, int epilogue, float c0, float c1, float d0,
                                   float d1, int dtype, cudaStream_t stream) {
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    switch (epilogue) {
      case EPI_EYE:
        return launch_gemm_layout<T, EPI_EYE>(layout, a, b, c, c2, prev, acc, bh, M, N, K, c0,
                                              c1, d0, d1, stream);
      case EPI_ADD:
        return launch_gemm_layout<T, EPI_ADD>(layout, a, b, c, c2, prev, acc, bh, M, N, K, c0,
                                              c1, d0, d1, stream);
      case EPI_ACC32:
        return launch_gemm_layout<T, EPI_ACC32>(layout, a, b, c, c2, prev, acc, bh, M, N, K,
                                                c0, c1, d0, d1, stream);
      default:
        return cudaErrorInvalidValue;
    }
  });
}

MIRROR_EXPORT int mirror_pinv_eye_axpby(const void* in, void* out, int bh, int m, float c0,
                                        float c1, int dtype, cudaStream_t stream) {
  const size_t total = (size_t)bh * m * m;
  const int blocks = (int)((total + 255) / 256 < 8192 ? (total + 255) / 256 : 8192);
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    pinv_eye_axpby_kernel<T><<<blocks, 256, 0, stream>>>(static_cast<const T*>(in),
                                                         static_cast<T*>(out), total, m, c0, c1);
    return cudaGetLastError();
  });
}

MIRROR_EXPORT int mirror_pinv_bwd_finish(const void* gx32, const void* gz, const void* z0,
                                         const void* s, void* gx, void* gs_partial, int bh,
                                         int m, int dtype, cudaStream_t stream) {
  const dim3 grid((m + 31) / 32, (m + 31) / 32, bh);
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    pinv_bwd_finish_kernel<T><<<grid, dim3(32, 8), 0, stream>>>(
        static_cast<const float*>(gx32), static_cast<const T*>(gz),
        static_cast<const float*>(s), static_cast<T*>(gx), m);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    pinv_bwd_gs_kernel<T><<<bh, kGsThreads, 0, stream>>>(
        static_cast<const T*>(gz), static_cast<const T*>(z0), static_cast<const float*>(s),
        static_cast<float*>(gs_partial), m);
    return cudaGetLastError();
  });
}
