// Backward of the landmark means and landmark softmax (K1b): a row pass
// (dot, then dq) and a column pass (dk) from the forward's residuals q_l,
// k_l and lse, with no [m, m] scratch and no float atomics.
//
// Replaces: mirror_tpu/ops/landmark_pallas.py::landmark_softmax's backward
// pallas_call (_bwd_call, body _bwd_kernel). What it computes, what bounds
// it and the design: landmark.cu's head comment, part (3). A file of its
// own so that nvcc builds the two passes beside the forward, in parallel.
#include "landmark.cuh"

namespace {

using namespace attn;
using namespace landmark;

// cp.async the [rows, 64] bf16 tile at (row0, col0) of a row-major [nr, nc]
// matrix into shared memory with stride ld, 16 bytes a thread; outside the
// matrix, zeros (nc and col0 are multiples of 8).
template <typename T>
__device__ __forceinline__ void load_tile_async(T* dst, int ld, const T* src, int row0,
                                                int col0, int rows, int nr, int nc) {
  constexpr int V = vec16<T>();
  for (int idx = threadIdx.x; idx < rows * (BN / V); idx += kThreads) {
    const int r = idx / (BN / V), c = (idx % (BN / V)) * V;
    const int gr = row0 + r, gc = col0 + c;
    const bool ok = gr < nr && gc < nc;
    cp_async16(dst + r * ld + c, ok ? src + (size_t)gr * nc + gc : src, ok);
  }
}

// Shared memory of either pass: the owned tile (A), the owned gradient
// tile (gql or gkl, then the staged result), and a ring of kStages stages of
// (walked tile, ga2 tile, and in the column pass the walked rows' lse and
// dot); tile t + kStages - 1 is in flight while tile t is multiplied.

template <typename T, int DT>
__host__ __device__ constexpr size_t stage_elems() {
  return (size_t)BN * row_stride<DT>() + (size_t)BN * LDP + 2 * BN * sizeof(float) / sizeof(T);
}

template <typename T, int DT>
__host__ __device__ constexpr size_t bwd_smem() {
  return (2 * (size_t)BM * row_stride<DT>() + kStages * stage_elems<T, DT>()) * sizeof(T);
}

// blocks an SM at the least: float's 144 KB (dh 96) leave room for one
template <typename T>
__host__ __device__ constexpr int min_blocks() { return sizeof(T) == 4 ? 1 : 2; }

// The epilogue of both passes: out rows of the block's groups g0.. take
// bf16((acc + gadd) / l). sG holds the block's [64, dh] gadd tile and is
// overwritten by the result (each thread its own pairs), which is then
// written to the groups' real rows, a contiguous span of `out`.
template <int DT, typename T>
__device__ __forceinline__ void write_groups(const float (&acc)[2 * DT][4], T* sG,
                                             T* __restrict__ out, int g0, int m, int n, int l,
                                             int pad) {
  constexpr int DH = 16 * DT, LD = row_stride<DT>(), V = vec16<T>(), CH = DH / V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const float inv_l = 1.0f / (float)l;
#pragma unroll
  for (int nn = 0; nn < 2 * DT; ++nn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* p = sG + (warp * 16 + g + 8 * h) * LD + 8 * nn + 2 * t;
      const float2 ga = load2(p);
      store2(p, (acc[nn][2 * h] + ga.x) * inv_l, (acc[nn][2 * h + 1] + ga.y) * inv_l);
    }
  __syncthreads();
  const int first = max(g0 * l - pad, 0);
  const int last = min(min(g0 + BM, m) * l - pad, n);
  for (int idx = threadIdx.x; idx < (last - first) * CH; idx += kThreads) {
    const int row = first + idx / CH, c = (idx % CH) * V;
    const int grp = (row + pad) / l - g0;
    *reinterpret_cast<uint4*>(out + (size_t)row * DH + c) =
        *reinterpret_cast<const uint4*>(sG + grp * LD + c);
  }
}

// rows: dot, then dq. One block per 64 rows of one (batch, head).
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
    landmark_bwd_rows_kernel(const T* __restrict__ q_l, const T* __restrict__ k_l,
                             const float* __restrict__ lse, const T* __restrict__ gql,
                             const T* __restrict__ ga2, T* __restrict__ dq,
                             float* __restrict__ dvec, int n, int m, int l, int pad) {
  constexpr int DH = 16 * DT, LD = row_stride<DT>(), NT = 2 * DT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sG = sQ + BM * LD;
  T* sRing = sG + BM * LD;  // stage s: k_l tile, then the ga2 tile

  const int bh = blockIdx.y, r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t lbase = (size_t)bh * m * DH;
  const T* kb = k_l + lbase;
  const T* gab = ga2 + (size_t)bh * m * m;
  const int ntiles = (m + BN - 1) / BN, nsteps = 2 * ntiles;  // two sweeps
  auto issue = [&](int step) {  // k_l and ga2 tiles of column tile step % ntiles
    if (step < nsteps) {
      T* st = sRing + (step % kStages) * stage_elems<T, DT>();
      const int c1 = (step % ntiles) * BN;
      load_rows_async<DH>(st, LD, kb, c1, BN, m);
      load_tile_async(st + BN * LD, LDP, gab, r0, c1, BM, m, m);
    }
    cp_async_commit();
  };
  load_rows_async<DH>(sQ, LD, q_l + lbase, r0, BM, m);
  load_rows_async<DH>(sG, LD, gql + lbase, r0, BM, m);
  for (int step = 0; step < kStages - 1; ++step) issue(step);  // the owned tiles join group 0

  const int row_lo = r0 + warp * 16 + g;
  const float ml2[2] = {row_lo < m ? lse[(size_t)bh * m + row_lo] * kLog2e : 0.f,
                        row_lo + 8 < m ? lse[(size_t)bh * m + row_lo + 8] * kLog2e : 0.f};
  float dot[2] = {0.f, 0.f};
  float acc[NT][4];
  zero(acc);
  AFrag<T> aq[DT];
  for (int it = 0; it < nsteps; ++it) {
    __syncthreads();  // every warp is done with the stage about to be refilled
    issue(it + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (it == 0) load_a_frags<DT>(aq, sQ + warp * 16 * LD, LD);

    const T* sK = sRing + (it % kStages) * stage_elems<T, DT>();
    const T* sGa = sK + BN * LD + warp * 16 * LDP;
    const int c0 = (it % ntiles) * BN;
    float s[8][4];
    zero(s);
    mma_nt_ra<DT, 8>(s, aq, sK, LD);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nn][e] = c0 + 8 * nn + 2 * t + (e & 1) < m
                       ? fast_exp2(fmaf(s[nn][e], kLog2e, -ml2[e / 2])) : 0.f;
    // ga2 in the accumulator's layout: ldmatrix of its 16 x 16 blocks (16-bit
    // types; 8-byte loads in float32); f[h] holds subtile 2 kk + h / 2, row
    // g + 8 (h % 2). Sweep 1 sums dot = rowsum(P ga2); sweep 2 forms dsim =
    // P ga2 - P dot in place.
    const bool sweep1 = it < ntiles;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned f[4];
      if constexpr (sizeof(T) == 2) ldsm_x4(f, sGa + (lane % 16) * LDP + 16 * kk + (lane / 16) * 8);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int nn = 2 * kk + h / 2, e = 2 * (h % 2), i = h % 2;
        float2 v;
        if constexpr (sizeof(T) == 2)
          v = Elem<T>::unpack(f[h]);
        else
          v = load2(sGa + (g + 8 * i) * LDP + 8 * nn + 2 * t);
        if (sweep1) {
          dot[i] = fmaf(s[nn][e], v.x, dot[i]);
          dot[i] = fmaf(s[nn][e + 1], v.y, dot[i]);
        } else {
          s[nn][e] = s[nn][e] * v.x - s[nn][e] * dot[i];
          s[nn][e + 1] = s[nn][e + 1] * v.y - s[nn][e + 1] * dot[i];
        }
      }
    }
    if (sweep1) {
      if (it == ntiles - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], 1);
          dot[i] += __shfl_xor_sync(0xffffffffu, dot[i], 2);
        }
        if (t == 0) {
          if (row_lo < m) dvec[(size_t)bh * m + row_lo] = dot[0];
          if (row_lo + 8 < m) dvec[(size_t)bh * m + row_lo + 8] = dot[1];
        }
      }
      continue;
    }
    mma_pv<4, NT>(acc, s, sK, LD);  // dsim rounded to T in registers: dsim k_l
  }
  write_groups<DT>(acc, sG, dq + (size_t)bh * n * DH, r0, m, n, l, pad);
}

// cols: dk. One block per 64 landmark columns of one (batch, head).
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
    landmark_bwd_cols_kernel(const T* __restrict__ q_l, const T* __restrict__ k_l,
                             const float* __restrict__ lse, const float* __restrict__ dvec,
                             const T* __restrict__ gkl, const T* __restrict__ ga2,
                             T* __restrict__ dk, int n, int m, int l, int pad) {
  constexpr int DH = 16 * DT, LD = row_stride<DT>(), NT = 2 * DT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sG = sK + BM * LD;
  T* sRing = sG + BM * LD;  // stage s: q_l tile, ga2 tile, lse and dot

  const int bh = blockIdx.y, j0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t lbase = (size_t)bh * m * DH;
  const T* qb = q_l + lbase;
  const T* gab = ga2 + (size_t)bh * m * m;
  const float* lb = lse + (size_t)bh * m;
  const float* db = dvec + (size_t)bh * m;
  auto stats = [&](T* st) { return reinterpret_cast<float*>(st + BN * LD + BN * LDP); };
  const int ntiles = (m + BN - 1) / BN;
  auto issue = [&](int step) {  // q_l, ga2, lse and dot of row tile step
    if (step < ntiles) {
      T* st = sRing + (step % kStages) * stage_elems<T, DT>();
      const int i1 = step * BN;
      load_rows_async<DH>(st, LD, qb, i1, BN, m);
      load_tile_async(st + BN * LD, LDP, gab, i1, j0, BN, m, m);
      load_vec_async(stats(st), lb, i1, m);
      load_vec_async(stats(st) + BN, db, i1, m);
    }
    cp_async_commit();
  };
  load_rows_async<DH>(sK, LD, k_l + lbase, j0, BM, m);
  load_rows_async<DH>(sG, LD, gkl + lbase, j0, BM, m);
  for (int step = 0; step < kStages - 1; ++step) issue(step);  // the owned tiles join group 0

  float acc[NT][4];
  zero(acc);
  AFrag<T> ak[DT];
  for (int it = 0; it < ntiles; ++it) {
    __syncthreads();  // every warp is done with the stage about to be refilled
    issue(it + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (it == 0) load_a_frags<DT>(ak, sK + warp * 16 * LD, LD);

    T* sQ = sRing + (it % kStages) * stage_elems<T, DT>();
    const T* sGa = sQ + BN * LD;
    const float* sL = stats(sQ);
    const float* sD = sL + BN;
    const int i0 = it * BN;
    float s[8][4];  // transposed: rows = this warp's columns j, columns = rows i
    zero(s);
    mma_nt_ra<DT, 8>(s, ak, sQ, LD);
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
      const float2 lse2 = *reinterpret_cast<const float2*>(sL + 8 * nn + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nn][e] = i0 + 8 * nn + 2 * t + (e & 1) < m
                       ? fast_exp2(fmaf(s[nn][e], kLog2e, -(e & 1 ? lse2.y : lse2.x) * kLog2e))
                       : 0.f;
    }
    // ga2^T in the accumulator's layout: ldmatrix.trans of the [i, j] tile
    // (16-bit types; 4-byte loads in float32); f[h] holds subtile 2 kk + h /
    // 2, column j = g + 8 (h % 2); dsim^T = P^T ga2^T - P^T dot_i in place
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned f[4];
      if constexpr (sizeof(T) == 2)
        ldsm_x4_t(f, sGa + (16 * kk + lane % 8 + (lane / 16) * 8) * LDP + warp * 16 +
                         ((lane / 8) % 2) * 8);
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int nn = 2 * kk + h / 2, e = 2 * (h % 2);
        float2 v;
        if constexpr (sizeof(T) == 2) {
          v = Elem<T>::unpack(f[h]);
        } else {
          const T* col = sGa + (8 * nn + 2 * t) * LDP + warp * 16 + g + 8 * (h % 2);
          v = make_float2(col[0], col[LDP]);
        }
        const float2 d = *reinterpret_cast<const float2*>(sD + 8 * nn + 2 * t);
        s[nn][e] = s[nn][e] * v.x - s[nn][e] * d.x;
        s[nn][e + 1] = s[nn][e + 1] * v.y - s[nn][e + 1] * d.y;
      }
    }
    mma_pv<4, NT>(acc, s, sQ, LD);  // dsim^T rounded to T in registers: dsim^T q_l
  }
  write_groups<DT>(acc, sG, dk + (size_t)bh * n * DH, j0, m, n, l, pad);
}

template <typename T, int DT>
cudaError_t launch_bwd(const T* q_l, const T* k_l, const float* lse, const T* gql,
                       const T* gkl, const T* ga2, T* dq, T* dk, float* dvec, int bh, int n,
                       int m, int l, int pad, cudaStream_t stream) {
  const size_t smem = bwd_smem<T, DT>();
  cudaError_t err = allow_smem(landmark_bwd_rows_kernel<T, DT>, smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(landmark_bwd_cols_kernel<T, DT>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + BM - 1) / BM, bh);
  landmark_bwd_rows_kernel<T, DT><<<grid, kThreads, smem, stream>>>(q_l, k_l, lse, gql, ga2,
                                                                     dq, dvec, n, m, l, pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  landmark_bwd_cols_kernel<T, DT><<<grid, kThreads, smem, stream>>>(q_l, k_l, lse, dvec, gkl,
                                                                     ga2, dk, n, m, l, pad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int dh, const T* q_l, const T* k_l, const float* lse, const T* gql,
                      const T* gkl, const T* ga2, T* dq, T* dk, float* dvec, int bh, int n,
                      int m, int l, int pad, cudaStream_t stream) {
  using BwdFn = cudaError_t (*)(const T*, const T*, const float*, const T*, const T*,
                                const T*, T*, T*, float*, int, int, int, int, int,
                                cudaStream_t);
  constexpr BwdFn kBwd[8] = {launch_bwd<T, 1>, launch_bwd<T, 2>, launch_bwd<T, 3>,
                             launch_bwd<T, 4>, launch_bwd<T, 5>, launch_bwd<T, 6>,
                             launch_bwd<T, 7>, launch_bwd<T, 8>};
  return kBwd[dh / 16 - 1](q_l, k_l, lse, gql, gkl, ga2, dq, dk, dvec, bh, n, m, l, pad, stream);
}

}  // namespace

// Everything of type code dtype (common.cuh's Elem) but lse and dvec (fp32).
MIRROR_EXPORT int mirror_landmark_softmax_bwd(const void* q_l, const void* k_l, const void* lse,
                                              const void* gql, const void* gkl, const void* ga2,
                                              void* dq, void* dk, void* dvec, int bh, int n,
                                              int dh, int m, int l, int pad, int dtype,
                                              cudaStream_t stream) {
  if (!landmark::bwd_shape_ok(n, dh, m, l, pad)) return (int)cudaErrorInvalidValue;
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    return launch_dh<T>(dh, static_cast<const T*>(q_l), static_cast<const T*>(k_l),
                        static_cast<const float*>(lse), static_cast<const T*>(gql),
                        static_cast<const T*>(gkl), static_cast<const T*>(ga2),
                        static_cast<T*>(dq), static_cast<T*>(dk), static_cast<float*>(dvec), bh,
                        n, m, l, pad, stream);
  });
}
