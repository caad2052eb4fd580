// Backward of the row softmax attention of the Nystrom attention (K3c), with
// the fused 33-tap residual conv's backward (WITH_CONV, K4b).
//
// Replaces: mirror_tpu/ops/nystrom_pallas.py::fused_softmax_attn's backward
// pallas_call (_bwd_call, reached through softmax_matmul_landmark_kv) and
// ::fused_softmax_attn_conv's backward pallas_call (_bwd_conv_call). Both
// TPU kernels share _attn_bwd_math, and so do the two kernels here.
//
// What it computes, per (batch, head), with P = exp(s - lse), s = q k^T,
// and lse the forward's row log-sum-exp (softmax_attn.cu; the `pad`
// virtual columns of logit 0 are in it, and their w rows are 0):
//   dw   = bf16(P)^T g                          (fp32 sum, rounded)
//   dsim = bf16(P * (g w^T) - P * D),  D = rowsum(g * O)
//   dq   = dsim k,   dk = dsim^T q              (fp32 sums, rounded)
// with O the forward's attention output in bf16 (the output itself, or
// o_attn before the conv WITH_CONV). The JAX kernel takes D = rowsum(P *
// (g w^T)) from fp32 values; since O = P w, the two are equal in real
// arithmetic and differ only by the bf16 rounding of P inside O and of O
// itself (about 2^-8 relative on D, so on the dsim term P * D). WITH_CONV
// then runs the standalone conv's backward (conv1d.cu, kernel 9b, through
// conv1d.cuh) unchanged: dv from a window of g, dkern from fixed-order
// partials per (batch, row tile) and tap.
//
// What bounds it on the H100: tensor-core operations. The function needs
// 5 products of 2 r c dh a (batch, head) (S, g w^T, dw, dq, dk): 100 GFLOP
// at the slice's shape (b 16, h 8, r 384, c 2117, dh 96), 0.101 ms at the
// bf16 peak; these kernels run 7 (S and g w^T twice) = 140 GFLOP.
//
// Design (FlashAttention-2's backward on mma.sync, attn_mma.cuh; the
// forward's note says why not wgmma), two launches, 7 products, no float
// atomics, no statistics sweep:
// (1) rows: a block of 4 warps owns 64 rows of q and g, 16 a warp. Its
//     prologue computes D for its rows from g and O (2 threads a row, a
//     fixed order) and writes it for (2). It walks the column tiles of k
//     and w through a 2-stage cp.async ring: S = q k^T and dP = g w^T in
//     registers (32 fp32 each a thread), P from lse, dsim rounded to bf16
//     in place as the A operand of dq += dsim k (3 products; dq's 16 x dh
//     fp32 accumulator stays in registers for the whole walk).
// (2) cols: a block owns 64 columns of k and w, 16 a warp, and walks the
//     row tiles of q and g with their lse and D through the ring. It forms
//     the transposes directly, S^T = k q^T and dP^T = w g^T, so that P^T
//     and dsim^T are accumulator fragments of the warp's own columns and
//     serve, rounded to bf16 in registers, as the A operands of dw += P^T g
//     and dk += dsim^T q (4 products; dw and dk accumulate in registers).
// Neither P nor dsim goes through shared memory. Every sum is taken inside
// one block in a fixed order (the row tiles, or the column tiles, in
// sequence; the mma steps in sequence), so two runs on the same inputs give
// the same bits. S and dP are computed twice (once in each kernel) rather
// than stashed: a 5-product design would need dsim and P in device memory
// (2 x bh r c bf16, 0.8 GB at the slice's shape) or a reduction across
// blocks.
// Occupancy (dh 96; ptxas -v, printed by chip_smoke.py): 186 registers a
// thread in the rows kernel and 240 in the cols kernel, no spills, and
// about 81 KB of shared memory a block give 2 blocks, 8 warps, an SM.
// Element types: as the forward (softmax_attn.cu), T is the compute type,
// bf16 in the sentences above; P^T, dsim and dsim^T are rounded to T where
// the bf16 instance rounds them, and float32's products are 3xTF32. Its
// tiles take 161 KB at dh 96, one block an SM.
#include "attn_mma.cuh"
#include "conv1d.cuh"

namespace {

using namespace attn;

template <int DT>
__host__ __device__ constexpr int row_stride() { return 16 * DT + 8; }

// bytes of either kernel: two owned tiles, the ring of two walked tiles a
// stage, and (cols) the walked rows' lse and D a stage
template <typename T, int DT>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(2 * BM + kStages * 2 * BN) * row_stride<DT>() * sizeof(T) +
         (size_t)kStages * 2 * BN * sizeof(float);
}

// blocks an SM at the least: float's tiles (161 KB at dh 96) leave room for one
template <typename T>
__host__ __device__ constexpr int min_blocks() { return sizeof(T) == 4 ? 1 : 2; }

// (1) rows: D, then dq. One block per 64 rows of one (batch, head).
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
    attn_bwd_rows_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ w, const T* __restrict__ g,
                         const float* __restrict__ lse, const T* __restrict__ o,
                         T* __restrict__ dq, float* __restrict__ dvec, int R, int C) {
  constexpr int DH = 16 * DT, LD = row_stride<DT>(), NT = 2 * DT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sG = sQ + BM * LD;
  T* sRing = sG + BM * LD;  // stage s: k at s * 2 BN rows, w BN rows later
  float* sStat = reinterpret_cast<float*>(sRing + kStages * 2 * BN * LD);  // lse, D

  const int bh = blockIdx.y, r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const size_t rbase = (size_t)bh * R * DH;
  const T* kb = k + (size_t)bh * C * DH;
  const T* wb = w + (size_t)bh * C * DH;

  load_rows_async<DH>(sQ, LD, q + rbase, r0, BM, R);
  load_rows_async<DH>(sG, LD, g + rbase, r0, BM, R);
  load_rows_async<DH>(sRing, LD, kb, 0, BN, C);
  load_rows_async<DH>(sRing + BN * LD, LD, wb, 0, BN, C);
  cp_async_commit();

  {  // D = rowsum(g o) of the block's rows: 2 threads a row, 8 columns a step
    const int row = threadIdx.x / 2, part = threadIdx.x % 2;
    const bool ok = r0 + row < R;
    float acc = 0.f;
    if (ok) {
      const T* gp = g + rbase + (size_t)(r0 + row) * DH;
      const T* op = o + rbase + (size_t)(r0 + row) * DH;
      for (int c = 8 * part; c < DH; c += 16) {
        if constexpr (sizeof(T) == 2) {  // 16 bytes of each
          const uint4 gv = *reinterpret_cast<const uint4*>(gp + c);
          const uint4 ov = *reinterpret_cast<const uint4*>(op + c);
          const unsigned* g2 = reinterpret_cast<const unsigned*>(&gv);
          const unsigned* o2 = reinterpret_cast<const unsigned*>(&ov);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = Elem<T>::unpack(g2[e]), b = Elem<T>::unpack(o2[e]);
            acc = fmaf(a.x, b.x, acc);
            acc = fmaf(a.y, b.y, acc);
          }
        } else {  // the same 8 columns, in the same order
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = load2(gp + c + 2 * e), b = load2(op + c + 2 * e);
            acc = fmaf(a.x, b.x, acc);
            acc = fmaf(a.y, b.y, acc);
          }
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) {
      sStat[row] = ok ? lse[(size_t)bh * R + r0 + row] : 0.f;
      sStat[BM + row] = acc;
      if (ok) dvec[(size_t)bh * R + r0 + row] = acc;
    }
  }
  __syncthreads();
  const int rl = warp * 16 + gid;  // this thread's rows: rl and rl + 8
  const float lse_r[2] = {sStat[rl], sStat[rl + 8]};
  const float d_r[2] = {sStat[BM + rl], sStat[BM + rl + 8]};

  float acc[NT][4];
  zero(acc);
  const T* sQw = sQ + warp * 16 * LD;
  const T* sGw = sG + warp * 16 * LD;
  const int ntiles = (C + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // every warp is done with the stage about to be refilled
    if (j + 1 < ntiles) {
      T* nxt = sRing + ((j + 1) % kStages) * 2 * BN * LD;
      load_rows_async<DH>(nxt, LD, kb, (j + 1) * BN, BN, C);
      load_rows_async<DH>(nxt + BN * LD, LD, wb, (j + 1) * BN, BN, C);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const T* sK = sRing + (j % kStages) * 2 * BN * LD;
    const T* sW = sK + BN * LD;
    const int c0 = j * BN;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_nt<DT, 8>(s, sQw, sK, LD);
    mma_nt<DT, 8>(dp, sGw, sW, LD);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const float p = c0 + 8 * n + 2 * t + (e & 1) < C
                            ? fast_exp2((s[n][e] - lse_r[i]) * kLog2e) : 0.f;
        dp[n][e] = p * dp[n][e] - p * d_r[i];
      }
    mma_pv<4, NT>(acc, dp, sK, LD);  // dsim rounded to T in registers
  }
  T* stage = sQ + warp * 16 * LD;  // this warp's q rows: only it read them
  stage_rows<NT>(stage, LD, acc, 1.f, 1.f);
  store_staged<DH>(dq + rbase, stage, LD, r0 + warp * 16, R);
}

// (2) cols: dw and dk. One block per 64 columns of one (batch, head).
template <typename T, int DT>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
    attn_bwd_cols_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ w, const T* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         T* __restrict__ dk, T* __restrict__ dw, int R, int C) {
  constexpr int DH = 16 * DT, LD = row_stride<DT>(), NT = 2 * DT;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sW = sK + BM * LD;
  T* sRing = sW + BM * LD;  // stage s: q at s * 2 BN rows, g BN rows later
  float* sStat = reinterpret_cast<float*>(sRing + kStages * 2 * BN * LD);  // s: lse, D

  const int bh = blockIdx.y, c0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const size_t cbase = (size_t)bh * C * DH;
  const T* qb = q + (size_t)bh * R * DH;
  const T* gb = g + (size_t)bh * R * DH;
  const float* lb = lse + (size_t)bh * R;
  const float* db = dvec + (size_t)bh * R;

  load_rows_async<DH>(sK, LD, k + cbase, c0, BM, C);
  load_rows_async<DH>(sW, LD, w + cbase, c0, BM, C);
  load_rows_async<DH>(sRing, LD, qb, 0, BN, R);
  load_rows_async<DH>(sRing + BN * LD, LD, gb, 0, BN, R);
  load_vec_async(sStat, lb, 0, R);
  load_vec_async(sStat + BN, db, 0, R);
  cp_async_commit();

  float adw[NT][4], adk[NT][4];
  zero(adw);
  zero(adk);
  const T* sKw = sK + warp * 16 * LD;
  const T* sWw = sW + warp * 16 * LD;
  const int ntiles = (R + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();
    if (j + 1 < ntiles) {
      const int s1 = (j + 1) % kStages;
      T* nxt = sRing + s1 * 2 * BN * LD;
      load_rows_async<DH>(nxt, LD, qb, (j + 1) * BN, BN, R);
      load_rows_async<DH>(nxt + BN * LD, LD, gb, (j + 1) * BN, BN, R);
      load_vec_async(sStat + s1 * 2 * BN, lb, (j + 1) * BN, R);
      load_vec_async(sStat + s1 * 2 * BN + BN, db, (j + 1) * BN, R);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int st = j % kStages;
    const T* sQ = sRing + st * 2 * BN * LD;
    const T* sG = sQ + BN * LD;
    const float* sL = sStat + st * 2 * BN;
    const float* sD = sL + BN;
    const int r0 = j * BN;
    float s[8][4], dp[8][4];  // transposed: m = this warp's columns, n = rows
    zero(s);
    zero(dp);
    mma_nt<DT, 8>(s, sKw, sQ, LD);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * n + 2 * t + (e & 1);
        s[n][e] = r0 + row < R ? fast_exp2((s[n][e] - sL[row]) * kLog2e) : 0.f;
      }
    mma_nt<DT, 8>(dp, sWw, sG, LD);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = sD[8 * n + 2 * t + (e & 1)];
        dp[n][e] = s[n][e] * dp[n][e] - s[n][e] * d;
      }
    mma_pv<4, NT>(adw, s, sG, LD);  // P^T and dsim^T rounded to T in registers
    mma_pv<4, NT>(adk, dp, sQ, LD);
  }
  // this warp's k and w rows: only it read them
  T* stage_w = sW + warp * 16 * LD;
  T* stage_k = sK + warp * 16 * LD;
  stage_rows<NT>(stage_w, LD, adw, 1.f, 1.f);
  store_staged<DH>(dw + cbase, stage_w, LD, c0 + warp * 16, C);
  stage_rows<NT>(stage_k, LD, adk, 1.f, 1.f);
  store_staged<DH>(dk + cbase, stage_k, LD, c0 + warp * 16, C);
}

template <typename T, int DT>
cudaError_t launch_attn(const T* q, const T* k, const T* w, const T* g, const float* lse,
                        const T* o, T* dq, T* dk, T* dw, float* dvec, int bh, int R, int C,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes<T, DT>();
  cudaError_t err = allow_smem(attn_bwd_rows_kernel<T, DT>, smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_cols_kernel<T, DT>, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_rows_kernel<T, DT><<<dim3((R + BM - 1) / BM, bh), kThreads, smem, stream>>>(
      q, k, w, g, lse, o, dq, dvec, R, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_cols_kernel<T, DT><<<dim3((C + BM - 1) / BM, bh), kThreads, smem, stream>>>(
      q, k, w, g, lse, dvec, dk, dw, R, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const void* q, const void* k, const void* w, const void* v,
                       const void* kern, const void* g, const float* lse, const void* o,
                       void* dq, void* dk, void* dw, void* dv, float* dkern, float* dvec,
                       float* partial, int bh, int heads, int r, int c, int dh, int ksize,
                       cudaStream_t stream) {
  using LaunchFn = cudaError_t (*)(const T*, const T*, const T*, const T*, const float*,
                                   const T*, T*, T*, T*, float*, int, int, int, cudaStream_t);
  constexpr LaunchFn kLaunch[8] = {launch_attn<T, 1>, launch_attn<T, 2>, launch_attn<T, 3>,
                                   launch_attn<T, 4>, launch_attn<T, 5>, launch_attn<T, 6>,
                                   launch_attn<T, 7>, launch_attn<T, 8>};
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  auto out = [](void* p) { return static_cast<T*>(p); };
  cudaError_t err = kLaunch[dh / 16 - 1](in(q), in(k), in(w), in(g), lse, in(o), out(dq),
                                         out(dk), out(dw), dvec, bh, r, c, stream);
  if (err != cudaSuccess || ksize == 0) return err;
  return conv1d_bwd<T>(in(v), in(kern), in(g), out(dv), dkern, partial, bh, heads, r, dh, ksize,
                       stream);
}

}  // namespace

// ksize == 0: no conv (v, kern, dv, dkern and partial unused, may be null).
// lse: fp32 [bh, r] and o: [bh, r, dh], the forward's residuals (o is the
// output, or o_attn WITH_CONV); dvec: fp32 [bh, r] scratch (D, from the
// rows kernel to the cols kernel); partial: fp32 scratch of
// mirror_conv1d_bwd_partial_elems(bh, r, dh, ksize, dtype) elements. dtype:
// the type code of q, k, w, v, kern, g, o and the gradients but dkern
// (fp32), as mirror_softmax_attn takes it.
MIRROR_EXPORT int mirror_softmax_attn_bwd(const void* q, const void* k, const void* w,
                                          const void* v, const void* kern, const void* g,
                                          const void* lse, const void* o, void* dq, void* dk,
                                          void* dw, void* dv, void* dkern, void* dvec,
                                          void* partial, int bh, int heads, int r, int c,
                                          int dh, int ksize, int dtype, cudaStream_t stream) {
  if (dh % 16 != 0 || dh < 16 || dh > 128) return (int)cudaErrorInvalidValue;
  return (int)by_type(dtype, [&](auto e) {
    return launch_all<decltype(e)>(q, k, w, v, kern, g, static_cast<const float*>(lse), o, dq,
                                   dk, dw, dv, static_cast<float*>(dkern),
                                   static_cast<float*>(dvec), static_cast<float*>(partial), bh,
                                   heads, r, c, dh, ksize, stream);
  });
}
