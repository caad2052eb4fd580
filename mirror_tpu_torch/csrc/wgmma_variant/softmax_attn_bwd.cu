// The wgmma variant of csrc/softmax_attn_bwd.cu (kernels 3c, 4b), kept for
// the comparison that scripts/exp_attn_wgmma.py makes on the card. It is on
// no path of the port: the shipped library does not build it. Same
// function, same C entry (mirror_softmax_attn_bwd), same two launches and 7
// products, same D = rowsum(g o) in the rows kernel's prologue, same fixed
// order of every sum (deterministic, no float atomics), same conv backward
// (conv1d.cu, kernel 9b); see the shipped source's note for all of that.
//
// What differs is the products, as in the forward variant
// (wgmma_variant/softmax_attn.cu): a block is one warpgroup owning 64 rows
// (rows kernel) or 64 columns (cols kernel); S, dP and their transposes are
// m64n64k16 with both operands from shared memory; dq += dsim k,
// dw += P^T g and dk += dsim^T q are m64n(dh)k16 with P^T or dsim (dsim^T)
// as the register A operand and the walked tile from shared memory,
// MN-major; tiles in wgmma's unswizzled core-matrix layout; each product
// issued and awaited in turn.
#include "attn_wgmma.cuh"
#include "conv1d.cuh"

namespace {

using namespace attn;

// bytes of either kernel: two owned tiles, the ring of two walked tiles a
// stage, and (cols) the walked rows' lse and D a stage
template <int DT>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(2 * BM + kStages * 2 * BN) * 16 * DT * sizeof(bf16) +
         (size_t)kStages * 2 * BN * sizeof(float);
}

// (1) rows: D, then dq. One block per 64 rows of one (batch, head).
template <int DT>
__global__ void __launch_bounds__(kThreads, 2)
    attn_bwd_rows_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ w, const bf16* __restrict__ g,
                         const float* __restrict__ lse, const bf16* __restrict__ o,
                         bf16* __restrict__ dq, float* __restrict__ dvec, int R, int C) {
  constexpr int DH = 16 * DT, NT = 2 * DT, TILE = BN * DH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sG = sQ + BM * DH;
  bf16* sRing = sG + BM * DH;  // stage s: k tile at 2 s TILE, w tile after it
  float* sStat = reinterpret_cast<float*>(sRing + kStages * 2 * TILE);  // lse, D

  const int bh = blockIdx.y, r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, t = lane % 4;
  const size_t rbase = (size_t)bh * R * DH;
  const bf16* kb = k + (size_t)bh * C * DH;
  const bf16* wb = w + (size_t)bh * C * DH;

  load_rows_async<DH>(sQ, q + rbase, r0, BM, R);
  load_rows_async<DH>(sG, g + rbase, r0, BM, R);
  load_rows_async<DH>(sRing, kb, 0, BN, C);
  load_rows_async<DH>(sRing + TILE, wb, 0, BN, C);
  cp_async_commit();

  {  // D = rowsum(g o) of the block's rows: 2 threads a row, 8 columns a step
    const int row = threadIdx.x / 2, part = threadIdx.x % 2;
    const bool ok = r0 + row < R;
    float acc = 0.f;
    if (ok) {
      const bf16* gp = g + rbase + (size_t)(r0 + row) * DH;
      const bf16* op = o + rbase + (size_t)(r0 + row) * DH;
      for (int c = 8 * part; c < DH; c += 16) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gp + c);
        const uint4 ov = *reinterpret_cast<const uint4*>(op + c);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(g2[e]), b = __bfloat1622float2(o2[e]);
          acc = fmaf(a.x, b.x, acc);
          acc = fmaf(a.y, b.y, acc);
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
  const int ntiles = (C + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // every warp is done with the stage about to be refilled
    if (j + 1 < ntiles) {
      bf16* nxt = sRing + ((j + 1) % kStages) * 2 * TILE;
      load_rows_async<DH>(nxt, kb, (j + 1) * BN, BN, C);
      load_rows_async<DH>(nxt + TILE, wb, (j + 1) * BN, BN, C);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const bf16* sK = sRing + (j % kStages) * 2 * TILE;
    const bf16* sW = sK + TILE;
    const int c0 = j * BN;
    float s[8][4], dp[8][4];
    gemm_nt<DT>(s, sQ, sK);
    gemm_nt<DT>(dp, sG, sW);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const float p = c0 + 8 * n + 2 * t + (e & 1) < C
                            ? fast_exp2((s[n][e] - lse_r[i]) * kLog2e) : 0.f;
        dp[n][e] = p * dp[n][e] - p * d_r[i];
      }
    unsigned ds[4][4];
    to_a_frags(ds, dp);
    gemm_rs<4, DT>(acc, ds, sK);
  }
  __syncthreads();  // every warp's products are done reading the q tile
  stage_bf16<DT>(sQ, acc, 1.f, 1.f);
  store_staged<DH>(dq + rbase, sQ, r0, R);
}

// (2) cols: dw and dk. One block per 64 columns of one (batch, head).
template <int DT>
__global__ void __launch_bounds__(kThreads, 2)
    attn_bwd_cols_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ w, const bf16* __restrict__ g,
                         const float* __restrict__ lse, const float* __restrict__ dvec,
                         bf16* __restrict__ dk, bf16* __restrict__ dw, int R, int C) {
  constexpr int DH = 16 * DT, NT = 2 * DT, TILE = BN * DH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sW = sK + BM * DH;
  bf16* sRing = sW + BM * DH;  // stage s: q tile at 2 s TILE, g tile after it
  float* sStat = reinterpret_cast<float*>(sRing + kStages * 2 * TILE);  // s: lse, D

  const int bh = blockIdx.y, c0 = blockIdx.x * BM;
  const int t = threadIdx.x % 4;
  const size_t cbase = (size_t)bh * C * DH;
  const bf16* qb = q + (size_t)bh * R * DH;
  const bf16* gb = g + (size_t)bh * R * DH;
  const float* lb = lse + (size_t)bh * R;
  const float* db = dvec + (size_t)bh * R;

  load_rows_async<DH>(sK, k + cbase, c0, BM, C);
  load_rows_async<DH>(sW, w + cbase, c0, BM, C);
  load_rows_async<DH>(sRing, qb, 0, BN, R);
  load_rows_async<DH>(sRing + TILE, gb, 0, BN, R);
  load_vec_async(sStat, lb, 0, R);
  load_vec_async(sStat + BN, db, 0, R);
  cp_async_commit();

  float adw[NT][4], adk[NT][4];
  zero(adw);
  zero(adk);
  const int ntiles = (R + BN - 1) / BN;
  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();
    if (j + 1 < ntiles) {
      const int s1 = (j + 1) % kStages;
      bf16* nxt = sRing + s1 * 2 * TILE;
      load_rows_async<DH>(nxt, qb, (j + 1) * BN, BN, R);
      load_rows_async<DH>(nxt + TILE, gb, (j + 1) * BN, BN, R);
      load_vec_async(sStat + s1 * 2 * BN, lb, (j + 1) * BN, R);
      load_vec_async(sStat + s1 * 2 * BN + BN, db, (j + 1) * BN, R);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const int st = j % kStages;
    const bf16* sQ = sRing + st * 2 * TILE;
    const bf16* sG = sQ + TILE;
    const float* sL = sStat + st * 2 * BN;
    const float* sD = sL + BN;
    const int r0 = j * BN;
    float s[8][4], dp[8][4];  // transposed: m = the block's columns, n = rows
    gemm_nt<DT>(s, sK, sQ);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * n + 2 * t + (e & 1);
        s[n][e] = r0 + row < R ? fast_exp2((s[n][e] - sL[row]) * kLog2e) : 0.f;
      }
    gemm_nt<DT>(dp, sW, sG);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = sD[8 * n + 2 * t + (e & 1)];
        dp[n][e] = s[n][e] * dp[n][e] - s[n][e] * d;
      }
    unsigned pa[4][4], da[4][4];
    to_a_frags(pa, s);
    to_a_frags(da, dp);
    gemm_rs<4, DT>(adw, pa, sG);
    gemm_rs<4, DT>(adk, da, sQ);
  }
  __syncthreads();  // every warp's products are done reading the k and w tiles
  stage_bf16<DT>(sW, adw, 1.f, 1.f);
  store_staged<DH>(dw + cbase, sW, c0, C);
  stage_bf16<DT>(sK, adk, 1.f, 1.f);
  store_staged<DH>(dk + cbase, sK, c0, C);
}

template <int DT>
cudaError_t launch_attn(const bf16* q, const bf16* k, const bf16* w, const bf16* g,
                        const float* lse, const bf16* o, bf16* dq, bf16* dk, bf16* dw,
                        float* dvec, int bh, int R, int C, cudaStream_t stream) {
  const size_t smem = smem_bytes<DT>();
  cudaError_t err = allow_smem(attn_bwd_rows_kernel<DT>, smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(attn_bwd_cols_kernel<DT>, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_rows_kernel<DT><<<dim3((R + BM - 1) / BM, bh), kThreads, smem, stream>>>(
      q, k, w, g, lse, o, dq, dvec, R, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_cols_kernel<DT><<<dim3((C + BM - 1) / BM, bh), kThreads, smem, stream>>>(
      q, k, w, g, lse, dvec, dk, dw, R, C);
  return cudaGetLastError();
}

using LaunchFn = cudaError_t (*)(const bf16*, const bf16*, const bf16*, const bf16*,
                                 const float*, const bf16*, bf16*, bf16*, bf16*, float*, int,
                                 int, int, cudaStream_t);
constexpr LaunchFn kLaunch[8] = {launch_attn<1>, launch_attn<2>, launch_attn<3>,
                                 launch_attn<4>, launch_attn<5>, launch_attn<6>,
                                 launch_attn<7>, launch_attn<8>};

}  // namespace

// ksize == 0: no conv (v, kern, dv, dkern and partial unused, may be null).
// lse: fp32 [bh, r] and o: bf16 [bh, r, dh], the forward's residuals (o is
// the output, or o_attn WITH_CONV); dvec: fp32 [bh, r] scratch (D, from the
// rows kernel to the cols kernel); partial: fp32 scratch of
// mirror_conv1d_bwd_partial_elems(bh, r, ksize) elements.
MIRROR_EXPORT int mirror_softmax_attn_bwd(const void* q, const void* k, const void* w,
                                          const void* v, const void* kern, const void* g,
                                          const void* lse, const void* o, void* dq, void* dk,
                                          void* dw, void* dv, void* dkern, void* dvec,
                                          void* partial, int bh, int heads, int r, int c,
                                          int dh, int ksize, cudaStream_t stream) {
  if (dh % 16 != 0 || dh < 16 || dh > 128) return (int)cudaErrorInvalidValue;
  const bf16* gp = static_cast<const bf16*>(g);
  cudaError_t err = kLaunch[dh / 16 - 1](
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(w),
      gp, static_cast<const float*>(lse), static_cast<const bf16*>(o), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dw), static_cast<float*>(dvec), bh, r, c,
      stream);
  if (err != cudaSuccess || ksize == 0) return (int)err;
  return (int)conv1d_bwd(static_cast<const bf16*>(v), static_cast<const bf16*>(kern), gp,
                         static_cast<bf16*>(dv), static_cast<float*>(dkern),
                         static_cast<float*>(partial), bh, heads, r, dh, ksize, stream);
}
