// The wgmma variant of csrc/softmax_attn.cu (kernels 3, 3b, 4), kept for
// the comparison that scripts/exp_attn_wgmma.py makes on the card. It is on
// no path of the port: the shipped library does not build it. Same
// function, same C entry (mirror_softmax_attn), same residuals (lse, and
// o_attn WITH_CONV), same refusals, same cp.async ring and softmax, the
// same banded conv product (here on wgmma too); see the shipped source's
// note for all of that.
//
// What differs is the products: a block is one warpgroup (4 warps, 64 rows
// of q), and every product is a warpgroup wgmma (attn_wgmma.cuh):
// - S = q k^T: m64n64k16 with q and k from shared memory, both K-major,
//   dh / 16 dependent steps into one accumulator;
// - O += P w: m64n(dh)k16 with P as the register A operand (S's accumulator
//   fragment packed to bf16 in place, as in the shipped kernel) and w from
//   shared memory, MN-major (w is walked along its rows, the reduction
//   axis).
// The tiles are stored in wgmma's layout without swizzle (8 x 8 core
// matrices of 128 contiguous bytes), which fits every dh the template
// takes. A swizzled layout would fit the instances that run too: the
// 128-byte atom (64 elements) divides dh 64, and the 64-byte atom (32
// elements) divides dh 96's 192-byte rows; only dh 16, 48, 80 and 112,
// which no configuration uses, would need the 32-byte atom or none.
// Each product is issued, committed and awaited before the next
// (wgmma.wait_group 0), with one warpgroup a block: no second warpgroup's
// softmax overlaps this one's products, and nothing is issued ahead. That
// is the structure the comparison measures against the shipped mma.sync
// kernel.
#include "attn_wgmma.cuh"

namespace {

using namespace attn;

// bytes: q tile, the ring (k then w tile a stage), the conv taps
template <int DT>
__host__ __device__ constexpr size_t smem_bytes(int ksize) {
  return (size_t)(BM + kStages * 2 * BN) * 16 * DT * sizeof(bf16) +
         (size_t)ksize * sizeof(float);
}

// rows of v the conv reads: the block's 64 plus K - 1, rounded up to whole
// k-steps of 16 (rows past BM + K - 1 meet zero band entries); at most the
// 2 x 64 rows of a ring stage for K up to 65
__host__ __device__ constexpr int window_rows(int ksize) {
  return 16 * ((BM + ksize - 1 + 15) / 16);
}

template <int DT, bool WITH_CONV>
__global__ void __launch_bounds__(kThreads, DT <= 6 ? 3 : 2)
    softmax_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ w, const bf16* __restrict__ v,
                        const bf16* __restrict__ kern, bf16* __restrict__ out,
                        float* __restrict__ lse, bf16* __restrict__ o_attn, int heads, int R,
                        int C, int pad, int ksize) {
  constexpr int DH = 16 * DT, NT = 2 * DT, TILE = BN * DH;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sRing = sQ + BM * DH;  // stage s: k tile at 2 s TILE, w tile after it
  float* sTap = reinterpret_cast<float*>(sRing + kStages * 2 * TILE);

  const int bh = blockIdx.y, r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bf16* kb = k + (size_t)bh * C * DH;
  const bf16* wb = w + (size_t)bh * C * DH;
  const int half = ksize / 2;

  load_rows_async<DH>(sQ, q + (size_t)bh * R * DH, r0, BM, R);
  load_rows_async<DH>(sRing, kb, 0, BN, C);
  load_rows_async<DH>(sRing + TILE, wb, 0, BN, C);
  cp_async_commit();
  if (WITH_CONV)
    for (int i = threadIdx.x; i < ksize; i += kThreads)
      sTap[i] = __bfloat162float(kern[(bh % heads) * ksize + i]);

  float o[NT][4];
  zero(o);
  // running max and sum of rows g and g + 8: the pad columns seen first
  float m[2] = {pad > 0 ? 0.f : -INFINITY, pad > 0 ? 0.f : -INFINITY};
  float l[2] = {(float)pad, (float)pad};
  const int ntiles = (C + BN - 1) / BN;

  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // every warp is done with the stage about to be refilled
    bf16* nxt = sRing + ((j + 1) % kStages) * 2 * TILE;
    if (j + 1 < ntiles) {
      load_rows_async<DH>(nxt, kb, (j + 1) * BN, BN, C);
      load_rows_async<DH>(nxt + TILE, wb, (j + 1) * BN, BN, C);
    } else if (WITH_CONV) {  // the conv's v window joins the ring
      load_rows_async<DH>(nxt, v + (size_t)bh * R * DH, r0 - half, window_rows(ksize), R);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and q) have landed
    fence_proxy_async();
    __syncthreads();

    const bf16* sK = sRing + (j % kStages) * 2 * TILE;
    const bf16* sW = sK + TILE;
    const int c0 = j * BN;
    float s[8][4];
    gemm_nt<DT>(s, sQ, sK);
    if (c0 + BN > C) {  // the ragged edge: zero-filled k rows, masked logits
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c0 + 8 * n + 2 * t + (e & 1) >= C) s[n][e] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], ml2[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = fast_exp2((m[i] - mx[i]) * kLog2e);  // 0 when m is -inf
      m[i] = mx[i];
      ml2[i] = mx[i] * kLog2e;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = fast_exp2(fmaf(s[n][e], kLog2e, -ml2[e / 2]));
        sum[e / 2] += s[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    unsigned p[4][4];
    to_a_frags(p, s);
    gemm_rs<4, DT>(o, p, sW);
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int row_lo = r0 + warp * 16 + g;
  if (lse != nullptr && t == 0) {
    if (row_lo < R) lse[(size_t)bh * R + row_lo] = m[0] + logf(l[0]);
    if (row_lo + 8 < R) lse[(size_t)bh * R + row_lo + 8] = m[1] + logf(l[1]);
  }
  __syncthreads();  // every warp's products are done reading the q tile
  const size_t base = (size_t)bh * R * DH;
  if (!WITH_CONV) {
    stage_bf16<DT>(sQ, o, inv[0], inv[1]);
    store_staged<DH>(out + base, sQ, r0, R);
    return;
  }
  if (o_attn != nullptr) {
    stage_bf16<DT>(sQ, o, inv[0], inv[1]);
    store_staged<DH>(o_attn + base, sQ, r0, R);
  }
  cp_async_wait<0>();  // the v window
  fence_proxy_async();
  __syncthreads();
  // conv = band v_window on the tensor cores, k-step by k-step over the
  // window's rows; band entry (i, j) is tap j - i (0 outside [0, K)), exact
  // in bf16 like the taps
  const bf16* sV = sRing + (ntiles % kStages) * 2 * TILE;  // window row 0: r0 - K/2
  float conv[NT][4];
  zero(conv);
  const int ksteps = window_rows(ksize) / 16;
  for (int kk = 0; kk < ksteps; ++kk) {
    unsigned band[1][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // a[e]: row g + 8 (e & 1), k 16 kk + 8 (e / 2) + 2 t
      const int tap = 16 * kk + 8 * (e / 2) + 2 * t - (warp * 16 + g + 8 * (e & 1));
      band[0][e] = pack_bf16(tap >= 0 && tap < ksize ? sTap[tap] : 0.f,
                             tap + 1 >= 0 && tap + 1 < ksize ? sTap[tap + 1] : 0.f);
    }
    gemm_rs<1, DT>(conv, band, sV + 16 * DH * kk);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], inv[e / 2], conv[n][e]);
  stage_bf16<DT>(sQ, o, 1.f, 1.f);
  store_staged<DH>(out + base, sQ, r0, R);
}

template <int DT, bool WITH_CONV>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* w, const bf16* v, const bf16* kern,
                   bf16* out, float* lse, bf16* o_attn, int bh, int heads, int R, int C,
                   int pad, int ksize, cudaStream_t stream) {
  const size_t smem = smem_bytes<DT>(WITH_CONV ? ksize : 0);
  cudaError_t err = allow_smem(softmax_attn_kernel<DT, WITH_CONV>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + BM - 1) / BM, bh);
  softmax_attn_kernel<DT, WITH_CONV><<<grid, kThreads, smem, stream>>>(
      q, k, w, v, kern, out, lse, o_attn, heads, R, C, pad, ksize);
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_dt(const bf16* q, const bf16* k, const bf16* w, const bf16* v,
                      const bf16* kern, bf16* out, float* lse, bf16* o_attn, int bh, int heads,
                      int R, int C, int pad, int ksize, cudaStream_t stream) {
  if (ksize > 0)
    return launch<DT, true>(q, k, w, v, kern, out, lse, o_attn, bh, heads, R, C, pad, ksize,
                            stream);
  return launch<DT, false>(q, k, w, v, kern, out, lse, nullptr, bh, heads, R, C, pad, 0,
                           stream);
}

using LaunchFn = cudaError_t (*)(const bf16*, const bf16*, const bf16*, const bf16*,
                                 const bf16*, bf16*, float*, bf16*, int, int, int, int, int,
                                 int, cudaStream_t);
constexpr LaunchFn kLaunch[8] = {launch_dt<1>, launch_dt<2>, launch_dt<3>, launch_dt<4>,
                                 launch_dt<5>, launch_dt<6>, launch_dt<7>, launch_dt<8>};

}  // namespace

// ksize == 0: no conv (v, kern and o_attn unused, may be null). lse (fp32
// [bh, r]) and o_attn (bf16 [bh, r, dh]) are the backward's residuals:
// null when no backward will run. dh a multiple of 16 up to 128, K odd up
// to 65 (the window must fit one ring stage of 2 x 64 rows). dtype: the
// shipped entry's type code; this variant takes bf16 (0) only.
MIRROR_EXPORT int mirror_softmax_attn(const void* q, const void* k, const void* w,
                                      const void* v, const void* kern, void* out, void* lse,
                                      void* o_attn, int bh, int heads, int r, int c, int dh,
                                      int pad, int ksize, int dtype, cudaStream_t stream) {
  if (dtype != 0 || dh % 16 != 0 || dh < 16 || dh > 128 || ksize < 0 ||
      (ksize > 0 && ksize % 2 == 0) || ksize > 65)
    return (int)cudaErrorInvalidValue;
  return (int)kLaunch[dh / 16 - 1](
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(w),
      static_cast<const bf16*>(v), static_cast<const bf16*>(kern), static_cast<bf16*>(out),
      static_cast<float*>(lse), static_cast<bf16*>(o_attn), bh, heads, r, c, pad, ksize,
      stream);
}
