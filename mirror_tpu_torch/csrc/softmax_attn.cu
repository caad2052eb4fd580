// Row softmax attention of the Nystrom attention, with an optional fused
// 33-tap depthwise residual conv (K3, K3b; WITH_CONV is K4).
//
// Replaces: mirror_tpu/ops/nystrom_pallas.py::fused_softmax_attn (forward
// pallas_call in _fwd_call; reached through softmax_matmul_landmark_kv and
// softmax_matmul_landmark_q) and ::fused_softmax_attn_conv (forward
// pallas_call in _fwd_conv_call). Both TPU kernels share one body
// (_attn_fwd_math), and so does this template.
//
// What it computes, per (batch, head): out = softmax(q k^T) w over the c
// columns plus `pad` virtual columns whose logit is 0 and whose w row is 0
// (the Nystrom front pad; _softmax_pad on the TPU), with fp32 statistics,
// P rounded to bf16 and an fp32 accumulator for P w, rounded once.
// WITH_CONV adds sum_t kern[h, t] v[i + t - K/2, :] (zero SAME padding, one
// filter per head shared across dh, no bias) to the fp32 tile before that
// rounding.
//
// Residuals for the backward (softmax_attn_bwd.cu), written only when the
// caller passes their buffers (autograd needs them; never in predict):
// - lse, fp32 [bh, r]: the row log-sum-exp m + log(l), the pad's share
//   included, so the backward rebuilds P = exp(s - lse) with no statistics
//   sweep;
// - o_attn, bf16 [bh, r, dh], WITH_CONV only: the attention part before the
//   conv is added, rounded once, from which the backward takes
//   D = rowsum(g o). Without the conv the output itself is that O.
//
// What bounds it on the H100: tensor-core operations. At the slice's shape
// (b 16, h 8, r 384, c 2117, dh 96) a call is 2 products of 2 r c dh a
// (batch, head), 40 GFLOP, and 104 M exponentials, against 2 x 52 MB of k
// and w: 0.040 ms at the bf16 peak against 0.031 ms at the HBM rate.
//
// Design (FlashAttention-2 on mma.sync): a block of 4 warps owns 64 rows of
// q, 16 a warp, and walks the columns in tiles of 64.
// - S = q k^T and O += P w run on mma.sync m16n8k16 (attn_mma.cuh) with
//   both accumulators in registers for the whole walk: S is 32 fp32 a
//   thread, O 4 dh / 8 (48 at dh 96). P never leaves registers: S's
//   accumulator fragment is P w's A operand once rounded to bf16 in place.
//   q and k tiles feed ldmatrix, w tiles ldmatrix.trans.
// - Why mma.sync and not wgmma: a measurement, not the layout. A swizzled
//   wgmma layout fits both instances that run: w (like k, g and q in the
//   backward) is walked along its rows, the reduction axis, so it is an
//   MN-major B operand whose swizzle atom must divide the tile's dh
//   extent, and the 128-byte atom (64 elements) divides dh 64, the 64-byte
//   one (32 elements) dh 96's 192-byte rows; only dh 16, 48, 80 and 112,
//   which no configuration uses, would need the 32-byte atom or none. A
//   wgmma version of this same design (csrc/wgmma_variant/: one warpgroup
//   a block, unswizzled core-matrix tiles, each product issued and awaited
//   in turn) holds the same bars at the same errors and ran 1.6-1.8x
//   slower forward and 1.1x slower backward on an H100
//   (scripts/exp_attn_wgmma.py times both builds in one call; PERF.md has
//   the numbers). What it lacks is
//   FlashAttention-3's structure (TMA, swizzled tiles, two consumer
//   warpgroups in ping-pong, the next S issued before this tile's
//   softmax): ROADMAP R2b, which starts from that variant and script.
//   ldmatrix.trans reads the MN-major tiles here from one padded,
//   unswizzled layout (row stride dh + 8 elements, conflict-free at every
//   dh).
// - The online softmax stays in registers: each thread holds 16 logits of
//   two rows; the row max and row sum take two quad shuffles each, the
//   running (max, sum) are 4 registers, O is rescaled in registers. The
//   pad's closed form costs nothing: the running max starts at 0 and the
//   sum at `pad`, as if the pad columns had been seen first.
// - k and w tiles arrive through a 2-stage cp.async ring: tile j + 1 is in
//   flight while tile j is multiplied; cp.async zero-fills the ragged edge
//   (c 2117, 2049), whose logits are then masked to -inf.
// - The conv epilogue is one more tensor-core product, the TPU kernel's
//   banded matmul: conv = band v_window, band[i, j] = kern[h, j - i] (0
//   outside the K taps; exact in bf16, as the taps are), over a window of v
//   rows in shared memory (the block's rows plus K/2 on each side). A warp
//   needs (K + 30) / 16 k-steps of 16 window rows (3 at K 33), and its fp32
//   result lands in the accumulator's own layout, so it is added to O / l
//   in registers before the one rounding. The window's load is issued into
//   the free ring stage with the last column tile, so it overlaps that
//   tile's products.
// - Output, and o_attn, are staged through the warp's own q rows (read only
//   by that warp) and written 16 bytes a lane.
// Occupancy (dh 96; ptxas -v, printed by chip_smoke.py): 146 registers a
// thread (156 with the conv), no spills, and 66.6 KB of shared memory give
// 3 blocks, 12 warps, an SM; at dh 112 and 128 two blocks.
#include "attn_mma.cuh"

namespace {

using namespace attn;

template <int DT>
__host__ __device__ constexpr int row_stride() { return 16 * DT + 8; }

// bytes: q tile, the ring (k then w tile a stage), the conv taps
template <int DT>
__host__ __device__ constexpr size_t smem_bytes(int ksize) {
  return (size_t)(BM + kStages * 2 * BN) * row_stride<DT>() * sizeof(bf16) +
         (size_t)ksize * sizeof(float);
}

// rows of v the conv reads: the block's 64 plus K - 1, rounded up so that
// every warp's whole k-steps of the band product land in the window (the
// rows past BM + K - 1 meet zero band entries); at most the 2 x 64 rows of
// a ring stage for K up to 65
__host__ __device__ constexpr int window_rows(int ksize) {
  return BM - 16 + 16 * ((ksize + 30) / 16);
}

template <int DT, bool WITH_CONV>
__global__ void __launch_bounds__(kThreads, DT <= 6 ? 3 : 2)
    softmax_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ w, const bf16* __restrict__ v,
                        const bf16* __restrict__ kern, bf16* __restrict__ out,
                        float* __restrict__ lse, bf16* __restrict__ o_attn, int heads, int R,
                        int C, int pad, int ksize) {
  constexpr int DH = 16 * DT, LD = row_stride<DT>(), NT = 2 * DT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sRing = sQ + BM * LD;  // stage s: k at s * 2 BN rows, w BN rows later
  float* sTap = reinterpret_cast<float*>(sRing + kStages * 2 * BN * LD);

  const int bh = blockIdx.y, r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const bf16* kb = k + (size_t)bh * C * DH;
  const bf16* wb = w + (size_t)bh * C * DH;
  const int half = ksize / 2;

  load_rows_async<DH>(sQ, LD, q + (size_t)bh * R * DH, r0, BM, R);
  load_rows_async<DH>(sRing, LD, kb, 0, BN, C);
  load_rows_async<DH>(sRing + BN * LD, LD, wb, 0, BN, C);
  cp_async_commit();
  if (WITH_CONV)
    for (int i = threadIdx.x; i < ksize; i += kThreads)
      sTap[i] = __bfloat162float(kern[(bh % heads) * ksize + i]);

  float o[NT][4];
  zero(o);
  // running max and sum of rows g and g + 8: the pad columns seen first
  float m[2] = {pad > 0 ? 0.f : -INFINITY, pad > 0 ? 0.f : -INFINITY};
  float l[2] = {(float)pad, (float)pad};
  const bf16* sQw = sQ + warp * 16 * LD;
  const int ntiles = (C + BN - 1) / BN;

  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // every warp is done with the stage about to be refilled
    bf16* nxt = sRing + ((j + 1) % kStages) * 2 * BN * LD;
    if (j + 1 < ntiles) {
      load_rows_async<DH>(nxt, LD, kb, (j + 1) * BN, BN, C);
      load_rows_async<DH>(nxt + BN * LD, LD, wb, (j + 1) * BN, BN, C);
    } else if (WITH_CONV) {  // the conv's v window joins the ring
      load_rows_async<DH>(nxt, LD, v + (size_t)bh * R * DH, r0 - half, window_rows(ksize), R);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and q) have landed
    __syncthreads();

    const bf16* sK = sRing + (j % kStages) * 2 * BN * LD;
    const bf16* sW = sK + BN * LD;
    const int c0 = j * BN;
    float s[8][4];
    zero(s);
    mma_nt<DT, 8>(s, sQw, sK, LD);
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
    mma_rs<4, NT>(o, p, sW, LD);
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int row_lo = r0 + warp * 16 + g;
  if (lse != nullptr && t == 0) {
    if (row_lo < R) lse[(size_t)bh * R + row_lo] = m[0] + logf(l[0]);
    if (row_lo + 8 < R) lse[(size_t)bh * R + row_lo + 8] = m[1] + logf(l[1]);
  }
  bf16* stage = sQ + warp * 16 * LD;  // this warp's q rows: only it read them
  const size_t base = (size_t)bh * R * DH;
  if (!WITH_CONV) {
    stage_bf16<NT>(stage, LD, o, inv[0], inv[1]);
    store_staged<DH>(out + base, stage, LD, r0 + warp * 16, R);
    return;
  }
  if (o_attn != nullptr) {
    stage_bf16<NT>(stage, LD, o, inv[0], inv[1]);
    store_staged<DH>(o_attn + base, stage, LD, r0 + warp * 16, R);
  }
  cp_async_wait<0>();  // the v window
  __syncthreads();
  // conv = band v_window on the tensor cores: the warp's 16 rows need window
  // rows 16 warp .. 16 warp + 15 + K - 1, ksteps steps of 16; band entry
  // (i, j) is tap j - i (0 outside [0, K)), exact in bf16 like the taps
  const bf16* sV = sRing + (ntiles % kStages) * 2 * BN * LD + warp * 16 * LD;
  const int ksteps = (ksize + 30) / 16;
  float conv[NT][4];
  zero(conv);
  for (int kk = 0; kk < ksteps; ++kk) {
    unsigned band[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // a[e]: row g + 8 (e & 1), k 16 kk + 8 (e / 2) + 2 t
      const int tap = 16 * kk + 8 * (e / 2) + 2 * t - (g + 8 * (e & 1));
      band[e] = pack_bf16(tap >= 0 && tap < ksize ? sTap[tap] : 0.f,
                          tap + 1 >= 0 && tap + 1 < ksize ? sTap[tap + 1] : 0.f);
    }
    mma_rs_step<NT>(conv, band, sV + 16 * kk * LD, LD);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], inv[e / 2], conv[n][e]);
  stage_bf16<NT>(stage, LD, o, 1.f, 1.f);
  store_staged<DH>(out + base, stage, LD, r0 + warp * 16, R);
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
// to 65 (the window must fit one ring stage of 2 x 64 rows).
MIRROR_EXPORT int mirror_softmax_attn(const void* q, const void* k, const void* w,
                                      const void* v, const void* kern, void* out, void* lse,
                                      void* o_attn, int bh, int heads, int r, int c, int dh,
                                      int pad, int ksize, cudaStream_t stream) {
  if (dh % 16 != 0 || dh < 16 || dh > 128 || ksize < 0 || (ksize > 0 && ksize % 2 == 0) ||
      ksize > 65)
    return (int)cudaErrorInvalidValue;
  return (int)kLaunch[dh / 16 - 1](
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(w),
      static_cast<const bf16*>(v), static_cast<const bf16*>(kern), static_cast<bf16*>(out),
      static_cast<float*>(lse), static_cast<bf16*>(o_attn), bh, heads, r, c, pad, ksize,
      stream);
}
