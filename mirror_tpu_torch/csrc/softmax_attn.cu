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
// P rounded to the compute type T (bf16 in the sentences below, which the
// other types follow) and an fp32 accumulator for P w, rounded once.
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
// - Any dh. A dh that is not a multiple of 16 takes the ceil(dh / 16)
//   instance: the columns past dh are zero in shared memory (no product
//   sees them) and never stored; rows that are not whole 16-byte pieces
//   (an odd dh, or dh % 8 != 0 in the 16-bit types) load and store element
//   by element (attn_mma.cuh::load_cols, store_cols). A dh above 128 runs
//   softmax_attn_wide_kernel (below): 128-column output slices over blocks.
// Occupancy (dh 96; ptxas -v, printed by chip_smoke.py): 146 registers a
// thread (156 with the conv), no spills, and 66.6 KB of shared memory give
// 3 blocks, 12 warps, an SM; at dh 112 and 128 two blocks.
// Element types (attn_mma.cuh): T is the compute type of q, k, w, v and the
// outputs, bf16, float16 or float32, the JAX kernel's `q.dtype`; the
// statistics and accumulators are fp32 in all three, and P is rounded to T
// where the bf16 instance rounds it (the identity in float32). float16 is
// bf16's design with .f16 operands. float32 runs its products in the
// 3xTF32 split (three m16n8k8 tf32 products per 8-deep step): its tiles
// take (64 + 4 x 64) (dh + 8) 4 bytes, 133,120 at dh 96, so one block an
// SM (4 warps), __launch_bounds__ asking for one; the rest is the same.
#include "attn_mma.cuh"

namespace {

using namespace attn;

template <int DT>
__host__ __device__ constexpr int row_stride() { return 16 * DT + 8; }

// bytes: q tile, the ring (k then w tile a stage), the conv taps
template <typename T, int DT>
__host__ __device__ constexpr size_t smem_bytes(int ksize) {
  return (size_t)(BM + kStages * 2 * BN) * row_stride<DT>() * sizeof(T) +
         (size_t)ksize * sizeof(float);
}

// blocks an SM at the least (__launch_bounds__): float's tiles take twice
// the shared memory, so one block (133 KB at dh 96)
template <typename T, int DT>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 4 ? 1 : (DT <= 6 ? 3 : 2);
}

// rows of v the conv reads: the block's 64 plus K - 1, rounded up so that
// every warp's whole k-steps of the band product land in the window (the
// rows past BM + K - 1 meet zero band entries); at most the 2 x 64 rows of
// a ring stage for K up to 65
__host__ __device__ constexpr int window_rows(int ksize) {
  return BM - 16 + 16 * ((ksize + 30) / 16);
}

// One column tile's step of the online softmax, for the warp's rows g and
// g + 8 (m: running max, l: running sum): the logits past the ragged edge C
// masked (zero-filled k rows), m and l updated, s turned into P (the exp2
// form) and O rescaled by exp2 of the change of max (0 while m is -inf).
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[8][4], float (&o)[NT][4],
                                               float (&m)[2], float (&l)[2], int c0, int C) {
  const int t = threadIdx.x % 4;
  if (c0 + BN > C) {
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
    alpha[i] = fast_exp2((m[i] - mx[i]) * kLog2e);
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
}

// The conv epilogue's band product: conv = band v_window for the warp's 16
// rows, its window rows at sV (stride ld), ksteps steps of 16; band entry
// (i, j) is tap j - i (0 outside [0, K)), exact in T like the taps.
template <int NT, typename T>
__device__ __forceinline__ void conv_band(float (&conv)[NT][4], const float* sTap, int ksize,
                                          const T* sV, int ld) {
  zero(conv);
  for (int kk = 0; kk < (ksize + 30) / 16; ++kk) {
    const AFrag<T> band = afrag_from<T>([&](int i, int j) {
      const int tap = 16 * kk + j - i;
      return tap >= 0 && tap < ksize ? sTap[tap] : 0.f;
    });
    mma_rs_step<NT>(conv, band, sV + 16 * kk * ld, ld);
  }
}

template <typename T, int DT, bool WITH_CONV>
__global__ void __launch_bounds__(kThreads, min_blocks<T, DT>())
    softmax_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ w, const T* __restrict__ v,
                        const T* __restrict__ kern, T* __restrict__ out,
                        float* __restrict__ lse, T* __restrict__ o_attn, int heads, int R,
                        int C, int dh, int pad, int ksize) {
  constexpr int DH = 16 * DT, LD = row_stride<DT>(), NT = 2 * DT;  // dh <= DH
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sRing = sQ + BM * LD;  // stage s: k at s * 2 BN rows, w BN rows later
  float* sTap = reinterpret_cast<float*>(sRing + kStages * 2 * BN * LD);

  const int bh = blockIdx.y, r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const T* kb = k + (size_t)bh * C * dh;
  const T* wb = w + (size_t)bh * C * dh;
  const int half = ksize / 2;

  load_cols<DH>(sQ, LD, q + (size_t)bh * R * dh, dh, 0, r0, BM, R);
  load_cols<DH>(sRing, LD, kb, dh, 0, 0, BN, C);
  load_cols<DH>(sRing + BN * LD, LD, wb, dh, 0, 0, BN, C);
  cp_async_commit();
  if (WITH_CONV)
    for (int i = threadIdx.x; i < ksize; i += kThreads)
      sTap[i] = Elem<T>::to_float(kern[(bh % heads) * ksize + i]);

  float o[NT][4];
  zero(o);
  // running max and sum of rows g and g + 8: the pad columns seen first
  float m[2] = {pad > 0 ? 0.f : -INFINITY, pad > 0 ? 0.f : -INFINITY};
  float l[2] = {(float)pad, (float)pad};
  const T* sQw = sQ + warp * 16 * LD;
  const int ntiles = (C + BN - 1) / BN;

  for (int j = 0; j < ntiles; ++j) {
    __syncthreads();  // every warp is done with the stage about to be refilled
    T* nxt = sRing + ((j + 1) % kStages) * 2 * BN * LD;
    if (j + 1 < ntiles) {
      load_cols<DH>(nxt, LD, kb, dh, 0, (j + 1) * BN, BN, C);
      load_cols<DH>(nxt + BN * LD, LD, wb, dh, 0, (j + 1) * BN, BN, C);
    } else if (WITH_CONV) {  // the conv's v window joins the ring
      load_cols<DH>(nxt, LD, v + (size_t)bh * R * dh, dh, 0, r0 - half, window_rows(ksize), R);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and q) have landed
    __syncthreads();

    const T* sK = sRing + (j % kStages) * 2 * BN * LD;
    const T* sW = sK + BN * LD;
    const int c0 = j * BN;
    float s[8][4];
    zero(s);
    mma_nt<DT, 8>(s, sQw, sK, LD);
    online_softmax(s, o, m, l, c0, C);
    mma_pv<4, NT>(o, s, sW, LD);  // P rounded to T in registers
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int row_lo = r0 + warp * 16 + g;
  if (lse != nullptr && t == 0) {
    if (row_lo < R) lse[(size_t)bh * R + row_lo] = m[0] + logf(l[0]);
    if (row_lo + 8 < R) lse[(size_t)bh * R + row_lo + 8] = m[1] + logf(l[1]);
  }
  T* stage = sQ + warp * 16 * LD;  // this warp's q rows: only it read them
  const size_t base = (size_t)bh * R * dh;
  if (!WITH_CONV) {
    stage_rows<NT>(stage, LD, o, inv[0], inv[1]);
    store_cols<DH>(out + base, stage, LD, r0 + warp * 16, R, dh, 0);
    return;
  }
  if (o_attn != nullptr) {
    stage_rows<NT>(stage, LD, o, inv[0], inv[1]);
    store_cols<DH>(o_attn + base, stage, LD, r0 + warp * 16, R, dh, 0);
  }
  cp_async_wait<0>();  // the v window
  __syncthreads();
  // conv = band v_window on the tensor cores: the warp's 16 rows need window
  // rows 16 warp .. 16 warp + 15 + K - 1
  float conv[NT][4];
  conv_band<NT>(conv, sTap, ksize, sRing + (ntiles % kStages) * 2 * BN * LD + warp * 16 * LD,
                LD);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], inv[e / 2], conv[n][e]);
  stage_rows<NT>(stage, LD, o, 1.f, 1.f);
  store_cols<DH>(out + base, stage, LD, r0 + warp * 16, R, dh, 0);
}

// ---- dh above 128: the output's dh split over blocks ----
//
// A block owns 64 rows of q and one slice of at most WD output columns (the
// grid's z). It walks the column tiles as the kernel above does, but S =
// q k^T is summed over chunks of WD columns of dh: each ring step holds a
// q chunk and a k chunk (the q rows are streamed again for every column
// tile, from L2), and one more step a tile holds the slice's columns of w.
// Every slice recomputes S and its online softmax, so the statistics (and
// lse, written by slice 0) are the same in each; O is the slice's columns
// only, so the register plan is the DT = 8 instance's at every dh. The conv
// epilogue convolves the block's slice of v.
constexpr int WD = 128;               // columns of a dh chunk and of an output slice
constexpr int WLD = WD + 8;           // their row stride
constexpr int WSTAGE = 2 * BN * WLD;  // a stage: a q and a k chunk, a w slice or the v window

template <typename T>
__host__ __device__ constexpr size_t wide_smem_bytes(int ksize) {
  return (size_t)kStages * WSTAGE * sizeof(T) + (size_t)ksize * sizeof(float);
}

template <typename T, bool WITH_CONV>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 1 : 2)
    softmax_attn_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ w, const T* __restrict__ v,
                             const T* __restrict__ kern, T* __restrict__ out,
                             float* __restrict__ lse, T* __restrict__ o_attn, int heads, int R,
                             int C, int dh, int pad, int ksize) {
  constexpr int NT = WD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sRing = reinterpret_cast<T*>(smem);
  float* sTap = reinterpret_cast<float*>(sRing + kStages * WSTAGE);

  const int bh = blockIdx.y, r0 = blockIdx.x * BM, col0 = blockIdx.z * WD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int chunks = (dh + WD - 1) / WD, per = chunks + 1;  // ring steps a column tile
  const int ntiles = (C + BN - 1) / BN, nsteps = ntiles * per;
  const int pairs = (min(WD, dh - col0) + 15) / 16;  // the slice's live n-tile pairs
  const int half = ksize / 2;
  const T* qb = q + (size_t)bh * R * dh;
  const T* kb = k + (size_t)bh * C * dh;
  const T* wb = w + (size_t)bh * C * dh;
  auto issue = [&](int st) {  // step st into ring stage st % kStages
    T* dst = sRing + (st % kStages) * WSTAGE;
    if (st < nsteps) {
      const int j = st / per, u = st % per;
      if (u < chunks) {
        load_cols<WD>(dst, WLD, qb, dh, u * WD, r0, BM, R);
        load_cols<WD>(dst + BM * WLD, WLD, kb, dh, u * WD, j * BN, BN, C);
      } else {
        load_cols<WD>(dst, WLD, wb, dh, col0, j * BN, BN, C);
      }
    } else if (WITH_CONV && st == nsteps) {  // the conv's v window joins the ring
      load_cols<WD>(dst, WLD, v + (size_t)bh * R * dh, dh, col0, r0 - half, window_rows(ksize),
                    R);
    }
    cp_async_commit();
  };
  issue(0);
  if (WITH_CONV)
    for (int i = threadIdx.x; i < ksize; i += kThreads)
      sTap[i] = Elem<T>::to_float(kern[(bh % heads) * ksize + i]);

  float o[NT][4], s[8][4];
  zero(o);
  zero(s);
  float m[2] = {pad > 0 ? 0.f : -INFINITY, pad > 0 ? 0.f : -INFINITY};
  float l[2] = {(float)pad, (float)pad};
  for (int st = 0; st < nsteps; ++st) {
    __syncthreads();  // every warp is done with the stage about to be refilled
    issue(st + 1);
    cp_async_wait<1>();  // step st has landed
    __syncthreads();
    const T* sA = sRing + (st % kStages) * WSTAGE;
    const int j = st / per, u = st % per;
    if (u == chunks) {  // P w over the slice's columns
      mma_pv_nt<4, NT>(o, s, sA, WLD, pairs);
      continue;
    }
    if (u == 0) zero(s);
    mma_nt_kt<WD / 16, 8>(s, sA + warp * 16 * WLD, sA + BM * WLD, WLD,
                          (min(WD, dh - u * WD) + 15) / 16);
    if (u + 1 < chunks) continue;
    online_softmax(s, o, m, l, j * BN, C);  // S is whole: P in s
  }

  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const int row_lo = r0 + warp * 16 + g;
  if (lse != nullptr && blockIdx.z == 0 && t == 0) {
    if (row_lo < R) lse[(size_t)bh * R + row_lo] = m[0] + logf(l[0]);
    if (row_lo + 8 < R) lse[(size_t)bh * R + row_lo + 8] = m[1] + logf(l[1]);
  }
  __syncthreads();  // every warp is done with the last w slice: its stage stages the output
  T* stage = sRing + ((nsteps - 1) % kStages) * WSTAGE + warp * 16 * WLD;
  const size_t base = (size_t)bh * R * dh;
  if (!WITH_CONV || o_attn != nullptr) {
    stage_rows<NT>(stage, WLD, o, inv[0], inv[1]);
    store_cols<WD>((WITH_CONV ? o_attn : out) + base, stage, WLD, r0 + warp * 16, R, dh, col0);
    if (!WITH_CONV) return;
  }
  cp_async_wait<0>();  // the v window
  __syncthreads();
  float conv[NT][4];
  conv_band<NT>(conv, sTap, ksize, sRing + (nsteps % kStages) * WSTAGE + warp * 16 * WLD, WLD);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], inv[e / 2], conv[n][e]);
  stage_rows<NT>(stage, WLD, o, 1.f, 1.f);
  store_cols<WD>(out + base, stage, WLD, r0 + warp * 16, R, dh, col0);
}

template <typename T, int DT, bool WITH_CONV>
cudaError_t launch(const T* q, const T* k, const T* w, const T* v, const T* kern, T* out,
                   float* lse, T* o_attn, int bh, int heads, int R, int C, int dh, int pad,
                   int ksize, cudaStream_t stream) {
  if constexpr (DT == 0) {  // dh above 128
    const size_t smem = wide_smem_bytes<T>(WITH_CONV ? ksize : 0);
    cudaError_t err = allow_smem(softmax_attn_wide_kernel<T, WITH_CONV>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((R + BM - 1) / BM, bh, (dh + WD - 1) / WD);
    softmax_attn_wide_kernel<T, WITH_CONV><<<grid, kThreads, smem, stream>>>(
        q, k, w, v, kern, out, lse, o_attn, heads, R, C, dh, pad, ksize);
  } else {
    const size_t smem = smem_bytes<T, DT>(WITH_CONV ? ksize : 0);
    cudaError_t err = allow_smem(softmax_attn_kernel<T, DT, WITH_CONV>, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((R + BM - 1) / BM, bh);
    softmax_attn_kernel<T, DT, WITH_CONV><<<grid, kThreads, smem, stream>>>(
        q, k, w, v, kern, out, lse, o_attn, heads, R, C, dh, pad, ksize);
  }
  return cudaGetLastError();
}

template <typename T, int DT>
cudaError_t launch_dt(const void* q, const void* k, const void* w, const void* v,
                      const void* kern, void* out, float* lse, void* o_attn, int bh, int heads,
                      int R, int C, int dh, int pad, int ksize, cudaStream_t stream) {
  auto in = [](const void* p) { return static_cast<const T*>(p); };
  if (ksize > 0)
    return launch<T, DT, true>(in(q), in(k), in(w), in(v), in(kern), static_cast<T*>(out), lse,
                               static_cast<T*>(o_attn), bh, heads, R, C, dh, pad, ksize,
                               stream);
  return launch<T, DT, false>(in(q), in(k), in(w), nullptr, nullptr, static_cast<T*>(out), lse,
                              nullptr, bh, heads, R, C, dh, pad, 0, stream);
}

using LaunchFn = cudaError_t (*)(const void*, const void*, const void*, const void*,
                                 const void*, void*, float*, void*, int, int, int, int, int,
                                 int, int, cudaStream_t);
// by ceil(dh / 16): the DT instance (a ragged dh zero-fills its last k
// step); index 8, any dh above 128, the wide kernel
template <typename T>
constexpr LaunchFn kLaunch[9] = {launch_dt<T, 1>, launch_dt<T, 2>, launch_dt<T, 3>,
                                 launch_dt<T, 4>, launch_dt<T, 5>, launch_dt<T, 6>,
                                 launch_dt<T, 7>, launch_dt<T, 8>, launch_dt<T, 0>};

}  // namespace

// ksize == 0: no conv (v, kern and o_attn unused, may be null). lse (fp32
// [bh, r]) and o_attn ([bh, r, dh]) are the backward's residuals: null when
// no backward will run. Any dh >= 1 (up to 128 one block a 64-row tile,
// above it one a tile and 128-column slice of the output), K odd up to 65
// (the window must fit one ring stage of 2 x 64 rows). dtype: the type code
// of q, k, w, v, kern, out and o_attn (common.cuh's Elem: 0 bf16, 1 float16,
// 2 float32).
MIRROR_EXPORT int mirror_softmax_attn(const void* q, const void* k, const void* w,
                                      const void* v, const void* kern, void* out, void* lse,
                                      void* o_attn, int bh, int heads, int r, int c, int dh,
                                      int pad, int ksize, int dtype, cudaStream_t stream) {
  if (dh < 1 || ksize < 0 || (ksize > 0 && ksize % 2 == 0) || ksize > 65)
    return (int)cudaErrorInvalidValue;
  const int idx = dh > 128 ? 8 : (dh + 15) / 16 - 1;
  return (int)by_type(dtype, [&](auto e) {
    using T = decltype(e);
    return kLaunch<T>[idx](q, k, w, v, kern, out, static_cast<float*>(lse), o_attn, bh, heads,
                           r, c, dh, pad, ksize, stream);
  });
}
