// One ViT sub-layer in one launch: the fused kernels of the TPU probe
// scripts/exp_vit_fused_sublayer.py.
//
// Replaces (each builder's pallas_call):
// - make_k5 :101 (:111, body _k5_kernel :78): o = MHA(y W_qkv + b_qkv) W_o + b_o;
// - make_k7 :157 (:167, body _k7_kernel :146): o = GELU_erf(y W_1 + b_1) W_2 + b_2;
// - make_k8 :246 (:256, body _k8_kernel :218): x + k5(LN(x));
// - make_k9 :290 (:300, body _k9_kernel :274): x + k7(LN(x)).
// All bf16 in and out, fp32 LN scale/shift and biases, fp32 sums, rounded
// at the TPU kernels' points: y = LN(x) once; q|k|v after the fp32 bias
// add; the probabilities before P v; each head's output; the GELU hidden
// (GELU in fp32) before fc2; the output once, the residual added in fp32.
// The GELU uses erff where the TPU kernel has the A&S 7.1.26 polynomial
// (|error| <= 1.5e-7, far below a bf16 ulp of the hidden, 2^-8 relative).
//
// What bounds them on the H100: tensor-core operations. At the probe's
// B 512 (n 197, d 768, 12 heads of 64, MLP 3072): k5 and k8 do 5.37e11 FLOP
// of products (0.543 ms at 989 TFLOP/s) against 0.31 GB of device memory
// (0.094 ms at 3.35 TB/s); k7 and k9 9.52e11 FLOP (0.963 ms).
//
// Design. The TPU programs keep the weights resident in VMEM (3.5 MB of
// W_qkv, 4.7 MB of W_1 + W_2) and every intermediate on chip; a Hopper
// block has 227 KB. Here the weights stream through shared memory from L2
// and no intermediate (q|k|v, the head outputs, y, the GELU hidden) ever
// reaches device memory: the wrappers allocate only the output.
//
// MLP (k7, k9): WMMA 16x16x16 bf16 with fp32 accumulators, 8 warps a block,
// row-wise, so no cluster. A block owns G images (G n rows
// of the flattened [b n, d] stream) and walks them in tiles of 32 rows:
// the tile (LN'd once per tile for k9) sits in shared memory, and the
// hidden dim goes by in chunks of 64: h_c = GELU(y W_1[:, c] + b_1[c]) into
// shared memory as bf16, then acc[32, d] += h_c W_2[c, :], the accumulator
// in registers (each warp 96 columns: 96 fp32 a thread, so d <= 768). Bias
// and residual in the epilogue. The weights come as 27 KB tiles through a
// 4-stage cp.async ring: four [192, 64] tiles of W_1 and four [16, d] tiles
// of W_2 per chunk, 12 products a warp each. Cost of the design: every
// 32-row tile reads all 9.4 MB of W_1 and W_2 from L2, so at B 512 L2
// carries 100864 / 32 x 9.4 MB = 30 GB (about 5.5 ms at 5.5 TB/s): more
// rows a tile would cut it, but their accumulator no longer fits in
// registers. Measured (H100 SXM, B 512; scripts/vit_fused_phases.py of
// PR 7): bound by its WMMA products at one block of 8 warps a SM (about 100
// FMA a clock a SM, a tenth of the tensor cores' rate), not by L2 (k7
// without its weight loads kept 58 % of its time).
//
// Attention (k5, k8): a head needs all n rows of its image, and the out
// product all heads, so one thread block cluster an image; CTA r of the
// cluster owns hpc heads and the output columns [r hpc dh, (r + 1) hpc dh):
// two heads where they pair up and fit (6-CTA clusters at 12 heads, 17 at
// once on the H100, 102 SMs busy), else one (12-CTA clusters, 7 at once);
// the shape picks it (heads_per_cta). Two warpgroups, 8 warps, one CTA a
// SM; thread 0 also feeds a ring of 40 KB stages in shared memory by TMA
// (128-byte swizzle, counted in by "full" mbarriers, handed back by one
// arrival a warp on "empty" ones), 1 or 2 stages ahead of the consumers (2
// or 3 stages fit beside q, k, v), across phases and images. Its feed walks
// a cursor kept in shared memory (RingCursor): the feed is on the critical
// path of thread 0's warpgroup, and recomputing the position from its index
// (a dozen integer divisions a stage) cost more than the TMA wait. Per image:
// - LN statistics (k8): CTA r of a cluster of cs takes rows r, r + cs, ...
//   and, past a cluster barrier, reads the others' from their CTAs
//   (distributed shared memory).
// - Phase 1, a head at a time: q | k | v = bf16(y W_qkv[:, the head's
//   columns] + b) in passes of 128 rows (a warpgroup an m64 tile) x three
//   [64, 64] boxes of W_qkv (one pass at dh <= 64, two at dh > 64; boxes
//   past dh carry other heads' columns, dropped), K in steps of 64: a stage
//   is x [128, 64] (a 3-D map [b, n, d], so rows past n land as zeros) and
//   the three boxes, read by wgmma m64n192k16 with both operands in shared
//   memory (W MN-major in the JAX [in, out] layout, as csrc/vit_gemm.cu
//   reads it). k8 applies the LN affine to the landed x tile in place, a
//   warpgroup its own 64 rows (chunk p of row r of the swizzled box is
//   chunk p ^ r % 8 of the row), then fence.proxy.async before wgmma reads
//   it. The epilogue adds the bias in fp32 and writes q, k, v in bf16 (rows
//   past n zeros) at a row stride of dh + 8.
// - Phase 2: each warp takes 16-query tiles through attn_mma.cuh's
//   attend_rows_two_pass (kernel 8's body in two passes over 16-key tiles:
//   S and P in registers, the exact softmax, bf16 P; kernel 8's one pass
//   holds 128 fp32 scores a thread, which this kernel's other live state
//   pushed into spills) and writes its bf16 o tile over its own q rows in
//   the order of wgmma's A fragments (16 bytes a lane a key step). Then a
//   cluster barrier: every head's o is in its CTA's shared memory.
// - Phase 3: wgmma m64nNk16 (N = 64 or 128, hpc dh rounded up) with A from
//   registers, in rounds of 128 rows (a warpgroup an m64 tile): each lane
//   loads its fragments of o_hh from the owning CTA's shared memory
//   (16-byte distributed loads, the next head's under this head's
//   products), the W_o blocks arrive through the ring, as many heads' a
//   stage as fit; heads summed in order, so two calls give the same bits.
//   Bias and residual (k8) in fp32 in the epilogue, rounded once. The
//   cluster's end barrier is split: arrived once this CTA's last remote
//   read is done, waited before its next q overwrites its o (and before it
//   exits).
// Rounding points as listed above, unchanged.
//
// Measured (H100 80GB HBM3, 700 W; the probe exp_vit_fused_sublayer at B
// 512, G 1, and scripts/vit_fused_phases.py's clock stamps): k5 4.61-4.63
// ms, k8 6.59-6.72 ms (the earlier WMMA design 18.73-18.80 / 20.60-20.61 in
// the same call), against 1.49-1.51 ms for kernel 6's three launches (k8's
// function) and 1.81 ms for matmul + SDPA + matmul. Per image and CTA (two
// heads) about 103k clocks of q|k|v products (48 stages of about 2,150
// against about 740 of wgmma work), 89k of attention, 63k of out product
// and 11k of its epilogue (k8 adds 35k of LN statistics and 70k of LN on
// the tiles). What holds it back: one CTA an SM (its q, k, v and the ring
// fill the shared memory), so every phase runs with 8 warps and none
// overlaps another; phase 1 still waits on its loads (handing each stage
// back as soon as its products retire, so that two loads are in flight,
// did not shorten it); the attention runs 2 warps a scheduler through
// dependent chains. Tried and not kept: multicasting each x box to the
// whole cluster from one CTA (the box lands in every CTA, so a stage is
// reloaded only once all CTAs have handed it back): k5 6.54-6.57 against
// 4.88-4.92 ms without, k8 9.33-9.46 against 6.69-6.70, in one call; the
// lock-step of the cluster's rings cost more than the L2 reads it saved.
#include <cooperative_groups.h>

#include <type_traits>

#include "attn_mma.cuh"
#include "hopper.cuh"
#include "wmma_gemm.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace hopper;
using namespace nvcuda;
using wmma_gemm::pack_bf16x8;
using wmma_gemm::unpack_bf16x8;

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int LDE = 16 + 4;  // fp32 stride of a warp's epilogue staging tile
constexpr size_t kStagingBytes = (size_t)kWarps * 16 * LDE * sizeof(float);

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// --------------------------------------------------------------------------
// k7, k9: the MLP sub-layer
// --------------------------------------------------------------------------

constexpr int MR = 32;        // rows of a tile
constexpr int MC = 64;        // hidden columns of a chunk
constexpr int MK1 = 192;      // K rows of a W_1 tile
constexpr int MK2 = 16;       // hidden rows of a W_2 tile
constexpr int kMlpStages = 4;
constexpr int kMaxD = 768;    // the [32, d] accumulator in registers
constexpr int kMaxFn = kMaxD / 128;  // a warp's accumulator column tiles
constexpr int LDH = MC + 8;

struct MlpLayout {
  int dpad, ldy, ldw2, t1, stage;  // stage: bf16 elements of a ring stage
  size_t y, h, ring, e, total;
};

__host__ __device__ inline MlpLayout mlp_layout(int d) {
  MlpLayout L;
  L.dpad = (d + 127) / 128 * 128;
  L.ldy = L.dpad + 8;
  L.ldw2 = L.dpad + 8;
  L.t1 = (d + MK1 - 1) / MK1;
  L.stage = MK1 * LDH > MK2 * L.ldw2 ? MK1 * LDH : MK2 * L.ldw2;
  size_t off = 0;
  L.y = off; off += smem_align((size_t)MR * L.ldy * sizeof(bf16));
  L.h = off; off += smem_align((size_t)MR * LDH * sizeof(bf16));
  L.ring = off; off += smem_align((size_t)kMlpStages * L.stage * sizeof(bf16));
  L.e = off; off += kStagingBytes;
  L.total = off;
  return L;
}

// kBlock: k9 (LN before, residual after); else k7.
template <bool kBlock>
__global__ void __launch_bounds__(kThreads, 1)
    vit_fused_mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                         const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                         const float* __restrict__ b1, const bf16* __restrict__ w2,
                         const float* __restrict__ b2, bf16* __restrict__ out, int rows_total,
                         int rows_per_block, int d, int m, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MlpLayout L = mlp_layout(d);
  bf16* sY = reinterpret_cast<bf16*>(smem + L.y);
  bf16* sH = reinterpret_cast<bf16*>(smem + L.h);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* sE = reinterpret_cast<float*>(smem + L.e) + warp * 16 * LDE;
  const int er = lane / 2, ec = (lane % 2) * 8;  // a lane's row and 8 columns of a fragment
  const int ldy = L.ldy, ldw2 = L.ldw2, t1 = L.t1;
  const int fn = L.dpad / 128;  // this warp: output columns [16 fn warp, 16 fn (warp + 1))
  const int per_chunk = t1 + MC / MK2;
  const int tiles = (m + MC - 1) / MC * per_chunk;
  const int g0 = blockIdx.x * rows_per_block;
  const int g1 = min(rows_total, g0 + rows_per_block);

  // start copying weight tile s (of the sequence t1 W_1 tiles, 4 W_2 tiles
  // per hidden chunk) into ring stage st; zero-filled past d and m
  auto load_tile = [&](int st, int s) {
    bf16* dst = ring + (size_t)st * L.stage;
    const int chunk = s / per_chunk, j = s % per_chunk, c0 = chunk * MC;
    if (j < t1) {
      const int k0 = j * MK1;
      for (int idx = tid; idx < MK1 * (MC / 8); idx += kThreads) {
        const int r = idx / (MC / 8), c = (idx % (MC / 8)) * 8;
        const bool ok = k0 + r < d && c0 + c < m;
        cp_async16(dst + r * LDH + c, ok ? w1 + (size_t)(k0 + r) * m + c0 + c : w1, ok);
      }
    } else {
      const int k0 = c0 + (j - t1) * MK2, cols = L.dpad / 8;
      for (int idx = tid; idx < MK2 * cols; idx += kThreads) {
        const int r = idx / cols, c = (idx % cols) * 8;
        const bool ok = k0 + r < m && c < d;
        cp_async16(dst + r * ldw2 + c, ok ? w2 + (size_t)(k0 + r) * d + c : w2, ok);
      }
    }
  };

  for (int r0 = g0; r0 < g1; r0 += MR) {
    const int valid = min(MR, g1 - r0);
    for (int idx = tid; idx < MR * (L.dpad / 8); idx += kThreads) {
      const int r = idx / (L.dpad / 8), c = (idx % (L.dpad / 8)) * 8;
      const bool ok = r < valid && c < d;
      cp_async16(sY + r * ldy + c, ok ? x + (size_t)(r0 + r) * d + c : x, ok);
    }
    cp_async_commit();
    for (int st = 0; st < kMlpStages - 1; ++st) {
      if (st < tiles) load_tile(st, st);
      cp_async_commit();  // one group per stage, empty or not, so the count holds
    }
    cp_async_wait<kMlpStages - 1>();  // the row tile has landed
    __syncthreads();
    if (kBlock) {
      // y = LN(x) in place, a warp a row: fp32 statistics, the mean first,
      // then the mean of the squared deviations; rounded once
      for (int r = warp; r < valid; r += kWarps) {
        bf16* row = sY + r * ldy;
        float v[8], sum = 0.f, sq = 0.f;
        for (int c = lane * 8; c < d; c += 256) {
          unpack_bf16x8(*reinterpret_cast<const uint4*>(row + c), v);
          for (int t = 0; t < 8; ++t) sum += v[t];
        }
        const float mean = warp_sum(sum) / d;
        for (int c = lane * 8; c < d; c += 256) {
          unpack_bf16x8(*reinterpret_cast<const uint4*>(row + c), v);
          for (int t = 0; t < 8; ++t) sq += (v[t] - mean) * (v[t] - mean);
        }
        const float rstd = rsqrtf(warp_sum(sq) / d + eps);
        for (int c = lane * 8; c < d; c += 256) {
          unpack_bf16x8(*reinterpret_cast<const uint4*>(row + c), v);
          for (int t = 0; t < 8; ++t) v[t] = (v[t] - mean) * rstd * ln_s[c + t] + ln_b[c + t];
          *reinterpret_cast<uint4*>(row + c) = pack_bf16x8(v);
        }
      }
    }
    // (the first ring iteration's barrier orders these writes before the reads)

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kMaxFn], hacc;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < kMaxFn; ++f) wmma::fill_fragment(acc[i][f], 0.0f);
    const int hrt = warp / 4, hct = warp % 4;  // this warp's fragment of h_c

    for (int s = 0; s < tiles; ++s) {
      const int st = s % kMlpStages;
      cp_async_wait<kMlpStages - 2>();  // this thread's copies of tile s have landed
      __syncthreads();  // everyone's have; the stage of tile s - 1 is free; sH is written
      if (s + kMlpStages - 1 < tiles) load_tile((s + kMlpStages - 1) % kMlpStages,
                                                s + kMlpStages - 1);
      cp_async_commit();
      const bf16* tile = ring + (size_t)st * L.stage;
      const int chunk = s / per_chunk, j = s % per_chunk;
      if (j < t1) {  // h_c += y[:, k0:k0+192] W_1 tile
        const int k0 = j * MK1;
        if (j == 0) wmma::fill_fragment(hacc, 0.0f);
        const int ksub = (min(MK1, d - k0) + 15) / 16;
#pragma unroll
        for (int kk = 0; kk < MK1 / 16; ++kk) {
          if (kk >= ksub) break;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, sY + 16 * hrt * ldy + k0 + 16 * kk, ldy);
          wmma::load_matrix_sync(fb, tile + 16 * kk * LDH + 16 * hct, LDH);
          wmma::mma_sync(hacc, fa, fb, hacc);
        }
        if (j == t1 - 1) {  // h_c = bf16(GELU(. + b_1)), zeros past m
          wmma::store_matrix_sync(sE, hacc, LDE, wmma::mem_row_major);
          __syncwarp();
          const int col = chunk * MC + 16 * hct + ec;
          float v[8];
          for (int t = 0; t < 8; ++t)
            v[t] = col < m ? gelu_erf(sE[er * LDE + ec + t] + b1[col + t]) : 0.f;
          *reinterpret_cast<uint4*>(sH + (16 * hrt + er) * LDH + 16 * hct + ec) = pack_bf16x8(v);
          __syncwarp();
        }
      } else {  // acc += h_c[:, 16 jj : 16 jj + 16] W_2 tile
        const int jj = j - t1;
        // every fragment first, then the 2 fn independent products
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[kMaxFn];
#pragma unroll
        for (int f = 0; f < kMaxFn; ++f)
          if (f < fn) wmma::load_matrix_sync(fb[f], tile + 16 * (warp * fn + f), ldw2);
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], sH + 16 * i * LDH + 16 * jj, LDH);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int f = 0; f < kMaxFn; ++f)
            if (f < fn) wmma::mma_sync(acc[i][f], fa[i], fb[f], acc[i][f]);
      }
    }
    cp_async_wait<0>();

    // epilogue: + b_2 (+ the residual row, k9), rounded once
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int f = 0; f < kMaxFn; ++f) {
        if (f >= fn) break;
        wmma::store_matrix_sync(sE, acc[i][f], LDE, wmma::mem_row_major);
        __syncwarp();
        const int r = 16 * i + er, col = 16 * (warp * fn + f) + ec;
        if (r < valid && col < d) {
          const size_t at = (size_t)(r0 + r) * d + col;
          float v[8];
          for (int t = 0; t < 8; ++t) v[t] = sE[er * LDE + ec + t] + b2[col + t];
          if (kBlock) {
            float res[8];
            unpack_bf16x8(*reinterpret_cast<const uint4*>(x + at), res);
            for (int t = 0; t < 8; ++t) v[t] = res[t] + v[t];
          }
          *reinterpret_cast<uint4*>(out + at) = pack_bf16x8(v);
        }
        __syncwarp();
      }
    }
    __syncthreads();  // before the next row tile overwrites sY and the ring
  }
}

// --------------------------------------------------------------------------
// k5, k8: the attention sub-layer, one cluster an image
// --------------------------------------------------------------------------

constexpr int kAttnThreads = 256;  // two warpgroups, 8 warps
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kPassRows = 128;     // rows of a phase-1 pass: an m64 tile a warpgroup
constexpr int kBK = 64;            // K step of phase 1: one 128-byte swizzle row of bf16
constexpr int kPassBoxes = 3;      // [64, 64] W_qkv boxes a pass: one m64n192k16
constexpr unsigned kXBytes = kPassRows * kBK * 2;                    // 16 KB
constexpr unsigned kWBoxBytes = kBK * 64 * 2;                        // 8 KB
constexpr unsigned kStageBytes = kXBytes + kPassBoxes * kWBoxBytes;  // 40 KB
constexpr int kMaxHeads = 16;  // the largest (non-portable) cluster
constexpr int kMaxTokens = 16 * attn::kMaxKeyTiles;
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block can have

// Shared memory of a CTA, as offsets from a base aligned by hand to the
// 1024 bytes the 128-byte swizzle repeats over: the ring of `stages` stages
// (a phase-1 stage: an x tile [128, 64] and three W_qkv boxes; a phase-3
// stage: one head's W_o block, NB3 boxes of [dh, 64]), then hpc q buffers
// (q of the CTA's head j, then its o in fragment order over it), k, v (one
// head's at a time; npad rows of stride dh + 8), the LN statistics, the
// ring's mbarriers and thread 0's cursor over the ring (RingCursor).
struct AttnLayout {
  int npad, ldq;
  size_t head, q, k, v, stats, bars, total;
};

__host__ __device__ inline AttnLayout attn_layout(int n, int dh, int hpc, int stages) {
  AttnLayout L;
  L.npad = (n + 15) / 16 * 16;
  L.ldq = dh + 8;
  L.head = smem_align((size_t)L.npad * L.ldq * sizeof(bf16));
  size_t off = (size_t)stages * kStageBytes;
  L.q = off; off += hpc * L.head;
  L.k = off; off += L.head;
  L.v = off; off += L.head;
  L.stats = off; off += smem_align(2 * (size_t)L.npad * sizeof(float));
  L.bars = off; off += smem_align(2 * (size_t)stages * sizeof(uint64_t));
  L.total = off + 1024;  // the slack of the alignment by hand
  return L;
}

// the ring's depth: 3 stages where they fit, else 2; 0 where neither does
__host__ __device__ inline int attn_stages(int n, int dh, int hpc) {
  for (int s = 3; s >= 2; --s)
    if (attn_layout(n, dh, hpc, s).total <= kSmemLimit) return s;
  return 0;
}

struct AttnArgs {
  const bf16* x;  // [b, n, d]: the LN statistics and the residual read it here
  const float *ln_s, *ln_b, *bqkv, *bo;
  bf16* out;
  int b, n, heads, hpc, group, stages;
  float c, eps;  // c = dh^-0.5 log2(e)
};

// Bytes of one head's W_o block (its dh rows of the CTA's cw output
// columns, in boxes of 64 columns), and how many of them a ring stage holds.
__host__ __device__ inline unsigned wo_bytes(int dh, int cw) { return (cw + 63) / 64 * dh * 128; }

__host__ __device__ inline int wo_heads_per_stage(int dh, int cw) {
  return (int)(kStageBytes / wo_bytes(dh, cw));
}

// Thread 0's cursor over the ring's positions, kept in shared memory beside
// the barriers: every image's stages in the order the consumers take them
// (phase 1 head by head, column pass, row pass, K step; then, a round of
// phase 3 at a time, the W_o blocks of the heads in order, as many a stage
// as fit), the same sequence in every CTA of the cluster. Advanced one
// position a load by counting, with no division: the feed runs on thread
// 0, whose warpgroup's products wait for it.
struct RingCursor {
  int stage, parity;               // the next load's stage and the phase of its barriers
  int img, phase3, j, cp, rp, ks;  // rp: phase 3's round
  int gi;                          // phase 3: the W_o stage of the round
  int last, ksteps, row_passes, group, groups;
};

// the cursor sits 64 bytes into the 128 of the barriers (at most 4 stages)
static_assert(64 + sizeof(RingCursor) <= 128, "the ring cursor outgrew its place");

__device__ __forceinline__ RingCursor* ring_cursor(unsigned char* bars) {
  return reinterpret_cast<RingCursor*>(bars + 64);
}

template <int DH>
__device__ __forceinline__ void ring_cursor_init(RingCursor* c, const AttnArgs& a) {
  const int npad = (a.n + 15) / 16 * 16, d = a.heads * DH;
  *c = RingCursor{};
  c->img = blockIdx.y * a.group;
  c->last = min(a.b, c->img + a.group);
  c->ksteps = (d + kBK - 1) / kBK;
  c->row_passes = (npad + kPassRows - 1) / kPassRows;
  c->group = wo_heads_per_stage(DH, a.hpc * DH);
  c->groups = (a.heads + c->group - 1) / c->group;
}

// Thread 0 loads the cursor's position into its stage once the consumers
// have handed the stage back, then advances the cursor.
template <int DH>
__device__ __forceinline__ void feed_ring(const CUtensorMap* map_x, const CUtensorMap* map_w,
                                          const CUtensorMap* map_o, const AttnArgs& a,
                                          unsigned char* smem) {
  constexpr int NB = (DH + 63) / 64;
  const int stages = a.stages;
  unsigned char* bars = smem + attn_layout(a.n, DH, a.hpc, stages).bars;
  RingCursor* cur = ring_cursor(bars);
  RingCursor c = *cur;
  if (c.img >= c.last) return;
  uint64_t* full = reinterpret_cast<uint64_t*>(bars);
  uint64_t* empty = full + stages;
  const int s = c.stage, rank = blockIdx.x;  // the cluster spans the grid's x
  const int d = a.heads * DH, cw = a.hpc * DH;
  mbar_wait(&empty[s], c.parity ^ 1);  // passes at once on the first round
  unsigned char* dst = smem + (size_t)s * kStageBytes;
  if (!c.phase3) {
    const int head = rank * a.hpc + c.j;
    mbar_expect_tx(&full[s], kStageBytes);
    tma_load_3d(dst, map_x, &full[s], c.ks * kBK, c.rp * kPassRows, c.img);
    for (int bx = 0; bx < kPassBoxes; ++bx) {
      const int box = c.cp * kPassBoxes + bx;
      tma_load(dst + kXBytes + bx * kWBoxBytes, map_w, &full[s],
               (box / NB) * d + head * DH + 64 * (box % NB), c.ks * kBK);
    }
    if (++c.ks == c.ksteps) {
      c.ks = 0;
      if (++c.rp == c.row_passes) {
        c.rp = 0;
        if (++c.cp == NB) {
          c.cp = 0;
          if (++c.j == a.hpc) {
            c.j = 0;
            c.phase3 = 1;
          }
        }
      }
    }
  } else {
    const int h0 = c.gi * c.group, h1 = min(a.heads, h0 + c.group);
    mbar_expect_tx(&full[s], (h1 - h0) * wo_bytes(DH, cw));
    for (int hh = h0; hh < h1; ++hh)
      for (int jb = 0; jb < (cw + 63) / 64; ++jb)
        tma_load(dst + (hh - h0) * wo_bytes(DH, cw) + jb * DH * 128, map_o, &full[s],
                 rank * cw + 64 * jb, hh * DH);
    if (++c.gi == c.groups) {
      c.gi = 0;
      if (++c.rp == c.row_passes) {
        c.rp = 0;
        c.phase3 = 0;
        ++c.img;
      }
    }
  }
  if (++c.stage == stages) {
    c.stage = 0;
    c.parity ^= 1;
  }
  *cur = c;
}

// Phase 2 for one head: o = attention, a warp 16 queries at a time
// (attend_rows_two_pass: S and P in registers), rounded to bf16 and stored
// over the warp's own q rows in the order of wgmma's A fragments: key step
// kk, lane l at 8 (32 kk + l), 16 bytes.
template <int DH>
__device__ __forceinline__ void attend_head(bf16* q, const bf16* sK, const bf16* sV, int n,
                                            int npad, float c) {
  constexpr int KT = DH / 16, LD = DH + 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int rt = warp; rt < npad / 16; rt += kAttnWarps) {
    bf16* q16 = q + (size_t)rt * 16 * LD;
    float o[DH / 8][4];
    attn::attend_rows_two_pass<DH>(o, q16, sK, sV, LD, n, npad / 16, c);
    __syncwarp();  // every lane's ldmatrix of q16 is done
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      *reinterpret_cast<uint4*>(q16 + (kk * 32 + lane) * 8) = make_uint4(
          attn::pack_bf16(o[2 * kk][0], o[2 * kk][1]), attn::pack_bf16(o[2 * kk][2], o[2 * kk][3]),
          attn::pack_bf16(o[2 * kk + 1][0], o[2 * kk + 1][1]),
          attn::pack_bf16(o[2 * kk + 1][2], o[2 * kk + 1][3]));
  }
}

// This thread's A fragments of an o in fragment order (phase 2's layout):
// warp wi's 16 rows of m64 tile `tile`, every key step; zeros past npad.
template <int KT>
__device__ __forceinline__ void load_o_frags(uint32_t (&f)[KT][4], const bf16* src, int tile,
                                             int npad, int ldq) {
  const int rt = 4 * tile + (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (16 * rt < npad)
      v = *reinterpret_cast<const uint4*>(src + (size_t)rt * 16 * ldq + (kk * 32 + lane) * 8);
    f[kk][0] = v.x;
    f[kk][1] = v.y;
    f[kk][2] = v.z;
    f[kk][3] = v.w;
  }
}

// Phase 3 of image img: out[:, r cw : (r + 1) cw] = sum over heads hh of
// o_hh W_o[hh dh : (hh + 1) dh, r cw : (r + 1) cw], hh in order (fixed, no
// atomics), on wgmma m64nN3k16 with A from registers: o_hh's fragments read
// from its CTA's shared memory (16 bytes a lane a key step; the next
// head's loaded while this head's products run), the W_o block from the
// ring (several heads' blocks a stage). In rounds of 128 rows, a warpgroup
// an m64 tile: one tile's
// accumulators a thread at a time (two would not fit beside the rest of
// the kernel's registers), the W_o blocks streamed again each round. Then
// + b_o (+ the residual, k8), rounded once.
template <bool kBlock, int DH, int N3>
__device__ __forceinline__ void out_product(const CUtensorMap* map_x, const CUtensorMap* map_w,
                                            const CUtensorMap* map_o, const AttnArgs& a,
                                            unsigned char* smem, int img, int& pos,
                                            bool& end_pending) {
  constexpr int KT = DH / 16;
  cg::cluster_group cluster = cg::this_cluster();
  const AttnLayout L = attn_layout(a.n, DH, a.hpc, a.stages);
  const bf16* sQ = reinterpret_cast<const bf16*>(smem + L.q);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + a.stages;
  const size_t qbuf = L.head / sizeof(bf16);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t = lane % 4;
  const int n = a.n, heads = a.heads, hpc = a.hpc, stages = a.stages, d = heads * DH;
  const int cw = hpc * DH, rank = blockIdx.x;
  const int rounds = (L.npad + kPassRows - 1) / kPassRows;
  auto src = [&](int hh) { return cluster.map_shared_rank(sQ + (hh % hpc) * qbuf, hh / hpc); };

  const int group = wo_heads_per_stage(DH, cw);  // W_o blocks a ring stage holds
  for (int round = 0; round < rounds; ++round) {
    const int tile = 2 * round + wg;
    float acc[N3 / 2];
    uint32_t af[KT][4], nf[KT][4];
    load_o_frags<KT>(af, src(0), tile, L.npad, L.ldq);
#pragma unroll 1
    for (int hh = 0; hh < heads; ++hh) {
      if (round == rounds - 1 && hh == heads - 1) {  // every o this CTA reads has been read
        cluster_arrive();
        end_pending = true;
      }
      const int s = pos % stages;
      if (hh % group == 0) mbar_wait(&full[s], (pos / stages) & 1);
      wgmma_fence();
      const bf16* wt = reinterpret_cast<const bf16*>(smem + (size_t)s * kStageBytes +
                                                     (size_t)(hh % group) * wo_bytes(DH, cw));
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const uint64_t db = sw128_desc(wt + kk * 16 * 64, DH * 128, 1024);
        if constexpr (N3 == 64)
          wgmma_rs_m64n64k16(acc, af[kk], db, hh > 0 || kk > 0);
        else
          wgmma_rs_m64n128k16(acc, af[kk], db, hh > 0 || kk > 0);
      }
      wgmma_commit();
      if (hh + 1 < heads) load_o_frags<KT>(nf, src(hh + 1), tile, L.npad, L.ldq);
      wgmma_wait<0>();
      if (hh % group == group - 1 || hh == heads - 1) {  // the stage's last block is read
        if (lane == 0) mbar_arrive(&empty[s]);
        if (tid == 0) feed_ring<DH>(map_x, map_w, map_o, a, smem);
        ++pos;
      }
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) af[kk][e] = nf[kk][e];
    }
    fence_regs(acc);
    // + b_o (+ the residual, k8), rounded once; the residual pairs read
    // first, all in flight before the first store
    const int row0 = tile * 64 + wi * 16 + g;
    unsigned res[N3 / 8][2];
    if (kBlock) {
#pragma unroll
      for (int j8 = 0; j8 < N3 / 8; ++j8)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int cl = 8 * j8 + 2 * t, row = row0 + 8 * h2;
          const bf16* xr = a.x + ((size_t)img * n + row) * d + rank * cw + cl;
          res[j8][h2] = cl < cw && row < n ? __ldg(reinterpret_cast<const unsigned*>(xr)) : 0u;
        }
    }
#pragma unroll
    for (int j8 = 0; j8 < N3 / 8; ++j8) {
      const int cl = 8 * j8 + 2 * t;
      if (cl >= cw) continue;
      const int col = rank * cw + cl;
      const float2 bias = *reinterpret_cast<const float2*>(a.bo + col);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = row0 + 8 * h2;
        if (row >= n) continue;
        const size_t at = ((size_t)img * n + row) * d + col;
        float v0 = acc[4 * j8 + 2 * h2] + bias.x, v1 = acc[4 * j8 + 2 * h2 + 1] + bias.y;
        if (kBlock) {
          const float2 r =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[j8][h2]));
          v0 = r.x + v0;
          v1 = r.y + v1;
        }
        *reinterpret_cast<__nv_bfloat162*>(a.out + at) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// kBlock: k8 (LN before, residual after); else k5. Grid (heads / hpc,
// ceil(b / group)), clusters of heads / hpc CTAs along x; CTA r owns heads
// r hpc .. r hpc + hpc - 1 and output columns [r hpc dh, (r + 1) hpc dh).
template <bool kBlock, int DH>
__global__ void __launch_bounds__(kAttnThreads, 1)
    vit_fused_attn_kernel(__grid_constant__ const CUtensorMap map_x,
                          __grid_constant__ const CUtensorMap map_w,
                          __grid_constant__ const CUtensorMap map_o, const AttnArgs a) {
  constexpr int NB = (DH + 63) / 64;  // W_qkv boxes of 64 columns one of q, k, v spans
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  cg::cluster_group cluster = cg::this_cluster();
  const int n = a.n, heads = a.heads, hpc = a.hpc, stages = a.stages;
  const AttnLayout L = attn_layout(n, DH, hpc, stages);
  const int npad = L.npad, ldq = L.ldq, d = heads * DH, cs = heads / hpc;
  const size_t qbuf = L.head / sizeof(bf16);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L.v);
  float* sMu = reinterpret_cast<float*>(smem + L.stats);
  float* sRstd = sMu + npad;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, wi = warp % 4, g = lane / 4, t = lane % 4;
  const int rank = (int)cluster.block_rank();
  const int first = blockIdx.y * a.group, last = min(a.b, first + a.group);
  const int row_passes = (npad + kPassRows - 1) / kPassRows;
  const int ksteps = (d + kBK - 1) / kBK;

  if (tid == 0) {
    ring_cursor_init<DH>(ring_cursor(smem + L.bars), a);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                // thread 0's expect_tx
      mbar_init(&empty[s], kAttnWarps);      // one arrival a warp
    }
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int p = 0; p < stages; ++p) feed_ring<DH>(&map_x, &map_w, &map_o, a, smem);

  int pos = 0;               // the ring position being consumed
  bool end_pending = false;  // the last image's end barrier: arrived, not yet waited
  for (int img = first; img < last; ++img) {
    if (kBlock) {
      // LN statistics: CTA r takes rows r, r + cs, ..., a warp a row (the
      // mean, then the mean of the squared deviations), then reads the
      // other rows' from their CTAs
      const bf16* xi = a.x + (size_t)img * n * d;
      for (int r = rank + cs * warp; r < n; r += cs * kAttnWarps) {
        const bf16* row = xi + (size_t)r * d;
        float v[8], sum = 0.f, sq = 0.f;
        for (int c = lane * 8; c < d; c += 256) {
          unpack_bf16x8(*reinterpret_cast<const uint4*>(row + c), v);
          for (int e = 0; e < 8; ++e) sum += v[e];
        }
        const float mean = warp_sum(sum) / d;
        for (int c = lane * 8; c < d; c += 256) {
          unpack_bf16x8(*reinterpret_cast<const uint4*>(row + c), v);
          for (int e = 0; e < 8; ++e) sq += (v[e] - mean) * (v[e] - mean);
        }
        const float var = warp_sum(sq) / d;
        if (lane == 0) {
          sMu[r] = mean;
          sRstd[r] = rsqrtf(var + a.eps);
        }
      }
      if (end_pending) cluster_wait();
      end_pending = false;
      cluster_arrive();  // the statistics of every row are in their CTAs
      cluster_wait();
      for (int r = tid; r < n; r += kAttnThreads) {
        const int owner = r % cs;
        if (owner == rank) continue;
        sMu[r] = *cluster.map_shared_rank(sMu + r, owner);
        sRstd[r] = *cluster.map_shared_rank(sRstd + r, owner);
      }
      __syncthreads();
    }

    for (int j = 0; j < hpc; ++j) {
      const int head = rank * hpc + j;
      bf16* qj = sQ + j * qbuf;
      // phase 1: q | k | v of the head = bf16(y W_qkv[:, its columns] +
      // b), rows past n zeros; a pass is 128 rows (a warpgroup an m64
      // tile) x three boxes of 64 columns, wgmma m64n192k16 from the ring
      for (int cp = 0; cp < NB; ++cp) {
        for (int rp = 0; rp < row_passes; ++rp) {
          float acc[96];
          int prev = 0;
#pragma unroll 1
          for (int ks = 0; ks < ksteps; ++ks, ++pos) {
            const int s = pos % stages;
            unsigned char* st = smem + (size_t)s * kStageBytes;
            mbar_wait(&full[s], (pos / stages) & 1);
            if (kBlock) {
              // y = LN(x) on the warpgroup's 64 rows of the landed x tile, in
              // place: chunk p of row r of the swizzled box holds columns
              // 8 (p ^ r % 8) ..; a thread takes chunk ct % 8 of rows
              // ct / 8 + 16 u, so the same 8 columns each time
              bf16* tile = reinterpret_cast<bf16*>(st) + wg * 64 * kBK;
              const int ct = tid % 128, r0 = ct / 8;
              const int col = ks * kBK + 8 * ((ct % 8) ^ (r0 % 8));
              if (col < d) {
                const float4* ls = reinterpret_cast<const float4*>(a.ln_s + col);
                const float4* lb = reinterpret_cast<const float4*>(a.ln_b + col);
                float sc[8], sh[8];
                *reinterpret_cast<float4*>(sc) = __ldg(ls);
                *reinterpret_cast<float4*>(sc + 4) = __ldg(ls + 1);
                *reinterpret_cast<float4*>(sh) = __ldg(lb);
                *reinterpret_cast<float4*>(sh + 4) = __ldg(lb + 1);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  const int r = r0 + 16 * u, row = rp * kPassRows + wg * 64 + r;
                  if (row >= n) break;
                  uint4* p = reinterpret_cast<uint4*>(tile + r * kBK + (ct % 8) * 8);
                  const float mu = sMu[row], rstd = sRstd[row];
                  float v[8];
                  unpack_bf16x8(*p, v);
                  for (int e = 0; e < 8; ++e) v[e] = (v[e] - mu) * rstd * sc[e] + sh[e];
                  *p = pack_bf16x8(v);
                }
              }
              fence_proxy_async();  // the generic writes, before wgmma reads them
              named_bar_sync(1 + wg, 128);
            }
            wgmma_fence();
            const bf16* xa = reinterpret_cast<const bf16*>(st) + wg * 64 * kBK;
            const bf16* wb = reinterpret_cast<const bf16*>(st + kXBytes);
#pragma unroll
            for (int kk = 0; kk < kBK / 16; ++kk)
              wgmma_ss_m64n192k16(acc, sw128_desc(xa + kk * 16, 0, 1024),
                                  sw128_desc(wb + kk * 16 * 64, kWBoxBytes, 1024),
                                  ks > 0 || kk > 0);
            wgmma_commit();
            if (ks > 0) {  // the previous stage's products have retired: free it
              wgmma_wait<1>();
              if (lane == 0) mbar_arrive(&empty[prev]);
              if (tid == 0) feed_ring<DH>(&map_x, &map_w, &map_o, a, smem);
            }
            prev = s;
          }
          wgmma_wait<0>();
          if (lane == 0) mbar_arrive(&empty[prev]);
          if (tid == 0) feed_ring<DH>(&map_x, &map_w, &map_o, a, smem);
          fence_regs(acc);
          // the q buffers hold the last image's o until every CTA has read it
          if (end_pending) cluster_wait();
          end_pending = false;
          // + b_qkv, rounded, into q_j, k, v (rows past n zeros, past npad
          // not stored; columns of a box past dh belong to other heads)
          const int row0 = rp * kPassRows + wg * 64 + wi * 16 + g;
#pragma unroll
          for (int j8 = 0; j8 < 8 * kPassBoxes; ++j8) {
            const int box = cp * kPassBoxes + j8 / 8, which = box / NB;
            const int hc = (box % NB) * 64 + (j8 % 8) * 8 + 2 * t;
            if (hc >= DH) continue;
            bf16* dst = which == 0 ? qj : which == 1 ? sK : sV;
            const float2 bias =
                *reinterpret_cast<const float2*>(a.bqkv + which * d + head * DH + hc);
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
              const int row = row0 + 8 * h2;
              if (row >= npad) continue;
              const float v0 = row < n ? acc[4 * j8 + 2 * h2] + bias.x : 0.f;
              const float v1 = row < n ? acc[4 * j8 + 2 * h2 + 1] + bias.y : 0.f;
              *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * ldq + hc) =
                  __floats2bfloat162_rn(v0, v1);
            }
          }
        }
      }
      __syncthreads();  // head j's q, k and v are complete

      // phase 2: o = attention of the head
      attend_head<DH>(qj, sK, sV, n, npad, a.c);
      __syncthreads();  // k and v are free for the next head
    }
    cluster_arrive();  // every head's o is in its CTA's shared memory
    cluster_wait();

    // phase 3
    if constexpr (DH > 64) {
      out_product<kBlock, DH, 128>(&map_x, &map_w, &map_o, a, smem, img, pos, end_pending);
    } else {
      if (hpc * DH <= 64)
        out_product<kBlock, DH, 64>(&map_x, &map_w, &map_o, a, smem, img, pos, end_pending);
      else
        out_product<kBlock, DH, 128>(&map_x, &map_w, &map_o, a, smem, img, pos, end_pending);
    }
  }
  if (end_pending) cluster_wait();  // no CTA exits while another reads its o
}

// the heads a CTA takes: two where they pair up and fit (half the cluster
// size, so more clusters run at once), else one
int heads_per_cta(int n, int dh, int heads) {
  return heads % 2 == 0 && 2 * dh <= 128 && attn_stages(n, dh, 2) > 0 ? 2 : 1;
}

template <bool kBlock, int DH>
cudaError_t attn_config(int n, int heads, int hpc, size_t* smem) {
  const int stages = attn_stages(n, DH, hpc);
  *smem = attn_layout(n, DH, hpc, stages).total;
  cudaError_t err = cudaFuncSetAttribute(vit_fused_attn_kernel<kBlock, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) return err;
  if (heads / hpc > 8)
    err = cudaFuncSetAttribute(vit_fused_attn_kernel<kBlock, DH>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t attn_launch_config(int cs, int blocks, size_t smem, cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, blocks);
  cfg.blockDim = dim3(kAttnThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kBlock, int DH>
cudaError_t launch_attn(const void* wqkv, const void* wo, AttnArgs a, cudaStream_t stream) {
  size_t smem;
  cudaError_t err = attn_config<kBlock, DH>(a.n, a.heads, a.hpc, &smem);
  if (err != cudaSuccess) return err;
  a.stages = attn_stages(a.n, DH, a.hpc);
  const int d = a.heads * DH;
  CUtensorMap map_x, map_w, map_o;
  const cuuint64_t xdims[3] = {(cuuint64_t)d, (cuuint64_t)a.n, (cuuint64_t)a.b};
  const cuuint32_t xbox[3] = {64, kPassRows, 1};
  if (!encode_bf16_map(&map_x, a.x, 3, xdims, xbox) || !encode_map(&map_w, wqkv, d, 3 * d, kBK) ||
      !encode_map(&map_o, wo, d, d, DH))
    return cudaErrorNotSupported;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      attn_launch_config(a.heads / a.hpc, (a.b + a.group - 1) / a.group, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, vit_fused_attn_kernel<kBlock, DH>, map_x, map_w, map_o, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_attn_dh(const void* wqkv, const void* wo, const AttnArgs& a,
                           cudaStream_t stream) {
  return a.ln_s != nullptr ? launch_attn<true, DH>(wqkv, wo, a, stream)
                           : launch_attn<false, DH>(wqkv, wo, a, stream);
}

template <int DH>
long long attn_clusters_dh(int n, int heads, int hpc) {
  size_t smem;
  cudaError_t err = attn_config<true, DH>(n, heads, hpc, &smem);
  if (err != cudaSuccess) return -(long long)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = attn_launch_config(heads / hpc, 1, smem, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, vit_fused_attn_kernel<true, DH>, &cfg);
  if (err != cudaSuccess) return -(long long)err;
  return clusters;
}

#define MIRROR_FUSED_ATTN_DH(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

template <bool kBlock>
cudaError_t launch_mlp(const bf16* x, const float* ln_s, const float* ln_b, const bf16* w1,
                       const float* b1, const bf16* w2, const float* b2, bf16* out, int rows,
                       int rows_per_block, int d, int m, float eps, cudaStream_t stream) {
  const size_t smem = mlp_layout(d).total;
  const cudaError_t err = allow_smem(vit_fused_mlp_kernel<kBlock>, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  vit_fused_mlp_kernel<kBlock><<<blocks, kThreads, smem, stream>>>(
      x, ln_s, ln_b, w1, b1, w2, b2, out, rows, rows_per_block, d, m, eps);
  return cudaGetLastError();
}

}  // namespace

// k5 (ln_s null) or k8: x [b, n, d] bf16, d = heads dh; wqkv [d, 3d] (q|k|v
// column blocks), wo [d, d], bf16; ln_s, ln_b [d], bqkv [3d], bo [d] fp32;
// out [b, n, d]. A cluster of heads / hpc CTAs, hpc heads a CTA
// (mirror_vit_fused_attn_heads_per_cta), walks `group` images in turn. n <=
// 256, dh a multiple of 16 up to 128, heads <= 16, the layout's shared
// memory within a block's 227 KB (mirror_vit_fused_attn_smem); x, wqkv and
// wo 16-byte aligned (TMA).
MIRROR_EXPORT int mirror_vit_fused_attn(const void* x, const void* ln_s, const void* ln_b,
                                        const void* wqkv, const void* bqkv, const void* wo,
                                        const void* bo, void* out, int b, int n, int heads,
                                        int dh, int group, float scale, float eps,
                                        cudaStream_t stream) {
  if (b <= 0 || n <= 0 || n > kMaxTokens || dh % 16 != 0 || dh < 16 || dh > 128 ||
      heads <= 0 || heads > kMaxHeads || group <= 0 || (b + group - 1) / group > 65535)
    return (int)cudaErrorInvalidValue;
  const int hpc = heads_per_cta(n, dh, heads);
  if (attn_stages(n, dh, hpc) == 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wqkv) |
       reinterpret_cast<uintptr_t>(wo)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const AttnArgs args{static_cast<const bf16*>(x),     static_cast<const float*>(ln_s),
                      static_cast<const float*>(ln_b), static_cast<const float*>(bqkv),
                      static_cast<const float*>(bo),   static_cast<bf16*>(out),
                      b, n, heads, hpc, group, 0, scale * attn::kLog2e, eps};
  switch (dh) {
#define MIRROR_FUSED_ATTN_CASE(D) \
  case D:                         \
    return (int)launch_attn_dh<D>(wqkv, wo, args, stream);
    MIRROR_FUSED_ATTN_DH(MIRROR_FUSED_ATTN_CASE)
#undef MIRROR_FUSED_ATTN_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Bytes of shared memory a CTA of the attention kernels needs at (n, dh,
// heads) (at the 2-stage ring where none fits).
MIRROR_EXPORT long long mirror_vit_fused_attn_smem(int n, int dh, int heads) {
  const int hpc = heads_per_cta(n, dh, heads), stages = attn_stages(n, dh, hpc);
  return (long long)attn_layout(n, dh, hpc, stages > 0 ? stages : 2).total;
}

// The heads a CTA of the attention kernels takes at (n, dh, heads).
MIRROR_EXPORT long long mirror_vit_fused_attn_heads_per_cta(int n, int dh, int heads) {
  return heads_per_cta(n, dh, heads);
}

// How many clusters (heads / hpc CTAs) of the attention kernel the card
// holds at once (cudaOccupancyMaxActiveClusters): 0 when one cannot be
// scheduled, minus a CUDA error code when the query fails.
MIRROR_EXPORT long long mirror_vit_fused_attn_clusters(int n, int dh, int heads) {
  const int hpc = heads_per_cta(n, dh, heads);
  if (heads <= 0 || heads > kMaxHeads || dh % 16 != 0 || attn_stages(n, dh, hpc) == 0)
    return -(long long)cudaErrorInvalidValue;
  switch (dh) {
#define MIRROR_FUSED_ATTN_CASE(D) \
  case D:                         \
    return attn_clusters_dh<D>(n, heads, hpc);
    MIRROR_FUSED_ATTN_DH(MIRROR_FUSED_ATTN_CASE)
#undef MIRROR_FUSED_ATTN_CASE
  }
  return -(long long)cudaErrorInvalidValue;
}

// k7 (ln_s null) or k9: x [rows, d] bf16; w1 [d, m], w2 [m, d] bf16; ln_s,
// ln_b [d], b1 [m], b2 [d] fp32; out [rows, d]. A block takes
// rows_per_block consecutive rows (G images of n). d and m multiples of 8,
// d <= 768.
MIRROR_EXPORT int mirror_vit_fused_mlp(const void* x, const void* ln_s, const void* ln_b,
                                       const void* w1, const void* b1, const void* w2,
                                       const void* b2, void* out, int rows, int rows_per_block,
                                       int d, int m, float eps, cudaStream_t stream) {
  if (rows <= 0 || rows_per_block <= 0 || d % 8 != 0 || d > kMaxD || m % 8 != 0 || m <= 0)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* sp = static_cast<const float*>(ln_s);
  const auto* lbp = static_cast<const float*>(ln_b);
  const auto* w1p = static_cast<const bf16*>(w1);
  const auto* b1p = static_cast<const float*>(b1);
  const auto* w2p = static_cast<const bf16*>(w2);
  const auto* b2p = static_cast<const float*>(b2);
  auto* ob = static_cast<bf16*>(out);
  if (ln_s != nullptr)
    return (int)launch_mlp<true>(xb, sp, lbp, w1p, b1p, w2p, b2p, ob, rows, rows_per_block, d,
                                 m, eps, stream);
  return (int)launch_mlp<false>(xb, sp, lbp, w1p, b1p, w2p, b2p, ob, rows, rows_per_block, d, m,
                                eps, stream);
}
