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
// (cp.async rings) and no intermediate (q|k|v, the head outputs, the GELU
// hidden) ever reaches device memory: the wrappers allocate only the
// output. WMMA 16x16x16 bf16 with fp32 accumulators, 8 warps a block.
//
// MLP (k7, k9): row-wise, so no cluster. A block owns G images (G n rows
// of the flattened [b n, d] stream) and walks them in tiles of 32 rows:
// the tile (LN'd once per tile for k9) sits in shared memory, and the
// hidden dim goes by in chunks of 64: h_c = GELU(y W_1[:, c] + b_1[c]) into
// shared memory as bf16, then acc[32, d] += h_c W_2[c, :], the accumulator
// in registers (each warp 96 columns: 96 fp32 a thread, so d <= 768). Bias
// and residual in the epilogue. The weights come as 27 KB tiles through a
// 4-stage ring: four [192, 64] tiles of W_1 and four [16, d] tiles of W_2
// per chunk, 12 products a warp each. Cost of the design: every 32-row tile
// reads all 9.4 MB of W_1 and W_2 from L2, so at B 512 L2 carries
// 100864 / 32 x 9.4 MB = 30 GB (about 5.5 ms at 5.5 TB/s): more rows a tile
// would cut it, but their accumulator no longer fits in registers.
//
// Attention (k5, k8): a head needs all n rows of its image, so one thread
// block cluster per image, one CTA per head (12: a non-portable cluster
// size). A cluster of 6, two heads a CTA, would be portable but holds two
// heads' q, k and v (180 KB) and leaves no room for 8 warps' score rows;
// the cost of 12 is that a GPC holds one such cluster at a time (7 on the
// H100 SXM: 84 of its 132 SMs busy).
// - LN statistics (k8): CTA h takes rows h, h + 12, ... of the image and
//   reads the others' from their CTAs (distributed shared memory).
// - Phase 1: CTA h computes q_h | k_h | v_h [n -> npad, 3 dh] in passes of
//   128 rows x up to 192 columns (one pass at dh 64), streaming [128, 32]
//   tiles of LN(x) (k8: the affine applied as a tile lands) or y (k5) and
//   [32, 192] tiles of W_qkv's head-h columns through a 4-stage ring;
//   + b_qkv, rounded, into shared memory.
// - Phase 2: each warp takes 16-query tiles of head h through
//   vit_attn.cuh's attend_warp (kernel 8's body before its redesign: fp32
//   scores, an exact softmax, bf16 probabilities) and writes o_h bf16 over its own q rows.
// - cluster.sync(); phase 3: CTA j computes output columns [j dh, (j+1) dh)
//   as the sum over heads of o_h W_o[h dh:(h+1) dh, j dh:(j+1) dh], with o_h
//   read from CTA h's shared memory (distributed shared memory, in head
//   order: deterministic, no atomics) into one of two buffers while the
//   other head's products run. Bias and residual (k8) in the epilogue; then
//   cluster.sync() again, so that no CTA overwrites its o_h (next image) or
//   exits while others still read it.
// Shared memory at n 197, dh 64: q, k, v 88 KB; 8 warps' score rows 106 KB,
// aliased with phase 1's ring and phase 3's buffers; 12 KB more: one CTA a
// SM. With G > 1 a cluster walks G images in turn.
//
// Measured (H100 SXM, B 512; scripts/vit_fused_phases.py: clock64 stamps
// per phase, and k7/k9 built without their weight loads or products): all
// four are bound by their WMMA products at one block of 8 warps a SM (about
// 100 FMA a clock a SM, a tenth of the tensor cores' rate), not by L2 or
// device memory (k7 without its weight loads keeps 58 % of its time); the
// attention kernels also leave 48 SMs idle.
#include <cooperative_groups.h>

#include "vit_attn.cuh"
#include "wmma_gemm.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace nvcuda;
using vit_attn::kMaxDhTiles;
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
// k5, k8: the attention sub-layer, one cluster an image, one CTA a head
// --------------------------------------------------------------------------

constexpr int AR = 128;  // rows of a phase-1 pass, a warp a 16-row tile
constexpr int ABK = 32;  // K step of phase 1
constexpr int LDA = ABK + 8;
constexpr int kQkvTiles = 12;  // q|k|v column tiles a phase-1 pass holds (dh <= 64: all)
constexpr int LDB = 16 * kQkvTiles + 8;
constexpr int kAttnStages = 4;
constexpr int kMaxHeads = 16;   // the largest (non-portable) cluster
constexpr int kOChunks = 8;     // 16-byte chunks of a remote o_h a thread has in flight

struct AttnLayout {
  int npad, ldq, ls, stage;  // stage: bf16 elements of a phase-1 ring stage
  size_t q, k, v, stats, e, region, total;
};

__host__ __device__ inline AttnLayout attn_layout(int n, int dh) {
  AttnLayout L;
  L.npad = (n + 15) / 16 * 16;
  L.ldq = dh + 8;
  L.ls = vit_attn::score_stride(L.npad, dh);
  L.stage = AR * LDA + ABK * LDB;
  const size_t head = smem_align((size_t)L.npad * L.ldq * sizeof(bf16));
  const size_t scores = (size_t)kWarps * 16 * L.ls * sizeof(float);
  const size_t ring = (size_t)kAttnStages * L.stage * sizeof(bf16);
  const size_t out_bufs = 2 * smem_align((size_t)(L.npad + dh) * L.ldq * sizeof(bf16));
  size_t region = scores > ring ? scores : ring;
  region = region > out_bufs ? region : out_bufs;
  size_t off = 0;
  L.q = off; off += head;
  L.k = off; off += head;
  L.v = off; off += head;
  L.stats = off; off += smem_align(2 * (size_t)L.npad * sizeof(float));
  L.e = off; off += kStagingBytes;
  L.region = off; off += smem_align(region);
  L.total = off;
  return L;
}

// kBlock: k8 (LN before, residual after); else k5. Grid (heads, ceil(b / G)),
// clusters of `heads` CTAs along x.
template <bool kBlock>
__global__ void __launch_bounds__(kThreads, 1)
    vit_fused_attn_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
                          const float* __restrict__ ln_b, const bf16* __restrict__ wqkv,
                          const float* __restrict__ bqkv, const bf16* __restrict__ wo,
                          const float* __restrict__ bo, bf16* __restrict__ out, int b, int n,
                          int heads, int dh, int group, float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const AttnLayout L = attn_layout(n, dh);
  bf16* sQ = reinterpret_cast<bf16*>(smem + L.q);  // q_h, then o_h over it
  bf16* sK = reinterpret_cast<bf16*>(smem + L.k);
  bf16* sV = reinterpret_cast<bf16*>(smem + L.v);
  float* sMu = reinterpret_cast<float*>(smem + L.stats);
  float* sRstd = sMu + L.npad;
  unsigned char* region = smem + L.region;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* sE = reinterpret_cast<float*>(smem + L.e) + warp * 16 * LDE;
  const int er = lane / 2, ec = (lane % 2) * 8;
  const int npad = L.npad, ldq = L.ldq, dtiles = dh / 16, d = heads * dh;
  const int h = (int)cluster.block_rank();
  const int first = blockIdx.y * group, last = min(b, first + group);

  for (int img = first; img < last; ++img) {
    const bf16* xi = x + (size_t)img * n * d;
    if (kBlock) {
      // LN statistics: CTA h takes rows h, h + heads, ..., a warp a row
      // (the mean, then the mean of the squared deviations), then reads
      // the other rows' from their CTAs
      for (int r = h + heads * warp; r < n; r += heads * kWarps) {
        const bf16* row = xi + (size_t)r * d;
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
        const float var = warp_sum(sq) / d;
        if (lane == 0) {
          sMu[r] = mean;
          sRstd[r] = rsqrtf(var + eps);
        }
      }
      cluster.sync();
      for (int r = tid; r < n; r += kThreads) {
        const int owner = r % heads;
        if (owner == h) continue;
        sMu[r] = *cluster.map_shared_rank(sMu + r, owner);
        sRstd[r] = *cluster.map_shared_rank(sRstd + r, owner);
      }
      __syncthreads();
    }

    // phase 1: q_h | k_h | v_h = bf16(y W_qkv[:, head h's columns] + b),
    // rows past n zeros; a pass is 128 rows x up to 12 column tiles of the
    // 3 dh columns (all of them for dh <= 64)
    const int col_tiles = 3 * dtiles;
    for (int r0 = 0; r0 < npad; r0 += AR) {
      for (int ct0 = 0; ct0 < col_tiles; ct0 += kQkvTiles) {
        const int nt = min(kQkvTiles, col_tiles - ct0);
        bf16* ring = reinterpret_cast<bf16*>(region);
        // column c of the pass -> column of W_qkv (q, k or v block, head h)
        auto wcol = [&](int c) {
          const int cc = 16 * ct0 + c;
          return (cc / dh) * d + h * dh + cc % dh;
        };
        auto copy_stage = [&](int st, int ks) {
          bf16* sa = ring + (size_t)st * L.stage;
          bf16* sb = sa + AR * LDA;
          const int k0 = ks * ABK;
          for (int idx = tid; idx < AR * (ABK / 8); idx += kThreads) {
            const int r = idx / (ABK / 8), c = (idx % (ABK / 8)) * 8;
            const bool ok = r0 + r < n && k0 + c < d;
            cp_async16(sa + r * LDA + c, ok ? xi + (size_t)(r0 + r) * d + k0 + c : xi, ok);
          }
          const int chunks = 2 * nt;
          for (int idx = tid; idx < ABK * chunks; idx += kThreads) {
            const int r = idx / chunks, c = (idx % chunks) * 8;
            const bool ok = k0 + r < d;
            cp_async16(sb + r * LDB + c, ok ? wqkv + (size_t)(k0 + r) * 3 * d + wcol(c) : wqkv,
                       ok);
          }
        };
        // the LN affine on the activation chunks this thread copied
        auto layer_norm = [&](int st, int ks) {
          bf16* sa = ring + (size_t)st * L.stage;
          const int k0 = ks * ABK;
          for (int idx = tid; idx < AR * (ABK / 8); idx += kThreads) {
            const int r = idx / (ABK / 8), c = (idx % (ABK / 8)) * 8;
            if (r0 + r >= n || k0 + c >= d) continue;
            uint4* p = reinterpret_cast<uint4*>(sa + r * LDA + c);
            const float mu = sMu[r0 + r], rstd = sRstd[r0 + r];
            float v[8];
            unpack_bf16x8(*p, v);
            for (int t = 0; t < 8; ++t)
              v[t] = (v[t] - mu) * rstd * ln_s[k0 + c + t] + ln_b[k0 + c + t];
            *p = pack_bf16x8(v);
          }
        };

        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kQkvTiles];
#pragma unroll
        for (int t = 0; t < kQkvTiles; ++t) wmma::fill_fragment(acc[t], 0.0f);
        const bool mine = r0 + 16 * warp < npad;  // this warp's 16 rows exist
        const int ksteps = (d + ABK - 1) / ABK;
        for (int st = 0; st < kAttnStages - 1; ++st) {
          if (st < ksteps) copy_stage(st, st);
          cp_async_commit();
        }
        for (int ks = 0; ks < ksteps; ++ks) {
          const int st = ks % kAttnStages;
          cp_async_wait<kAttnStages - 2>();
          if (kBlock) layer_norm(st, ks);
          __syncthreads();
          if (ks + kAttnStages - 1 < ksteps)
            copy_stage((ks + kAttnStages - 1) % kAttnStages, ks + kAttnStages - 1);
          cp_async_commit();
          if (!mine) continue;
          const bf16* sa = ring + (size_t)st * L.stage;
          const bf16* sb = sa + AR * LDA;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[ABK / 16];
#pragma unroll
          for (int kk = 0; kk < ABK / 16; ++kk)
            wmma::load_matrix_sync(fa[kk], sa + 16 * warp * LDA + 16 * kk, LDA);
#pragma unroll
          for (int t = 0; t < kQkvTiles; ++t) {
            if (t >= nt) break;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[ABK / 16];
#pragma unroll
            for (int kk = 0; kk < ABK / 16; ++kk)
              wmma::load_matrix_sync(fb[kk], sb + 16 * kk * LDB + 16 * t, LDB);
#pragma unroll
            for (int kk = 0; kk < ABK / 16; ++kk) wmma::mma_sync(acc[t], fa[kk], fb[kk], acc[t]);
          }
        }
        cp_async_wait<0>();
        if (mine) {
#pragma unroll
          for (int t = 0; t < kQkvTiles; ++t) {
            if (t >= nt) break;
            wmma::store_matrix_sync(sE, acc[t], LDE, wmma::mem_row_major);
            __syncwarp();
            const int cc = 16 * (ct0 + t) + ec, which = cc / dh, col = cc % dh;
            bf16* dst = which == 0 ? sQ : which == 1 ? sK : sV;
            const float* bias = bqkv + which * d + h * dh + col;
            const int row = r0 + 16 * warp + er;
            float v[8];
            for (int i = 0; i < 8; ++i) v[i] = row < n ? sE[er * LDE + ec + i] + bias[i] : 0.f;
            *reinterpret_cast<uint4*>(dst + (size_t)row * ldq + col) = pack_bf16x8(v);
            __syncwarp();
          }
        }
        __syncthreads();  // the ring is free for the next pass
      }
    }

    // phase 2: o_h = attention of head h, a warp 16 queries at a time,
    // written bf16 over the warp's own q rows
    {
      float* wS = reinterpret_cast<float*>(region) + (size_t)warp * 16 * L.ls;
      for (int tile = warp; tile < npad / 16; tile += kWarps) {
        const int rows = min(16, n - 16 * tile);
        bf16* q16 = sQ + (size_t)16 * tile * ldq;
        vit_attn::attend_warp(q16, ldq, sK, sV, ldq, wS, L.ls, n, npad, dh, scale, rows);
        const int chunks = dh / 8;
        for (int idx = lane; idx < 16 * chunks; idx += 32) {
          const int r = idx / chunks, c = (idx % chunks) * 8;
          float v[8];
          for (int i = 0; i < 8; ++i) v[i] = r < rows ? wS[(size_t)r * L.ls + c + i] : 0.f;
          *reinterpret_cast<uint4*>(q16 + (size_t)r * ldq + c) = pack_bf16x8(v);
        }
        __syncwarp();
      }
    }
    cluster.sync();  // every head's o_h is in its CTA's shared memory

    // phase 3: out[:, h dh:(h+1) dh] = sum over heads hh of
    // o_hh W_o[hh dh:(hh+1) dh, h dh:(h+1) dh], hh in order. Two buffers:
    // head hh + 1's W_o block (cp.async) and o (loads from CTA hh + 1, held
    // in registers) are in flight while head hh's products run.
    {
      const size_t buf_elems = smem_align((size_t)(npad + dh) * ldq * sizeof(bf16)) / sizeof(bf16);
      bf16* bufs = reinterpret_cast<bf16*>(region);
      const int oc0 = h * dh, chunks = dh / 8, total = npad * chunks;
      uint4 held[kOChunks];
      // head hh's W_o block into buffer buf (cp.async, one group), and the
      // first kOChunks x kThreads chunks of its o into registers
      auto fetch = [&](int hh, int buf) {
        bf16* bufW = bufs + buf * buf_elems + (size_t)npad * ldq;
        for (int idx = tid; idx < dh * chunks; idx += kThreads) {
          const int r = idx / chunks, c = (idx % chunks) * 8;
          cp_async16(bufW + r * ldq + c, wo + (size_t)(hh * dh + r) * d + oc0 + c, true);
        }
        cp_async_commit();
        const bf16* remote = cluster.map_shared_rank(sQ, hh);
#pragma unroll
        for (int u = 0; u < kOChunks; ++u) {
          const int idx = tid + u * kThreads;
          if (idx < total)
            held[u] = *reinterpret_cast<const uint4*>(remote + (size_t)(idx / chunks) * ldq +
                                                      (idx % chunks) * 8);
        }
      };
      // the held chunks into buffer buf, then the rest of o (past
      // kOChunks x kThreads chunks, only for npad dh > 16384) directly
      auto land = [&](int hh, int buf) {
        bf16* bufO = bufs + buf * buf_elems;
#pragma unroll
        for (int u = 0; u < kOChunks; ++u) {
          const int idx = tid + u * kThreads;
          if (idx < total)
            *reinterpret_cast<uint4*>(bufO + (size_t)(idx / chunks) * ldq + (idx % chunks) * 8) =
                held[u];
        }
        const bf16* remote = cluster.map_shared_rank(sQ, hh);
        for (int idx = tid + kOChunks * kThreads; idx < total; idx += kThreads) {
          const size_t at = (size_t)(idx / chunks) * ldq + (idx % chunks) * 8;
          *reinterpret_cast<uint4*>(bufO + at) = *reinterpret_cast<const uint4*>(remote + at);
        }
      };
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kMaxDhTiles];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int t = 0; t < kMaxDhTiles; ++t) wmma::fill_fragment(acc[i][t], 0.0f);
      fetch(0, 0);
      land(0, 0);
      for (int hh = 0; hh < heads; ++hh) {
        const int buf = hh % 2;
        cp_async_wait<0>();
        __syncthreads();  // head hh's buffer is complete; the other is free
        if (hh + 1 < heads) fetch(hh + 1, 1 - buf);
        const bf16* bufO = bufs + buf * buf_elems;
        const bf16* bufW = bufO + (size_t)npad * ldq;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int rt = warp + kWarps * i;
          if (16 * rt >= npad) break;
#pragma unroll
          for (int kk = 0; kk < kMaxDhTiles; ++kk) {
            if (kk >= dtiles) break;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::load_matrix_sync(fa, bufO + (size_t)16 * rt * ldq + 16 * kk, ldq);
#pragma unroll
            for (int t = 0; t < kMaxDhTiles; ++t) {
              if (t >= dtiles) break;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
              wmma::load_matrix_sync(fb, bufW + 16 * kk * ldq + 16 * t, ldq);
              wmma::mma_sync(acc[i][t], fa, fb, acc[i][t]);
            }
          }
        }
        if (hh + 1 < heads) land(hh + 1, 1 - buf);
      }
      // epilogue: + b_o (+ the residual, k8), rounded once
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int rt = warp + kWarps * i;
        if (16 * rt >= npad) break;
#pragma unroll
        for (int t = 0; t < kMaxDhTiles; ++t) {
          if (t >= dtiles) break;
          wmma::store_matrix_sync(sE, acc[i][t], LDE, wmma::mem_row_major);
          __syncwarp();
          const int row = 16 * rt + er, col = oc0 + 16 * t + ec;
          if (row < n) {
            const size_t at = ((size_t)img * n + row) * d + col;
            float v[8];
            for (int j = 0; j < 8; ++j) v[j] = sE[er * LDE + ec + j] + bo[col + j];
            if (kBlock) {
              float res[8];
              unpack_bf16x8(*reinterpret_cast<const uint4*>(x + at), res);
              for (int j = 0; j < 8; ++j) v[j] = res[j] + v[j];
            }
            *reinterpret_cast<uint4*>(out + at) = pack_bf16x8(v);
          }
          __syncwarp();
        }
      }
    }
    cluster.sync();  // no CTA overwrites its o_h or exits while others read it
  }
}

template <bool kBlock>
cudaError_t attn_config(int n, int dh, int heads, size_t* smem) {
  *smem = attn_layout(n, dh).total;
  cudaError_t err = cudaFuncSetAttribute(vit_fused_attn_kernel<kBlock>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) return err;
  if (heads > 8)
    err = cudaFuncSetAttribute(vit_fused_attn_kernel<kBlock>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t attn_launch_config(int heads, int blocks, size_t smem, cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(heads, blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = heads;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kBlock>
cudaError_t launch_attn(const bf16* x, const float* ln_s, const float* ln_b, const bf16* wqkv,
                        const float* bqkv, const bf16* wo, const float* bo, bf16* out, int b,
                        int n, int heads, int dh, int group, float scale, float eps,
                        cudaStream_t stream) {
  size_t smem;
  cudaError_t err = attn_config<kBlock>(n, dh, heads, &smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      attn_launch_config(heads, (b + group - 1) / group, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, vit_fused_attn_kernel<kBlock>, x, ln_s, ln_b, wqkv, bqkv, wo,
                           bo, out, b, n, heads, dh, group, scale, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

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
// out [b, n, d]. A cluster of `heads` CTAs walks `group` images in turn.
// n <= 256, dh a multiple of 16 up to 128, heads <= 16, and the layout's
// shared memory within a block's 227 KB (mirror_vit_fused_attn_smem).
MIRROR_EXPORT int mirror_vit_fused_attn(const void* x, const void* ln_s, const void* ln_b,
                                        const void* wqkv, const void* bqkv, const void* wo,
                                        const void* bo, void* out, int b, int n, int heads,
                                        int dh, int group, float scale, float eps,
                                        cudaStream_t stream) {
  if (n <= 0 || n > vit_attn::kMaxCols || dh % 16 != 0 || dh / 16 > kMaxDhTiles ||
      heads <= 0 || heads > kMaxHeads || group <= 0 || (b + group - 1) / group > 65535)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* sp = static_cast<const float*>(ln_s);
  const auto* lbp = static_cast<const float*>(ln_b);
  const auto* wq = static_cast<const bf16*>(wqkv);
  const auto* bq = static_cast<const float*>(bqkv);
  const auto* wop = static_cast<const bf16*>(wo);
  const auto* bop = static_cast<const float*>(bo);
  auto* ob = static_cast<bf16*>(out);
  if (ln_s != nullptr)
    return (int)launch_attn<true>(xb, sp, lbp, wq, bq, wop, bop, ob, b, n, heads, dh, group,
                                  scale, eps, stream);
  return (int)launch_attn<false>(xb, sp, lbp, wq, bq, wop, bop, ob, b, n, heads, dh, group,
                                 scale, eps, stream);
}

// Bytes of shared memory a CTA of the attention kernels needs at (n, dh).
MIRROR_EXPORT long long mirror_vit_fused_attn_smem(int n, int dh) {
  return (long long)attn_layout(n, dh).total;
}

// How many clusters of `heads` CTAs of the attention kernel the card holds
// at once (cudaOccupancyMaxActiveClusters): 0 when one cannot be scheduled,
// minus a CUDA error code when the query fails.
MIRROR_EXPORT long long mirror_vit_fused_attn_clusters(int n, int dh, int heads) {
  size_t smem;
  cudaError_t err = attn_config<true>(n, dh, heads, &smem);
  if (err != cudaSuccess) return -(long long)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = attn_launch_config(heads, 1, smem, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, vit_fused_attn_kernel<true>, &cfg);
  if (err != cudaSuccess) return -(long long)err;
  return clusters;
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
