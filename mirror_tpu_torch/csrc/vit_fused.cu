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
// The GELU's erf is the TPU kernel's A&S 7.1.26 polynomial (|error| <=
// 1.5e-7, far below a bf16 ulp of the hidden, 2^-8 relative).
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
// MLP (k7, k9): wgmma fed by TMA, a quad of CTAs a 64-row tile of the
// flattened [b n, d] rows (rows past the end zero-filled by the TMA map),
// kQuads = 2 quads a cluster (8 CTAs). What holds such a kernel back: L2,
// and the registers. Every weight byte (9.4 MB of W_1 and W_2) is read
// once for each group of rows that shares it, 100864 / 64 x 9.4 MB = 14.9
// GB at B 512 for 64 rows (about 2.7 ms at 5.5 TB/s, against 0.96 ms of
// products); and a tile's fc2 accumulator, [64, 768] fp32, is 192 KB,
// three quarters of an SM's registers, while ptxas compiles a wgmma
// m64n256k16 only with 154 registers a thread or more (fewer than a block
// of 512 threads gets). So a tile's work is split across four SMs, and the
// quads of a cluster share each weight box by multicast (each CTA of a
// role loads every kQuads-th box of a stage for the kQuads CTAs of that
// role, and hands the stage back to all of them), which divides the L2
// traffic by kQuads:
// - two fc1 CTAs (f = 0, 1) keep the tile y resident (d / 64 boxes of [64,
//   64], 128-byte swizzle) and take the quad's 128-column hidden chunks q =
//   f, f + 2, ..., their three consumer warpgroups in turns (chunk q = 2 (3
//   i + j) + f to warpgroup j), so that two can run their GELU while the
//   third multiplies: acc[64, 128] = y W_1[:, chunk] by wgmma m64n128k16
//   (y K-major, the W_1 stage [64, 128] MN-major from an 8-stage ring),
//   then + b_1 and the erf GELU in fp32 in registers, one rounding, zeros
//   past m, and the bf16 chunk stored straight into hidden buffer q % 6 of
//   the first fc2 CTA (16 bytes a lane after a transpose across each quad,
//   in the swizzled A layout), fenced for the async proxy and released to
//   it by one arrival a thread. A warpgroup waits on its chunk's stages only
//   in its turn (a barrier's parity tells apart only two phases). k9: the
//   12 consumer warps apply the LN to each landed tile once, in place, a
//   warp a row, then fence.proxy.async and a barrier;
// - two fc2 CTAs (h = 0, 1) each sum the output columns [384 h, 384 h +
//   384) over the chunks in order, three consumer warpgroups of 128
//   columns: acc[64, 128] += h_q W_2[chunk rows, columns] by wgmma
//   m64n128k16 (the hidden chunk K-major from its buffer, the W_2 stage
//   [32, 384] MN-major from a 5-stage ring); then + b_2 (+ x, k9) in fp32,
//   rounded once, stored from the registers. The first fc2 CTA copies each
//   chunk on to the second by one bulk copy (a second round of stores from
//   the fc1 warpgroup cost more). Columns past d are computed, not stored;
//   so d <= 768.
// - warpgroup 0 feeds: thread 0 the weight ring; warp 1 the y tiles (fc1)
//   or the hand-back of each hidden buffer once the CTA's products have
//   read it (fc2; the fc1 warpgroup that fills the buffer waits for both
//   fc2 CTAs'); warp 2 of the first fc2 CTA the copy of each chunk on to
//   the second.
// The hidden chunks are summed in a fixed order with no atomics: two calls,
// and every kQuads, give the same bits. The hidden layer never leaves shared
// memory; the wrapper allocates only the output.
// Measured (H100 80GB HBM3, 700 W; exp_vit_fused_sublayer at B 512 beside
// the parent's WMMA kernel in one call, scripts/vit_fused_phases.py): k7
// 2.61-2.66 ms at G 1 (17.93-18.02 before; matmul, gelu, matmul 2.68-2.71),
// k9 3.25-3.28 (18.46-18.51; with layer_norm and add 3.07-3.09), kernel 7's
// split 1.81-1.82. kQuads = 2 beat 1 and 4 in every call. Per 64-row tile and
// consumer warpgroup, the fc1 CTA's GELU and stores took about three times
// its products' clocks: the epilogue runs one warp a scheduler (no GELU:
// k7 about 2.0 ms; no stores: about 2.0 ms). Tried and not kept: one CTA
// pair a tile with the [64, 768] accumulator in 3 warpgroups (ptxas needs
// 154 registers a thread for m64n256k16; 512 threads get 128); 256-column
// chunks in two warpgroups (k7 3.25 ms with the chunk copied through a
// staging chunk by bulk copies, its 4-stage W_1 ring starved; 4.37 with
// 4-byte stores into both fc2 CTAs); erff (0.2 ms slower than the
// polynomial); the LN by two warps of warpgroup 0, or by the two fc1
// warpgroups not busy with a GELU (k9 3.80-4.02).
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

namespace {

namespace cg = cooperative_groups;
using namespace hopper;

// GELU(v) = v (1 + erf(v / sqrt 2)) / 2 with erf by Abramowitz & Stegun
// 7.1.26, as the TPU kernel computes it (|error| <= 1.5e-7, far below a
// bf16 ulp of the hidden): erfc(z) = t P(t) exp(-z^2), t = 1 / (1 + p z), z
// = |v| / sqrt 2, so GELU(v) = v - w for v >= 0 and w below, w = v erfc(z)
// / 2 (P's coefficients halved). A reciprocal, an exponential and a dozen
// FP32 operations: the epilogue that runs it is one warp a scheduler.
__device__ __forceinline__ float gelu_erf(float v) {
  const float t = __fdividef(1.0f, fmaf(0.3275911f * 0.70710678118654752f, fabsf(v), 1.0f));
  const float half_p =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 0.5f * 1.061405429f, 0.5f * -1.453152027f),
                               0.5f * 1.421413741f),
                       0.5f * -0.284496736f),
               0.5f * 0.254829592f);
  const float w = v * half_p * exp2f(v * v * (-0.5f * 1.4426950408889634f));
  return v >= 0.f ? v - w : w;
}

// --------------------------------------------------------------------------
// k7, k9: the MLP sub-layer, a quad of CTAs a 64-row tile (two fc1 CTAs,
// two fc2 CTAs), kQuads quads a cluster
// --------------------------------------------------------------------------

// Quads of a cluster: they share each weight box by multicast. 2 beat 1
// and 4 on the H100 (scripts/vit_fused_phases.py builds 1 and 4 beside it).
constexpr int kQuads = 2;

constexpr int kMlpThreads = 512;  // warpgroup 0 feeds, warpgroups 1-3 multiply
constexpr int kMlpRows = 64;      // rows of a tile: one m64 wgmma tile
constexpr int kChunk = 128;       // hidden columns of a chunk: one m64n128k16
constexpr int kHalfD = 384;       // output columns of a fc2 CTA: three warpgroups of 128
constexpr int kMaxD = 2 * kHalfD;
constexpr int kK1 = 64;           // K rows (of d) a W_1 stage holds
constexpr int kK2 = 32;           // K rows (of m) a W_2 stage holds
constexpr int kStages1 = 8, kStages2 = 5;
constexpr int kBufs = 6;          // hidden buffers of a fc2 CTA: chunk q lands in q % 6
constexpr unsigned kBox = kMlpRows * 64 * 2;         // 8 KB: [64 rows, 64 columns] of y or h
constexpr unsigned kW1Box = kK1 * 64 * 2;            // 8 KB: [64, 64] of W_1
constexpr unsigned kW2Box = kK2 * 64 * 2;            // 4 KB: [32, 64] of W_2
constexpr unsigned kW1Stage = kChunk / 64 * kW1Box;  // 16 KB
constexpr unsigned kW2Stage = kHalfD / 64 * kW2Box;  // 24 KB
constexpr unsigned kHBytes = kChunk / 64 * kBox;     // 16 KB: a hidden chunk [64, 128]
// Shared memory, as offsets from a base aligned by hand to the 1024 bytes
// the 128-byte swizzle repeats over. A fc1 CTA: the row tile y (d / 64
// boxes), the W_1 ring. A fc2 CTA: kBufs hidden chunks (at offset 0), the
// W_2 ring. Both: the barriers.
constexpr size_t kOffRing1 = kMaxD / 64 * kBox;               // 96 KB
constexpr size_t kOffRing2 = kBufs * kHBytes;                 // 96 KB
constexpr size_t kOffBars = kOffRing1 + kStages1 * kW1Stage;  // 224 KB
static_assert(kOffRing2 + kStages2 * kW2Stage <= kOffBars, "the W_2 ring outgrew its place");

struct MlpBars {
  uint64_t full[kStages1], empty[kStages1];  // the weight ring's stages (fc2: kStages2)
  uint64_t y_full, y_empty;  // fc1 CTA: y landed / read by every product of the tile
  uint64_t hfree[3];         // fc1 CTA: both fc2 CTAs took back warpgroup j's buffer
  uint64_t turn[3];          // fc1 CTA: warpgroup j may wait on its next chunk's stages
  uint64_t h_full[kBufs], h_empty[kBufs];  // fc2 CTA: hidden buffer q % 6 written / read
};
constexpr size_t kMlpSmem = kOffBars + sizeof(MlpBars) + 1024;  // + the alignment slack
static_assert(kMlpSmem <= 232448, "the MLP kernel outgrew a block's shared memory");

struct MlpArgs {
  const bf16* x;  // [rows, d]: k9's residual is read here
  const float *ln_s, *ln_b, *b1, *b2;
  bf16* out;
  int rows, d, m, tiles;  // tiles: the 64-row tiles a quad walks
  float eps;
};

__device__ __forceinline__ int mlp_chunks(int m) { return (m + kChunk - 1) / kChunk; }

// Bias pairs of a warpgroup's accumulator columns, fetched once a warp
// (global loads one at a time in the epilogue each stalled the warp):
// lane l holds the pairs p = l + 32 k of the columns col0 + 2 p, zeros from
// `end` on; the pair of 8-column group jj a lane (g, t4) adds, p = 4 jj +
// t4, is held by lane 4 (jj % 8) + t4, slot jj / 8.
template <int K>
__device__ __forceinline__ void load_bias_pairs(float2 (&held)[K], const float* bias, int col0,
                                                int end, int lane) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int col = col0 + 2 * (lane + 32 * k);  // end is a multiple of 8: col + 1 < end too
    held[k] = col < end ? __ldg(reinterpret_cast<const float2*>(bias + col))
                        : make_float2(0.f, 0.f);
  }
}

template <int K>
__device__ __forceinline__ float2 bias_pair(const float2 (&held)[K], int jj, int t4) {
  const int src = 4 * (jj % 8) + t4;
  return make_float2(__shfl_sync(0xffffffffu, held[jj / 8].x, src),
                     __shfl_sync(0xffffffffu, held[jj / 8].y, src));
}

// A 4 x 4 transpose of 32-bit values across the 4 lanes of each quad (t4 =
// lane % 4): afterwards lane t4's v[x] is lane x's v[t4] before. Turns the
// accumulator layout (a lane 2 columns of each 8-column group) into 16
// bytes of one row a lane.
__device__ __forceinline__ void transpose_quad(unsigned (&v)[4], int t4) {
  unsigned r[4] = {v[0], v[1], v[2], v[3]};
#pragma unroll
  for (int m = 1; m < 4; ++m) {
    const int x = t4 ^ m;  // the partner lane, which takes this lane's v[x] into its r[t4]
    const unsigned send = x == 0 ? v[0] : x == 1 ? v[1] : x == 2 ? v[2] : v[3];
    const unsigned got = __shfl_xor_sync(0xffffffffu, send, m);
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = i == x ? got : r[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = r[i];
}

// the warpgroup of this thread, read from lane 0 so that the compiler sees
// a warp-uniform value (wgmma in branches on it is not serialised)
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
}

// one weight box into `dst` of this CTA, or of every CTA of its role in the
// cluster (ranks first .. first + kQuads - 1) by multicast
__device__ __forceinline__ void load_weight_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                int c0, int c1, int first) {
  if constexpr (kQuads == 1)
    tma_load(dst, map, bar, c0, c1);
  else
    tma_load_multicast(dst, map, bar, c0, c1, (uint16_t)(((1u << kQuads) - 1) << first));
}

// a weight stage read: one arrival a warp on the stage's "empty" barrier in
// every CTA whose load wrote it (its role's kQuads CTAs, ranks first ..)
__device__ __forceinline__ void release_stage(uint64_t* bar, int lane, int first) {
  if constexpr (kQuads == 1) {
    if (lane == 0) mbar_arrive(bar);
  } else {
    if (lane < kQuads) mbar_arrive_rank(bar, first + lane);
  }
}

// fc1 CTA f, thread 0: W_1 through the ring for the chunks it takes (the
// quad's chunk sequence q = tile nch + c, every second one from f), K step
// by K step; a stage is [64 rows of d, 128 hidden columns] as 2 boxes
// (fewer past m), each CTA of the role loading every kQuads-th box for all
__device__ __forceinline__ void feed_w1(const CUtensorMap* map_w1, MlpBars& bars,
                                        unsigned char* smem, const MlpArgs& a, int f, int quad) {
  const int nch = mlp_chunks(a.m), ksteps = (a.d + kK1 - 1) / kK1;
  int stage = 0;
  unsigned phase = 0;
  for (int q = f; q < a.tiles * nch; q += 2) {
    const int c = q % nch, boxes = min(kChunk / 64, (a.m - c * kChunk + 63) / 64);
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(&bars.empty[stage], phase ^ 1);  // passes at once on the first round
      mbar_expect_tx(&bars.full[stage], boxes * kW1Box);
      unsigned char* dst = smem + kOffRing1 + stage * kW1Stage;
      for (int bx = quad; bx < boxes; bx += kQuads)
        load_weight_box(dst + bx * kW1Box, map_w1, &bars.full[stage], c * kChunk + 64 * bx,
                        ks * kK1, f * kQuads);
      if (++stage == kStages1) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// fc1 CTA, warp 1: the row tile y = x[64 rows, d] as d / 64 boxes of [64,
// 64] (rows past the end zero-filled) once every product has read the last
__device__ __forceinline__ void feed_y(const CUtensorMap* map_x, MlpBars& bars,
                                       unsigned char* smem, const MlpArgs& a, int tile0) {
  const int boxes = (a.d + 63) / 64;
  for (int t = 0; t < a.tiles; ++t) {
    mbar_wait(&bars.y_empty, (t & 1) ^ 1);
    const int row0 = (tile0 + t) * kMlpRows;
    if (row0 >= a.rows) {  // wholly past the end: nothing of it is stored
      mbar_arrive(&bars.y_full);
      continue;
    }
    mbar_expect_tx(&bars.y_full, boxes * kBox);
    for (int bx = 0; bx < boxes; ++bx)
      tma_load(smem + bx * kBox, map_x, &bars.y_full, 64 * bx, row0);
  }
}

// fc2 CTA h, thread 0: W_2 through the ring for every chunk in order, K step
// by K step; a stage is [32 hidden rows, the CTA's 384 columns] as 6 boxes
// (fewer past d)
__device__ __forceinline__ void feed_w2(const CUtensorMap* map_w2, MlpBars& bars,
                                        unsigned char* smem, const MlpArgs& a, int h, int quad) {
  const int nch = mlp_chunks(a.m);
  const int boxes = max(0, min(kHalfD / 64, (a.d - h * kHalfD + 63) / 64));
  int stage = 0;
  unsigned phase = 0;
  for (int q = 0; q < a.tiles * nch; ++q) {
    const int c = q % nch, ksteps = (min(kChunk, a.m - c * kChunk) + kK2 - 1) / kK2;
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(&bars.empty[stage], phase ^ 1);
      mbar_expect_tx(&bars.full[stage], boxes * kW2Box);
      unsigned char* dst = smem + kOffRing2 + stage * kW2Stage;
      for (int bx = quad; bx < boxes; bx += kQuads)
        load_weight_box(dst + bx * kW2Box, map_w2, &bars.full[stage], h * kHalfD + 64 * bx,
                        c * kChunk + ks * kK2, (2 + h) * kQuads);
      if (++stage == kStages2) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// fc2 CTA h, warp 1: hands hidden buffer q % 6 back to the fc1 warpgroup
// that fills it (fc1 CTA q % 2, warpgroup q / 2 % 3) once this CTA's
// products have read it; the second fc2 CTA first arms the buffer's "full"
// barrier for the copy from the first
__device__ __forceinline__ void hand_back_hidden(MlpBars& bars, const MlpArgs& a, int h,
                                                 int quad) {
  const int chunks = a.tiles * mlp_chunks(a.m);
  for (int q = 0; q < chunks; ++q) {
    const int hb = q % kBufs;
    mbar_wait(&bars.h_empty[hb], ((q / kBufs) & 1) ^ 1);
    if (h == 1) mbar_expect_tx(&bars.h_full[hb], kHBytes);
    mbar_arrive_rank(&bars.hfree[hb / 2], (hb % 2) * kQuads + quad);
  }
}

// the first fc2 CTA, warp 2: each hidden chunk, once its fc1 warpgroup has
// released it here, copied on to the second fc2 CTA by one bulk copy
// (cheaper than a second round of stores from the fc1 warpgroup)
__device__ __forceinline__ void forward_hidden(MlpBars& bars, unsigned char* smem,
                                               const MlpArgs& a, int quad) {
  const int chunks = a.tiles * mlp_chunks(a.m);
  for (int q = 0; q < chunks; ++q) {
    const int hb = q % kBufs;
    mbar_wait_cluster(&bars.h_full[hb], (q / kBufs) & 1);
    bulk_copy_to_rank(smem + hb * kHBytes, smem + hb * kHBytes, kHBytes, &bars.h_full[hb],
                      3 * kQuads + quad);
  }
}

// k9: y = LN(x) on rows r0, r0 + stride, ... of the landed tile, in place, a
// warp a row: fp32 statistics, the mean first, then the mean of the squared
// deviations; rounded once. Chunk p of row r of a box holds its columns
// 8 (p ^ r % 8) .. + 7 (the 128-byte swizzle); lane l takes chunks l, l +
// 32, l + 64 of the row (box ci / 8, chunk ci % 8). The LN scale and shift
// (6 KB, in L1 after the first row) are read again each row: held for the
// tile they took 48 registers beside the accumulators.
__device__ __forceinline__ void layer_norm_rows(unsigned char* y, const MlpArgs& a, int r0,
                                                int stride, int lane) {
  for (int r = r0; r < kMlpRows; r += stride) {
    float v[3][8], sum = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int ci = lane + 32 * i;
      if (8 * ci < a.d) {
        unpack_bf16x8(*reinterpret_cast<const uint4*>(y + (ci / 8) * kBox + r * 128 +
                                                      (((ci % 8) ^ (r % 8)) << 4)),
                      v[i]);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += v[i][e];
      }
    }
    const float mean = warp_sum(sum) / a.d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (8 * (lane + 32 * i) < a.d)
#pragma unroll
        for (int e = 0; e < 8; ++e) sq += (v[i][e] - mean) * (v[i][e] - mean);
    const float rstd = rsqrtf(warp_sum(sq) / a.d + a.eps);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int ci = lane + 32 * i, col = 8 * ci;
      if (col < a.d) {
        float sc[8], sh[8];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          *reinterpret_cast<float4*>(sc + 4 * h) =
              __ldg(reinterpret_cast<const float4*>(a.ln_s + col + 4 * h));
          *reinterpret_cast<float4*>(sh + 4 * h) =
              __ldg(reinterpret_cast<const float4*>(a.ln_b + col + 4 * h));
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) v[i][e] = (v[i][e] - mean) * rstd * sc[e] + sh[e];
        *reinterpret_cast<uint4*>(y + (ci / 8) * kBox + r * 128 + (((ci % 8) ^ (r % 8)) << 4)) =
            pack_bf16x8(v[i]);
      }
    }
  }
}

// h = bf16(GELU(acc + b_1)) of a chunk from columns col0 on (zeros past m:
// kEdge, the last chunk) into a fc2 CTA's hidden buffer (this thread's row
// of it at dst). Lane (g, t4) holds rows 16 warp + g (+ 8), columns 8 jj +
// 2 t4 (+ 1); four column groups at a time are transposed across the quad,
// so that it stores the 16 bytes of group 4 k + t4 of its row: chunk (4 k +
// t4) % 8 of the row of box k / 2, at position (4 k + t4) % 8 ^ g (the
// row's 8).
template <bool kEdge>
__device__ __forceinline__ void store_hidden(const float (&acc)[64], const float2 (&bias)[2],
                                             int col0, int m, unsigned dst, int g, int t4) {
#pragma unroll
  for (int k = 0; k < kChunk / 32; ++k) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      unsigned pk[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int jj = 4 * k + x;
        const bool in = !kEdge || col0 + 8 * jj + 2 * t4 < m;  // m a multiple of 8
        const float2 b = bias_pair(bias, jj, t4);
        const float v0 = in ? gelu_erf(acc[4 * jj + 2 * h2] + b.x) : 0.f;
        const float v1 = in ? gelu_erf(acc[4 * jj + 2 * h2 + 1] + b.y) : 0.f;
        const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
        pk[x] = *reinterpret_cast<const unsigned*>(&pair);
      }
      transpose_quad(pk, t4);
      st_cluster_v4(dst + (k / 2) * kBox + 8 * h2 * 128 + (((4 * (k % 2) + t4) ^ g) << 4), pk);
    }
  }
}

// fc1 CTA f, consumer warpgroup j (0-2): the quad's chunks q = 2 (3 i + j)
// + f, i = 0, 1, ... (a sixth of them; the three warpgroups take the CTA's
// in turns, so that two can run their GELU under the third's products). A
// chunk: acc[64, 128] = y W_1[:, chunk] by wgmma m64n128k16 (y K-major from
// its resident boxes, the W_1 stage MN-major), K in steps of 64; then h =
// bf16(GELU(acc + b_1)) (zeros past m) stored from the registers straight
// into hidden buffer q % 6 of the first fc2 CTA, in the swizzled A layout,
// and released to it (each thread's stores fenced for its wgmma and bulk
// copy, then one arrival a thread on its barrier); it copies the chunk on
// to the second.
template <bool kBlock>
__device__ __forceinline__ void fc1_consumer(MlpBars& bars, unsigned char* smem, const MlpArgs& a,
                                             int f, int quad) {
  const int j = warpgroup() - 1, ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32, g = lane / 4, t4 = lane % 4;
  const int nch = mlp_chunks(a.m), ksteps = (a.d + kK1 - 1) / kK1, hb = 2 * j + f;
  // this thread's row of hidden buffer hb in the first fc2 CTA
  const unsigned dst = map_to_rank(smem_u32(smem) + hb * kHBytes + (warp * 16 + g) * 128,
                                   2 * kQuads + quad);
  float acc[64];
  for (int t = 0; t < a.tiles; ++t) {
    mbar_wait(&bars.y_full, t & 1);
    if (kBlock) {  // y = LN(x), a warp a row
      layer_norm_rows(smem, a, threadIdx.x / 32 - 4, 12, lane);
      fence_proxy_async();  // the generic writes, before wgmma reads them
      named_bar_sync(4, 384);
    }
    // this warpgroup's chunks of the tile: q = t nch + c = hb (mod 6)
    const int c0 = ((hb - t * nch) % kBufs + kBufs) % kBufs;
    if (c0 >= nch && lane == 0) mbar_arrive(&bars.y_empty);  // none in this tile
    for (int c = c0; c < nch; c += kBufs) {
      const int q = t * nch + c, u = q >> 1;  // u: the chunk's place in this CTA's ring order
      // A barrier's parity tells apart only its current phase and the one
      // before, so a warpgroup waits on its chunk's stages only once the
      // one before it has waited on all of the chunk before (u - 1): its
      // turn (warpgroup j's i-th turn is phase i of turn[j], and the first
      // of warpgroup 0 passes at once)
      mbar_wait(&bars.turn[j], ((u / 3) & 1) ^ (j == 0));
      int prev = 0;
#pragma unroll 1
      for (int ks = 0; ks < ksteps; ++ks) {
        const int pos = u * ksteps + ks, s = pos % kStages1;
        mbar_wait(&bars.full[s], (pos / kStages1) & 1);
        if (ks == ksteps - 1 && ct == 0) mbar_arrive(&bars.turn[(j + 1) % 3]);
        wgmma_fence();
        const unsigned char* w = smem + kOffRing1 + s * kW1Stage;
#pragma unroll
        for (int kk = 0; kk < kK1 / 16; ++kk) {
          const int k = ks * kK1 + kk * 16;
          wgmma_ss_m64n128k16(acc, sw128_desc(smem + (k / 64) * kBox + (k % 64) * 2, 0, 1024),
                              sw128_desc(w + kk * 16 * 128, kW1Box, 1024), ks > 0 || kk > 0);
        }
        wgmma_commit();
        if (ks > 0) {  // the previous stage's products have retired: free it
          wgmma_wait<1>();
          release_stage(&bars.empty[prev], lane, f * kQuads);
        }
        prev = s;
      }
      float2 bias[2];  // fetched while the last products run
      load_bias_pairs(bias, a.b1, c * kChunk, a.m, lane);
      wgmma_wait<0>();
      release_stage(&bars.empty[prev], lane, f * kQuads);
      if (c + kBufs >= nch && lane == 0) mbar_arrive(&bars.y_empty);  // its last read of y
      fence_regs(acc);

      // h = bf16(GELU(acc + b_1)), zeros past m, once both fc2 CTAs have
      // read this warpgroup's last chunk
      mbar_wait(&bars.hfree[j], (q / kBufs) & 1);
      if (c * kChunk + kChunk <= a.m)
        store_hidden<false>(acc, bias, c * kChunk, a.m, dst, g, t4);
      else
        store_hidden<true>(acc, bias, c * kChunk, a.m, dst, g, t4);
      fence_proxy_async_cluster();  // the stores, before its wgmma and bulk copy read them
      mbar_arrive_rank_release(&bars.h_full[hb], 2 * kQuads + quad);
    }
  }
}

// fc2 CTA h, consumer warpgroup i (0-2): output columns 384 h + 128 i ..
// + 127 of the tile, acc[64, 128] += h_q W_2[chunk rows, its columns] over
// the chunks in order (fixed: two calls and every cluster size give the
// same bits), K in steps of 32, by wgmma m64n128k16 (the hidden chunk
// K-major from its buffer, the W_2 stage MN-major); then + b_2 (+ x, k9)
// in fp32, rounded once, stored from the registers. Columns past d (from
// boxes never loaded) are computed and not stored.
template <bool kBlock>
__device__ __forceinline__ void fc2_consumer(MlpBars& bars, unsigned char* smem, const MlpArgs& a,
                                             int h, int tile0) {
  const int i = warpgroup() - 1, ct = threadIdx.x % 128;
  const int warp = ct / 32, lane = ct % 32, g = lane / 4, t4 = lane % 4;
  const int col0 = h * kHalfD + i * 128;
  const int nch = mlp_chunks(a.m);
  int stage = 0;
  unsigned phase = 0;
  float acc[64];
  for (int t = 0; t < a.tiles; ++t) {
    for (int c = 0; c < nch; ++c) {
      const int q = t * nch + c, hb = q % kBufs;
      const int ksteps = (min(kChunk, a.m - c * kChunk) + kK2 - 1) / kK2;
      const unsigned char* hid = smem + hb * kHBytes;
      mbar_wait_cluster(&bars.h_full[hb], (q / kBufs) & 1);
      int prev = 0;
#pragma unroll 1
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(&bars.full[stage], phase);
        wgmma_fence();
        const unsigned char* w = smem + kOffRing2 + stage * kW2Stage + i * 2 * kW2Box;
#pragma unroll
        for (int kk = 0; kk < kK2 / 16; ++kk) {
          const int k = ks * kK2 + kk * 16;
          wgmma_ss_m64n128k16(acc, sw128_desc(hid + (k / 64) * kBox + (k % 64) * 2, 0, 1024),
                              sw128_desc(w + kk * 16 * 128, kW2Box, 1024),
                              c > 0 || ks > 0 || kk > 0);
        }
        wgmma_commit();
        if (ks > 0) {
          wgmma_wait<1>();
          release_stage(&bars.empty[prev], lane, (2 + h) * kQuads);
        }
        prev = stage;
        if (++stage == kStages2) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      release_stage(&bars.empty[prev], lane, (2 + h) * kQuads);
      if (lane == 0) mbar_arrive(&bars.h_empty[hb]);
    }
    fence_regs(acc);

    // + b_2 (+ the residual row, k9) in fp32, rounded once: lane (g, t4)
    // holds rows r0 + g (+ 8), columns col0 + 8 jj + 2 t4 (+ 1); the
    // residual pairs of 8 column groups loaded together before they are
    // used
    if (col0 >= a.d) continue;
    const int r0 = (tile0 + t) * kMlpRows + warp * 16 + g;
    float2 bias[2];
    load_bias_pairs(bias, a.b2, col0, a.d, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      unsigned res[8][2];
      if (kBlock) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int col = col0 + 8 * (8 * half + jj) + 2 * t4, row = r0 + 8 * h2;
            const bf16* xr = a.x + (size_t)row * a.d + col;
            res[jj][h2] =
                col < a.d && row < a.rows ? __ldg(reinterpret_cast<const unsigned*>(xr)) : 0u;
          }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j8 = 8 * half + jj;
        const int col = col0 + 8 * j8 + 2 * t4;  // d is a multiple of 8: col + 1 < d too
        const float2 b = bias_pair(bias, j8, t4);
        if (col >= a.d) continue;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = r0 + 8 * h2;
          if (row >= a.rows) continue;
          const size_t at = (size_t)row * a.d + col;
          float o0 = acc[4 * j8 + 2 * h2] + b.x, o1 = acc[4 * j8 + 2 * h2 + 1] + b.y;
          if (kBlock) {
            const float2 r =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&res[jj][h2]));
            o0 = r.x + o0;
            o1 = r.y + o1;
          }
          *reinterpret_cast<__nv_bfloat162*>(a.out + at) = __floats2bfloat162_rn(o0, o1);
        }
      }
    }
  }
}

// kBlock: k9 (LN before, residual after); else k7. Clusters of 4 kQuads
// CTAs: rank role kQuads + p is CTA `role` of quad p; roles 0 and 1 the fc1
// CTAs (each every second hidden chunk), 2 and 3 the fc2 CTAs (each 384
// output columns). Quad p walks a.tiles 64-row tiles from tile (cluster
// kQuads + p) a.tiles. Warpgroup 0 feeds, 1-3 multiply.
template <bool kBlock>
__global__ void __launch_bounds__(kMlpThreads, 1)
    vit_fused_mlp_kernel(__grid_constant__ const CUtensorMap map_x,
                         __grid_constant__ const CUtensorMap map_w1,
                         __grid_constant__ const CUtensorMap map_w2, const MlpArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  MlpBars& bars = *reinterpret_cast<MlpBars*>(smem + kOffBars);
  const int rank = (int)blockIdx.x % (4 * kQuads), role = rank / kQuads, quad = rank % kQuads;
  const bool fc1 = role < 2;
  const int tile0 = ((int)blockIdx.x / (4 * kQuads) * kQuads + quad) * a.tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages1; ++s) {
      mbar_init(&bars.full[s], 1);  // the feeding thread's expect_tx
      mbar_init(&bars.empty[s], (fc1 ? 4 : 12) * kQuads);  // a warp of each reader in each CTA
    }
    for (int hb = 0; hb < kBufs; ++hb) {
      // each thread of the fc1 warpgroup that writes it (the first fc2
      // CTA), or the expect_tx of the copy from there (the second)
      mbar_init(&bars.h_full[hb], role == 2 ? 128 : 1);
      mbar_init(&bars.h_empty[hb], 12);  // each consumer warp
    }
    mbar_init(&bars.y_full, 1);
    mbar_init(&bars.y_empty, 12);  // each consumer warp
    for (int j = 0; j < 3; ++j) {
      mbar_init(&bars.hfree[j], 2);  // warp 1 of each fc2 CTA
      mbar_init(&bars.turn[j], 1);   // thread 0 of the consumer warpgroup before
    }
    fence_mbar_init();
  }
  cluster_arrive();  // the barriers of all CTAs are set before any peer signals them
  cluster_wait();

  if (warpgroup() == 0) {
    if (threadIdx.x == 0) {
      if (fc1)
        feed_w1(&map_w1, bars, smem, a, role, quad);
      else
        feed_w2(&map_w2, bars, smem, a, role - 2, quad);
    } else if (threadIdx.x == 32) {
      if (fc1)
        feed_y(&map_x, bars, smem, a, tile0);
      else
        hand_back_hidden(bars, a, role - 2, quad);
    } else if (threadIdx.x == 64 && role == 2) {
      forward_hidden(bars, smem, a, quad);
    }
    __syncwarp();
  } else if (fc1) {
    fc1_consumer<kBlock>(bars, smem, a, role, quad);
  } else {
    fc2_consumer<kBlock>(bars, smem, a, role - 2, tile0);
  }
  __syncwarp();
  cluster_arrive();  // no CTA leaves while a peer may still signal or write it
  cluster_wait();
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

// the launch of clusters of 4 kQuads CTAs (16: non-portable, allowed here)
template <bool kBlock>
cudaError_t mlp_config(unsigned ctas, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                       cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(vit_fused_mlp_kernel<kBlock>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kMlpSmem);
  if (err == cudaSuccess && 4 * kQuads > 8)
    err = cudaFuncSetAttribute(vit_fused_mlp_kernel<kBlock>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *cfg = {};
  cfg->gridDim = dim3(ctas);
  cfg->blockDim = dim3(kMlpThreads);
  cfg->dynamicSmemBytes = kMlpSmem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 4 * kQuads;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

template <bool kBlock>
cudaError_t launch_mlp(const void* w1, const void* w2, MlpArgs a, int rows_per_block,
                       cudaStream_t stream) {
  const int tiles = (a.rows + kMlpRows - 1) / kMlpRows;
  a.tiles = (rows_per_block + kMlpRows - 1) / kMlpRows;  // rows_per_block > 0: at least 1
  const int quads = (tiles + a.tiles - 1) / a.tiles;
  const long long ctas = 4LL * kQuads * ((quads + kQuads - 1) / kQuads);
  if (ctas > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap map_x, map_w1, map_w2;
  if (!encode_map(&map_x, a.x, a.rows, a.d, kMlpRows) ||
      !encode_map(&map_w1, w1, a.d, a.m, kK1) || !encode_map(&map_w2, w2, a.m, a.d, kK2))
    return cudaErrorNotSupported;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = mlp_config<kBlock>((unsigned)ctas, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, vit_fused_mlp_kernel<kBlock>, map_x, map_w1, map_w2, a);
  if (err != cudaSuccess) return err;
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
// ln_b [d], b1 [m], b2 [d] fp32; out [rows, d]. A quad of CTAs walks
// ceil(rows_per_block / 64) consecutive 64-row tiles (G images of n);
// kQuads quads a cluster share each weight box by multicast. d and m
// multiples of 8, d <= 768; x, w1 and w2 16-byte aligned (TMA).
MIRROR_EXPORT int mirror_vit_fused_mlp(const void* x, const void* ln_s, const void* ln_b,
                                       const void* w1, const void* b1, const void* w2,
                                       const void* b2, void* out, int rows, int rows_per_block,
                                       int d, int m, float eps, cudaStream_t stream) {
  if (rows <= 0 || rows_per_block <= 0 || d <= 0 || d % 8 != 0 || d > kMaxD || m % 8 != 0 ||
      m <= 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w1) |
       reinterpret_cast<uintptr_t>(w2)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const MlpArgs a{static_cast<const bf16*>(x),     static_cast<const float*>(ln_s),
                  static_cast<const float*>(ln_b), static_cast<const float*>(b1),
                  static_cast<const float*>(b2),   static_cast<bf16*>(out),
                  rows, d, m, 0, eps};
  return (int)(a.ln_s != nullptr ? launch_mlp<true>(w1, w2, a, rows_per_block, stream)
                                  : launch_mlp<false>(w1, w2, a, rows_per_block, stream));
}

// How many clusters of the MLP kernel (4 kQuads CTAs each) the card holds
// at once: 0 when one cannot be scheduled, minus a CUDA error code when
// the query fails.
MIRROR_EXPORT long long mirror_vit_fused_mlp_clusters() {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = mlp_config<true>(4 * kQuads, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return -(long long)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, vit_fused_mlp_kernel<true>, &cfg);
  if (err != cudaSuccess) return -(long long)err;
  return clusters;
}
