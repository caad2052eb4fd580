// Fused LayerNorm + bias-free q/k/v projection with a head-major emit (K10)
// and its backward (K10b).
//
// Replaces: mirror_tpu/ops/ln_qkv_pallas.py::ln_qkv_fused, the forward
// pallas_call of _fwd_call (_fwd_kernel) and the backward one of _bwd_call
// (_bwd_kernel).
//
// What it computes, with x [b, n, d] bf16 as M = b n rows, ln scale and bias
// [d] fp32 and w [d, 3 h dh] bf16 in to_qkv's layout (q | k | v column
// blocks, head-major inside each):
// - forward: y = bf16((x - mu) rstd s + b) with flax's fast variance
//   (var = max(E[x^2] - E[x]^2, 0), fp32), rounded once as _fwd_kernel
//   rounds it; q|k|v = y w with an fp32 accumulator, rounded once and
//   written head-major: column c of the product goes to tensor c / (h dh),
//   head (c % (h dh)) / dh, feature c % dh, each [b, h, n, dh];
// - backward, from gq, gk, gv in x's dtype: G [M, 3 h dh] is their
//   head-major gather; gy = G w^T in fp32 (never rounded before the LN
//   backward); gw = y^T G over all M rows in fp32, cast to bf16 once at the
//   end; gs = sum gy xhat and gb = sum gy over the rows, fp32;
//   gx = rstd (gxhat - mean(gxhat) - xhat mean(gxhat xhat)) with
//   gxhat = gy s, rounded to bf16.
//
// What bounds it on the H100: tensor-core FLOPs. At x [16, 2117, 768],
// h 8, dh 96 the forward is 2 M d 3 h dh = 120 GFLOP (0.121 ms at 989
// TFLOP/s) against 0.16 GB of traffic (0.05 ms); the backward's two
// products are 240 GFLOP (0.242 ms).
//
// Design, and why not the TPU's: the Pallas kernel holds one whole sequence
// (3.25 MB of x) and all of w (3.5 MB) in VMEM, one program per batch
// element, and accumulates gw across its sequential grid. A Hopper block has
// 227 KB and blocks run in no order, so the work is a launch sequence
// (ops/ln_qkv.py runs it) of row passes and GEMMs in vit_gemm.cu's shape:
// - a row pass (ln_qkv_rows_kernel), one warp a row held in registers,
//   writes y = LN(x) once (and, for the backward, the row statistics and G,
//   the row-major gather of gq, gk, gv); the GEMMs then read plain bf16
//   tiles that TMA delivers with no per-element work. A prologue on the
//   tiles normalised the same row strip once for each of the 18 column
//   tiles (vit_gemm.cu measured such a prologue at about 35 % of a GEMM);
// - one persistent GEMM kernel (ln_qkv_gemm_kernel) for the three products:
//   warpgroup 0's one thread keeps a 4-stage ring of K steps of 64 full by
//   TMA (128-byte swizzle, "full" / "empty" mbarriers), warpgroups 1 and 2
//   each run wgmma on 64 rows of a 128-row tile, setmaxnreg 40 / 232. The
//   operands are read as they lie, by wgmma's transpose immediates: the
//   forward's y K-major and w MN-major; gy's G K-major and w^T (w's rows)
//   K-major; gw's y^T MN-major (transpose-A) and G MN-major;
// - the forward's tiles are 192 columns (m64n192k16). With dh 64, 96 or
//   192 a tile holds whole heads, and row tiles start at each sequence's
//   first row (n = 2117 wastes 2.8 % of the rows), so every [64-row, head]
//   piece of a warpgroup is a box of a contiguous [n, dh] slab: it goes out
//   by a TMA store through a 3-D map over [b h, n, dh] that clips at n and
//   dh, from a 128-byte-swizzled staging tile, as vit_gemm.cu stores
//   (stored from the registers, its epilogue took as long as its products
//   at K 768). Other dh (a multiple of 8) take the general instance: flat
//   row tiles, and 16-byte stores from the staging tile, each 8 columns
//   within one head;
// - gy and gw write fp32 from the registers (a quad of threads one 32-byte
//   sector); gw's long reduction over the M rows is split into a fixed
//   number of row ranges of whole K steps (mirror_ln_qkv_gw_splits), each a
//   partial that launch_column_sum (common.cuh) adds in its fixed order
//   (plain part order where d n3 columns fill the card), so gw, like gs and
//   gb (per-block column partials of the LN backward, summed the same way),
//   is the same from run to run;
// - the LN backward (ln_bwd_rows_kernel) holds a row of gy and xhat and
//   its lane's gs / gb column sums in registers, bytes-bound.
// vit_gemm.cu's LN pass takes the two-pass variance; this file's is
// flax's fast variance, and it also writes the statistics and the gather.
// Tried on the card (exp_ln_qkv_ab, H100 80GB HBM3 at 700 W, x [16, 2117,
// 768]) and not kept: the box epilogue finding each column group's head
// by three divisions (the q|k|v GEMM 0.2714 ms, 442 TFLOP/s, against
// 0.2075 with the head stepped by 8); the LN backward summing gs and gb
// per element into shared memory with scalar loads of gy (0.2709 ms,
// against 0.1051 from registers). The whole WMMA design this replaces
// (a 128 x 128 tile of 8 warps, the LN applied to every landed A chunk,
// the head-major gather on every chunk) ran 10 in 1.07 ms and 10b in
// 2.93.
#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BK = 64;  // a tile's rows; a K step (one 128-byte swizzle row of bf16)
constexpr int kStages = 4;
constexpr int kThreads = 384;  // warpgroup 0 loads, 1 and 2 multiply
constexpr int kConsumerWarps = 8;
constexpr int kBox = 64;                      // a box's contiguous extent: 128 bytes of bf16
constexpr int kBoxBytes = kBox * BK * 2;      // one [64, 64] bf16 box
constexpr int kABytes = BM * BK * 2;          // an A stage of [128, 64]
constexpr int kMaxDim = 2048;
constexpr int kMaxSplits = 16;  // gw's row ranges at most
constexpr int kRowWarps = 8;    // rows a block of the row pass and the LN backward
constexpr int kLnRows = 64;     // rows per block of the LN backward

// The four instances of the GEMM. A is [M, K] and B is [K, N] in GEMM terms.
enum Mode {
  kQkvBoxes = 0,   // A = y [rows, d], B = w [d, 3hdh] -> q, k, v by TMA boxes
  kQkvPieces = 1,  // the same product, q, k, v stored 16 bytes at a time
  kGradY = 2,      // A = G [rows, 3hdh], B = w^T (w's rows, K-major) -> gy fp32 [rows, d]
  kGradW = 3,      // A = y^T (y, MN-major), B = G [rows, 3hdh] -> a split's fp32 partial
};

template <int MODE>
struct Gemm {
  static constexpr int BN = MODE <= kQkvPieces ? 192 : 256;
  static constexpr int TA = MODE == kGradW;  // transpose-A: y^T read from y
  static constexpr int TB = MODE != kGradY;  // B MN-major, except gy's w^T
};

template <int BN>
struct __align__(1024) GemmSmem {
  bf16 a[kStages][BM * BK];  // 16 KB a stage, 1024-byte aligned
  bf16 b[kStages][BK * BN];  // 24 or 32 KB a stage: [64, 64] boxes, or gy's [256, 64]
  bf16 c[2][2][64 * 64];     // each consumer warpgroup's two staging tiles (q, k, v)
  uint64_t full[kStages], empty[kStages];
};

// The product's sizes, its tiles, and the heads of the q|k|v forms.
struct Shape {
  int M, N, K;
  int n, heads, dh;      // sequence length, heads, head dim (q|k|v forms)
  int tiles_m, tiles_n;  // kQkvBoxes: tiles_m is b x a sequence's row tiles
  int split_steps;       // K steps a split of gw's rows (the others: all of K)
  int units;             // tiles x splits
};

// What one unit of work covers: a tile, and its K range in steps.
struct Unit {
  int m0, n0, step0, steps, split;
  int seq, i0;  // kQkvBoxes: the tile's sequence and first row in it
};

template <int MODE>
__device__ __forceinline__ Unit unit_of(int u, const Shape& s) {
  Unit t;
  const int tiles = s.tiles_m * s.tiles_n;
  t.split = MODE == kGradW ? u / tiles : 0;
  const int tile = u - t.split * tiles;
  const int tm = tile / s.tiles_n;
  t.n0 = (tile - tm * s.tiles_n) * Gemm<MODE>::BN;
  t.seq = 0;
  t.i0 = 0;
  if (MODE == kQkvBoxes) {
    const int per_seq = (s.n + BM - 1) / BM;
    t.seq = tm / per_seq;
    t.i0 = (tm - t.seq * per_seq) * BM;
    t.m0 = t.seq * s.n + t.i0;
  } else {
    t.m0 = tm * BM;
  }
  t.step0 = t.split * s.split_steps;
  t.steps = min(s.split_steps, (s.K + BK - 1) / BK - t.step0);
  return t;
}

// t[which] for which in 0..2, without indexing the kernel's parameters at
// run time (which would copy them to local memory)
template <typename T>
__device__ __forceinline__ T pick(T t0, T t1, T t2, int which) {
  return which == 0 ? t0 : (which == 1 ? t1 : t2);
}

// Offset of element (row, c) of the head-major [3][b, h, n, dh] layout
// within tensor c / (h dh), and that tensor's index; 8 columns from c
// (c a multiple of 8, dh too) stay in one head.
__device__ __forceinline__ size_t head_major(int row, int c, int n, int heads, int dh,
                                             int& which) {
  const int inner = heads * dh;
  which = c / inner;
  const int rem = c - which * inner, hh = rem / dh, e = rem - hh * dh;
  const int bi = row / n, i = row - bi * n;
  return ((size_t)(bi * heads + hh) * n + i) * dh + e;
}

// --- the row pass ---------------------------------------------------------------

// y = LN(x) over rows of d (bf16) with flax's fast variance, one warp a row
// held in registers (CH chunks of 8 a lane, lane l the columns l 8 + 256 i),
// the sums of x and x^2 taken in the lane's column order, then across lanes.
// With stats, the row's mean and rstd go to stats[row] and stats[rows + row];
// with G, row `row` of the gather of g0, g1, g2 (each [b, h, n, dh]) too.
template <int CH>
__global__ void __launch_bounds__(32 * kRowWarps)
    ln_qkv_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ s,
                       const float* __restrict__ b, bf16* __restrict__ y, float* __restrict__ stats,
                       const bf16* __restrict__ g0, const bf16* __restrict__ g1,
                       const bf16* __restrict__ g2, bf16* __restrict__ G, int rows, int d, int n,
                       int heads, int dh, float eps) {
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  float v[CH][8], sum = 0.f, sq = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < d) {
      unpack_bf16x8(*reinterpret_cast<const uint4*>(xr + c), v[i]);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        sum += v[i][t];
        sq += v[i][t] * v[i][t];
      }
    }
  }
  const float mean = warp_sum(sum) / d;
  const float var = fmaxf(warp_sum(sq) / d - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  if (stats != nullptr && lane == 0) {
    stats[row] = mean;
    stats[rows + row] = rstd;
  }
  bf16* yr = y + (size_t)row * d;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < d) {
      float sv[8], bv[8];
      *reinterpret_cast<float4*>(sv) = *reinterpret_cast<const float4*>(s + c);
      *reinterpret_cast<float4*>(sv + 4) = *reinterpret_cast<const float4*>(s + c + 4);
      *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(b + c);
      *reinterpret_cast<float4*>(bv + 4) = *reinterpret_cast<const float4*>(b + c + 4);
#pragma unroll
      for (int t = 0; t < 8; ++t) v[i][t] = (v[i][t] - mean) * rstd * sv[t] + bv[t];
      *reinterpret_cast<uint4*>(yr + c) = pack_bf16x8(v[i]);
    }
  }
  if (G == nullptr) return;
  const int n3 = 3 * heads * dh;
  for (int c = lane * 8; c < n3; c += 256) {
    int which;
    const size_t off = head_major(row, c, n, heads, dh, which);
    *reinterpret_cast<uint4*>(G + (size_t)row * n3 + c) =
        *reinterpret_cast<const uint4*>(pick(g0, g1, g2, which) + off);
  }
}

// --- the GEMM ---------------------------------------------------------------------

// one stage of A and B for K step `kc` (in elements) of unit t, counted in
// on `full`
template <int MODE>
__device__ __forceinline__ void load_stage(GemmSmem<Gemm<MODE>::BN>& sm, int stage,
                                           const CUtensorMap* map_a, const CUtensorMap* map_b,
                                           const Unit& t, int kc, const Shape& s) {
  constexpr int BN = Gemm<MODE>::BN;
  uint64_t* full = &sm.full[stage];
  if constexpr (MODE == kGradY) {  // A [128 rows, 64 of K]; B = w's rows [256, 64 of K]
    mbar_expect_tx(full, kABytes + BN * BK * 2);
    tma_load(sm.a[stage], map_a, full, kc, t.m0);
    tma_load(sm.b[stage], map_b, full, kc, t.n0);
    return;
  }
  // B: [64 of K, 64 columns] boxes of w or G, none wholly past N
  const int boxes_b = min(BN / kBox, (s.N - t.n0 + kBox - 1) / kBox);
  if constexpr (MODE == kGradW) {  // A = y^T: [64 rows of y, 64 features] boxes, one a warpgroup
    const int boxes_a = min(BM / kBox, (s.M - t.m0 + kBox - 1) / kBox);
    mbar_expect_tx(full, (boxes_a + boxes_b) * kBoxBytes);
    for (int j = 0; j < boxes_a; ++j)
      tma_load(sm.a[stage] + j * kBox * BK, map_a, full, t.m0 + j * kBox, kc);
  } else {  // A = y [128 rows, 64 of K]
    mbar_expect_tx(full, kABytes + boxes_b * kBoxBytes);
    tma_load(sm.a[stage], map_a, full, kc, t.m0);
  }
  for (int j = 0; j < boxes_b; ++j)
    tma_load(sm.b[stage] + j * BK * kBox, map_b, full, t.n0 + j * kBox, kc);
}

// the 4 products of one K step for a warpgroup's 64 rows: a, b its A rows
// and the stage's B in shared memory
template <int MODE>
__device__ __forceinline__ void mma_step(float (&acc)[Gemm<MODE>::BN / 2], const bf16* a,
                                         const bf16* b, bool first) {
  constexpr int BN = Gemm<MODE>::BN, TA = Gemm<MODE>::TA, TB = Gemm<MODE>::TB;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // K-major: 16 more of K are 32 bytes along each 128-byte row; MN-major:
    // 16 more rows of 128 bytes (8-row groups 1024 bytes apart, [64, 64]
    // boxes kBoxBytes apart)
    const uint64_t da = TA ? sw128_desc(a + kk * 16 * kBox, kBoxBytes, 1024)
                           : sw128_desc(a + kk * 16, 0, 1024);
    const uint64_t db = TB ? sw128_desc(b + kk * 16 * kBox, kBoxBytes, 1024)
                           : sw128_desc(b + kk * 16, 0, 1024);
    if constexpr (BN == 256)
      wgmma_ss_m64n256k16<TA, TB>(acc, da, db, !first || kk > 0);
    else
      wgmma_ss_m64n192k16<TA, TB>(acc, da, db, !first || kk > 0);
  }
}

// a bf16 pair of the accumulator (rows r and r + 8 at h 0, 1; columns
// 8 j + 2 t) written to a [64, 64] staging tile in the 128-byte swizzle:
// row `row`, 16-byte chunk `ch` of it (row % 8 = g)
__device__ __forceinline__ void stage_pair(unsigned char* buf, int row, int ch, int g, int t,
                                           float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(buf + row * 128 + ((ch ^ g) << 4) + 4 * t) =
      __floats2bfloat162_rn(v0, v1);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    ln_qkv_gemm_kernel(__grid_constant__ const CUtensorMap map_a,
                       __grid_constant__ const CUtensorMap map_b,
                       __grid_constant__ const CUtensorMap map_q,
                       __grid_constant__ const CUtensorMap map_k,
                       __grid_constant__ const CUtensorMap map_v, bf16* __restrict__ q,
                       bf16* __restrict__ k, bf16* __restrict__ v, float* __restrict__ c,
                       const Shape s) {
  constexpr int BN = Gemm<MODE>::BN;
  extern __shared__ unsigned char smem_raw[];
  GemmSmem<BN>& sm = *reinterpret_cast<GemmSmem<BN>*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);                // the producer's expect_tx
      mbar_init(&sm.empty[st], kConsumerWarps);  // one arrival a consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load; the others leave
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int stage = 0;
    unsigned phase = 0;
    for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
      const Unit t = unit_of<MODE>(u, s);
      for (int ks = 0; ks < t.steps; ++ks) {
        mbar_wait(&sm.empty[stage], phase ^ 1);  // passes at once on the first round
        load_stage<MODE>(sm, stage, &map_a, &map_b, t, (t.step0 + ks) * BK, s);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup 1 the tile's rows 0-63, warpgroup 2 rows 64-127
  setmaxnreg_inc<232>();
  const int half = wg - 1, ct = threadIdx.x - 128 * wg;
  const int warp = ct / 32, lane = ct % 32, g = lane / 4, t4 = lane % 4;
  float acc[BN / 2];
  int stage = 0, nbuf = 0;  // nbuf: the staging tile the next box takes (kQkvBoxes)
  unsigned phase = 0;
  for (int u = blockIdx.x; u < s.units; u += gridDim.x) {
    const Unit t = unit_of<MODE>(u, s);
    int prev = 0;
    for (int ks = 0; ks < t.steps; ++ks) {
      mbar_wait(&sm.full[stage], phase);
      wgmma_fence();
      mma_step<MODE>(acc, sm.a[stage] + half * 64 * BK, sm.b[stage], ks == 0);
      wgmma_commit();
      if (ks > 0) {  // the previous step's products have retired: free its stage
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&sm.empty[prev]);
      }
      prev = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&sm.empty[prev]);
    fence_regs(acc);

    if constexpr (MODE == kGradY || MODE == kGradW) {
      // fp32 from the registers: a quad writes 32 contiguous bytes of a row
      float* out = MODE == kGradW ? c + (size_t)t.split * s.M * s.N : c;
      const int r = t.m0 + half * 64 + warp * 16 + g;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = t.n0 + 8 * j + 2 * t4;  // N is even: col + 1 < N too
        if (col >= s.N) break;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (r + 8 * h < s.M)
            *reinterpret_cast<float2*>(out + (size_t)(r + 8 * h) * s.N + col) =
                make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    } else if constexpr (MODE == kQkvPieces) {
      // 64 columns at a time through one staging tile, then 16-byte stores,
      // each 8 columns of one head, to the head-major address
      if (t.m0 + half * 64 >= s.M) continue;
      unsigned char* buf = reinterpret_cast<unsigned char*>(sm.c[half][0]);
#pragma unroll
      for (int cc = 0; cc < BN / 64; ++cc) {
        if (t.n0 + 64 * cc >= s.N) break;
        named_bar_sync(1 + half, 128);  // the last chunk's reads are done
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            stage_pair(buf, warp * 16 + g + 8 * h, jj, g, t4, acc[4 * (8 * cc + jj) + 2 * h],
                       acc[4 * (8 * cc + jj) + 2 * h + 1]);
        named_bar_sync(1 + half, 128);
        for (int p = ct; p < 64 * 8; p += 128) {
          const int row = p / 8, ch = p % 8;
          const int grow = t.m0 + half * 64 + row, gcol = t.n0 + 64 * cc + 8 * ch;
          if (grow < s.M && gcol < s.N) {
            int which;
            const size_t off = head_major(grow, gcol, s.n, s.heads, s.dh, which);
            *reinterpret_cast<uint4*>(pick(q, k, v, which) + off) =
                *reinterpret_cast<const uint4*>(buf + row * 128 + ((ch ^ (row & 7)) << 4));
          }
        }
      }
    } else {
      // whole heads: each [64-row, 64-column] piece of a head (a head of 96
      // is two, the second clipped at dh by the map) staged in the swizzle,
      // then one TMA store of the box into its [n, dh] slab (clipped at n),
      // which drains while the next box is staged and the next tile runs
      const int i_half = t.i0 + half * 64;
      if (i_half >= s.n) continue;
      // column n0 + 8 j is feature e of head hh of tensor `which`: found
      // once, then stepped by 8 (no division a column group)
      const int inner = s.heads * s.dh;
      int which = t.n0 / inner, hh = (t.n0 - which * inner) / s.dh;
      int e = t.n0 - which * inner - hh * s.dh, e0 = 0, bh = 0;
      const CUtensorMap* map = &map_q;
      unsigned char* buf = nullptr;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (t.n0 + 8 * j >= s.N) break;
        if (j == 0 || e % kBox == 0) {  // a new box: store the last one, take a tile
          if (j > 0) {
            fence_proxy_async();
            named_bar_sync(1 + half, 128);
            if (ct == 0) tma_store_3d(map, buf, e0, i_half, bh);
          }
          map = pick(&map_q, &map_k, &map_v, which);
          e0 = e;
          bh = t.seq * s.heads + hh;
          buf = reinterpret_cast<unsigned char*>(sm.c[half][nbuf]);
          nbuf ^= 1;
          if (ct == 0) bulk_wait_read<1>();  // the store from buf two boxes ago has read it
          named_bar_sync(1 + half, 128);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
          stage_pair(buf, warp * 16 + g + 8 * h, (e - e0) / 8, g, t4, acc[4 * j + 2 * h],
                     acc[4 * j + 2 * h + 1]);
        if ((e += 8) == s.dh) {
          e = 0;
          if (++hh == s.heads) {
            hh = 0;
            ++which;
          }
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + half, 128);
      if (ct == 0) tma_store_3d(map, buf, e0, i_half, bh);
    }
  }
  if (MODE == kQkvBoxes && ct == 0) bulk_wait_all();
}

template <int MODE>
cudaError_t launch_gemm(const CUtensorMap& map_a, const CUtensorMap& map_b,
                        const CUtensorMap* maps_qkv, bf16* q, bf16* k, bf16* v, float* c,
                        const Shape& s, cudaStream_t stream) {
  constexpr size_t smem = sizeof(GemmSmem<Gemm<MODE>::BN>) + 1024;  // aligned by hand
  const cudaError_t err = allow_smem(ln_qkv_gemm_kernel<MODE>, smem);
  if (err != cudaSuccess) return err;
  ln_qkv_gemm_kernel<MODE><<<std::min(s.units, sm_count()), kThreads, smem, stream>>>(
      map_a, map_b, maps_qkv[0], maps_qkv[1], maps_qkv[2], q, k, v, c, s);
  return cudaGetLastError();
}

// --- the LN backward ----------------------------------------------------------------

// The LN backward over kLnRows rows a block, one warp a row held in
// registers (CH chunks of 8 a lane, as the row pass): gx, and the block's
// column partials of gs = sum gy xhat and gb = sum gy (partial
// [blocks][2][d]), each lane's columns summed in row order in registers,
// then over the warps in order through shared memory.
template <int CH>
__global__ void __launch_bounds__(32 * kRowWarps)
    ln_bwd_rows_kernel(const float* __restrict__ gy, const bf16* __restrict__ x,
                       const float* __restrict__ mu, const float* __restrict__ rstd,
                       const float* __restrict__ s, bf16* __restrict__ gx,
                       float* __restrict__ partial, int rows, int d) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);  // [kRowWarps][2][d]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float gs[CH][8], gb[CH][8];
#pragma unroll
  for (int i = 0; i < CH; ++i)
#pragma unroll
    for (int t = 0; t < 8; ++t) gs[i][t] = gb[i][t] = 0.f;
  const int row0 = blockIdx.x * kLnRows;
  for (int r = row0 + warp; r < min(rows, row0 + kLnRows); r += kRowWarps) {
    const float m = mu[r], rs = rstd[r];
    const float* gyr = gy + (size_t)r * d;
    const bf16* xr = x + (size_t)r * d;
    float g[CH][8], xhat[CH][8], sum1 = 0.f, sum2 = 0.f;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane * 8 + i * 256;
      if (c >= d) continue;
      *reinterpret_cast<float4*>(g[i]) = *reinterpret_cast<const float4*>(gyr + c);
      *reinterpret_cast<float4*>(g[i] + 4) = *reinterpret_cast<const float4*>(gyr + c + 4);
      unpack_bf16x8(*reinterpret_cast<const uint4*>(xr + c), xhat[i]);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        xhat[i][t] = (xhat[i][t] - m) * rs;
        const float gxhat = g[i][t] * s[c + t];
        sum1 += gxhat;
        sum2 += gxhat * xhat[i][t];
        gs[i][t] += g[i][t] * xhat[i][t];
        gb[i][t] += g[i][t];
      }
    }
    const float m1 = warp_sum(sum1) / d, m2 = warp_sum(sum2) / d;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = lane * 8 + i * 256;
      if (c >= d) continue;
      float out[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) out[t] = rs * (g[i][t] * s[c + t] - m1 - xhat[i][t] * m2);
      *reinterpret_cast<uint4*>(gx + (size_t)r * d + c) = pack_bf16x8(out);
    }
  }
  float* gs_w = acc + (size_t)warp * 2 * d;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane * 8 + i * 256;
    if (c >= d) continue;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      gs_w[c + t] = gs[i][t];
      gs_w[d + c + t] = gb[i][t];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * d; c += 32 * kRowWarps) {
    float sum = 0.f;
    for (int w = 0; w < kRowWarps; ++w) sum += acc[(size_t)w * 2 * d + c];
    partial[(size_t)blockIdx.x * 2 * d + c] = sum;
  }
}

template <int CH>
cudaError_t launch_ln_bwd(const float* gy, const bf16* x, const float* stats, const float* s,
                          bf16* gx, float* partial, int rows, int d, int blocks,
                          cudaStream_t stream) {
  const size_t smem = (size_t)kRowWarps * 2 * d * sizeof(float);
  const cudaError_t err = allow_smem(ln_bwd_rows_kernel<CH>, smem);
  if (err != cudaSuccess) return err;
  ln_bwd_rows_kernel<CH><<<blocks, 32 * kRowWarps, smem, stream>>>(gy, x, stats, stats + rows, s,
                                                                   gx, partial, rows, d);
  return cudaGetLastError();
}

int ln_blocks(int rows) { return (rows + kLnRows - 1) / kLnRows; }

// --- host helpers ---------------------------------------------------------------------

bool valid_rows(int rows, int d) { return rows > 0 && d > 0 && d % 8 == 0 && d <= kMaxDim; }

bool valid_heads(int heads, int dh) { return heads > 0 && dh > 0 && dh % 8 == 0; }

// dh whose heads a 192-column tile holds whole, as boxes of 64 columns
bool whole_heads(int dh) { return dh >= kBox && 192 % dh == 0; }

int gw_tiles(int d, int n3) {
  return ((d + BM - 1) / BM) * ((n3 + Gemm<kGradW>::BN - 1) / Gemm<kGradW>::BN);
}

// gw's K steps a split and the splits they make: `splits` ranges of whole K
// steps, none empty (ops/ln_qkv.py::gw_row_ranges cuts the same)
int gw_split_steps(int rows, int splits) {
  const int steps = (rows + BK - 1) / BK;
  splits = std::max(1, std::min(splits, steps));
  return (steps + splits - 1) / splits;
}

}  // namespace

// y = LN(x) (fast variance) over the rows of x [rows, d] (bf16), s and b fp32
// [d], d a multiple of 8 up to 2048. With stats (fp32 [2, rows]) also each
// row's mean and rstd; with G (bf16 [rows, 3 heads dh]) also the row-major
// gather of gq, gk, gv (bf16 [rows / n, heads, n, dh]).
MIRROR_EXPORT int mirror_ln_qkv_rows(const void* x, const void* s, const void* b, void* y,
                                     void* stats, const void* gq, const void* gk, const void* gv,
                                     void* G, int rows, int d, int n, int heads, int dh,
                                     float eps, cudaStream_t stream) {
  if (!valid_rows(rows, d) || (G != nullptr && (!valid_heads(heads, dh) || n <= 0)))
    return (int)cudaErrorInvalidValue;
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(b);
  bf16* yp = static_cast<bf16*>(y);
  float* st = static_cast<float*>(stats);
  const bf16* g0 = static_cast<const bf16*>(gq);
  const bf16* g1 = static_cast<const bf16*>(gk);
  const bf16* g2 = static_cast<const bf16*>(gv);
  bf16* Gp = static_cast<bf16*>(G);
  const dim3 grid((rows + kRowWarps - 1) / kRowWarps), block(32 * kRowWarps);
  const int chunks = (d + 255) / 256;
  if (chunks == 1)
    ln_qkv_rows_kernel<1><<<grid, block, 0, stream>>>(xp, sp, bp, yp, st, g0, g1, g2, Gp, rows,
                                                      d, n, heads, dh, eps);
  else if (chunks == 2)
    ln_qkv_rows_kernel<2><<<grid, block, 0, stream>>>(xp, sp, bp, yp, st, g0, g1, g2, Gp, rows,
                                                      d, n, heads, dh, eps);
  else if (chunks == 3)
    ln_qkv_rows_kernel<3><<<grid, block, 0, stream>>>(xp, sp, bp, yp, st, g0, g1, g2, Gp, rows,
                                                      d, n, heads, dh, eps);
  else if (chunks == 4)
    ln_qkv_rows_kernel<4><<<grid, block, 0, stream>>>(xp, sp, bp, yp, st, g0, g1, g2, Gp, rows,
                                                      d, n, heads, dh, eps);
  else
    ln_qkv_rows_kernel<8><<<grid, block, 0, stream>>>(xp, sp, bp, yp, st, g0, g1, g2, Gp, rows,
                                                      d, n, heads, dh, eps);
  return (int)cudaGetLastError();
}

// q|k|v = y w, head-major. y bf16 [bsz n, d]; w bf16 [d, 3 heads dh]; q, k,
// v bf16 [bsz, heads, n, dh]; d a multiple of 8 up to 2048, dh a multiple of
// 8; every pointer 16-byte aligned.
MIRROR_EXPORT int mirror_ln_qkv_gemm(const void* y, const void* w, void* q, void* k, void* v,
                                     int bsz, int n, int d, int heads, int dh,
                                     cudaStream_t stream) {
  if (bsz <= 0 || n <= 0 || !valid_rows(bsz * n, d) || !valid_heads(heads, dh))
    return (int)cudaErrorInvalidValue;
  Shape s{};
  s.M = bsz * n;
  s.N = 3 * heads * dh;
  s.K = d;
  s.n = n;
  s.heads = heads;
  s.dh = dh;
  s.tiles_n = (s.N + Gemm<kQkvBoxes>::BN - 1) / Gemm<kQkvBoxes>::BN;
  s.split_steps = (d + BK - 1) / BK;
  CUtensorMap map_a, map_b, maps[3] = {};
  if (!encode_map(&map_a, y, s.M, d, BM) || !encode_map(&map_b, w, d, s.N, BK))
    return (int)cudaErrorNotSupported;
  bf16* out[3] = {static_cast<bf16*>(q), static_cast<bf16*>(k), static_cast<bf16*>(v)};
  if (whole_heads(dh)) {
    // each of q, k, v as [bsz heads, n, dh] in boxes of [1, 64, 64]
    const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)n, (cuuint64_t)bsz * heads};
    const cuuint32_t box[3] = {kBox, 64, 1};
    for (int i = 0; i < 3; ++i)
      if (!encode_bf16_map(&maps[i], out[i], 3, dims, box)) return (int)cudaErrorNotSupported;
    s.tiles_m = bsz * ((n + BM - 1) / BM);
    s.units = s.tiles_m * s.tiles_n;
    return (int)launch_gemm<kQkvBoxes>(map_a, map_b, maps, out[0], out[1], out[2], nullptr, s,
                                       stream);
  }
  s.tiles_m = (s.M + BM - 1) / BM;
  s.units = s.tiles_m * s.tiles_n;
  return (int)launch_gemm<kQkvPieces>(map_a, map_b, maps, out[0], out[1], out[2], nullptr, s,
                                      stream);
}

// gy = G w^T in fp32. G bf16 [rows, n3]; w bf16 [d, n3]; gy fp32 [rows, d].
MIRROR_EXPORT int mirror_ln_qkv_grad_y(const void* G, const void* w, void* gy, int rows, int d,
                                       int n3, cudaStream_t stream) {
  if (!valid_rows(rows, d) || n3 <= 0 || n3 % 8) return (int)cudaErrorInvalidValue;
  Shape s{};
  s.M = rows;
  s.N = d;
  s.K = n3;
  s.tiles_m = (rows + BM - 1) / BM;
  s.tiles_n = (d + Gemm<kGradY>::BN - 1) / Gemm<kGradY>::BN;
  s.split_steps = (n3 + BK - 1) / BK;
  s.units = s.tiles_m * s.tiles_n;
  CUtensorMap map_a, map_b, maps[3] = {};
  if (!encode_map(&map_a, G, rows, n3, BM) || !encode_map(&map_b, w, d, n3, Gemm<kGradY>::BN))
    return (int)cudaErrorNotSupported;
  return (int)launch_gemm<kGradY>(map_a, map_b, maps, nullptr, nullptr, nullptr,
                                  static_cast<float*>(gy), s, stream);
}

// The default number of gw's row ranges: the fewest (up to 16) that fill the
// card's SMs to 90 % over whole waves of tiles, else the fullest.
MIRROR_EXPORT long long mirror_ln_qkv_gw_splits(int rows, int d, int n3) {
  const int tiles = gw_tiles(d, n3), sms = sm_count();
  const int most = std::min(kMaxSplits, (rows + BK - 1) / BK);
  int best = 1;
  double best_fill = 0.0;
  for (int splits = 1; splits <= most; ++splits) {
    const int units = tiles * splits, waves = (units + sms - 1) / sms;
    const double fill = (double)units / ((double)waves * sms);
    if (fill >= 0.9) return splits;
    if (fill > best_fill) {
      best = splits;
      best_fill = fill;
    }
  }
  return best;
}

// gw = bf16(y^T G), summed in fp32 over all rows: `splits` ranges of rows,
// each an fp32 partial [d, n3] in `partial` (fp32 of splits d n3
// elements), then their sum in order. y bf16 [rows, d]; G bf16 [rows, n3];
// gw bf16 [d, n3].
MIRROR_EXPORT int mirror_ln_qkv_grad_w(const void* y, const void* G, void* gw, void* partial,
                                       int rows, int d, int n3, int splits,
                                       cudaStream_t stream) {
  if (!valid_rows(rows, d) || n3 <= 0 || n3 % 8 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  Shape s{};
  s.M = d;
  s.N = n3;
  s.K = rows;
  s.tiles_m = (d + BM - 1) / BM;
  s.tiles_n = (n3 + Gemm<kGradW>::BN - 1) / Gemm<kGradW>::BN;
  s.split_steps = gw_split_steps(rows, splits);
  const int used = ((rows + BK - 1) / BK + s.split_steps - 1) / s.split_steps;
  s.units = used * s.tiles_m * s.tiles_n;
  CUtensorMap map_a, map_b, maps[3] = {};
  if (!encode_map(&map_a, y, rows, d, BK) || !encode_map(&map_b, G, rows, n3, BK))
    return (int)cudaErrorNotSupported;
  float* part = static_cast<float*>(partial);
  cudaError_t err =
      launch_gemm<kGradW>(map_a, map_b, maps, nullptr, nullptr, nullptr, part, s, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_column_sum(part, used, (long long)d * n3, static_cast<bf16*>(gw), stream);
}

// Elements of the fp32 scratch that mirror_ln_qkv_ln_bwd needs: the blocks'
// gs / gb partials.
MIRROR_EXPORT long long mirror_ln_qkv_ln_bwd_partial_elems(int rows, int d) {
  return 2LL * ln_blocks(rows) * d;
}

// The LN backward: gx bf16 [rows, d] and gsb fp32 [2, d] (gs, then gb) from
// gy fp32 [rows, d], x bf16 [rows, d], stats fp32 [2, rows] (mean, rstd)
// and s fp32 [d]; partial fp32 of mirror_ln_qkv_ln_bwd_partial_elems.
MIRROR_EXPORT int mirror_ln_qkv_ln_bwd(const void* gy, const void* x, const void* stats,
                                       const void* s, void* gx, void* gsb, void* partial,
                                       int rows, int d, cudaStream_t stream) {
  if (!valid_rows(rows, d)) return (int)cudaErrorInvalidValue;
  const float* gp = static_cast<const float*>(gy);
  const bf16* xp = static_cast<const bf16*>(x);
  const float* st = static_cast<const float*>(stats);
  const float* sp = static_cast<const float*>(s);
  bf16* gxp = static_cast<bf16*>(gx);
  float* part = static_cast<float*>(partial);
  const int blocks = ln_blocks(rows), chunks = (d + 255) / 256;
  cudaError_t err;
  if (chunks == 1)
    err = launch_ln_bwd<1>(gp, xp, st, sp, gxp, part, rows, d, blocks, stream);
  else if (chunks == 2)
    err = launch_ln_bwd<2>(gp, xp, st, sp, gxp, part, rows, d, blocks, stream);
  else if (chunks == 3)
    err = launch_ln_bwd<3>(gp, xp, st, sp, gxp, part, rows, d, blocks, stream);
  else if (chunks == 4)
    err = launch_ln_bwd<4>(gp, xp, st, sp, gxp, part, rows, d, blocks, stream);
  else
    err = launch_ln_bwd<8>(gp, xp, st, sp, gxp, part, rows, d, blocks, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_column_sum(part, blocks, 2LL * d, static_cast<float*>(gsb), stream);
}
