// The projection GEMMs of the ViT half-block kernels (K6 attn_block's q|k|v
// and output projections, K7 mlp_block's fc1 and fc2), each with a fused
// epilogue, and the LayerNorm pass that feeds the first product of each.
//
// Replaces: the products inside mirror_tpu/ops/vit_attn_pallas.py::
// _attn_block_kernel (q, k, v = LN(x) W + b; x + att W_o + b_o) and
// ::_mlp_block_kernel (h = GELU(LN(x) W_1 + b_1); x + h W_2 + b_2), the
// pallas_calls of attn_block and mlp_block, and their LN (_ln_f32). The
// attention between the two projections of K6 is csrc/vit_attn.cu.
//
// What it computes:
// - vit_ln_kernel: y = bf16((x - mu) * rstd * s + b) per row, mu and the
//   variance in fp32, the variance as the mean of squared deviations (two
//   passes, as _ln_f32 takes it), rstd = rsqrt(var + eps); y rounded once,
//   as the TPU kernel rounds it;
// - vit_gemm_kernel: C[M, N] = epilogue(A[M, K] B[K, N]) in bf16 with an
//   fp32 accumulator, B row-major [in, out] (W_q | W_k | W_v side by side for
//   the fused q|k|v product); the epilogue, in fp32 with one rounding at the
//   end: + bias (q|k|v), + bias then exact GELU 0.5 h (1 + erf(h / sqrt 2))
//   (fc1), or + bias then + the residual row (out projection, fc2).
//
// What bounds it on the H100: tensor-core FLOPs. At Phikon's batch of 256
// (M = 256 x 197 = 50432 rows, d 768, MLP 3072) the four products of one
// block are 2 M d (3d + d + 2 x 4d) = 7.1e11 FLOP against ~0.9 GB of
// operand and result traffic (0.72 ms at 989 TFLOP/s vs 0.27 ms at 3.35
// TB/s). The LN pass is bytes-bound: 77 MB in and 77 MB out a call.
//
// Design. The Pallas kernels keep every weight resident in VMEM (4.7 MB for
// attn_block, 9.4 MB for mlp_block); a Hopper block has 227 KB, so each
// product is a tiled GEMM that streams A and the weights, in the shape the
// card's full tensor-core rate needs (wgmma fed by TMA):
// - one persistent block an SM walks 128 x 256 output tiles, N fastest, so
//   the blocks running at once share the A row strip in L2 (the weights,
//   3.5-4.7 MB, stay there anyway);
// - warpgroup 0 is the producer: one thread keeps a 4-stage ring of K steps
//   of 64 full, each stage an A tile [128, 64] and a B tile [64, 256] as
//   four [64, 64] boxes, 48 KB, loaded by TMA with the 128-byte swizzle and
//   counted in by a "full" mbarrier (complete_tx); it goes on loading the
//   next tile while the consumers run the last one's epilogue;
// - warpgroups 1 and 2 are the consumers, 64 rows of the tile each, one
//   wgmma m64n256k16 per 16 of K with both operands from shared memory: A
//   K-major, B MN-major (the transpose-B immediate; B is read in the JAX
//   [in, out] layout with no transpose); one wgmma group stays in flight
//   across K steps (wait_group 1) and a stage goes back to the producer
//   (its "empty" mbarrier) only once the products that read it retired;
// - setmaxnreg moves registers from the producer (40) to the consumers
//   (232): a consumer thread holds 128 fp32 accumulators;
// - the epilogue runs from the registers, 64 columns at a time: bias, GELU
//   or the residual in fp32, one rounding, the bf16 pairs written to one of
//   the warpgroup's two [64, 64] staging tiles in the same swizzle, and one
//   TMA store a chunk (clipped at M and N; TMA zero-fills loads past M, N
//   and K), which drains while the next chunk and the next tile's products
//   run. Stored straight from the registers, 4 bytes a thread a row, and
//   with a bias load and a bounds check beside each, the epilogue took about
//   as long as the products at K 768. The residual's 128-byte lines are
//   prefetched to L2 when a tile starts and loaded a chunk ahead.
// Tried on the card and not kept (scratch timings, by a script not in the
// repository): a cluster of two CTAs sharing the B tile by TMA multicast
// ran no faster than one CTA, and far slower with a release.cluster
// arrival on the peer's "empty" barrier (keep arrivals .cta); ping-pong
// consumers, each warpgroup a 128 x 128 tile of its own in turns so that
// one's epilogue overlaps the other's products, ran slower on three of the
// four products (a 128 x 128 tile moves a third more bytes from L2 a
// FLOP). What caps the mainloop: each m64n256k16 reads 10 KB of shared
// memory in 128 clocks, so two warpgroups ask 160 bytes a clock of the
// SM's 128.
// Why the LN is a pass of its own, not a prologue on the tiles: normalising
// A in shared memory after TMA lands would need the swizzled addresses, a
// per-element pass over every A tile of every N tile (9 or 12 times the
// same row strip) and a fence.proxy.async before wgmma may read it; the
// parent kernel's prologue made its GEMM about 35 % slower. Written out, y
// costs 2 x 77 MB a call at the copy floor (~0.05 ms), and the GEMM reads
// plain bf16 tiles that TMA delivers with no per-element work.
#include <algorithm>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128, BN = 256, BK = 64;  // BK: one 128-byte swizzle row of bf16
constexpr int kStages = 4;
constexpr int kThreads = 384;  // warpgroup 0 loads, 1 and 2 multiply
constexpr int kBoxN = 64;      // B arrives as BN / kBoxN boxes of [BK, 64]
constexpr int kABytes = BM * BK * 2, kBBoxBytes = BK * kBoxN * 2;
constexpr int kConsumerWarps = 8;

enum Epilogue { kBias = 0, kBiasGelu = 1, kBiasResidual = 2 };

struct __align__(1024) GemmSmem {
  bf16 a[kStages][BM * BK];  // 16 KB a stage, 1024-byte aligned
  bf16 b[kStages][BK * BN];  // 32 KB a stage: 4 boxes of 8 KB
  bf16 c[2][2][64 * 64];     // each consumer warpgroup's two staging tiles of C, 8 KB each
  uint64_t full[kStages], empty[kStages];
};
// dynamic shared memory is aligned here by hand to the 1024 bytes the
// 128-byte swizzle repeats over
constexpr size_t kSmemBytes = sizeof(GemmSmem) + 1024;

// --- the LN pass --------------------------------------------------------------

constexpr int kLnWarps = 8;
constexpr int kLnMaxChunks = 16;  // 16-byte chunks a lane holds: d up to 4096

// y = LN(x) over rows of d (bf16), one warp a row held in registers (CH
// chunks of 8 a lane, lane l the columns l 8 + 256 i): the mean first, then
// the mean of the squared deviations, summed in the lane's column order and
// then across lanes.
template <int CH>
__global__ void __launch_bounds__(32 * kLnWarps)
    vit_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ s,
                  const float* __restrict__ b, bf16* __restrict__ y, int rows, int d,
                  float eps) {
  const int row = blockIdx.x * kLnWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const bf16* xr = x + (size_t)row * d;
  float v[CH][8], sum = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = lane * 8 + i * 256;
    if (c < d) {
      unpack_bf16x8(*reinterpret_cast<const uint4*>(xr + c), v[i]);
#pragma unroll
      for (int t = 0; t < 8; ++t) sum += v[i][t];
    }
  }
  const float mean = warp_sum(sum) / d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < CH; ++i)
    if (lane * 8 + i * 256 < d)
#pragma unroll
      for (int t = 0; t < 8; ++t) sq += (v[i][t] - mean) * (v[i][t] - mean);
  const float rstd = rsqrtf(warp_sum(sq) / d + eps);
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
}

template <int CH>
cudaError_t launch_ln(const bf16* x, const float* s, const float* b, bf16* y, int rows, int d,
                      float eps, cudaStream_t stream) {
  vit_ln_kernel<CH><<<(rows + kLnWarps - 1) / kLnWarps, 32 * kLnWarps, 0, stream>>>(
      x, s, b, y, rows, d, eps);
  return cudaGetLastError();
}

// --- the GEMM -----------------------------------------------------------------

// the residual pairs a consumer thread adds in 64 columns from col0: rows r
// and r + 8, columns col0 + 8 jj + 2 t (zeros past M and N)
__device__ __forceinline__ void load_residual(__nv_bfloat162 (&res)[8][2],
                                              const bf16* __restrict__ R, int r, int col0, int M,
                                              int N, int t) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = col0 + 8 * jj + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      res[jj][h] = r + 8 * h < M && col < N
                       ? *reinterpret_cast<const __nv_bfloat162*>(R + (size_t)(r + 8 * h) * N + col)
                       : __floats2bfloat162_rn(0.f, 0.f);
  }
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    vit_gemm_kernel(__grid_constant__ const CUtensorMap map_a,
                    __grid_constant__ const CUtensorMap map_b,
                    __grid_constant__ const CUtensorMap map_c, const float* __restrict__ bias,
                    const bf16* __restrict__ R, int M, int N, int K) {
  extern __shared__ unsigned char smem_raw[];
  GemmSmem& sm = *reinterpret_cast<GemmSmem*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = tiles_n * ((M + BM - 1) / BM);
  const int ksteps = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);                // the producer's expect_tx
      mbar_init(&sm.empty[s], kConsumerWarps);  // one arrival a consumer warp
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
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
      const int boxes = min(BN / kBoxN, (N - n0 + kBoxN - 1) / kBoxN);
      for (int ks = 0; ks < ksteps; ++ks) {
        mbar_wait(&sm.empty[stage], phase ^ 1);  // passes at once on the first round
        mbar_expect_tx(&sm.full[stage], kABytes + boxes * kBBoxBytes);
        tma_load(sm.a[stage], &map_a, &sm.full[stage], ks * BK, m0);
        for (int j = 0; j < boxes; ++j)
          tma_load(sm.b[stage] + j * BK * kBoxN, &map_b, &sm.full[stage], n0 + j * kBoxN,
                   ks * BK);
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
  const int warp = ct / 32, lane = ct % 32, g = lane / 4, t = lane % 4;
  float d[128];
  int stage = 0;
  unsigned phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    const int r = m0 + half * 64 + warp * 16 + g;  // this thread's rows r and r + 8
    if (EPI == kBiasResidual) {
      // bring the residual rows this thread reads into L2 while the tile runs:
      // a quad's 4 threads take the 4 lines of 128 bytes of 2 rows
      const int col = n0 + 64 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r + 8 * h < M && col < N)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(R + (size_t)(r + 8 * h) * N + col));
    }
    int prev = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(&sm.full[stage], phase);
      wgmma_fence();
      const bf16* a = sm.a[stage] + half * 64 * BK;
      const bf16* b = sm.b[stage];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_m64n256k16(d, sw128_desc(a + kk * 16, 0, 1024),
                         sw128_desc(b + kk * 16 * kBoxN, BK * kBoxN * 2, 1024),
                         ks > 0 || kk > 0);
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
    // the residual pairs of the first 64 columns, loaded while the last
    // products run (the next chunk's while one chunk is stored)
    __nv_bfloat162 res[2][8][2];
    if (EPI == kBiasResidual) load_residual(res[0], R, r, n0, M, N, t);
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&sm.empty[prev]);
    fence_regs(d);
    if (m0 + half * 64 >= M) continue;  // a warpgroup wholly past M stores nothing

    // epilogue, 64 columns at a time: bias, GELU or the residual in fp32, one
    // rounding, the bf16 pairs (rows r and r + 8, columns 8 j + 2 t) written
    // to one of the warpgroup's two staging tiles in the 128-byte swizzle,
    // then one TMA store of the [64, 64] box (clipped at M and N) that drains
    // while the next chunk, or the next tile's products, run
#pragma unroll
    for (int c = 0; c < BN / 64; ++c) {
      if (n0 + 64 * c >= N) break;
      unsigned char* buf = reinterpret_cast<unsigned char*>(sm.c[half][c & 1]);
      if (ct == 0) bulk_wait_read<1>();  // the store from buf two chunks ago has read it
      named_bar_sync(1 + half, 128);
      float2 bc[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = n0 + 64 * c + 8 * jj + 2 * t;  // N is even: col + 1 < N too
        bc[jj] = col < N ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.f, 0.f);
      }
      if (EPI == kBiasResidual && c + 1 < BN / 64)
        load_residual(res[(c + 1) & 1], R, r, n0 + 64 * (c + 1), M, N, t);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * c + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = d[4 * j + 2 * h] + bc[jj].x, v1 = d[4 * j + 2 * h + 1] + bc[jj].y;
          if (EPI == kBiasGelu) {
            v0 = 0.5f * v0 * (1.0f + erff(v0 * 0.70710678118654752f));
            v1 = 0.5f * v1 * (1.0f + erff(v1 * 0.70710678118654752f));
          }
          if (EPI == kBiasResidual) {
            const float2 rv = __bfloat1622float2(res[c & 1][jj][h]);
            v0 = rv.x + v0;
            v1 = rv.y + v1;
          }
          const int row = warp * 16 + g + 8 * h;  // in the staging tile; row % 8 = g
          *reinterpret_cast<__nv_bfloat162*>(buf + row * 128 + ((jj ^ g) << 4) + 4 * t) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
      fence_proxy_async();
      named_bar_sync(1 + half, 128);
      if (ct == 0) tma_store(&map_c, buf, n0 + 64 * c, m0 + half * 64);
    }
  }
  if (ct == 0) bulk_wait_all();
}

template <int EPI>
cudaError_t launch_gemm(const bf16* a, const bf16* b, const float* bias, const bf16* r, bf16* c,
                        int M, int N, int K, cudaStream_t stream) {
  CUtensorMap map_a, map_b, map_c;
  if (!encode_map(&map_a, a, M, K, BM) || !encode_map(&map_b, b, K, N, BK) ||
      !encode_map(&map_c, c, M, N, 64))
    return cudaErrorNotSupported;
  const cudaError_t err = allow_smem(vit_gemm_kernel<EPI>, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  vit_gemm_kernel<EPI><<<std::min(tiles, sm_count()), kThreads, kSmemBytes, stream>>>(
      map_a, map_b, map_c, bias, r, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// y = LN(x) over the rows of x [rows, d] (bf16), s and b fp32 [d]; d a
// multiple of 8 up to 4096.
MIRROR_EXPORT int mirror_vit_ln(const void* x, const void* s, const void* b, void* y, int rows,
                                int d, float eps, cudaStream_t stream) {
  const bf16* xp = static_cast<const bf16*>(x);
  const float* sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(b);
  bf16* yp = static_cast<bf16*>(y);
  const int chunks = (d + 255) / 256;
  if (d % 8 || chunks > kLnMaxChunks) return (int)cudaErrorInvalidValue;
  if (chunks == 1) return (int)launch_ln<1>(xp, sp, bp, yp, rows, d, eps, stream);
  if (chunks == 2) return (int)launch_ln<2>(xp, sp, bp, yp, rows, d, eps, stream);
  if (chunks == 3) return (int)launch_ln<3>(xp, sp, bp, yp, rows, d, eps, stream);
  if (chunks == 4) return (int)launch_ln<4>(xp, sp, bp, yp, rows, d, eps, stream);
  if (chunks <= 8) return (int)launch_ln<8>(xp, sp, bp, yp, rows, d, eps, stream);
  return (int)launch_ln<kLnMaxChunks>(xp, sp, bp, yp, rows, d, eps, stream);
}

// C[M, N] = epilogue(A B + bias), in the three forms the half-blocks use:
// bias (q|k|v), bias then GELU (fc1), bias then + resid (out projection,
// fc2). a is [M, K], b [K, N] row-major ([in, out]), bias fp32 [N]; resid
// [M, N] is read by the residual epilogue only. K and N are multiples of 8
// (TMA's 16-byte strides); every pointer is 16-byte aligned.
MIRROR_EXPORT int mirror_vit_gemm(const void* a, const void* b, const void* bias,
                                  const void* resid, void* c, int M, int N, int K, int epilogue,
                                  cudaStream_t stream) {
  const bf16* ap = static_cast<const bf16*>(a);
  const bf16* wp = static_cast<const bf16*>(b);
  const float* bp = static_cast<const float*>(bias);
  const bf16* rp = static_cast<const bf16*>(resid);
  bf16* cp = static_cast<bf16*>(c);
  if (N % 8 || K % 8) return (int)cudaErrorInvalidValue;
  if (epilogue == kBias) return (int)launch_gemm<kBias>(ap, wp, bp, rp, cp, M, N, K, stream);
  if (epilogue == kBiasGelu)
    return (int)launch_gemm<kBiasGelu>(ap, wp, bp, rp, cp, M, N, K, stream);
  if (epilogue == kBiasResidual)
    return (int)launch_gemm<kBiasResidual>(ap, wp, bp, rp, cp, M, N, K, stream);
  return (int)cudaErrorInvalidValue;
}
