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
#include <cuda.h>

#include <algorithm>

#include "common.cuh"

namespace {

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// --- mbarriers and TMA ------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one TMA box of the 2-D map into shared memory, counted in on `bar`;
// c0 indexes the contiguous axis
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// --- wgmma ------------------------------------------------------------------

// A shared-memory matrix descriptor with the 128-byte swizzle (layout type
// 1): the start address, the leading and the stride byte offsets, all in
// 16-byte units. A K-major operand (A: rows of 128 bytes of K) has its
// 8-row groups SBO = 1024 bytes apart (LBO unused); an MN-major one (B: rows
// of 128 bytes of N, one per k) has its 8-k-row groups SBO = 1024 bytes
// apart and its 64-column boxes LBO = 8 KB apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lbo, unsigned sbo) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulators here: the compiler sees wgmma as a plain asm that
// reads and writes them when issued, so reads after a wait must not move
// above it.
__device__ __forceinline__ void fence_regs(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 256] (+)= A[64 x 16] B[16 x 256]: A K-major, B MN-major (trans-b
// 1), both from shared memory; scale_d 0 overwrites d. Fragment layout of d
// (PTX ISA, wgmma .m64nNk16): warp w of the warpgroup holds rows 16 w ..
// 16 w + 15; lane = 4 g + t holds, per 8 columns j, d[4 j], d[4 j + 1] at
// row g, columns 8 j + 2 t, 8 j + 2 t + 1, and d[4 j + 2], d[4 j + 3] at
// row g + 8.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),
        "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]),
        "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]),
        "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// --- the LN pass --------------------------------------------------------------

__device__ __forceinline__ uint4 pack_bf16x8(const float* v) {
  uint4 out;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int t = 0; t < 4; ++t) h[t] = __floats2bfloat162_rn(v[2 * t], v[2 * t + 1]);
  return out;
}

__device__ __forceinline__ void unpack_bf16x8(uint4 in, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&in);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(h[t]);
    v[2 * t] = f.x;
    v[2 * t + 1] = f.y;
  }
}

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

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// shared-memory writes of this thread made visible to the async proxy (TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one TMA box from shared memory to the 2-D map (clipped at its edges)
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's stores still read shared memory
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load; the others leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
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
        wgmma_m64n256k16(d, sw128_desc(a + kk * 16, 0, 1024),
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
      if (ct == 0) tma_store_wait_read<1>();  // the store from buf two chunks ago has read it
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
  if (ct == 0) tma_store_wait_all();
}

// cuTensorMapEncodeTiled, a driver-API symbol, reached through the runtime
// (the library is not linked against libcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// a row-major bf16 [rows, cols] matrix as a TMA map of [box_rows, 64] boxes
// (128 bytes of the contiguous axis a box row, the 128-byte swizzle); boxes
// past the matrix are zero-filled
bool encode_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  }
  return count;
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
