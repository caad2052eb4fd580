// PPEG: identity + bias + merged 7x7 depthwise conv on NHWC (K5), and its
// backward (K5b).
//
// Replaces: mirror_tpu/ops/ppeg_pallas.py::ppeg_fused (forward pallas_call
// in _fwd_call, backward pallas_call in _bwd_call, body _bwd_kernel).
//
// What it computes: out = bf16(img + b + sum over the 49 taps of
// k[dy, dx, c] * img[y + dy - 3, x + dx - 3, c]), zero SAME padding, the
// sum in fp32 and one rounding, as on the TPU. Backward: dimg = bf16(g +
// the same conv of g with the taps flipped), dk[dy, dx, c] = sum over batch
// and grid of g[y, x, c] img[y + dy - 3, x + dx - 3, c] and db[c] = sum of
// g, both fp32 (the caller rounds dk to the kernel's dtype, db to the
// bias's).
//
// What bounds it on the H100: the fp32 FMA rate. The forward does 49 FMAs
// (98 FLOP) per element against one bf16 read and one write, 24.5
// FLOP/byte, near the card's fp32 ridge of ~20 FLOP/byte (67 TFLOP/s over
// 3.35 TB/s); the backward does twice the FMAs (dimg's conv and dk's
// correlation) on two reads and one write. At the slice's shape [16, 46,
// 46, 768] the forward moves 52 MB and does 2.6 GFLOP, the backward 78 MB
// and 5.1 GFLOP (0.077 ms at 67 TFLOP/s).
//
// Forward design: channels are contiguous (NHWC), so a block takes a 8 x 8
// spatial tile of 32 channels, stages the tile plus its 3-pixel halo (14 x
// 14 x 32 bf16, 12.5 KB) in shared memory once, and each thread (one
// channel, one row of the tile) keeps its channel's 49 taps in registers
// and sweeps the 8 pixels of its row. Every input element is read from
// device memory about (14/8)^2 = 3 times through L2 and once from DRAM; the
// TPU's channel blocking (_cblk) and 64 MB VMEM limit have no counterpart.
// The backward's design is at ppeg_bwd_kernel.
#include "common.cuh"

namespace {

constexpr int KS = 7, HALO = KS / 2;
constexpr int TH = 8, TW = 8, CB = 32;
constexpr int SH = TH + KS - 1, SW = TW + KS - 1;

__global__ void __launch_bounds__(CB * TH)
    ppeg_kernel(const bf16* __restrict__ img, const bf16* __restrict__ kern,
                const bf16* __restrict__ bias, bf16* __restrict__ out, int H, int W,
                int C) {
  __shared__ bf16 tile[SH * SW * CB];
  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int c0 = blockIdx.y * CB;
  const size_t base = (size_t)blockIdx.z * H * W * C;
  const int tid = threadIdx.y * CB + threadIdx.x;
  const bf16 zero = __float2bfloat16(0.0f);

  for (int idx = tid; idx < SH * SW * CB; idx += CB * TH) {
    const int c = idx % CB, p = idx / CB;
    const int gy = y0 + p / SW - HALO, gx = x0 + p % SW - HALO, gc = c0 + c;
    tile[idx] = (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
                    ? img[base + ((size_t)gy * W + gx) * C + gc]
                    : zero;
  }
  __syncthreads();

  const int c = threadIdx.x, gc = c0 + c, ty = threadIdx.y, gy = y0 + ty;
  if (gc >= C || gy >= H) return;
  float taps[KS * KS];
#pragma unroll
  for (int t = 0; t < KS * KS; ++t)
    taps[t] = __bfloat162float(kern[(size_t)t * C + gc]);
  const float b = __bfloat162float(bias[gc]);
  for (int tx = 0; tx < TW; ++tx) {
    const int gx = x0 + tx;
    if (gx >= W) break;
    float acc = __bfloat162float(tile[((ty + HALO) * SW + tx + HALO) * CB + c]) + b;
#pragma unroll
    for (int dy = 0; dy < KS; ++dy)
#pragma unroll
      for (int dx = 0; dx < KS; ++dx)
        acc = fmaf(taps[dy * KS + dx],
                   __bfloat162float(tile[((ty + dy) * SW + tx + dx) * CB + c]), acc);
    out[base + ((size_t)gy * W + gx) * C + gc] = __float2bfloat16(acc);
  }
}

// Backward (K5b): one pass over g and img, as the TPU kernel makes it. A
// block of 15 warps takes (64 channels, a band of BH grid rows, one image)
// and walks the band in chunks of BW columns. Each chunk's g and img, with
// their 3-pixel halos (14 x 22 x 64 bf16 each, zero SAME padding), are
// staged in shared memory once, and both gradients are taken from them:
// - warp y < 8: dimg of band row y over the chunk's 16 columns, a channel
//   pair a lane (4-byte shared loads, fp32 math): for each tap row dy, one
//   load of g feeds the up to 7 outputs whose window holds it (the 7 dx
//   taps that share it), summed into each output in (dy, dx) order;
// - warp 8 + dy: dk's tap row dy over the band, a channel pair a lane: a
//   7-wide window of the img row slides along x in registers, so one load
//   feeds the 7 dx taps; the 7 x 2 sums (and, in warp 8, db's 2) stay in
//   registers across the band's chunks and rows.
// The block writes its [50, 64] partial once; column_sum_kernel sums the
// partials over images and bands in a fixed order (deterministic, no
// atomics). One block an SM (83 KB of shared memory; ptxas: 118 registers,
// no spills): held to 64 registers for two blocks an SM, it spilled.
constexpr int BH = 8;    // grid rows a band: warp y takes dimg's row y
constexpr int BW = 16;   // grid columns a chunk: a dimg thread's outputs
constexpr int BC = 64;   // channels a block: a pair a lane
constexpr int SBH = BH + KS - 1, SBW = BW + KS - 1;
constexpr int kDimgWarps = BH, kDkWarps = KS;
constexpr int kBwdThreads = 32 * (kDimgWarps + kDkWarps);
constexpr int NT = KS * KS + 1;  // 49 taps and the bias

struct BwdSmem {
  bf16 g[SBH * SBW * BC];
  bf16 img[SBH * SBW * BC];
  bf16 taps[KS * KS * BC];
};

__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Stage rows [y0 - 3, y0 + BH + 3) x columns [x0 - 3, x0 + BW + 3) x
// channels [c0, c0 + BC) of one image of src into dst, zeros outside:
// cp.async 16 bytes at a time when C is a multiple of 8, else one element
// at a time.
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* __restrict__ src, int y0,
                                            int x0, int c0, int H, int W, int C) {
  if (C % 8 == 0) {
    constexpr int chunks = BC / 8;
    for (int idx = threadIdx.x; idx < SBH * SBW * chunks; idx += kBwdThreads) {
      const int p = idx / chunks, gc = c0 + (idx % chunks) * 8;
      const int gy = y0 + p / SBW - HALO, gx = x0 + p % SBW - HALO;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C;
      cp_async16(dst + p * BC + gc - c0, ok ? src + ((size_t)gy * W + gx) * C + gc : src, ok);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < SBH * SBW * BC; idx += kBwdThreads) {
    const int p = idx / BC, gc = c0 + idx % BC;
    const int gy = y0 + p / SBW - HALO, gx = x0 + p % SBW - HALO;
    dst[idx] = gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C
                   ? src[((size_t)gy * W + gx) * C + gc]
                   : __float2bfloat16(0.0f);
  }
}

// Channels c and c + 1 (those below C) of v at dst, which points at channel c.
__device__ __forceinline__ void store_pair(bf16* dst, int c, int C, float2 v) {
  if (C % 2 == 0 && c < C) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v.x, v.y);
    return;
  }
  if (c < C) dst[0] = __float2bfloat16(v.x);
  if (c + 1 < C) dst[1] = __float2bfloat16(v.y);
}

__device__ __forceinline__ void store_pair(float* dst, int c, int C, float2 v) {
  if (C % 2 == 0 && c < C) {
    *reinterpret_cast<float2*>(dst) = v;
    return;
  }
  if (c < C) dst[0] = v.x;
  if (c + 1 < C) dst[1] = v.y;
}

__device__ __forceinline__ void fma2(float2& acc, float2 a, float2 b) {
  acc.x = fmaf(a.x, b.x, acc.x);
  acc.y = fmaf(a.y, b.y, acc.y);
}

__global__ void __launch_bounds__(kBwdThreads, 1)
    ppeg_bwd_kernel(const bf16* __restrict__ img, const bf16* __restrict__ kern,
                    const bf16* __restrict__ g, bf16* __restrict__ dimg,
                    float* __restrict__ partial, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw);
  const int c0 = blockIdx.x * BC, band = blockIdx.y, b = blockIdx.z;
  const int y0 = band * BH, rows = min(BH, H - y0);
  const size_t base = (size_t)b * H * W * C;
  const int warp = threadIdx.x / 32, cp = 2 * (threadIdx.x % 32);
  for (int idx = threadIdx.x; idx < KS * KS * BC; idx += kBwdThreads) {
    const int gc = c0 + idx % BC;
    sm.taps[idx] = gc < C ? kern[(size_t)(idx / BC) * C + gc] : __float2bfloat16(0.0f);
  }

  const int dy = warp - kDimgWarps;  // the dk warps' tap row
  float2 dk[KS], db = make_float2(0.f, 0.f);
#pragma unroll
  for (int dx = 0; dx < KS; ++dx) dk[dx] = make_float2(0.f, 0.f);

  for (int x0 = 0; x0 < W; x0 += BW) {
    if (x0 > 0) __syncthreads();  // every warp is done with the last chunk
    stage_chunk(sm.g, g + base, y0, x0, c0, H, W, C);
    stage_chunk(sm.img, img + base, y0, x0, c0, H, W, C);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    if (warp < kDimgWarps) {
      // dimg of band row y: g plus the conv of g with the flipped taps
      const int y = warp;
      if (y >= rows) continue;
      float2 acc[BW];
#pragma unroll
      for (int xo = 0; xo < BW; ++xo) acc[xo] = load2(sm.g + ((y + HALO) * SBW + xo + HALO) * BC + cp);
#pragma unroll 1
      for (int ty = 0; ty < KS; ++ty) {
        float2 tap[KS];
#pragma unroll
        for (int dx = 0; dx < KS; ++dx)
          tap[dx] = load2(sm.taps + (KS * KS - 1 - (ty * KS + dx)) * BC + cp);
        const bf16* row = sm.g + (y + ty) * SBW * BC + cp;
#pragma unroll
        for (int xi = 0; xi < SBW; ++xi) {
          const float2 val = load2(row + xi * BC);
#pragma unroll
          for (int dx = 0; dx < KS; ++dx)
            if (xi - dx >= 0 && xi - dx < BW) fma2(acc[xi - dx], tap[dx], val);
        }
      }
      bf16* out = dimg + base + ((size_t)(y0 + y) * W + x0) * C + c0 + cp;
#pragma unroll
      for (int xo = 0; xo < BW; ++xo)
        if (x0 + xo < W) store_pair(out + (size_t)xo * C, c0 + cp, C, acc[xo]);
      continue;
    }
    // dk's tap row dy: g at (y, x) against the img row y + dy - 3, x + dx - 3
    for (int y = 0; y < rows; ++y) {
      const bf16* grow = sm.g + ((y + HALO) * SBW + HALO) * BC + cp;
      const bf16* irow = sm.img + (y + dy) * SBW * BC + cp;
      float2 win[KS];
#pragma unroll
      for (int i = 0; i < KS - 1; ++i) win[i] = load2(irow + i * BC);
#pragma unroll
      for (int x = 0; x < BW; ++x) {
        win[(x + KS - 1) % KS] = load2(irow + (x + KS - 1) * BC);
        const float2 gv = load2(grow + x * BC);
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) fma2(dk[dx], gv, win[(x + dx) % KS]);
        if (dy == 0) {
          db.x += gv.x;
          db.y += gv.y;
        }
      }
    }
  }
  if (warp < kDimgWarps) return;
  float* out = partial + ((size_t)b * gridDim.y + band) * NT * C + c0 + cp;
#pragma unroll
  for (int dx = 0; dx < KS; ++dx) store_pair(out + (size_t)(dy * KS + dx) * C, c0 + cp, C, dk[dx]);
  if (dy == 0) store_pair(out + (size_t)(NT - 1) * C, c0 + cp, C, db);
}

}  // namespace

// Elements of the fp32 `partial` scratch that mirror_ppeg_bwd needs: one
// [50, C] partial per (image, band of BH grid rows).
MIRROR_EXPORT long long mirror_ppeg_bwd_partial_elems(int b, int H, int C) {
  return (long long)b * ((H + BH - 1) / BH) * NT * C;
}

// Backward: dimg (bf16, img's shape) and dkb, fp32 [50, C]: rows 0-48 the
// taps in [7, 7] order, row 49 the bias. partial: fp32 scratch of
// mirror_ppeg_bwd_partial_elems(b, H, C) elements.
MIRROR_EXPORT int mirror_ppeg_bwd(const void* img, const void* kern, const void* g,
                                  void* dimg, void* dkb, void* partial, int b, int H, int W,
                                  int C, cudaStream_t stream) {
  const int bands = (H + BH - 1) / BH;
  const size_t smem = sizeof(BwdSmem);
  cudaError_t err = allow_smem(ppeg_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ppeg_bwd_kernel<<<dim3((C + BC - 1) / BC, bands, b), kBwdThreads, smem, stream>>>(
      static_cast<const bf16*>(img), static_cast<const bf16*>(kern),
      static_cast<const bf16*>(g), static_cast<bf16*>(dimg), static_cast<float*>(partial), H,
      W, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long count = (long long)NT * C;
  column_sum_kernel<float><<<column_sum_blocks(count), dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(partial), b * bands, count, static_cast<float*>(dkb));
  return (int)cudaGetLastError();
}

MIRROR_EXPORT int mirror_ppeg(const void* img, const void* kern, const void* bias, void* out,
                              int b, int H, int W, int C, cudaStream_t stream) {
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), (C + CB - 1) / CB, b);
  ppeg_kernel<<<grid, dim3(CB, TH), 0, stream>>>(
      static_cast<const bf16*>(img), static_cast<const bf16*>(kern),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), H, W, C);
  return (int)cudaGetLastError();
}
