// PPEG: identity + bias + merged 7x7 depthwise conv on NHWC (K5), and its
// backward (K5b).
//
// Replaces: mirror_tpu/ops/ppeg_pallas.py::ppeg_fused (forward pallas_call
// in _fwd_call, backward pallas_call in _bwd_call).
//
// What it computes: out = bf16(img + b + sum over the 49 taps of
// k[dy, dx, c] * img[y + dy - 3, x + dx - 3, c]), zero SAME padding, the
// sum in fp32 and one rounding, as on the TPU. Backward: dimg = bf16(g +
// the same conv of g with the taps flipped), dk[dy, dx, c] = sum over batch
// and grid of g[y, x, c] img[y + dy - 3, x + dx - 3, c] and db[c] = sum of
// g, both fp32 (the caller rounds dk to the kernel's dtype, db to the
// bias's). The backward's reductions are 16 x 2116 positions deep at the
// slice's shape: per-block partials over bands of 8 grid rows, then a
// second pass in a fixed order, so the result is deterministic.
//
// What bounds it on the H100: the fp32 FMA rate and bytes about equally.
// 49 FMAs (98 FLOP) per element against one bf16 read and one write is
// 24.5 FLOP/byte, near the card's fp32 ridge of ~20 FLOP/byte (67 TFLOP/s
// over 3.35 TB/s). At the slice's shape [16, 46, 46, 768] the op moves
// 52 MB and does 2.6 GFLOP.
//
// Design: channels are contiguous (NHWC), so a block takes a 8 x 8 spatial
// tile of 32 channels, stages the tile plus its 3-pixel halo (14 x 14 x 32
// bf16, 12.5 KB) in shared memory once, and each thread (one channel, one
// row of the tile) keeps its channel's 49 taps in registers and sweeps the
// 8 pixels of its row. Every input element is read from device memory about
// (14/8)^2 = 3 times through L2 and once from DRAM; the TPU's channel
// blocking (_cblk) and 64 MB VMEM limit have no counterpart.
#include "common.cuh"

namespace {

constexpr int KS = 7, HALO = KS / 2;
constexpr int TH = 8, TW = 8, CB = 32;
constexpr int SH = TH + KS - 1, SW = TW + KS - 1;

// FLIP (the backward's dimg = g + conv of g with the flipped taps): taps
// read mirrored, no bias.
template <bool FLIP>
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
    taps[t] = __bfloat162float(kern[(size_t)(FLIP ? KS * KS - 1 - t : t) * C + gc]);
  const float b = FLIP ? 0.f : __bfloat162float(bias[gc]);
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

// Backward (K5b), the tap and bias gradients: one block per (channel block
// of 32, band of TH grid rows, batch item) stages the band of g and the
// band of img with its 3-pixel halo, and thread (c, ty) sums, for its
// channel, the taps t = ty, ty + 8, ... of the 50 "taps" (49 conv taps,
// then the bias: the plain sum of g) over the band's positions in fp32.
// Each block writes its partial; ppeg_reduce_kernel sums them over batch
// and bands in a fixed order (deterministic, no atomics).
constexpr int NT = KS * KS + 1;  // 49 taps and the bias

__global__ void __launch_bounds__(CB * TH)
    ppeg_dk_partial_kernel(const bf16* __restrict__ img, const bf16* __restrict__ g,
                           float* __restrict__ partial, int H, int W, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int SWb = W + KS - 1, SHb = TH + KS - 1;
  bf16* sI = reinterpret_cast<bf16*>(smem);                      // [SHb][SWb][CB]
  bf16* sG = sI + (size_t)SHb * SWb * CB;                       // [TH][W][CB]
  const int c0 = blockIdx.x * CB, band = blockIdx.y, b = blockIdx.z;
  const int y0 = band * TH;
  const size_t base = (size_t)b * H * W * C;
  const int tid = threadIdx.y * CB + threadIdx.x;
  const bf16 zero = __float2bfloat16(0.0f);
  for (int idx = tid; idx < SHb * SWb * CB; idx += CB * TH) {
    const int c = idx % CB, p = idx / CB;
    const int gy = y0 + p / SWb - HALO, gx = p % SWb - HALO, gc = c0 + c;
    sI[idx] = (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
                  ? img[base + ((size_t)gy * W + gx) * C + gc]
                  : zero;
  }
  for (int idx = tid; idx < TH * W * CB; idx += CB * TH) {
    const int c = idx % CB, p = idx / CB;
    const int gy = y0 + p / W, gx = p % W, gc = c0 + c;
    sG[idx] = (gy < H && gc < C) ? g[base + ((size_t)gy * W + gx) * C + gc] : zero;
  }
  __syncthreads();

  const int c = threadIdx.x, gc = c0 + c;
  if (gc >= C) return;
  const int rows = min(TH, H - y0);
  float* out = partial + ((size_t)b * gridDim.y + band) * NT * C;
  for (int t = threadIdx.y; t < NT; t += TH) {
    const int dy = t / KS, dx = t % KS;
    float acc = 0.f;
    for (int y = 0; y < rows; ++y)
      for (int x = 0; x < W; ++x) {
        const float gv = __bfloat162float(sG[(y * W + x) * CB + c]);
        acc = t == NT - 1
                  ? acc + gv
                  : fmaf(gv, __bfloat162float(sI[((y + dy) * SWb + x + dx) * CB + c]), acc);
      }
    out[(size_t)t * C + gc] = acc;
  }
}

__global__ void ppeg_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ dkb, int parts, int C) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;  // t * C + c
  if (idx >= NT * C) return;
  float acc = 0.f;
  for (int p = 0; p < parts; ++p) acc += partial[(size_t)p * NT * C + idx];
  dkb[idx] = acc;
}

}  // namespace

// Elements of the fp32 `partial` scratch that mirror_ppeg_bwd needs: one
// [50, C] partial per (image, band of TH grid rows).
MIRROR_EXPORT long long mirror_ppeg_bwd_partial_elems(int b, int H, int C) {
  return (long long)b * ((H + TH - 1) / TH) * NT * C;
}

// Backward: dimg (bf16, img's shape) and dkb, fp32 [50, C]: rows 0-48 the
// taps in [7, 7] order, row 49 the bias. partial: fp32 scratch of
// mirror_ppeg_bwd_partial_elems(b, H, C) elements.
MIRROR_EXPORT int mirror_ppeg_bwd(const void* img, const void* kern, const void* g,
                                  void* dimg, void* dkb, void* partial, int b, int H, int W,
                                  int C, cudaStream_t stream) {
  const bf16* gp = static_cast<const bf16*>(g);
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), (C + CB - 1) / CB, b);
  ppeg_kernel<true><<<grid, dim3(CB, TH), 0, stream>>>(
      gp, static_cast<const bf16*>(kern), nullptr, static_cast<bf16*>(dimg), H, W, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int bands = (H + TH - 1) / TH;
  const size_t smem = ((size_t)(TH + KS - 1) * (W + KS - 1) + (size_t)TH * W) * CB * sizeof(bf16);
  err = allow_smem(ppeg_dk_partial_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  ppeg_dk_partial_kernel<<<dim3((C + CB - 1) / CB, bands, b), dim3(CB, TH), smem, stream>>>(
      static_cast<const bf16*>(img), gp, static_cast<float*>(partial), H, W, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ppeg_reduce_kernel<<<(NT * C + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(dkb), b * bands, C);
  return (int)cudaGetLastError();
}

MIRROR_EXPORT int mirror_ppeg(const void* img, const void* kern, const void* bias, void* out,
                              int b, int H, int W, int C, cudaStream_t stream) {
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), (C + CB - 1) / CB, b);
  ppeg_kernel<false><<<grid, dim3(CB, TH), 0, stream>>>(
      static_cast<const bf16*>(img), static_cast<const bf16*>(kern),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), H, W, C);
  return (int)cudaGetLastError();
}
