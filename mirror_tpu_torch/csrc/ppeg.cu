// PPEG: identity + bias + merged 7x7 depthwise conv on NHWC (K5).
//
// Replaces: mirror_tpu/ops/ppeg_pallas.py::ppeg_fused (forward pallas_call
// in _fwd_call).
//
// What it computes: out = bf16(img + b + sum over the 49 taps of
// k[dy, dx, c] * img[y + dy - 3, x + dx - 3, c]), zero SAME padding, the
// sum in fp32 and one rounding, as on the TPU.
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
  for (int t = 0; t < KS * KS; ++t) taps[t] = __bfloat162float(kern[(size_t)t * C + gc]);
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

}  // namespace

MIRROR_EXPORT int mirror_ppeg(const void* img, const void* kern, const void* bias, void* out,
                              int b, int H, int W, int C, cudaStream_t stream) {
  const dim3 grid(((H + TH - 1) / TH) * ((W + TW - 1) / TW), (C + CB - 1) / CB, b);
  ppeg_kernel<<<grid, dim3(CB, TH), 0, stream>>>(
      static_cast<const bf16*>(img), static_cast<const bf16*>(kern),
      static_cast<const bf16*>(bias), static_cast<bf16*>(out), H, W, C);
  return (int)cudaGetLastError();
}
